"""A whole run with the timed path broken underneath has to come out not
correct: once for each fault a serving cell can have, and for faults in
part of a face.  (A serving cell on
one chip has no exchange between chips to leave out.)"""

import pytest
import torch
from conftest import tiny_cell

import sr3d_torch.diffusion.gaussian as gaussian
import sr3d_torch.serve as serve
from benchmark import run as run_mod
from benchmark import spec


def _broken_step(fault):
    real = serve.make_val_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(modules, batch, **kw):
            if fault == "half_batch":
                half = {"SR": batch["SR"][: batch["SR"].shape[0] // 2]}
                out = step(modules, half, **kw)
                return {k: torch.cat([v, v]) for k, v in out.items()}
            out = step(modules, batch, **kw)
            if fault == "identity_altered":
                out["identity"] = out["identity"].clone()
                out["identity"][0] *= 1.1
            elif fault == "image_altered":
                out["sr"] = out["sr"].clone()
                out["sr"][0] = out["sr"][0].flip(1)
            return out

        return broken

    return make


def _broken_sample(fault):
    """The sampler's output with part of the first face inverted about
    mid-grey where it is produced, before the MICA branch reads it: one
    colour channel, or the top left quarter of the image."""
    real = gaussian._run_steps

    def run(*args, **kwargs):
        img = real(*args, **kwargs).clone()     # NCHW
        assert img.shape[1] == 3, img.shape
        h, w = img.shape[2] // 2, img.shape[3] // 2
        part = (0, 0) if fault == "channel_altered" else \
            (0, slice(None), slice(0, h), slice(0, w))
        img[part] = -img[part]
        return img

    return run


LOCAL = ["channel_altered", "quarter_altered"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "identity_altered", "image_altered"]
                         + LOCAL)
def test_broken_path_is_not_correct(fault, monkeypatch):
    if fault == "state_unchanged":
        # every sampler step hands back the state it was given
        monkeypatch.setattr(gaussian, "_run_steps",
                            lambda step, img, n, draw, **kw: img)
    elif fault in LOCAL:
        monkeypatch.setattr(gaussian, "_run_steps", _broken_sample(fault))
    else:
        monkeypatch.setattr(serve, "make_val_step", _broken_step(fault))
    res = run_mod.run("tiny.serve_b8", 3000000777, 1.0, False,
                      device="cpu", cell=tiny_cell())
    assert not res["correct"], res["checks"]
    if fault in LOCAL:
        # a fault in a third or a quarter of a face's values leaves the
        # median of |Δ| inside its limit: the share off by more than 64
        # levels catches it
        med = res["checks"]["sr_median_u8"]
        far = res["checks"]["sr_over64_share"]
        assert med["value"] <= med["limit"], res["checks"]
        assert far["value"] > far["limit"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", LOCAL)
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_local_fault_fails_on_card_at_the_cells_size(card, workload, fault,
                                                     monkeypatch):
    from benchmark.calibrate import readings

    monkeypatch.setattr(gaussian, "_run_steps", _broken_sample(fault))
    cell = spec.cell(workload)
    limits = cell["limits"]["limits"]
    numbers = readings(cell, 3000000999, card, control=False)
    print(workload, fault, numbers)
    assert any(numbers[k] > limits[k] for k in limits), numbers
