"""The 7-level SR3 UNet of the 64->512 face model (``benchmark/configs/
sr3_64_512.json``: 64·[1, 2, 4, 8, 8, 16, 16], 3 ResnetBlocks a level,
attention at 16² in the encoder, the decoder and the mid block) at a CPU
test size: the same plan at 64² data, ``image_size`` 64 and ``attn_res``
[16], with 32·[1, 1, 2, 2, 2, 4, 4] channels.  Held against the
benchmark's plain reference (``benchmark/reference/``) with and without
the int8 convs, in a served request, and against the JAX package's UNet;
and the level marks of each plan, on the meta device for the benchmark's
configurations."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import spec as bm_spec
from benchmark import weights
from benchmark.reference import unet as ref_unet
from benchmark.reference.ops import Arith
from sr3d_torch.models import sr3_unet
from sr3d_torch.models.sr3_unet import SR3UNet, level_labels
from sr3d_torch.utils.bridge import state_dict_to_flax
from sr3d_tpu.models.sr3_unet import SR3UNet as JaxUNet

torch.set_num_threads(1)

RES = 64
UNET = {"in_channel": 6, "out_channel": 3, "inner_channel": 32,
        "norm_groups": 8, "channel_multiplier": [1, 1, 2, 2, 2, 4, 4],
        "attn_res": [16], "res_blocks": 3, "dropout": 0.0}
# fp32 on both sides, summed in other orders: ~1e-6 a layer through ~50
# layers.
ATOL = 2e-4


def _kwargs(quant: bool) -> dict:
    return dict(in_channel=6, out_channel=3, inner_channel=32,
                norm_groups=8, channel_mults=(1, 1, 2, 2, 2, 4, 4),
                attn_res=(16,), res_blocks=3, image_size=RES,
                quant_min_res=1 if quant else 0, quant_resample=quant)


@pytest.fixture(scope="module")
def params():
    """The benchmark's seeded weights for the deep plan (the reference's
    names are the port's ``state_dict`` keys)."""
    spec = {"unet": UNET, "image_size": RES,
            "mica": {"arcface_layers": [1, 1, 1, 1], "map_hidden_dim": 8,
                     "n_shape": 8, "mapping_layers": 1}}
    return weights.make(spec, 190001, "cpu")["unet"]


def _port(params, quant: bool) -> SR3UNet:
    unet = SR3UNet(**_kwargs(quant), dtype=torch.float32)
    unet.load_state_dict(params, strict=True)
    return unet.eval()


def _inputs(seed: int, B: int = 2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 6, RES, RES, generator=g),
            torch.rand(B, 1, generator=g))


def test_the_plan_attends_in_the_encoder_decoder_and_mid_block(params):
    unet = _port(params, False)
    attn = sorted(n for n, _ in unet.named_modules() if n.endswith("attn"))
    # the 16² level is level 2: its 3 encoder and 4 decoder blocks
    assert attn == sorted([f"down_2_{b}.attn" for b in range(3)]
                          + [f"up_2_{b}.attn" for b in range(4)]
                          + ["mid_0.attn"])
    assert [k for k, _ in unet.plan].count("down") == 7 * 3
    assert len(ref_unet.unet_plan(UNET, RES)) == len(unet.plan) + 1


@pytest.mark.parametrize("quant", [False, True])
def test_deep_unet_matches_the_plain_reference(params, quant):
    """fp32, eager, against ``benchmark/reference/unet.py::unet_forward``,
    whose ``Arith`` quantizes the same convs with the same steps.

    The int8 forward is not continuous: an activation within an fp32 ulp
    of a rounding boundary takes either int8 level, and at the 2² and 1²
    levels one level moves every pixel after it.  The reference itself
    moves by 2.8% (relative norm) when its input moves by 1e-7; the port
    is held to twice the larger of two such moves of the reference."""
    unet = _port(params, quant)
    x, g = _inputs(3)
    u = dict(UNET, quant_min_res=1 if quant else 0, quant_resample=quant)

    def ref(x):
        return ref_unet.unet_forward(params, u, RES, x, g, Arith(), quant)

    with torch.no_grad():
        got = unet(x, g, quant=quant)
        want = ref(x)
        if quant:
            moved = max(float((ref(x * (1 + s)) - want).norm())
                        for s in (1e-7, -1e-7))
    assert got.shape == want.shape == (2, 3, RES, RES)
    if quant:
        err = float((got - want).norm())
        assert 0 < moved < 0.1 * float(want.norm())
        assert err < 2 * moved, (err, moved)
    else:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_deep_unet_matches_jax(params):
    """The same weights in the JAX package's UNet, NHWC at the boundary,
    jitted."""
    unet = _port(params, False)
    jax_unet = JaxUNet(inner_channel=32, norm_groups=8,
                       channel_mults=(1, 1, 2, 2, 2, 4, 4), attn_res=(16,),
                       res_blocks=3, image_size=RES, dropout=0.0,
                       dtype=jnp.float32)
    tree = {"params": state_dict_to_flax(unet.state_dict())}
    x, g = _inputs(5)
    want = np.asarray(jax.jit(jax_unet.apply)(
        tree, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
        jnp.asarray(g.numpy())))
    with torch.no_grad():
        got = unet(x, g).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _deep_cell() -> dict:
    """A serving cell of the deep plan at 8 → 64: the benchmark's CPU test
    configuration (a 4-block ArcFace, a small synthetic FLAME) with this
    UNet, requests of 2 faces in chunks of 2, DDIM-3 at the serving
    defaults (w8a8 at every ResnetBlock and resampling conv), held to the
    64->512 cell's limits."""
    here = bm_spec.ROOT / "benchmark"
    config = json.loads((here / "tests" / "tiny_config.json").read_text())
    sr = config["yaml"]["sr"]
    sr["model"]["unet"] = dict(UNET)
    sr["model"]["diffusion"]["image_size"] = RES
    for part in ("train", "val"):
        sr["datasets"][part].update(l_resolution=8, r_resolution=RES)
    traffic = {"load": "serve_closed", "request_faces": [2],
               "batch_size": 2, "serve": {"steps": 3, "int8": None},
               "faces_pool": 4, "warmup_requests": 0, "trace_requests": 1,
               "check_requests": 1}
    return {"workload": {"name": "deep.serve", "chips": 1},
            "config": config, "traffic": traffic,
            "limits": bm_spec.load_json(here / "limits"
                                        / "sr3_64_512.serve_b4.json"),
            "end_to_end": [], "per_layer": []}


def test_served_request_matches_the_plain_reference():
    """``Predictor.predict`` (built as the serving CLI builds it, through
    the benchmark's closed loop) against ``benchmark/reference/serve.py``
    on the same weights, faces and generator."""
    from benchmark.loads.serve_closed import Load

    cell = _deep_cell()
    d = Load(cell, 3000000777, "cpu")
    d.setup()
    assert d.predictor.hr == RES and d.predictor.modules.unet.n_levels == 7
    assert d.serve(0) == 2 and d.failed == 0
    assert d.outputs[0]["sr_u8"].shape == (2, RES, RES, 3)
    d.release()
    numbers = d.check(requests=[0])
    limits = cell["limits"]["limits"]
    assert all(numbers[k] <= limits[k] for k in limits), numbers


def _unet_of(config: str) -> SR3UNet:
    """A benchmark configuration's served UNet on the meta device."""
    conf = bm_spec.load_json(bm_spec.HERE / "configs" / f"{config}.json")
    u = bm_spec.program_tree(conf, {"serve": {"steps": 25, "int8": None}}
                             )["sr"]["model"]
    with torch.device("meta"):
        return sr3_unet.unet_from_config(u["unet"], u["diffusion"]).eval()


@pytest.mark.parametrize("config,res,levels", [
    ("tiny", RES, ("e64-e32", "e16-d16", "d32-d64")),
    ("sr3_16_128", 128, ("e128-e64", "e32-d32", "d64-d128")),
    ("sr3_64_512", 512, ("e512-e256", "e128-d128", "d256-d512")),
])
def test_level_marks_bound_each_level(params, monkeypatch, config, res,
                                      levels):
    """A forward where marks record launches ``levels`` + 1 of them: at the
    start, after the encoder's two outer levels (the second's Downsample
    output, at a quarter of the resolution), before the decoder's (after
    the Upsample into them, at half), and after the final block; the
    ``sr3d.unet`` span names the three segments.  The benchmark's
    configurations run on the meta device (no memory, no arithmetic);
    off CUDA, where marks do not record, a forward launches none."""
    from sr3d_torch.utils import profiling

    unet = _port(params, False) if config == "tiny" else _unet_of(config)
    device = "cpu" if config == "tiny" else "meta"
    if device == "meta":    # the kernels' wrappers take CPU or CUDA tensors
        monkeypatch.setattr(sr3_unet, "gn_swish",
                            lambda x, gamma, beta, groups, eps=1e-5: x)
        monkeypatch.setattr(sr3_unet, "spatial_attention",
                            lambda q, k, v, channels=None: q)
    x = torch.zeros(1, 6, res, res, device=device)
    t = torch.zeros(1, 1, device=device)
    seen = []
    monkeypatch.setattr(sr3_unet, "level_mark",
                        lambda dev: seen.append(len(seen)))
    with torch.no_grad():
        unet(x, t)
        assert seen == []
        monkeypatch.setattr(sr3_unet, "marks_recorded", lambda x: True)
        shapes = []
        monkeypatch.setattr(sr3_unet, "level_mark",
                            lambda dev: shapes.append(here()))
        out = {}

        def here():
            return out.get("h")

        def keep(mod, args, result):
            out["h"] = result.shape[2]

        hooks = [getattr(unet, n).register_forward_hook(keep)
                 for _, n in unet.plan]
        hooks.append(unet.final_conv.register_forward_hook(keep))
        profiling.take_spans()
        profiling.spans_on()
        try:
            unet(x, t)
        finally:
            profiling.spans_off()
            for h in hooks:
                h.remove()
    assert level_labels(unet.n_levels, res) == levels
    assert [s.attrs["levels"] for s in profiling.take_spans()] == [levels]
    assert shapes == [None, res // 4, res // 2, res]
    assert len(shapes) == len(levels) + 1 == 4
