"""Closed-loop serving load: one client sends a request of LR faces to the
program's ``Predictor.predict`` and sends the next when it returns.

Parameters (the traffic file): ``request_faces`` (the sizes of the
requests, each once in every run of that many requests, in an order drawn
from the seed), ``batch_size`` (the Predictor's chunk, as ``serve
--batch``), ``serve`` (``steps`` of DDIM; ``int8`` as ``serve --int8``,
None its default; the rest of the recipe is ``spec.py``'s),
``faces_pool`` (distinct LR faces made from the seed, which the requests
draw from), ``warmup_requests``, ``trace_requests`` (the profiled slice),
``check_requests`` (requests compared with the reference after the
window).

The Predictor is built as the serving CLI builds it (the configuration, the
serving flags, ``Predictor.from_config``), with the benchmark's weights and
FLAME handed in.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import inputs, spec as spec_mod, weights
from ..reference import serve as ref_serve


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flame_arrays(config: dict, seed: int) -> dict:
    f = config["flame"]
    n_shape = int(config["yaml"]["mica"]["model"]["n_shape"])
    return inputs.synthetic_flame(int(f["n_vertices"]), n_shape,
                                  int(f["n_exp"]), int(f["n_faces"]),
                                  inputs.seed32(seed, "flame"))


def flame_tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()
            if k != "parents"}


class Load:
    """One client's closed loop over the program for one seed: set-up,
    the window, the profiled slice, and the check of what it served."""

    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = cell["traffic"]
        self.spec = spec_mod.reference_spec(cell["config"], self.traffic)
        self.batch = int(self.traffic["batch_size"])
        self.outputs: dict[int, dict] = {}
        self.failed = 0
        self.errors: list[str] = []

    # -- the program ----------------------------------------------------
    def _program_flame(self, arrays: dict):
        from sr3d_torch.models.flame import FlameModel

        parents = np.asarray(arrays["parents"], np.int64)
        chain, j = [], 1
        while j != -1:
            chain.append(j)
            j = int(parents[j])
        t = flame_tensors(arrays, self.device)
        t = {k: (v.long() if not torch.is_floating_point(v) else v)
             for k, v in t.items()}
        return FlameModel(**t, parents=parents,
                          neck_kin_chain=np.asarray(chain, np.int64),
                          n_shape=int(self.spec["mica"]["n_shape"]),
                          n_exp=int(self.cell["config"]["flame"]["n_exp"]))

    def build(self) -> None:
        """The Predictor with the benchmark's weights for ``self.seed``."""
        from sr3d_torch.config import get_cfg_defaults
        from sr3d_torch.serve import Predictor

        cfg = get_cfg_defaults()
        cfg.merge_from_other(spec_mod.program_tree(self.cell["config"],
                                                   self.traffic),
                             strict=True)
        self.predictor = Predictor.from_config(
            cfg, init_seed=0, batch_size=self.batch,
            flame=self._program_flame(self.flame_np), device=self.device)
        self.load_weights(self.seed)

    def load_weights(self, seed: int) -> None:
        m = self.predictor.modules
        w = weights.make(self.spec, seed, self.device)
        for net in ("unet", "arcface", "mapping"):
            getattr(m, net).load_state_dict(w[net], strict=True)
        del w

    def release(self) -> None:
        self.predictor = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the traffic ----------------------------------------------------
    def make_inputs(self) -> None:
        """The seed's LR face pool and FLAME arrays."""
        self.pool = inputs.lr_faces_u8(int(self.traffic["faces_pool"]),
                                       self.spec["lr"],
                                       inputs.seed32(self.seed, "faces"))
        self.flame_np = flame_arrays(self.cell["config"], self.seed)

    def request(self, i: int) -> tuple[np.ndarray, int]:
        """Request ``i``'s faces and the seed of its CPU generator.  Each
        run of ``len(request_faces)`` requests takes every size once, in an
        order drawn from the seed, so every seed sends the same work."""
        sizes = self.traffic["request_faces"]
        block = np.random.RandomState(inputs.seed32(
            self.seed, f"sizes{i // len(sizes)}")).permutation(len(sizes))
        n = int(sizes[block[i % len(sizes)]])
        rng = np.random.RandomState(inputs.seed32(self.seed, f"req{i}"))
        idx = rng.choice(self.pool.shape[0], n,
                         replace=n > self.pool.shape[0])
        return self.pool[idx], inputs.seed32(self.seed, f"noise{i}")

    def serve(self, i: int, keep: bool = True) -> int:
        """Serve request ``i``; returns its faces (0 if it failed)."""
        lr, gseed = self.request(i)
        try:
            out = self.predictor.predict(
                lr, generator=torch.Generator().manual_seed(gseed))
        except Exception as e:  # a failed request counts, the loop goes on
            self.failed += 1
            self.errors.append(f"request {i}: {type(e).__name__}: {e}")
            return 0
        if keep:
            self.outputs[i] = out
        return lr.shape[0]

    # -- the phases -----------------------------------------------------
    def setup(self) -> None:
        t = [time.perf_counter()]
        self.make_inputs()
        t.append(time.perf_counter())
        self.build()
        t.append(time.perf_counter())
        for k in range(int(self.traffic["warmup_requests"])):
            lr, gseed = self.request(-1 - k)     # a failure here raises
            self.predictor.predict(
                lr, generator=torch.Generator().manual_seed(gseed))
        _sync(self.device)
        t.append(time.perf_counter())
        self.setup_phases = dict(zip(("inputs", "program", "warmup"),
                                     np.diff(t).tolist()))

    def window(self, seconds: float) -> dict:
        """Requests back to back until ``seconds`` have passed; the window
        ends when the last request returns."""
        lat, faces, i = [], 0, 0
        t0 = time.perf_counter()
        while i == 0 or time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            faces += self.serve(i)
            lat.append(time.perf_counter() - ts)
            i += 1
        wall = time.perf_counter() - t0
        self.n_next = i
        return {"latencies_s": lat, "faces": faces, "wall_s": wall,
                "requests": i}

    def traced(self, profile, host: bool) -> tuple:
        """A profiled slice: the next ``trace_requests`` requests after the
        window's and the slices' before; returns its faces, the ``Trace``
        and its requests."""
        n0, n = self.n_next, int(self.traffic["trace_requests"])
        self.n_next += n

        def run():
            return sum(self.serve(n0 + k, keep=False) for k in range(n))

        faces, tr = profile(run, host)
        return faces, tr, n

    def hook(self, spans) -> None:
        m = self.predictor.modules
        spans.hook(m.unet, "bm.unet")
        spans.hook(m.arcface, "bm.arcface", then_open="bm.mica")
        spans.hook(m.mapping, "bm.mapping")
        p = self.predictor
        p._step = spans.wrap(p._step, "bm.val_step", closes=("bm.mica",))
        p.predict = spans.wrap(p.predict, "bm.request")

    # -- correctness ----------------------------------------------------
    def check_sample(self) -> list[int]:
        """The requests compared with the reference: drawn by the seed from
        those the window completed."""
        done = sorted(self.outputs)
        k = min(int(self.traffic["check_requests"]), len(done))
        rng = np.random.RandomState(inputs.seed32(self.seed, "check"))
        return sorted(rng.choice(done, k, replace=False).tolist())

    def check(self, control: bool = False, requests=None) -> dict:
        """Compare the sampled requests with the plain reference.  With
        ``control`` the reference in lower precision stands in the
        program's place."""
        reqs = self.check_sample() if requests is None else requests
        params = weights.make(self.spec, self.seed, self.device)
        flame = flame_tensors(self.flame_np, self.device)
        got, want, mica_want = [], [], []
        for i in reqs:
            lr, gseed = self.request(i)
            ref = ref_serve.serve(params, self.spec, flame, lr,
                                  torch.Generator().manual_seed(gseed),
                                  self.batch, self.device)
            if control:
                prog = ref_serve.serve(params, self.spec, flame, lr,
                                       torch.Generator().manual_seed(gseed),
                                       self.batch, self.device, control=True)
            else:
                prog = self.outputs[i]
            got.append(prog)
            want.append(ref)
            mica_want.append(ref_serve.mica_of(params, self.spec, flame,
                                               np.asarray(prog["sr_u8"]),
                                               self.device))
        template = ref_serve.mica.flame_decode(
            flame, torch.zeros(1, self.spec["mica"]["n_shape"],
                               device=self.device),
            ref_serve.Arith())
        del params
        return compare(got, want, mica_want,
                       [t[0].cpu().numpy() for t in template])


def _rel(a: np.ndarray, b: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Per face ‖a − b‖ / ‖base‖ over every axis but the first."""
    ax = tuple(range(1, a.ndim))
    num = np.sqrt(((a.astype(np.float64) - b) ** 2).sum(ax))
    den = np.sqrt((base.astype(np.float64) ** 2).sum(ax))
    return num / np.maximum(den, 1e-30)


def compare(got: list[dict], want: list[dict], mica_want: list[dict],
            template: list[np.ndarray]) -> dict:
    """The numbers that decide ``correct``, each the worst face of the
    sample:

    * ``sr_median_u8``: the median over the SR image's values of |Δ| in
      uint8 levels, the program's served image against the reference's own
      sample of the same request (the median, since an int8 level that
      flips on rounding sends a few regions of a stochastic 25-step
      trajectory elsewhere);
    * ``sr_over64_share``: the share of the image's values off by more than
      64 levels, which a fault in part of a face (a colour channel, a
      quarter of the image) raises while the median stays;
    * ``identity_rel``, ``verts_rel``, ``lmk68_rel``: the program's MICA
      outputs against the reference's MICA branch run on the program's own
      SR image, as ‖Δ‖ over the reference's identity code, its vertices'
      offset from the template, its landmarks' offset from the template's.

    A request whose outputs have the wrong shapes or are not finite makes
    every number infinite."""
    v0, l0 = template
    rows = {"sr_median_u8": [], "sr_over64_share": [], "identity_rel": [],
            "verts_rel": [], "lmk68_rel": []}
    for g, w, mw in zip(got, want, mica_want):
        ok = all(k in g and np.shape(g[k]) == np.shape(w[k])
                 and np.isfinite(np.asarray(g[k], np.float64)).all()
                 for k in ("sr_u8", "identity", "verts", "lmk68"))
        if not ok:
            return {k: float("inf") for k in rows}
        d = np.abs(np.asarray(g["sr_u8"], np.float64) - w["sr_u8"])
        d = d.reshape(d.shape[0], -1)
        rows["sr_median_u8"].append(np.median(d, axis=1))
        rows["sr_over64_share"].append((d > 64).mean(axis=1))
        rows["identity_rel"].append(_rel(g["identity"], mw["identity"],
                                         mw["identity"]))
        rows["verts_rel"].append(_rel(g["verts"], mw["verts"],
                                      mw["verts"] - v0))
        rows["lmk68_rel"].append(_rel(g["lmk68"], mw["lmk68"],
                                      mw["lmk68"] - l0))
    return {k: float(np.concatenate(v).max()) for k, v in rows.items()}
