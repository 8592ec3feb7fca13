"""Serving API: LR faces → (SR image, FLAME mesh, landmarks, identity).

Counterpart of ``sr3d_tpu/serve.py``: ``Predictor`` and the batch-serving
CLI ``main``.  Requests of any size are cut into chunks of a fixed
``batch_size`` (the tail padded with zeros and un-padded after), each chunk
with its own noise stream, and served by ``train.joint.make_val_step`` on
the GPU, with the w8a8 int8 UNet where the config's ``quant_min_res`` asks
for it (the CLI's default).

    >>> from sr3d_torch.config import get_cfg_defaults, update_cfg
    >>> cfg = update_cfg(get_cfg_defaults(), "configs/<config>.yml")
    >>> p = Predictor.from_config(cfg, checkpoint="out/best_model.npz")
    >>> out = p.predict(lr_u8)          # [N, l, l, 3] uint8, any N
    >>> out["sr_u8"], out["verts"], out["lmk68"], out["identity"]

    python -m sr3d_torch.serve -c <cfg.yml> -ckt best_model.npz \
        --input <lr_dir> --out <dst>
"""

from __future__ import annotations

import contextlib
import functools
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .diffusion.ema import EmaState
from .eval.export import export_prediction, save_img
from .ops.image import resize, tensor_to_uint8
from .parallel.mesh import DATA_AXIS, MODEL_AXIS
from .parallel.steps import pjit_sample, pjit_sample_spatial
from .train.checkpoint import (
    latest_npz_step,
    load_leaves_into,
    load_state_npz,
    npz_step_path,
)
from .train.joint import JointModules, build_joint, make_val_step
from .utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_ema,
    load_jax_params,
)
from .utils.profiling import annotate, trace


class Predictor:
    """Inference endpoint over a ``JointModules``.  With ``use_ema`` the UNet
    samples with ``ema``'s parameters (without one, with its own, as the
    JAX package does).

    With ``mesh`` (``parallel.make_mesh``; every rank of it builds the same
    Predictor and calls ``predict`` with the same request) a request is
    served over the mesh: each chunk's batch is split over the ``data``
    axis (throughput), or with ``spatial=True`` the image height over the
    ``model`` axis (latency: one face's sampling spread over ranks; the
    UNet exchanges halo rows, sums GroupNorm's moments over the bands and
    gathers attention's q, k and v).  The draws are the one-device run's,
    and every rank returns the whole result, as the JAX Predictor's
    replicated outputs."""

    def __init__(self, cfg, modules: JointModules, batch_size: int = 8,
                 use_ema: bool = False, ema: EmaState | None = None,
                 mesh=None, spatial: bool = False):
        self.cfg = cfg
        self.modules = modules
        self.batch_size = int(batch_size)
        # the SR output resolution is the dataset's r_resolution, not
        # diffusion.image_size (which only gates the attention topology)
        self.hr = int(cfg.sr.datasets.val.r_resolution)
        self.lr = int(cfg.sr.datasets.val.l_resolution)
        # without use_ema the EMA is dead weight
        self.ema = ema if use_ema else None
        sample_over = None
        if mesh is not None and spatial:
            n = mesh.shape[MODEL_AXIS]
            if self.hr % n:
                raise ValueError(f"image height {self.hr} not divisible by "
                                 f"the model axis ({n})")
            # each Downsample halves an even band (JAX's GSPMD pads an
            # uneven one; the port asks for even bands at every level)
            downs = sum(k == "downsample" for k, _ in modules.unet.plan)
            for lvl in range(downs):
                if n > 1 and (self.hr >> lvl) % (2 * n):
                    raise ValueError(
                        f"UNet level {lvl} ({self.hr >> lvl} rows) does "
                        f"not split into even bands over the model axis "
                        f"({n})")
            sample_over = functools.partial(pjit_sample_spatial, mesh=mesh)
        elif mesh is not None:
            n = mesh.shape[DATA_AXIS]
            if self.batch_size % n:
                raise ValueError(f"batch_size {self.batch_size} not "
                                 f"divisible by the data axis ({n})")
            sample_over = functools.partial(pjit_sample, mesh=mesh)
        # under a mesh each rank samples its rows or band of rows; the
        # sample and the MICA branch's outputs are whole on every rank
        self._step = make_val_step(use_ema=use_ema, sample_over=sample_over)

    @classmethod
    def from_config(cls, cfg, checkpoint: str | None = None, *,
                    use_ema: bool = False,
                    params: Mapping[str, Any] | None = None,
                    init_seed: int | None = None, batch_size: int = 8,
                    flame=None, dtype: torch.dtype | None = None,
                    device: str | torch.device | None = None,
                    mesh=None, spatial: bool = False) -> "Predictor":
        """Build the modules from the config and load their weights, as the
        JAX ``Predictor.from_config`` does:

        * ``checkpoint`` a ``.npz``: a ``save_state_npz`` train state (its
          EMA too, where the config has one), or else a converted reference
          UNet (SR branch only: ArcFace and the mapping keep their random
          init from ``cfg.seed``, and there is no EMA);
        * ``checkpoint=None``: the newest ``ckpt_*.npz`` under
          ``{output_dir}/{name}/{path.checkpoint}``; FileNotFoundError where
          there is none.

        ``params`` (the JAX joint tree as numpy: ``{"sr", "arcface",
        "arcface_stats", "mapping"}``) or ``init_seed`` (random weights,
        explicitly) replace the checkpoint.  Random weights are never
        served by accident.  ``mesh`` and ``spatial`` as for the
        constructor."""
        par = dict(mesh=mesh, spatial=spatial)
        if params is not None or init_seed is not None:
            if checkpoint is not None:
                raise ValueError("pass one of checkpoint=, params= and "
                                 "init_seed=")
            modules = build_joint(cfg, flame=flame, dtype=dtype,
                                  device=device, init_seed=init_seed or 0)
            if params is not None:
                load_jax_params(modules, params)
            return cls(cfg, modules, batch_size, use_ema, **par)
        if checkpoint is None:
            ckpt_dir = (Path(cfg.output_dir) / (cfg.get("name") or "default")
                        / cfg.path.checkpoint)
            step = latest_npz_step(ckpt_dir)
            if step is None:
                # never silently serve randomly-initialised weights
                raise FileNotFoundError(
                    f"no checkpoint found under {ckpt_dir} — pass an "
                    f"explicit .npz via `checkpoint=` or train first")
            checkpoint = str(npz_step_path(ckpt_dir, step))
        elif not str(checkpoint).endswith(".npz"):
            raise FileNotFoundError(f"checkpoint {checkpoint!r}: expected a "
                                    f".npz path or None for auto-resume")
        modules = build_joint(cfg, flame=flame, dtype=dtype, device=device,
                              init_seed=int(cfg.seed))
        try:
            state = load_state_npz(checkpoint, modules, cfg)
        except (ValueError, KeyError):
            # a converted reference UNet: the SR branch only
            sr = load_leaves_into(checkpoint, export_jax_params(modules)["sr"])
            modules.unet.load_state_dict(flax_to_state_dict(sr))
            return cls(cfg, modules, batch_size, use_ema, **par)
        load_jax_params(modules, dict(state["params"],
                                      arcface_stats=state["arcface_stats"]))
        ema = state["ema"]
        if ema is not None:
            ema = load_jax_ema(ema["params"], ema["step"], modules.device)
        return cls(cfg, modules, batch_size, use_ema, ema, **par)

    def warmup(self) -> float:
        """Serve one dummy face end to end; returns wall seconds."""
        t0 = time.perf_counter()
        self.predict(np.zeros((1, self.lr, self.lr, 3), np.uint8))
        return time.perf_counter() - t0

    def _prep_cond(self, lr_imgs: np.ndarray) -> torch.Tensor:
        """uint8 or [−1, 1] NHWC LR batch → the bicubic-upsampled
        conditioning on the device."""
        with annotate("sr3d.prep"):
            x = np.asarray(lr_imgs)
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 127.5 - 1.0
            x = torch.from_numpy(np.asarray(x, np.float32)).to(
                self.modules.device)
            if x.shape[1] != self.hr:
                x = resize(x, self.hr, self.hr, "bicubic", antialias=False)
            return x

    def predict(self, lr_imgs: np.ndarray,
                generator: torch.Generator | None = None) -> dict:
        """Serve a request of any size.  ``generator`` (CPU) draws one seed
        per chunk; the default is seed 0, so a request is reproducible.

        Returns numpy ``{"sr_u8" [N, hr, hr, 3] uint8, "verts" [N, V, 3],
        "lmk68" [N, 68, 3], "identity" [N, n_shape]}``."""
        n = len(lr_imgs)
        with annotate("sr3d.request", faces=n,
                      chunks=-(-n // self.batch_size)):
            return self._predict(lr_imgs, generator)

    def _predict(self, lr_imgs: np.ndarray,
                 generator: torch.Generator | None) -> dict:
        if np.size(lr_imgs) == 0:
            nv = self.modules.flame.n_vertices
            ns = int(self.cfg.mica.model.n_shape)
            return {"sr_u8": np.zeros((0, self.hr, self.hr, 3), np.uint8),
                    "verts": np.zeros((0, nv, 3), np.float32),
                    "lmk68": np.zeros((0, 68, 3), np.float32),
                    "identity": np.zeros((0, ns), np.float32)}
        cond = self._prep_cond(lr_imgs)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        outs: list[dict] = []
        for i in range(0, cond.shape[0], self.batch_size):
            chunk = cond[i:i + self.batch_size]
            keep = chunk.shape[0]
            if keep < self.batch_size:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (self.batch_size - keep,) + chunk.shape[1:])])
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            noise = torch.Generator(self.modules.device).manual_seed(seed)
            out = self._step(self.modules, {"SR": chunk}, generator=noise,
                             ema=self.ema)
            outs.append({
                "sr_u8": tensor_to_uint8(out["sr"])[:keep].to(torch.uint8),
                "verts": out["verts"][:keep],
                "lmk68": out["lmk68"][:keep],
                "identity": out["identity"][:keep],
            })
        with annotate("sr3d.fetch"):
            return {k: torch.cat([o[k] for o in outs]).cpu().numpy()
                    for k in outs[0]}

    def export(self, lr_imgs: np.ndarray, out_dir: str,
               names: list[str] | None = None) -> int:
        """Predict and write each face's bundle (mesh.ply/obj,
        kpt7/kpt68/identity npys, the SR png)."""
        res = self.predict(lr_imgs)
        n = res["verts"].shape[0]
        names = names or [f"{i:04d}" for i in range(n)]
        faces = self.modules.flame.faces.cpu().numpy()
        for i in range(n):
            dst = Path(out_dir) / names[i]
            export_prediction(dst, res["verts"][i], faces,
                              res["identity"][i], res["lmk68"][i])
            save_img(res["sr_u8"][i], str(dst / f"{names[i]}_sr.png"))
        return n


def bundle_names(paths: list, input_root: str) -> list[str]:
    """Output-bundle name per input image: the file stem, disambiguated by
    its subdirectory when the recursive scan finds duplicate stems
    (``a/face.png`` + ``b/face.png``), and by the extension when even the
    relative path collides (``a/face.png`` + ``a/face.jpg``) — bundles
    must never overwrite each other."""
    from collections import Counter

    stems = [Path(p).stem for p in paths]
    stem_counts = Counter(stems)
    names = []
    for p, stem in zip(paths, stems):
        if stem_counts[stem] > 1:
            rel = Path(p).relative_to(input_root)
            stem = "_".join(rel.parts[:-1] + (rel.stem,))
        names.append(stem)
    name_counts = Counter(names)
    for i, p in enumerate(paths):
        if name_counts[names[i]] > 1:
            names[i] = f"{names[i]}_{Path(p).suffix.lstrip('.')}"
    return names


def apply_serving_flags(cfg, *, sampler: str | None = None,
                        steps: int | None = None, int8: int | None = None,
                        int8_resample: bool | None = None):
    """The CLI's overrides, in place: ``sampler`` and ``steps`` set
    ``sr.model.diffusion.{sampler,ddim_steps}``; ``int8`` sets
    ``sr.model.unet.quant_min_res`` (0 forces fp).  Unset, a config without
    its own ``quant_min_res`` serves the w8a8 int8 UNet at every ResnetBlock
    conv (``quant_min_res`` 1), and at that depth the Downsample and
    Upsample convs quantize too unless ``int8_resample`` is False — the JAX
    package's serving default."""
    if sampler:
        cfg.sr.model.diffusion.sampler = sampler
    if steps:
        cfg.sr.model.diffusion.ddim_steps = steps
    unet = cfg.sr.model.unet
    if int8 is not None:
        unet.quant_min_res = int8
    elif not int(unet.quant_min_res or 0):
        unet.quant_min_res = 1
    if int8_resample is not None:
        unet.quant_resample = bool(int8_resample)
    elif int(unet.quant_min_res or 0) == 1:
        unet.quant_resample = True
    return cfg


def main(argv=None, *, device: str | torch.device | None = None) -> int:
    """Batch-serving CLI: a directory of LR face images → per-face bundles
    (mesh.ply/obj, kpt7/kpt68/identity npys, SR png).

    ``python -m sr3d_torch.serve -c <cfg.yml> [-ckt best_model.npz]
    --input <lr_dir> --out <dst> [--sampler dpm++] [--steps 25]
    [--batch 8] [--ema] [--int8 MIN_RES] [--[no-]int8-resample]
    [--profile DIR]``

    The flags and defaults of ``python -m sr3d_tpu.serve``, and
    ``--profile DIR`` (``utils.profiling.trace``).  ``device`` is
    for callers in Python (the tests pass ``"cpu"``); the default is the
    GPU."""
    import argparse

    from .config.defaults import get_cfg_defaults, update_cfg
    from .data.lrhr import get_paths_from_images, load_image_m11

    ap = argparse.ArgumentParser(description="sr3d_torch batch serving")
    ap.add_argument("-c", "--cfg", default=None)
    ap.add_argument("-ckt", "--checkpoint", default=None,
                    help="a save_state_npz train state or a converted "
                         "reference UNet .npz; default: the newest "
                         "ckpt_*.npz under {output_dir}/{name}/"
                         "{path.checkpoint}")
    ap.add_argument("--input", required=True, help="directory of LR images")
    ap.add_argument("--out", required=True)
    ap.add_argument("--sampler", default=None,
                    choices=["ddpm", "ddim", "dpm++"],
                    help="ddim (eta=1, marginal init) matches ancestral "
                         "ddpm quality at a fraction of the steps; dpm++ "
                         "is faster at equal steps but measurably worse "
                         "quality on this model family — prefer ddim "
                         "unless latency-bound")
    ap.add_argument("--steps", type=int, default=None,
                    help="strided sampler step count (ddim/dpm++)")
    ap.add_argument("--int8", type=int, default=None, metavar="MIN_RES",
                    help="w8a8 int8 convs at spatial res >= MIN_RES "
                         "(sets sr.model.unet.quant_min_res; 0 forces fp). "
                         "Default 1 (all ResnetBlock convs) unless the "
                         "config sets its own: the same fp checkpoint, "
                         "quantized at every call.  Pass --int8 0 for "
                         "exact-fp sampling.")
    ap.add_argument("--int8-resample", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="also quantize the Downsample/Upsample transition "
                         "convs (sets sr.model.unet.quant_resample; dynamic "
                         "activation scale).  Default on at --int8 1; "
                         "--no-int8-resample keeps them fp")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the serving, "
                         "with the program's spans, to DIR (trace.json, "
                         "spans.json, key_averages.txt)")
    ap.add_argument("--warmup-cache", default=None, metavar="DIR",
                    help="accepted for the JAX package's CLI and ignored: it "
                         "names XLA's persistent compile cache, which has "
                         "no PyTorch counterpart (the CUDA kernels are "
                         "built once into build/kernels)")
    args = ap.parse_args(argv)

    cfg = get_cfg_defaults()
    if args.cfg:
        cfg = update_cfg(cfg, args.cfg)
    apply_serving_flags(cfg, sampler=args.sampler, steps=args.steps,
                        int8=args.int8, int8_resample=args.int8_resample)

    paths = get_paths_from_images(args.input)
    names = bundle_names(paths, args.input)
    imgs = np.stack([load_image_m11(p) for p in paths])
    predictor = Predictor.from_config(cfg, checkpoint=args.checkpoint,
                                      batch_size=int(args.batch),
                                      use_ema=bool(args.ema), device=device)
    t0 = time.perf_counter()
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        n = predictor.export(imgs, args.out, names=names)
    dt = time.perf_counter() - t0
    print(f"served {n} faces -> {args.out} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.2f} faces/s incl. export)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
