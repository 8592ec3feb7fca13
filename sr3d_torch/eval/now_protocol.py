"""One-command NoW protocol runner.

The port's copy of ``sr3d_tpu/eval/now_protocol.py``: predict → 7-landmark
rigid align → masked point-to-surface → pooled median/mean/std and the
cumulative curve, written as ``now_report.json`` + ``now_report.txt`` next
to the official-layout ``predicted_meshes/`` tree::

    python -m sr3d_torch.eval.now_protocol --pictures <NoW pictures tree> \\
        --scans <GT dir: {subject}/{scan.npy,lmk7.npy[,mask.npy]} in mm> \\
        --out <dir> -c <cfg.yml> -ckt best_model.npz

The prediction (ArcFace → mapping → FLAME) runs on the GPU, or on the CPU
with ``--cpu`` (``main(argv, device="cpu")`` from Python); the scoring is
``eval/tester.py``'s, numpy on the host.

Without ``--pictures`` it runs the synthetic dry run: a sphere-FLAME
fixture (pictures rendered from per-subject shapes, GT scans that are the
same meshes in mm with a face-region boolean mask) is generated under
``--out`` and scored end to end, every stage of the real protocol without
the licensed assets.  Without ``-ckt`` the MICA weights are the random
ones ``train.joint.build_joint`` draws from ``cfg.seed`` (the JAX package
draws its own from a ``PRNGKey``: other numbers, the same protocol).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def generate_now_fixture(root: Path, flame, n_subjects: int = 3,
                         imgs_per_subject: int = 2, img_res: int = 224,
                         seed: int = 0, shape_std: float = 1.0,
                         noise_mm: float = 0.5) -> tuple[Path, Path]:
    """Synthetic NoW-style assets: ``{root}/pictures/{subject}/
    {challenge}/{img}.jpg`` + ``{root}/scans/{subject}/{scan.npy, lmk7.npy,
    mask.npy}`` (mm), rendered and decoded on ``flame``'s device.  Scans
    are the subjects' own FLAME meshes (+ small mm-scale noise, standing in
    for scanner error), so a correct pipeline scores a few mm and a broken
    alignment or masking stage scores wildly off.  The same files as the
    JAX package's for a seed."""
    from PIL import Image

    from ..data.synthetic import render_flame_views
    from ..models.flame import compute_landmarks, flame_forward
    from .export import landmarks_7

    rng = np.random.RandomState(seed)
    root = Path(root)
    pictures = root / "pictures"
    scans = root / "scans"
    dev = flame.v_template.device
    challenges = ("neutral", "multiview")[:max(1, imgs_per_subject)]
    for s in range(n_subjects):
        subject = f"subject{s:03d}"
        betas = rng.randn(1, flame.n_shape).astype(np.float32) * shape_std
        n = imgs_per_subject
        yaws = np.deg2rad(rng.uniform(-20, 20, n)).astype(np.float32)
        pitches = np.deg2rad(rng.uniform(-8, 8, n)).astype(np.float32)
        lights = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
        imgs = render_flame_views(flame, np.repeat(betas, n, 0), yaws,
                                  pitches, lights, image_size=img_res)
        for i in range(n):
            ch = challenges[min(i, len(challenges) - 1)]
            d = pictures / subject / ch
            d.mkdir(parents=True, exist_ok=True)
            u8 = ((imgs[i] + 1) / 2 * 255).round().astype(np.uint8)
            Image.fromarray(u8).save(d / f"{subject}_{i:02d}.jpg")

        with torch.no_grad():
            verts_t = flame_forward(flame,
                                    torch.from_numpy(betas).to(dev))[0]
            lmk68 = compute_landmarks(flame, verts_t)[0].cpu().numpy()
        verts = verts_t[0].cpu().numpy()
        scan_mm = verts * 1000.0 + rng.randn(*verts.shape) * noise_mm
        lmk7_mm = landmarks_7(lmk68) * 1000.0
        # face-region mask: the 70% of scan points nearest the landmark
        # centroid (exercises the official masked-scan path; a fixed mm
        # radius would depend on the synthetic head's scale)
        d = np.linalg.norm(scan_mm - lmk7_mm.mean(0), axis=-1)
        mask = d <= np.quantile(d, 0.7)
        gd = scans / subject
        gd.mkdir(parents=True, exist_ok=True)
        np.save(gd / "scan.npy", scan_mm.astype(np.float32))
        np.save(gd / "lmk7.npy", lmk7_mm.astype(np.float32))
        np.save(gd / "mask.npy", mask)
        np.save(gd / "betas.npy", betas[0])  # generator params (oracle/debug)
    return pictures, scans


def _build_state(cfg, checkpoint: str | None, modules):
    """Load the MICA weights the prediction uses into ``modules``: a joint
    ``save_state_npz`` checkpoint when given (the JAX package's or the
    port's Trainer's), else the random weights ``build_joint`` drew (the
    dry-run case).  Returns the ``state`` argument of the predict function,
    None: the port keeps the weights in the modules."""
    if checkpoint:
        from ..train.checkpoint import load_state_npz
        from ..utils.bridge import load_jax_params

        got = load_state_npz(checkpoint, modules, cfg)
        load_jax_params(modules, dict(got["params"],
                                      arcface_stats=got["arcface_stats"]))
    return None


def main(argv=None, *, device: str | torch.device | None = None) -> int:
    """The CLI; ``device`` is for callers in Python (None: the GPU, or the
    CPU with ``--cpu``)."""
    ap = argparse.ArgumentParser(
        description="sr3d_torch NoW protocol: predict + masked "
                    "point-to-surface evaluation in one command")
    ap.add_argument("-c", "--cfg", default=None)
    ap.add_argument("-ckt", "--checkpoint", default=None,
                    help="joint .npz checkpoint (best_model / "
                         "save_state_npz format); omitted = random init "
                         "(dry-run only)")
    ap.add_argument("--pictures", default=None,
                    help="NoW pictures tree {subject}/{challenge}/*.jpg; "
                         "omitted = generate + score the synthetic "
                         "dry-run fixture")
    ap.add_argument("--scans", default=None,
                    help="GT dir {subject}/{scan.npy,lmk7.npy[,mask.npy]} "
                         "in mm")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--subjects", type=int, default=3,
                    help="dry-run fixture size")
    ap.add_argument("--imgs", type=int, default=2)
    ap.add_argument("--crop-radius-mm", type=float, default=None,
                    help="fallback face-crop radius when a scan has no "
                         "mask.npy (see eval/tester.py::mask_scan_points)")
    ap.add_argument("--cpu", action="store_true",
                    help="predict on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    if args.cpu:
        device = "cpu"

    from ..config.defaults import get_cfg_defaults, update_cfg
    from ..train.joint import build_joint
    from ..train.mica_only import make_mica_predict
    from .tester import Tester

    cfg = get_cfg_defaults()
    if args.cfg:
        cfg = update_cfg(cfg, args.cfg)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    synthetic = args.pictures is None
    if synthetic:
        # the dry run renders from / decodes with the same sphere FLAME
        cfg.mica.model.synthetic_flame_kind = "sphere"
    modules = build_joint(cfg, device=device, init_seed=int(cfg.seed))

    if synthetic:
        pictures, scans = generate_now_fixture(
            out / "fixture", modules.flame, n_subjects=args.subjects,
            imgs_per_subject=args.imgs)
        print(f"[fixture] synthetic NoW assets -> {out / 'fixture'}",
              flush=True)
    else:
        pictures, scans = Path(args.pictures), Path(args.scans or "")
        if not args.scans:
            print("note: no --scans given — exporting the submission "
                  "tree only (official-layout predicted_meshes/), "
                  "skipping evaluation", flush=True)

    state = _build_state(cfg, args.checkpoint, modules)
    tester = Tester(modules, make_mica_predict(),
                    cache_path=str(out / "blob_cache"))
    t0 = time.time()
    n = tester.run(state, pictures, out, batch=args.batch)
    print(f"[predict] {n} images -> {out / 'predicted_meshes'} "
          f"({time.time() - t0:.1f}s)", flush=True)

    if not args.scans and not synthetic:
        return 0

    report = Tester.evaluate_now(out, scans,
                                 face_crop_radius_mm=args.crop_radius_mm)
    (out / "now_report.json").write_text(json.dumps(report, indent=1))
    lines = [f"NoW evaluation ({report['n']} images, pooled masked "
             f"point-to-surface, mm)",
             f"median: {report['median']:.4f}",
             f"mean:   {report['mean']:.4f}",
             f"std:    {report['std']:.4f}"]
    (out / "now_report.txt").write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
