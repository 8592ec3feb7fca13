"""Procedural synthetic faces and dataset roots, for tests, ``chip_smoke.py``
and asset-free runs while no face data is in the repository.

The port's copy of ``sr3d_tpu/data/synthetic.py`` (numpy and PIL; the same
files for a seed): smooth face-like images drawn as arrays
(``synthetic_face_batch``), SR-only roots in the ``lr_{l}/ hr_{r}/
sr_{l}_{r}/`` layout (``generate_synthetic_faces``), and joint roots in the
reference's actor-keyed ``image_paths/<NAME>.npy`` layout
(``generate_synthetic_joint_root``; the identity-correlated variants render
each actor's FLAME shape with ``eval.renderer``), so the loaders run the
same code as on real data.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def synthetic_face_batch(n: int, size: int, seed: int = 0) -> np.ndarray:
    """[n, size, size, 3] float32 in [-1, 1]: smooth blob-and-gradient images
    with face-ish structure (ellipse + two eyes + mouth), deterministic."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        cx, cy = 0.5 + rng.uniform(-0.08, 0.08, 2)
        a, b = 0.32 + rng.uniform(-0.05, 0.05), 0.42 + rng.uniform(-0.05, 0.05)
        skin = rng.uniform(0.3, 0.9, 3)
        bg = rng.uniform(-0.9, -0.2, 3)
        face = np.exp(-(((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2) ** 2)
        img = bg[None, None] + (skin - bg)[None, None] * face[..., None]
        for ex in (cx - 0.13, cx + 0.13):
            eye = np.exp(-(((xx - ex) / 0.05) ** 2
                           + ((yy - (cy - 0.1)) / 0.035) ** 2))
            img -= 0.9 * eye[..., None]
        mouth = np.exp(-(((xx - cx) / 0.12) ** 2
                         + ((yy - (cy + 0.18)) / 0.03) ** 2))
        img -= 0.5 * mouth[..., None] * np.array([0.2, 0.7, 0.7])
        out[i] = np.clip(img, -1, 1)
    return out


def _to_png(path: Path, img_m11: np.ndarray) -> None:
    from PIL import Image

    u8 = ((np.clip(img_m11, -1, 1) + 1) / 2 * 255).round().astype(np.uint8)
    Image.fromarray(u8).save(path)


def _resize_pil(img_u8: np.ndarray, size: int):
    from PIL import Image

    return np.asarray(
        Image.fromarray(img_u8).resize((size, size), Image.BICUBIC))


def generate_synthetic_faces(
    root: str | os.PathLike,
    n: int,
    l_res: int,
    r_res: int,
    seed: int = 0,
) -> Path:
    """Materialise an SR-only dataset root: ``{root}/lr_{l}, hr_{r},
    sr_{l}_{r}`` PNG dirs (layout of datasets/tool/prepare_data.py:80-103)."""
    from PIL import Image

    root = Path(root)
    lr_d = root / f"lr_{l_res}"
    hr_d = root / f"hr_{r_res}"
    sr_d = root / f"sr_{l_res}_{r_res}"
    for d in (lr_d, hr_d, sr_d):
        d.mkdir(parents=True, exist_ok=True)

    hrs = synthetic_face_batch(n, r_res, seed)
    for i in range(n):
        name = f"{i:05d}.png"
        hr_u8 = ((hrs[i] + 1) / 2 * 255).round().astype(np.uint8)
        lr_u8 = _resize_pil(hr_u8, l_res)
        sr_u8 = _resize_pil(lr_u8, r_res)  # bicubic re-upsample conditioning
        Image.fromarray(hr_u8).save(hr_d / name)
        Image.fromarray(lr_u8).save(lr_d / name)
        Image.fromarray(sr_u8).save(sr_d / name)
    return root


def _write_actor_images(root: Path, name: str, actor: str,
                        imgs_m11: np.ndarray, lr_res: int,
                        hr_res: int) -> list[str]:
    """Write one actor's files in the reference layout — 224 crops + 112
    arcface blobs (datasets/base.py:115-180) + per-image SR triplet dirs —
    from [K, res, res, 3] float images in [-1, 1].  Returns rel paths."""
    from PIL import Image

    adir = root / name / "arcface_input" / actor
    srdir = root / name / "SR" / f"{lr_res}_{hr_res}" / actor
    for d in (adir, srdir):
        d.mkdir(parents=True, exist_ok=True)
    rel_imgs = []
    for i in range(imgs_m11.shape[0]):
        stem = f"{i:03d}"
        u8 = ((imgs_m11[i] + 1) / 2 * 255).round().astype(np.uint8)
        Image.fromarray(u8).save(adir / f"{stem}.jpg")
        blob = _resize_pil(u8, 112).astype(np.float32)
        blob = (blob[..., ::-1] - 127.5) / 127.5  # BGR, [-1,1], HWC
        np.save(adir / f"{stem}.npy", blob.transpose(2, 0, 1))  # CHW parity
        hr_u8 = _resize_pil(u8, hr_res)
        lr_u8 = _resize_pil(hr_u8, lr_res)
        sr_u8 = _resize_pil(lr_u8, hr_res)
        Image.fromarray(hr_u8).save(srdir / f"{stem}_hr.png")
        Image.fromarray(lr_u8).save(srdir / f"{stem}_lr.png")
        Image.fromarray(sr_u8).save(srdir / f"{stem}_sr.png")
        rel_imgs.append(f"{name}/arcface_input/{actor}/{stem}.jpg")
    return rel_imgs


def _rot_yx(yaw: float, pitch: float) -> np.ndarray:
    """World rotation: yaw about +y then pitch about +x (radians)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return rx @ ry


def render_flame_views(flame, betas: np.ndarray, yaws: np.ndarray,
                       pitches: np.ndarray, lights: np.ndarray,
                       image_size: int = 224,
                       chunk: int = 32) -> np.ndarray:
    """Render ``flame_forward(betas)`` under per-image rotations and lights
    → ``[N, S, S, 3]`` float32 in [−1, 1], on ``flame``'s device.
    ``betas`` ``[N, n_shape(+n_exp)]``; ``chunk`` meshes a decode."""
    import torch

    from ..eval.renderer import render_mesh, required_tile_grid
    from ..models.flame import flame_forward

    nb = np.asarray(betas, np.float32)
    if nb.shape[1] < flame.n_shape + flame.n_exp:
        nb = np.concatenate(
            [nb, np.zeros((nb.shape[0],
                           flame.n_shape + flame.n_exp - nb.shape[1]),
                          np.float32)], 1)
    dev = flame.v_template.device
    with torch.no_grad():
        verts = np.concatenate([flame_forward(
            flame, torch.from_numpy(nb[i:i + chunk, :flame.n_shape]).to(dev),
            torch.from_numpy(nb[i:i + chunk, flame.n_shape:]).to(dev)
        )[0].cpu().numpy() for i in range(0, nb.shape[0], chunk)])
    rots = np.stack([_rot_yx(y, p) for y, p in zip(yaws, pitches)])
    vrot = np.einsum("nij,nvj->nvi", rots, verts).astype(np.float32)

    tg = required_tile_grid(vrot, flame.faces, image_size)
    out = [render_mesh(torch.from_numpy(v).to(dev), flame.faces, image_size,
                       tile_grid=tg, light_dir=tuple(float(c) for c in l)
                       ).cpu().numpy()
           for v, l in zip(vrot, np.asarray(lights, np.float32))]
    return np.stack(out).astype(np.float32) * 2.0 - 1.0


def _identity_texture_basis(n_freq: int, res: int,
                            seed: int = 12345) -> np.ndarray:
    """[K, res, res] bank of fixed high-frequency plane waves (16–36
    cycles/image at the 224 render: destroyed by 16 px downsampling —
    Nyquist 8 c/img — but preserved through the 128 HR and the 112
    arcface blob).  Deterministic and shared across actors/datasets."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    fs = rng.uniform(16.0, 36.0, n_freq).astype(np.float32)
    th = rng.uniform(0.0, np.pi, n_freq).astype(np.float32)
    ph = rng.uniform(0.0, 2 * np.pi, n_freq).astype(np.float32)
    return np.stack([
        np.cos(2 * np.pi * f * (np.cos(t) * xx + np.sin(t) * yy) + p)
        for f, t, p in zip(fs, th, ph)]).astype(np.float32)


def apply_identity_texture(imgs_m11: np.ndarray, betas: np.ndarray,
                           amp: float, n_freq: int = 32) -> np.ndarray:
    """Superimpose an identity-coded HIGH-FREQUENCY texture on rendered
    faces: per-image modulation ``amp · Σ_k tanh(β_k)·B_k`` over the fixed
    wave bank, masked to the rendered head.

    This plants identity information that 16 px downsampling provably
    destroys (the waves alias to ~0 under the antialiased bicubic
    reduction) while the geometry/shading identity cue of the plain
    renders survives any blur.  It exists for the SR→reconstruction
    value-chain study (the reference's core claim,
    reference model/sr3d/model.py:441-533): on plain renders the
    bicubic-conditioning control arm matches the HR oracle — identity is
    low-frequency there — so only texture-coded data can measure what
    image fidelity buys the 3D branch.  With sphere_flame's amp/(1+0.15k)
    component decay, the first 32 β carry ≈ 82% of vertex-L1 variance, so
    a branch that decodes them from texture separates decisively.

    The modulation is HEADROOM-SCALED (``amp·pat·(1−|img|)``) rather than
    clipped: clipping would rectify the zero-mean waves wherever the base
    image saturates, leaking an identity-coded LOW-frequency mean shift
    that survives the 16 px reduction (measured: 7.6/255 mean-abs on the
    bicubic conditioning before this fix, <1/255 after) and would
    contaminate the bicubic control arm.

    ``imgs_m11`` [N,S,S,3] in [-1,1]; ``betas`` [N, n_shape] (the SAME
    vector the MICA branch regresses).  Returns a new array."""
    K = int(min(n_freq, betas.shape[1]))
    B = _identity_texture_basis(K, imgs_m11.shape[1])
    coef = np.tanh(betas[:, :K].astype(np.float32))
    pat = np.tanh(np.einsum("nk,kxy->nxy", coef, B) / np.sqrt(K / 2.0))
    mask = (imgs_m11.mean(-1) > -0.98).astype(np.float32)
    head = 1.0 - np.abs(imgs_m11)
    out = imgs_m11 + amp * (pat * mask)[..., None] * head
    return np.clip(out, -1.0, 1.0)  # no-op for amp <= 1; belt and braces


def generate_correlated_joint_root(
    root: str | os.PathLike,
    flame,
    name: str = "SYNC",
    n_actors: int = 80,
    imgs_per_actor: int = 4,
    img_res: int = 224,
    lr_res: int = 16,
    hr_res: int = 128,
    seed: int = 0,
    shape_std: float = 1.0,
    yaw_deg: float = 25.0,
    pitch_deg: float = 10.0,
    texture_identity: float = 0.0,
) -> Path:
    """Identity-CORRELATED joint dataset: every actor's images are rendered
    *from their FLAME shape* (per-image pose/light jitter), so the joint
    model's identity→shape mapping (reference model/sr3d/model.py:441-533)
    is learnable and val ``l_mica`` on held-out actors can actually
    decrease — unlike :func:`generate_synthetic_joint_root`, whose images
    and shapes are drawn independently (fine for wiring tests, unlearnable
    by construction).  Same on-disk layout; ``flame`` must be the SAME
    model the trainer will decode with (e.g.
    ``sphere_flame(n_shape=cfg.mica.model.n_shape, ...)`` — the
    ``mica.model.synthetic_flame_kind: sphere`` fallback)."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    n_shape, n_exp = flame.n_shape, flame.n_exp

    shapes = rng.randn(n_actors, n_shape).astype(np.float32) * shape_std
    K = imgs_per_actor
    N = n_actors * K
    yaws = np.deg2rad(rng.uniform(-yaw_deg, yaw_deg, N)).astype(np.float32)
    pitches = np.deg2rad(rng.uniform(-pitch_deg, pitch_deg, N)
                         ).astype(np.float32)
    lights = np.stack([rng.uniform(-0.5, 0.5, N),
                       rng.uniform(-0.5, 0.5, N),
                       np.ones(N)], -1).astype(np.float32)
    lights /= np.linalg.norm(lights, axis=1, keepdims=True)

    imgs = render_flame_views(flame, np.repeat(shapes, K, axis=0),
                              yaws, pitches, lights, image_size=img_res)
    if texture_identity > 0:
        imgs = apply_identity_texture(imgs, np.repeat(shapes, K, axis=0),
                                      amp=texture_identity)

    paths_dict = {}
    for a in range(n_actors):
        actor = f"actor{a:03d}"
        rel_imgs = _write_actor_images(root, name, actor,
                                       imgs[a * K:(a + 1) * K],
                                       lr_res, hr_res)
        fdir = root / name / "FLAME_parameters" / actor
        fdir.mkdir(parents=True, exist_ok=True)
        np.savez(fdir / "flame.npz",
                 betas=np.concatenate(
                     [shapes[a], np.zeros(n_exp, np.float32)]))
        paths_dict[actor] = (rel_imgs,
                             f"{name}/FLAME_parameters/{actor}/flame.npz")

    ip = root / "image_paths"
    ip.mkdir(parents=True, exist_ok=True)
    np.save(ip / f"{name}.npy", paths_dict)
    return root


def generate_correlated_faces(
    root: str | os.PathLike,
    flame,
    n: int,
    l_res: int,
    r_res: int,
    seed: int = 0,
    shape_std: float = 1.0,
    texture_identity: float = 0.0,
) -> Path:
    """SR-only val root (``lr_{l}/hr_{r}/sr_{l}_{r}`` layout) whose faces
    are renders of *held-out* FLAME shapes — the on-distribution companion
    of :func:`generate_correlated_joint_root` for the trainer's SR val
    PSNR pass."""
    from PIL import Image

    root = Path(root)
    rng = np.random.RandomState(seed)
    shapes = rng.randn(n, flame.n_shape).astype(np.float32) * shape_std
    yaws = np.deg2rad(rng.uniform(-20, 20, n)).astype(np.float32)
    pitches = np.deg2rad(rng.uniform(-8, 8, n)).astype(np.float32)
    lights = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    imgs = render_flame_views(flame, shapes, yaws, pitches, lights,
                              image_size=max(r_res, 64))
    if texture_identity > 0:
        imgs = apply_identity_texture(imgs, shapes, amp=texture_identity)

    lr_d = root / f"lr_{l_res}"
    hr_d = root / f"hr_{r_res}"
    sr_d = root / f"sr_{l_res}_{r_res}"
    for d in (lr_d, hr_d, sr_d):
        d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        nm = f"{i:05d}.png"
        u8 = ((imgs[i] + 1) / 2 * 255).round().astype(np.uint8)
        hr_u8 = _resize_pil(u8, r_res)
        lr_u8 = _resize_pil(hr_u8, l_res)
        sr_u8 = _resize_pil(lr_u8, r_res)
        Image.fromarray(hr_u8).save(hr_d / nm)
        Image.fromarray(lr_u8).save(lr_d / nm)
        Image.fromarray(sr_u8).save(sr_d / nm)
    return root


def generate_synthetic_joint_root(
    root: str | os.PathLike,
    name: str = "SYNTH",
    n_actors: int = 4,
    imgs_per_actor: int = 6,
    img_res: int = 224,
    lr_res: int = 16,
    hr_res: int = 128,
    n_shape: int = 300,
    n_exp: int = 100,
    seed: int = 0,
) -> Path:
    """Materialise a joint (MICA-style) dataset root with the reference's
    actor-keyed layout (datasets/base.py:80-180):

    - ``{root}/image_paths/{name}.npy``: pickled dict
      {actor: ([rel image paths], rel flame.npz)}
    - per-actor dirs with 224 crops + 112 arcface ``.npy`` blobs
    - ``{root}/{name}/SR/{lr}_{hr}/`` HR/LR/SR triplet dirs per actor image
    - per-actor ``flame.npz`` with shape/exp/pose params.
    """
    root = Path(root)
    rng = np.random.RandomState(seed)
    paths_dict = {}
    for a in range(n_actors):
        actor = f"actor{a:03d}"
        fdir = root / name / "FLAME_parameters" / actor
        fdir.mkdir(parents=True, exist_ok=True)

        imgs = synthetic_face_batch(imgs_per_actor, img_res,
                                    seed=seed * 1000 + a)
        rel_imgs = _write_actor_images(root, name, actor, imgs,
                                       lr_res, hr_res)

        flame = fdir / "flame.npz"
        np.savez(flame,
                 betas=np.concatenate([
                     rng.randn(n_shape).astype(np.float32) * 0.3,
                     rng.randn(n_exp).astype(np.float32) * 0.1]))
        paths_dict[actor] = (rel_imgs,
                             f"{name}/FLAME_parameters/{actor}/flame.npz")

    ip = root / "image_paths"
    ip.mkdir(parents=True, exist_ok=True)
    np.save(ip / f"{name}.npy", paths_dict)  # pickled dict, reference format
    return root
