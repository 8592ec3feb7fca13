"""Mesh visualization renderer in PyTorch (no pytorch3d).

The port's counterpart of ``sr3d_tpu/eval/renderer.py``, the same scatter
tile rasterizer, run on the vertices' device (the card in training):

* vertices are projected by a pinhole FoV camera on the +z axis;
* every face rasterises a ``tile_grid × tile_grid`` grid of ``tile``-pixel
  blocks anchored at its screen-space bbox min, one grid cell at a time;
* a two-pass z-buffer resolves visibility: the nearest depth per pixel by
  ``scatter_reduce_(…, "amin")``, then the candidates at that depth write
  their shade by ``"amax"``;
* Lambertian + ambient headlight shading on smooth per-vertex normals,
  interpolated barycentrically (Gouraud).

Visualization only: it stays off the train step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BIG = 1e9


def look_at_z(vertices: torch.Tensor, eye_z: float = 3.0) -> torch.Tensor:
    """Camera on the +z axis looking toward −z (the canonical FLAME head
    faces +z).  Returns (x, y, depth) with depth = eye_z − z (> 0 in
    front)."""
    return torch.stack([vertices[:, 0], vertices[:, 1],
                        eye_z - vertices[:, 2]], -1)


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor
                   ) -> torch.Tensor:
    """[V, 3] smooth normals: area-weighted face normals summed per
    vertex."""
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def render_mesh(
    vertices: torch.Tensor,        # [V, 3] canonical space (metres)
    faces: torch.Tensor,           # [F, 3]
    image_size: int = 512,
    tile: int = 8,
    tile_grid: int = 4,
    fov_deg: float = 12.0,
    eye_z: float = 3.0,
    light_dir=(0.0, 0.0, 1.0),
    base_color=(0.8, 0.8, 0.8),
) -> torch.Tensor:
    """Render one mesh → ``[image_size, image_size, 3]`` float32 in [0, 1]
    on ``vertices``' device (white background).  Faces larger than
    ``tile · tile_grid`` pixels are drawn in part; ``render_meshes`` sizes
    the grid with ``required_tile_grid``."""
    dev = vertices.device
    v = vertices.to(torch.float32)
    faces = torch.as_tensor(faces, device=dev).long()
    P = int(image_size)

    cam = look_at_z(v, eye_z)
    focal = 1.0 / torch.tan(torch.deg2rad(
        torch.tensor(fov_deg, dtype=torch.float32)) / 2.0)
    z = cam[:, 2].clamp_min(1e-6)
    sx = (cam[:, 0] * focal / z * 0.5 + 0.5) * (P - 1)
    sy = (-cam[:, 1] * focal / z * 0.5 + 0.5) * (P - 1)
    screen = torch.stack([sx, sy], -1)                      # [V, 2]

    normals = vertex_normals(v, faces)
    ld = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    ld = ld / torch.linalg.norm(ld)
    vert_shade = 0.25 + 0.75 * torch.abs(normals @ ld)      # [V]

    tri = screen[faces]                                     # [F, 3, 2]
    tri_z = z[faces]                                        # [F, 3]
    tri_shade = vert_shade[faces]                           # [F, 3]

    cover = tile * tile_grid
    bb_min = torch.floor(tri.amin(dim=1)).to(torch.int64)
    bb_min = bb_min.clamp(0, max(P - cover, 0))             # [F, 2]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    dy, dx = torch.meshgrid(torch.arange(tile, device=dev),
                            torch.arange(tile, device=dev), indexing="ij")
    v0 = (b - a)[:, None, None]
    v1 = (c - a)[:, None, None]
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    denom = d00 * d11 - d01 * d01   # (2·area)² in pixel⁴
    # (near-)degenerate faces give barycentrics of cancellation noise that
    # pass the inside test across their whole window: cull below a sin²
    # of the edge angle of 1e-5, relative to the products denom comes from
    non_degenerate = denom > 1e-5 * d00 * d11 + 1e-12
    denom = torch.where(non_degenerate, denom, torch.ones_like(denom))

    def cells(ks: torch.Tensor):
        """Grid cells ``ks`` of every face → (flat pixel index, depth or
        BIG outside the face, shade), each ``[len(ks)·F·tile·tile]``."""
        gy = (ks // tile_grid)[:, None, None, None]
        gx = (ks % tile_grid)[:, None, None, None]
        px = bb_min[None, :, 0, None, None] + dx + gx * tile   # [C,F,t,t]
        py = bb_min[None, :, 1, None, None] + dy + gy * tile
        on_canvas = (px < P) & (py < P)
        v2 = torch.stack([px, py], -1).to(torch.float32) + 0.5 \
            - a[:, None, None]
        d20 = (v2 * v0).sum(-1)
        d21 = (v2 * v1).sum(-1)
        w1 = (d11 * d20 - d01 * d21) / denom
        w2 = (d00 * d21 - d01 * d20) / denom
        w0 = 1.0 - w1 - w2
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & on_canvas
                  & non_degenerate)
        depth = (w0 * tri_z[:, 0, None, None] + w1 * tri_z[:, 1, None, None]
                 + w2 * tri_z[:, 2, None, None])
        shade = (w0 * tri_shade[:, 0, None, None]
                 + w1 * tri_shade[:, 1, None, None]
                 + w2 * tri_shade[:, 2, None, None])
        idx = (py.clamp(0, P - 1) * P + px.clamp(0, P - 1)).reshape(-1)
        depth = torch.where(inside, depth, torch.full_like(depth, BIG))
        return idx, depth.reshape(-1), shade.reshape(-1)

    # cells in chunks of ~2²² candidate pixels; min and max do not depend
    # on the order of the scatter
    n_cells = tile_grid * tile_grid
    per = max(1, (1 << 22) // max(1, faces.shape[0] * tile * tile))
    chunks = torch.arange(n_cells, device=dev).split(per)
    zbuf = torch.full((P * P,), BIG, dtype=torch.float32, device=dev)
    for ks in chunks:                        # pass 1: the nearest depth
        idx, depth, _ = cells(ks)
        zbuf.scatter_reduce_(0, idx, depth, "amin")
    sbuf = torch.zeros((P * P,), dtype=torch.float32, device=dev)
    for ks in chunks:                        # pass 2: its shade
        idx, depth, shade = cells(ks)
        win = (depth <= zbuf[idx] + 1e-7) & (depth < BIG)
        sbuf.scatter_reduce_(0, idx, torch.where(
            win, shade, torch.zeros_like(shade)), "amax")

    img = sbuf.reshape(P, P, 1) * torch.tensor(base_color,
                                               dtype=torch.float32,
                                               device=dev)
    hit = (zbuf < BIG).reshape(P, P, 1)
    return torch.where(hit, img, torch.ones_like(img))


def required_tile_grid(vertices, faces, image_size: int = 512,
                       tile: int = 8, fov_deg: float = 12.0,
                       eye_z: float = 3.0) -> int:
    """The smallest ``tile_grid`` that draws every face whole, rounded up
    to a power of two (at least 4): ``render_mesh``'s projection in numpy
    on ``[V, 3]`` or ``[B, V, 3]`` vertices.  Extra grid cells write
    nothing, so a larger grid renders the same pixels."""
    v = np.asarray(torch.as_tensor(vertices).detach().cpu(), np.float32)
    if v.ndim == 2:
        v = v[None]
    f = np.asarray(torch.as_tensor(faces).cpu())
    P = image_size
    focal = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    z = np.clip(eye_z - v[..., 2], 1e-6, None)
    sx = (v[..., 0] * focal / z * 0.5 + 0.5) * (P - 1)
    sy = (-v[..., 1] * focal / z * 0.5 + 0.5) * (P - 1)
    tri = np.stack([sx, sy], -1)[:, f]                    # [B, F, 3, 2]
    lo = np.clip(np.floor(tri.min(axis=2)), 0, P - 1)
    hi = np.clip(tri.max(axis=2), 0, P - 1)
    ext = float((hi - lo).max()) + 1.0
    need = max(1, int(math.ceil(ext / tile)))
    bucket = 4
    while bucket < need:
        bucket *= 2
    return min(bucket, -(-P // tile))


def render_meshes(vertices_b, faces, image_size: int = 512, **kw
                  ) -> torch.Tensor:
    """``[B, V, 3]`` → ``[B, S, S, 3]``, one mesh at a time; ``tile_grid``
    sized by ``required_tile_grid`` unless given."""
    vertices_b = torch.as_tensor(vertices_b)
    if "tile_grid" not in kw:
        kw = dict(kw, tile_grid=required_tile_grid(
            vertices_b, faces, image_size, kw.get("tile", 8),
            kw.get("fov_deg", 12.0), kw.get("eye_z", 3.0)))
    return torch.stack([render_mesh(v, faces, image_size, **kw)
                        for v in vertices_b])


def visualize_grid(images, path: str | None = None, ncol: int = 4
                   ) -> np.ndarray:
    """Tile ``[N, H, W, 3]`` float [0, 1] images into a grid (white
    filler); optionally save it as an image."""
    images = np.asarray(torch.as_tensor(images).detach().cpu()) \
        if isinstance(images, torch.Tensor) else np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.ones((nrow * h, ncol * w, c), images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    if path is not None:
        from PIL import Image

        Image.fromarray((grid.clip(0, 1) * 255).astype(np.uint8)).save(path)
    return grid
