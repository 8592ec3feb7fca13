"""Image resampling of the serving path, in plain PyTorch (NHWC, fp32).

The resize of ``jax.image.resize`` that the framework's serving path is
defined by: per axis a dense ``[out, in]`` weight matrix of the Keys cubic
(a = −0.5) or the triangle kernel, sampled at pixel centres
(``(i + 0.5)·in/out − 0.5``), each column renormalised to sum to one, with
the kernel widened by the scale when ``antialias`` and downsampling.
"""

from __future__ import annotations

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def weights(n_in: int, n_out: int, method: str, antialias: bool
            ) -> np.ndarray:
    """``[n_out, n_in]`` float32 interpolation weights of one axis."""
    kernel = {"bicubic": _keys_cubic, "bilinear": _triangle}[method]
    scale = n_out / n_in
    widen = max(1.0 / scale, 1.0) if antialias else 1.0
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    w = kernel((centres[:, None] - np.arange(n_in)[None, :]) / widen)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize(x: torch.Tensor, size: int, method: str,
           antialias: bool = False) -> torch.Tensor:
    """NHWC ``x`` → [B, size, size, C], fp32."""
    B, H, W, C = x.shape
    wh = torch.from_numpy(weights(H, size, method, antialias)).to(x.device)
    ww = torch.from_numpy(weights(W, size, method, antialias)).to(x.device)
    x = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("pw,bowc->bopc", ww, x)


def to_uint8_levels(x: torch.Tensor) -> torch.Tensor:
    """[−1, 1] → the uint8 levels 0..255 as fp32, rounding half to even."""
    return torch.round((x.clamp(-1.0, 1.0) + 1.0) / 2.0 * 255.0)


def handoff(sr_u8: torch.Tensor, image_size: int = 224, blob_size: int = 112
            ) -> torch.Tensor:
    """The serving hand-off from the SR image's uint8 levels (NHWC fp32):
    bilinear to ``image_size``, rounded to uint8 levels, bilinear to
    ``blob_size``, (x − 127.5)/127.5, RGB → BGR: the ArcFace blob."""
    img = torch.round(resize(sr_u8, image_size, "bilinear"))
    blob = (resize(img, blob_size, "bilinear") - 127.5) / 127.5
    return blob.flip(-1)
