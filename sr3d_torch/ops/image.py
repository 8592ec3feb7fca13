"""Image ops of the SR → MICA hand-off and of serving's conditioning
(NHWC, the JAX package's layout).

Counterpart of ``sr3d_tpu/ops/image.py``.  ``resize`` reproduces
``jax.image.resize`` rather than ``F.interpolate``: its cubic is the Keys
kernel with a = −0.5 (torch's bicubic uses −0.75, up to 0.17 apart at
16→128 on a [−1, 1] image), taps outside the image are dropped and the
remaining weights renormalised (torch clamps the index instead), and
``antialias=True`` widens the kernel when downsampling.  So each spatial axis
is a dense ``[out, in]`` weight matrix built the way JAX builds it (fp32),
and the resize is two small matmuls.  Off the CPU each matrix is copied to
the device once and kept there (``_on_device``): a copy from host memory
makes the host wait for everything queued on the device, which in serving
is the whole sampling loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

INPUT_MEAN = 127.5
INPUT_STD = 127.5


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def _weight_matrix(in_size: int, out_size: int, method: str,
                   antialias: bool) -> np.ndarray:
    """``[out, in]`` fp32 interpolation weights of one axis, computed as
    ``jax.image.scale_and_translate`` does (translation 0)."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias \
        else np.float32(1.0)
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = kernel(x)                                          # [in, out]
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0))
    return np.ascontiguousarray(w.T.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _on_device(in_size: int, out_size: int, method: str, antialias: bool,
               device: torch.device) -> torch.Tensor:
    """``_weight_matrix`` on ``device``, copied there once: the same fp32
    values, so a resize through it is bit-equal."""
    return torch.from_numpy(_weight_matrix(in_size, out_size, method,
                                           antialias)).to(device)


def _weights(in_size: int, out_size: int, method: str, antialias: bool,
             device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return torch.from_numpy(_weight_matrix(in_size, out_size, method,
                                               antialias))
    return _on_device(in_size, out_size, method, antialias, device)


def resize(x: torch.Tensor, height: int, width: int,
           method: str = "bilinear", antialias: bool = False
           ) -> torch.Tensor:
    """Resize NHWC (or HWC) float images, fp32; method ``bilinear`` |
    ``bicubic``."""
    if x.dim() == 3:
        return resize(x[None], height, width, method, antialias)[0]
    B, H, W, C = x.shape
    if method not in _KERNELS:
        raise KeyError(method)
    x = x.float()
    if H != height:
        wh = _weights(H, height, method, antialias, x.device)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
    if W != width:
        ww = _weights(W, width, method, antialias, x.device)
        x = torch.einsum("pw,bowc->bopc", ww, x)
    return x


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to [lo, hi] as ``jnp.clip`` computes it,
    ``min(max(x, lo), hi)``: equal values, and a value on a bound passes
    half its gradient (``clamp`` passes all of it).  The differentiable
    hand-off clips twice in a row (x̂₀, then ``tensor_to_unit``)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def tensor_to_unit(x: torch.Tensor, min_max=(-1.0, 1.0)) -> torch.Tensor:
    """Clip to ``min_max`` and rescale to [0, 1]."""
    lo, hi = min_max
    return (clip(x, lo, hi) - lo) / (hi - lo)


def tensor_to_uint8(x: torch.Tensor, min_max=(-1.0, 1.0)) -> torch.Tensor:
    """[−1, 1] float → float tensor holding exact uint8 values (0..255),
    ``(img·255).round()`` with round-half-to-even as the JAX package."""
    return torch.round(tensor_to_unit(x, min_max) * 255.0)


def bgr_swap(x: torch.Tensor) -> torch.Tensor:
    """RGB ↔ BGR on the last axis."""
    return x.flip(-1)


def arcface_blob_from_uint8(img_uint8: torch.Tensor, size: int = 112
                            ) -> torch.Tensor:
    """``cv2.dnn.blobFromImages`` equivalent: resize(size) →
    (x − 127.5)/127.5 → BGR.  NHWC float holding uint8 values."""
    x = resize(img_uint8, size, size, "bilinear", antialias=False)
    return bgr_swap((x - INPUT_MEAN) / INPUT_STD)


def arcface_blob_differentiable(img_255: torch.Tensor, size: int = 112
                                ) -> torch.Tensor:
    """The model3 blob, continuous: (x − 127.5)/127.5 → bilinear
    resize(size) → BGR.  NHWC float in [0, 255]."""
    x = (img_255 - INPUT_MEAN) / INPUT_STD
    return bgr_swap(resize(x, size, size, "bilinear", antialias=False))


def sr_to_mica_inputs(sr: torch.Tensor, *, image_size: int = 224,
                      blob_size: int = 112, quantize: bool = True,
                      differentiable: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hand-off: SR in [−1, 1] NHWC → (images ``[B, 224, 224, 3]`` in
    [0, 1], ArcFace blobs ``[B, 112, 112, 3]`` in [−1, 1] BGR).

    ``differentiable`` (model3): ``tensor_to_unit`` → bilinear 224 → ×255
    → :func:`arcface_blob_differentiable`, no rounding, gradients flow.
    Otherwise the image is detached and goes through the uint8 round trip
    (``quantize``, model2 and serving) or, without ``quantize``, the same
    resizes unrounded."""
    if differentiable:
        img224 = resize(tensor_to_unit(sr), image_size, image_size,
                        "bilinear")
        return img224, arcface_blob_differentiable(img224 * 255.0, blob_size)
    u8 = (tensor_to_uint8(sr) if quantize
          else tensor_to_unit(sr) * 255.0).detach()
    img224_u8 = resize(u8, image_size, image_size, "bilinear")
    if quantize:
        img224_u8 = torch.round(img224_u8)
    blob = arcface_blob_from_uint8(img224_u8, blob_size)
    return img224_u8 / 255.0, blob


def degrade_pair(hr: torch.Tensor, l_res: int, r_res: int,
                 antialias: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """LR / SR-conditioning pair from an HR batch: bicubic downscale to
    ``l_res``, then bicubic upsample back to ``r_res``."""
    lr = resize(hr, l_res, l_res, "bicubic", antialias=antialias)
    return lr, resize(lr, r_res, r_res, "bicubic", antialias=False)
