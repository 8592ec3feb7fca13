"""Quality metrics: PSNR and MATLAB-style SSIM.

The port's copy of ``sr3d_tpu/eval/metrics.py``.  The host versions
(numpy, float64) are the JAX package's, bit for bit:

* ``calculate_psnr``: 20·log10(255/√MSE) on [0, 255] arrays;
* ``calculate_ssim`` / ``ssim``: 11×11 Gaussian window σ = 1.5,
  C1 = (0.01·255)², C2 = (0.03·255)², the 'valid' crop [5:−5, 5:−5],
  cv2.filter2D semantics (BORDER_REFLECT_101, per channel), and the
  reference's 3-channel mean over the full-image SSIM map.

``psnr_device`` / ``ssim_device`` are their torch versions (float32, the
same formulas) for tensors on the card.
"""

from __future__ import annotations

import math

import numpy as np

try:  # scipy where installed; otherwise the numpy loop below
    from scipy.ndimage import correlate as _nd_correlate
except Exception:  # pragma: no cover
    _nd_correlate = None

import torch


def gaussian_kernel_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel formula (for ksize computed, not the small-size
    fixed tables): k[i] ∝ exp(-((i-(k-1)/2)²)/(2σ²)), normalised, float64."""
    i = np.arange(ksize, dtype=np.float64)
    center = (ksize - 1) / 2.0
    k = np.exp(-((i - center) ** 2) / (2.0 * sigma * sigma))
    return k / k.sum()


def _filter2d_reflect101(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """cv2.filter2D equivalent: correlation, BORDER_REFLECT_101, per-channel."""
    if img.ndim == 3:
        return np.stack(
            [_filter2d_reflect101(img[..., c], window)
             for c in range(img.shape[-1])], axis=-1)
    if _nd_correlate is not None:
        return _nd_correlate(img, window, mode="mirror")
    pad = window.shape[0] // 2
    padded = np.pad(img, pad, mode="reflect")
    out = np.zeros_like(img)
    kh, kw = window.shape
    for dy in range(kh):
        for dx in range(kw):
            out += window[dy, dx] * padded[dy:dy + img.shape[0],
                                           dx:dx + img.shape[1]]
    return out


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    kernel = gaussian_kernel_1d(11, 1.5)
    window = np.outer(kernel, kernel)

    mu1 = _filter2d_reflect101(img1, window)[5:-5, 5:-5]
    mu2 = _filter2d_reflect101(img2, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_reflect101(img1 ** 2, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = _filter2d_reflect101(img2 ** 2, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = _filter2d_reflect101(img1 * img2, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Reference ``calculate_ssim`` dispatch (core/metrics.py:107-125)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            # reference quirk: averages three identical full-image SSIMs
            return float(np.mean([ssim(img1, img2) for _ in range(3)]))
        if img1.shape[2] == 1:
            return ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


def save_img(img: np.ndarray, img_path: str) -> None:
    """Write a uint8 RGB (HWC) image as PNG (reference core/metrics.py:53-71
    ``save_img``: the RGB→BGR swap there compensates cv2's BGR writer — the
    file on disk is the same RGB image PIL writes directly)."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(img_path)


# --------------------------------------------------------------------------
# device versions (torch, float32)
# --------------------------------------------------------------------------

def psnr_device(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR of [0, 255]-scaled tensors of any shape, as a 0-d tensor."""
    mse = torch.mean((img1.to(torch.float32) - img2.to(torch.float32)) ** 2)
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse.clamp_min(1e-12)))


def ssim_device(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """SSIM of HWC (or HW) [0, 255] images on their device: the host
    formula in float32.  filter2D followed by the [5:−5, 5:−5] crop never
    reads the padded border, so each filter is a 'valid' depthwise
    convolution."""
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    k = gaussian_kernel_1d(11, 1.5).astype(np.float32)
    C = img1.shape[-1]
    w = torch.from_numpy(np.outer(k, k)).to(img1.device)[None, None] \
        .expand(C, 1, 11, 11)

    def filt(x):
        x = x.permute(2, 0, 1)[None]                     # [1, C, H, W]
        return torch.nn.functional.conv2d(x, w, groups=C)[0].permute(1, 2, 0)

    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 ** 2) - mu1_sq
    s2 = filt(img2 ** 2) - mu2_sq
    s12 = filt(img1 * img2) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * s12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))
    return torch.mean(ssim_map)
