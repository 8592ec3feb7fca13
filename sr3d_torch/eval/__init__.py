"""Evaluation: image metrics, mesh export, the renderer, the validator,
the NoW / Stirling tester and the one-command NoW runner."""

from .export import (export_prediction, landmarks_7, read_obj, read_ply,
                     save_img, write_obj, write_ply)
from .metrics import (calculate_psnr, calculate_ssim, psnr_device, ssim,
                      ssim_device)

__all__ = [
    "calculate_psnr", "calculate_ssim", "psnr_device", "ssim", "ssim_device",
    "export_prediction", "landmarks_7", "read_obj", "read_ply", "save_img",
    "write_obj", "write_ply",
]
