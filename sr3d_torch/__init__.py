"""PyTorch / CUDA port of the 3D face super-resolution + reconstruction
framework, for NVIDIA Hopper (H100).

The serving path: ``serve.Predictor`` → ``train.joint.make_val_step`` →
SR3 sampling (``diffusion.gaussian``) over ``models.sr3_unet`` → the uint8
hand-off (``ops.image``) → ArcFace (``models.arcface``) → the mapping
network → FLAME (``models.flame``).  The training path:
``train.joint.make_train_step`` (model2) → the SR3 loss and the in-step
hand-off sampling → ArcFace in train mode → mapping → FLAME → the masked
vertex loss (``models.masking``) → Adam/AdamW and the EMA
(``diffusion.ema``).  The UNet's GroupNorm+Swish and spatial attention run
on hand-written CUDA kernels (``kernels/``), differentiable, built with
``nvcc`` at first use; ``kernels/`` also holds the conv3x3 and fused
GN→Swish→conv3x3 kernels, public functions that no model path calls, and
the w8a8 int8 conv that the int8 serving UNet (``ops/quant.py``) runs.
The JAX package's checkpoints are read without JAX
(``train/checkpoint.py``); ``python -m sr3d_torch.serve`` is the
batch-serving CLI.  ``parallel/`` runs serving and training over a mesh of
``torch.distributed`` ranks: data parallel, spatial (image rows over
ranks) and tensor parallel.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing the package needs neither a GPU nor a CUDA compiler.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
