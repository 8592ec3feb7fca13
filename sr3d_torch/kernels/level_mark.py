"""The UNet's level mark (``csrc/level_mark.cu``): a one-thread kernel that
does nothing, launched on the current stream.

``SR3UNet`` launches one at the start and end of its forward and around
its outer (highest-resolution) levels, into every captured graph of its
forward and, in an eager forward, while spans record, so that a device
trace of a replayed forward (one launch) can be cut into its levels by
the marks' times.  Its kernel's name is
``LEVEL_MARK``.  The mark is not counted among the kernel wrappers'
launches (``kernels.launch_counts()``): it does no work of the model.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, function

LEVEL_MARK = "sr3d_level_mark_kernel"


def level_mark(device: torch.device) -> None:
    """Launch one mark on ``device``'s current stream (a CUDA device)."""
    fn = function("level_mark", "sr3d_level_mark", [ctypes.c_void_p])
    check(fn(torch.cuda.current_stream(device).cuda_stream), "level_mark")
