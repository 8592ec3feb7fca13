"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their wrappers.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, and counts its launches in ``.launches``.
"""

from .attention import spatial_attention
from .conv3x3 import conv3x3
from .fused_block import fused_gn_swish_conv3x3
from .groupnorm_swish import gn_stats, gn_swish
from .int8_conv import int8_conv

WRAPPERS = {"gn_stats": gn_stats, "gn_swish": gn_swish,
            "spatial_attention": spatial_attention, "conv3x3": conv3x3,
            "fused_gn_swish_conv3x3": fused_gn_swish_conv3x3,
            "int8_conv": int8_conv}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
