"""The reference's arithmetic: every conv and product in fp32 (TF32 off),
or, for the control, each one step below the precision the configuration
states for it.

Each op names the precision the configuration states for it (``"int8"``:
the w8a8 convs that ``quant_min_res`` / ``quant_resample`` select;
``"bf16"``: ``tpu.compute_dtype``'s convs and dense layers; ``"fp32"``: what
the program keeps in fp32).  ``Arith(control=False)`` computes all of them
in fp32; the int8 convs quantize as the configuration states (w8a8,
per-tensor activation step, per-output-channel weight step, round half to
even, clip to ±127) and sum in fp32.  ``Arith(control=True)`` is the
nearest lower precision of each: int4 (w4a4, ±7) for int8, fp8 e4m3 with a
per-tensor scale for bf16, bf16 for fp32.

``tally``, where given, adds 2 FLOPs a multiply-add of each conv and product
under its stated precision: the count ``benchmark/count.py`` reads.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # the largest finite float8_e4m3fn


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32, not TF32, for the duration."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def quantize(x: torch.Tensor, step: torch.Tensor, levels: int
             ) -> torch.Tensor:
    """``clip(round(x / step), −levels, levels)`` as fp32 integers."""
    return torch.round(x / step).clamp(-levels, levels)


class Arith:
    def __init__(self, control: bool = False, tally: dict | None = None):
        self.control = control
        self.levels = 7 if control else 127
        self.tally = tally

    def _count(self, stated: str, flops: float) -> None:
        if self.tally is not None:
            self.tally[stated] = self.tally.get(stated, 0.0) + float(flops)

    def round(self, t: torch.Tensor, stated: str) -> torch.Tensor:
        """``t`` as the op's operands are held: fp32, or the control's
        precision below ``stated``."""
        if not self.control or t.device.type == "meta":
            return t
        if stated == "fp32":
            return t.to(torch.bfloat16).float()
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def conv(self, x, w, b, stride: int = 1, padding: int = 0,
             stated: str = "bf16") -> torch.Tensor:
        B, _, H, W = x.shape
        O, Ci, kh, kw = w.shape
        Ho = (H + 2 * padding - kh) // stride + 1
        Wo = (W + 2 * padding - kw) // stride + 1
        self._count(stated, 2.0 * B * O * Ho * Wo * Ci * kh * kw)
        return F.conv2d(self.round(x, stated), self.round(w, stated), b,
                        stride, padding)

    def linear(self, x, w, b, stated: str = "bf16") -> torch.Tensor:
        self._count(stated, 2.0 * x.shape[0] * w.shape[0] * w.shape[1])
        return F.linear(self.round(x, stated), self.round(w, stated), b)

    def bmm(self, a, b, stated: str = "bf16") -> torch.Tensor:
        self._count(stated, 2.0 * a.shape[0] * a.shape[1] * a.shape[2]
                    * b.shape[2])
        return torch.bmm(self.round(a, stated), self.round(b, stated))

    def einsum_flops(self, stated: str, flops: float) -> None:
        self._count(stated, flops)

    def qconv(self, x, w, b, stride: int = 1, padding: int = 1,
              bound: torch.Tensor | None = None) -> torch.Tensor:
        """The w8a8 conv (w4a4 for the control): the activation step is
        ``bound / levels`` for a static ``bound``, else the tensor's
        ``max|x| / levels``; one weight step per output channel."""
        B, _, H, W = x.shape
        O, Ci, kh, kw = w.shape
        Ho = (H + 2 * padding - kh) // stride + 1
        Wo = (W + 2 * padding - kw) // stride + 1
        self._count("int8", 2.0 * B * O * Ho * Wo * Ci * kh * kw)
        if x.device.type == "meta":
            return F.conv2d(x, w, b, stride, padding)
        L = self.levels
        a = (x.abs().amax().clamp_min(1e-8) if bound is None else bound) / L
        ws = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / L
        y = F.conv2d(quantize(x, a, L), quantize(w, ws[:, None, None, None],
                                                 L), None, stride, padding)
        return y * (a * ws)[None, :, None, None] + b[None, :, None, None]
