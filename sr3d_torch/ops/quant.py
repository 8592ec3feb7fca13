"""Post-training w8a8 int8 convolution for serving.

Counterpart of ``sr3d_tpu/ops/quant.py``: ``int8_conv`` (the wrapper of
``kernels/int8_conv.py``: the plain version on the CPU, the hand-written
CUDA kernels on the GPU) and ``Int8Conv``, a ``Conv2d`` with the same
parameters (``weight`` OIHW and ``bias``, fp32) whose forward runs the int8
conv when asked to at call time.  A checkpoint of the fp UNet loads into it
unchanged, and one module serves fp training and int8 sampling.

The JAX package derives the int8 weights and their steps from the fp32
weights at every apply, inside one jitted program.  Eager PyTorch would
pay that as ~9 torch ops before every conv, so ``Int8Conv`` keeps them per
weight *version* (``Versioned``): the same bits, recomputed whenever the
weight tensor is another one (``functional_call``, ``.to()``) or was
changed in place (an optimizer step, the EMA update, ``load_state_dict``).
``ConvBlock`` keeps its static activation step, ``gn_static_scale(γ, β)``,
the same way.

Inference only: rounding has no gradient, so a train step never asks for it
(model3's differentiable hand-off included).

The activation scale of the JAX package's dynamic quantize is over the whole
tensor, the global batch included.  Where the parallel layer splits the
tensor over ranks (the data-parallel and spatial Predictor), ``Int8Conv``
maximises each rank's scale over the ranks before the kernel runs.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.int8_conv import (dynamic_scale, int8_conv,
                                 int8_conv_quantized, prepare_weight)
from ..models.layers import Conv2d
from ..parallel import layout

__all__ = ["Int8Conv", "Versioned", "gn_static_scale", "int8_conv"]


def gn_static_scale(gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The static activation step of a conv fed by GroupNorm → swish with
    affine (γ, β): ``max(6·max|γ| + max|β|, 1e-3) / 127``.  GN's output is
    zero-mean unit-variance per group, so ±6σ is covered and outliers clip
    (``sr3d_tpu/models/sr3_unet.py::ConvBlock``).  fp32, 0-d, on γ's
    device: no host round trip."""
    bound = (6.0 * gamma.abs().amax() + beta.abs().amax()).clamp_min(1e-3)
    return bound / 127.0


class Versioned:
    """A value derived from some tensors, recomputed only when one of them
    changes: another tensor object, another storage, or an in-place write
    (``_version``; a write through ``.data`` bypasses it and is not seen).
    It holds a view of each source, so a source's storage cannot be freed
    and another tensor allocated at its address while the value stands.
    A plain attribute, never a buffer: it stays out of ``state_dict``."""

    def __init__(self, make: Callable[..., object]):
        self.make = make
        self.computes = 0       # how many times ``make`` ran
        self._key: list | None = None
        self._value = None

    @staticmethod
    def key(tensors) -> list:
        """What ``same`` compares: each tensor, a view that keeps its
        storage allocated, and its version."""
        return [(t, t.detach(), t._version) for t in tensors]

    @staticmethod
    def same(key: list | None, tensors) -> bool:
        """Whether ``tensors`` are the objects ``key`` was made from, on
        the same storage and unwritten since."""
        return (key is not None and len(key) == len(tensors)
                and all(src is t and view.data_ptr() == t.data_ptr()
                        and ver == t._version
                        for (src, view, ver), t in zip(key, tensors)))

    def __call__(self, *tensors: torch.Tensor):
        if any(t.is_inference() for t in tensors):
            # inference tensors keep no version: nothing to key on
            self.computes += 1
            with torch.no_grad():
                return self.make(*tensors)
        if not self.same(self._key, tensors):
            with torch.no_grad():
                self._value = self.make(*tensors)
            self._key = self.key(tensors)
            self.computes += 1
        return self._value


class Int8Conv(Conv2d):
    """``Conv2d`` whose forward, with ``quant=True``, is the w8a8 int8 conv
    (a static ``a_scale``, or the dynamic per-tensor one), returning
    ``compute_dtype``; with ``quant=False`` it is ``Conv2d``'s.  The packed
    int8 weights and their steps are made once per weight version;
    ``Int8Conv.weight_quantizes`` counts how often any instance made
    them."""

    weight_quantizes = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._quantized = Versioned(self._quantize)

    @staticmethod
    def _quantize(weight: torch.Tensor):
        Int8Conv.weight_quantizes += 1
        return prepare_weight(weight)

    def forward(self, x: torch.Tensor, quant: bool = False,
                a_scale: torch.Tensor | None = None) -> torch.Tensor:
        """Under a layout that splits ``x`` over ranks (``parallel``), the
        dynamic scale is the whole tensor's: this rank's, maximised over
        the ranks that hold the rest."""
        if not quant:
            return super().forward(x)
        wk, w_scale = self._quantized(self.weight)
        if a_scale is None and layout.current().axes():
            a_scale = layout.amax(dynamic_scale(x))

        def conv(t, bias):
            return int8_conv_quantized(
                t.contiguous(), wk, w_scale, bias, stride=self.stride[0],
                padding=self.padding[0], out_dtype=self.compute_dtype,
                a_scale=a_scale)

        return self.run(x, conv)
