"""Layers shared by the port's networks.

Parameters are fp32; ``Conv2d`` and ``Linear`` cast their input and their
parameters to ``compute_dtype`` at use, which is what flax's ``dtype=`` on
``nn.Conv`` / ``nn.Dense`` does.  Parameter names follow the flax scopes
(``scale``/``bias`` for norms), so the weight bridge is a transpose and not a
renaming table.

The parallel layer (``parallel/``) reaches them in two ways:

* tensor parallel: ``tp`` (set by ``parallel.shard_state_dp_tp``) is the
  model axis whose rank holds only its rows of ``weight`` (output
  channels).  The layer computes those channels (with its bias's rows) and
  gathers the rest, so everything downstream sees the whole activation;
  its input's gradient is summed over the axis and its bias's gradient,
  replicated, too.
* spatial: under a layout that splits the image rows, a 3×3 conv (padding
  1, stride 1 or 2) extends its band by the neighbours' halo rows
  (``parallel.collectives.halo_rows``) and keeps the output rows of its
  band.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import layout
from ..parallel.collectives import all_gather, copy_to, halo_rows


def _spatial_conv(x: torch.Tensor, rows, conv, stride: int
                  ) -> torch.Tensor:
    """A 3×3, padding-1 conv of this rank's band of rows ``x`` (NCHW):
    ``conv(x_ext)`` pads 1 all round, so the band is extended by the halo
    rows and the output rows of the band are kept.  Stride 2 needs an
    even band (its first output row is its first input row's); a zero row
    ahead of the halo puts that row on the stride."""
    n = x.shape[2]
    above, below = halo_rows(x, rows, dim=2)
    if stride == 1:
        return conv(torch.cat([above, x, below], 2)).narrow(2, 1, n)
    if n % 2:
        raise ValueError(f"a stride-2 conv over a band of {n} rows: each "
                         f"level's height must split evenly over the "
                         f"{rows.size} ranks of the {rows.name} axis")
    return conv(torch.cat([torch.zeros_like(above), above, x], 2)) \
        .narrow(2, 1, n // 2)


def _column_parallel(layer: nn.Module, x: torch.Tensor, compute,
                     channel_dim: int) -> torch.Tensor:
    """``compute(x, bias)`` with ``layer``'s bias; under ``layer.tp`` on
    this rank's output channels: the input copied to the model axis (its
    gradient summed over it), the bias cut to the rank's rows, the output
    gathered along ``channel_dim``."""
    axis = layer.tp
    if axis is None:
        return compute(x, layer.bias)
    bias = layer.bias
    if bias is not None:
        n = layer.weight.shape[0]
        bias = copy_to(bias, axis).narrow(0, axis.index * n, n)
    y = compute(copy_to(x, axis), bias)
    return all_gather(y, channel_dim % y.dim(), axis, replicated_grad=True)


class Conv2d(nn.Conv2d):
    tp = None   # the model Axis where this rank holds its output channels

    def __init__(self, c_in: int, c_out: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, kernel, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def run(self, x: torch.Tensor, conv) -> torch.Tensor:
        """``conv(x, bias)`` (a conv of this module's geometry that pads
        ``self.padding``, with ``bias`` the bias of the channels it
        computes, or None) under the active layout and ``tp``."""
        rows = layout.current().rows
        if rows is not None and rows.size > 1 and self.kernel_size[0] > 1:
            if self.kernel_size[0] != 3 or self.padding[0] != 1:
                raise ValueError("spatial sharding takes 1x1 convs and 3x3 "
                                 "convs with padding 1")
            band, stride = conv, self.stride[0]

            def conv(t, bias):
                return _spatial_conv(t, rows, lambda u: band(u, bias),
                                     stride)

        return _column_parallel(self, x, conv, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype

        def conv(t, bias):
            return F.conv2d(t.to(dt), self.weight.to(dt),
                            None if bias is None else bias.to(dt),
                            self.stride, self.padding)

        return self.run(x, conv)


class Linear(nn.Linear):
    tp = None   # as ``Conv2d.tp``

    def __init__(self, d_in: int, d_out: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(d_in, d_out)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return _column_parallel(
            self, x, lambda t, b: F.linear(t.to(dt), self.weight.to(dt),
                                           b.to(dt)), -1)


def init_lecun_normal_(module: nn.Module, generator: torch.Generator,
                       gain: float = 1.0) -> nn.Module:
    """Random weights from a seeded generator: every conv/dense ``weight``
    ~ N(0, gain²/fan_in) (flax's lecun-normal default, untruncated); biases,
    norm and PReLU parameters keep their construction values.  For serving
    without trained weights (``Predictor.from_config(init_seed=...)``)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("weight") and p.dim() >= 2:
                fan_in = p[0].numel()
                p.normal_(0.0, gain / fan_in ** 0.5, generator=generator)
    return module
