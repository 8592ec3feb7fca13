"""``Int8Conv``'s weights quantized once per weight version, and
``ConvBlock``'s static activation step kept the same way
(``sr3d_torch.ops.quant.Versioned``), on the CPU: the cached path gives
the uncached path's bits, a repeated forward quantizes no weight, and the
cache follows every kind of weight change a serving or training run
makes: an in-place write, an optimizer step, ``load_state_dict``, ``.to()``
and ``functional_call`` with other tensors (the EMA route of
``make_val_step``)."""

import copy

import pytest
import torch
from torch.func import functional_call

from sr3d_torch.kernels.int8_conv import int8_conv
from sr3d_torch.models.sr3_unet import ConvBlock, SR3UNet
from sr3d_torch.ops.quant import Int8Conv, Versioned, gn_static_scale

torch.set_num_threads(1)


def _conv(stride=1, seed=0):
    torch.manual_seed(seed)
    return Int8Conv(16, 8, 3, stride=stride, padding=1)


def _x(seed=1):
    return torch.randn(2, 16, 9, 10, generator=torch.Generator()
                       .manual_seed(seed))


def _uncached(conv, x, a_scale=None):
    return int8_conv(x, conv.weight, conv.bias, stride=conv.stride[0],
                     padding=1, out_dtype=conv.compute_dtype,
                     a_scale=a_scale)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("a_scale", [None, 0.03])
def test_cached_path_is_bit_equal_and_quantizes_once(stride, a_scale):
    conv, x = _conv(stride), _x()
    n = Int8Conv.weight_quantizes
    first = conv(x, quant=True, a_scale=a_scale)
    second = conv(x, quant=True, a_scale=a_scale)
    assert Int8Conv.weight_quantizes == n + 1
    assert torch.equal(first, _uncached(conv, x, a_scale))
    assert torch.equal(second, first)


def _refreshes(conv, x, change):
    """``change(conv)`` must make the next int8 forward quantize again and
    give the uncached bits of the changed weights."""
    conv(x, quant=True)
    n = Int8Conv.weight_quantizes
    change(conv)
    out = conv(x, quant=True)
    assert Int8Conv.weight_quantizes == n + 1
    assert torch.equal(out, _uncached(conv, x))
    conv(x, quant=True)
    assert Int8Conv.weight_quantizes == n + 1   # and then holds again


def test_cache_refreshes_after_an_in_place_write():
    def change(conv):
        with torch.no_grad():
            conv.weight.add_(0.05)
    _refreshes(_conv(), _x(), change)


def test_cache_refreshes_after_an_optimizer_step():
    x = _x()

    def change(conv):
        opt = torch.optim.SGD(conv.parameters(), lr=0.5)
        conv(x).square().mean().backward()
        opt.step()
    _refreshes(_conv(), x, change)


def test_cache_refreshes_after_load_state_dict():
    other = _conv(seed=5).state_dict()
    _refreshes(_conv(), _x(), lambda conv: conv.load_state_dict(other))


def test_cache_refreshes_after_to():
    """``.to()`` moves the data to new storage; the way back as well."""
    x = _x()
    _refreshes(_conv(), x, lambda conv: conv.to(torch.float64))
    _refreshes(_conv(), x, lambda conv: conv.to(torch.float64)
               .to(torch.float32))


def test_cache_follows_functional_call():
    """``functional_call`` with other tensors (the EMA route of
    ``make_val_step``): their quantize, once while they stand, and the
    module's own weights again afterwards; the EMA's in-place update
    (``torch._foreach_copy_``) refreshes it."""
    conv, x = _conv(), _x()
    own = conv(x, quant=True)
    ema = {k: v.detach().clone() + 0.1 for k, v in conv.named_parameters()}
    n = Int8Conv.weight_quantizes
    got = functional_call(conv, ema, (x,), {"quant": True})
    again = functional_call(conv, ema, (x,), {"quant": True})
    assert Int8Conv.weight_quantizes == n + 1
    want = int8_conv(x, ema["weight"], ema["bias"], out_dtype=torch.float32)
    assert torch.equal(got, want) and torch.equal(again, want)
    torch._foreach_copy_([ema["weight"]], [ema["weight"] * 0.5])
    got = functional_call(conv, ema, (x,), {"quant": True})
    assert Int8Conv.weight_quantizes == n + 2
    assert torch.equal(got, int8_conv(x, ema["weight"], ema["bias"],
                                      out_dtype=torch.float32))
    assert torch.equal(conv(x, quant=True), own)
    assert Int8Conv.weight_quantizes == n + 3


def test_cache_stays_out_of_state_dict():
    conv = _conv()
    conv(_x(), quant=True)
    assert set(conv.state_dict()) == {"weight", "bias"}
    block = ConvBlock(16, 8, 8, torch.float32)
    block(_x(), quant=True)
    assert set(block.state_dict()) == {"norm.scale", "norm.bias",
                                       "conv.weight", "conv.bias"}
    copy.deepcopy(block)(_x(), quant=True)


def test_static_scale_follows_gamma_and_beta():
    """``ConvBlock``'s static step: made once, the uncached value, and
    made again after γ or β change."""
    torch.manual_seed(0)
    block = ConvBlock(16, 8, 8, torch.float32)
    with torch.no_grad():
        block.norm.scale.uniform_(0.5, 1.5)
        block.norm.bias.uniform_(-0.2, 0.2)
    x = _x()
    cache = block._static_scale
    out = block(x, quant=True)
    n = cache.computes
    assert torch.equal(block(x, quant=True), out)
    assert cache.computes == n
    for p in (block.norm.scale, block.norm.bias):
        with torch.no_grad():
            p.mul_(1.5)
        h = block.norm(x)
        want = _uncached(block.conv, h, gn_static_scale(block.norm.scale,
                                                        block.norm.bias))
        assert torch.equal(block(x, quant=True), want)
        assert cache.computes == n + 1
        n = cache.computes


def test_versioned_keys_on_the_tensor_not_its_address():
    """A value is never served for another tensor, nor for a source that
    was freed and whose address was reused: the cache holds a view of its
    sources, so their storage stays allocated while the value stands."""
    made = Versioned(lambda t: t.sum().item())
    t = torch.ones(1000)
    assert made(t) == 1000 and made.computes == 1
    ptr = t.data_ptr()
    del t
    u = torch.full((1000,), 2.0)
    assert u.data_ptr() != ptr
    assert made(u) == 2000 and made.computes == 2
    u.data = torch.full((1000,), 3.0)   # new storage, same object
    assert made(u) == 3000 and made.computes == 3


def test_repeated_int8_unet_forward_quantizes_no_weight():
    """The tiny int8 UNet: the first forward quantizes each gated conv's
    weights once, the second none, with the same bits; an in-place write
    to one conv re-quantizes that conv alone."""
    torch.manual_seed(0)
    unet = SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   quant_min_res=1, quant_resample=True).eval()
    x, t = torch.randn(2, 6, 16, 16), torch.rand(2, 1)
    with torch.no_grad():
        n = Int8Conv.weight_quantizes
        first = unet(x, t, quant=True)
        assert Int8Conv.weight_quantizes == n + 14
        assert torch.equal(unet(x, t, quant=True), first)
        assert Int8Conv.weight_quantizes == n + 14
        conv = next(m for m in unet.modules() if isinstance(m, Int8Conv))
        conv.weight.mul_(1.01)
        unet(x, t, quant=True)
        assert Int8Conv.weight_quantizes == n + 15
