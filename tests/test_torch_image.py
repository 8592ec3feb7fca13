"""The port's image ops held against the JAX package (``jax.image.resize``
and ``sr3d_tpu.ops.image``) on the same numpy inputs, on the CPU; and the
resize's matrices and FLAME's joint-tree indices kept on the device, with
the meta device standing in for the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.models import lbs
from sr3d_torch.ops import image as ti
from sr3d_tpu.ops import image as ji

torch.set_num_threads(1)

# Both sides build the same fp32 weights; the sums run in another order
# (two matmuls here, one XLA einsum there), ~1e-7 relative on O(1) values.
ATOL = 1e-5


@pytest.mark.parametrize("src,dst,method,antialias", [
    (16, 128, "bicubic", False),   # serving's conditioning upsample
    (128, 224, "bilinear", False),  # SR → the 224² image
    (224, 112, "bilinear", False),  # 224² → the ArcFace blob
    (128, 16, "bicubic", True),     # degrade_pair's antialiased downscale
    (8, 16, "bicubic", False),
])
def test_resize_matches_jax(src, dst, method, antialias):
    x = np.random.RandomState(0).uniform(-1, 1, (2, src, src, 3)) \
        .astype(np.float32)
    ref = np.asarray(ji.resize(jnp.asarray(x), dst, dst, method, antialias))
    out = ti.resize(torch.from_numpy(x), dst, dst, method, antialias).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_bicubic_is_not_torch_interpolate():
    """The hazard the port's own cubic exists for: torch's bicubic (a =
    −0.75, clamped taps) is visibly off JAX's at 16→128."""
    x = np.random.RandomState(1).uniform(-1, 1, (1, 16, 16, 3)) \
        .astype(np.float32)
    ref = np.asarray(ji.resize(jnp.asarray(x), 128, 128, "bicubic"))
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(128, 128),
        mode="bicubic", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(torch_bicubic - ref).max() > 0.05
    out = ti.resize(torch.from_numpy(x), 128, 128, "bicubic").numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_sr_to_mica_inputs_matches_jax():
    """The quantised hand-off: uint8 round trip, 224² bilinear, round,
    112² blob, BGR.  Values land on the uint8 grid, so a rounding tie
    decided differently moves a pixel by exactly one level; no more than
    that on a handful of pixels is accepted."""
    sr = np.random.RandomState(2).uniform(-1.1, 1.1, (2, 32, 32, 3)) \
        .astype(np.float32)
    img_ref, blob_ref = ji.sr_to_mica_inputs(jnp.asarray(sr))
    img, blob = ti.sr_to_mica_inputs(torch.from_numpy(sr))
    img_ref, blob_ref = np.asarray(img_ref), np.asarray(blob_ref)
    assert img.shape == (2, 224, 224, 3) and blob.shape == (2, 112, 112, 3)
    d = np.abs(img.numpy() - img_ref) * 255.0
    assert d.max() <= 1.0 + 1e-4 and np.mean(d > 0.5) < 1e-3
    np.testing.assert_allclose(blob.numpy(), blob_ref, atol=2.0 / 127.5)
    assert np.mean(np.abs(blob.numpy() - blob_ref) > 1e-4) < 1e-3


def test_uint8_and_degrade_pair_match_jax():
    x = np.random.RandomState(3).uniform(-1.2, 1.2, (2, 64, 64, 3)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        ti.tensor_to_uint8(torch.from_numpy(x)).numpy(),
        np.asarray(ji.tensor_to_uint8(jnp.asarray(x))))
    lr_ref, cond_ref = ji.degrade_pair(jnp.asarray(x), 8, 64)
    lr, cond = ti.degrade_pair(torch.from_numpy(x), 8, 64)
    np.testing.assert_allclose(lr.numpy(), np.asarray(lr_ref), atol=ATOL)
    np.testing.assert_allclose(cond.numpy(), np.asarray(cond_ref), atol=ATOL)
    with pytest.raises(KeyError):
        ti.resize(torch.from_numpy(x), 8, 8, "lanczos")


def _old_resize(x, height, width, method, antialias):
    """``resize`` as it was: each matrix copied from host memory at every
    call."""
    B, H, W, C = x.shape
    x = x.float()
    if H != height:
        wh = torch.from_numpy(ti._weight_matrix(H, height, method,
                                                antialias))
        x = torch.einsum("oh,bhwc->bowc", wh.to(x.device), x)
    if W != width:
        ww = torch.from_numpy(ti._weight_matrix(W, width, method,
                                                antialias))
        x = torch.einsum("pw,bowc->bopc", ww.to(x.device), x)
    return x


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("size", [(24, 16), (16, 9), (9, 24)])
def test_resize_is_bit_equal_to_the_copying_path(method, antialias, size,
                                                 monkeypatch):
    """Up and down, along either axis and both: the CPU path, and the
    device path's cached matrices (here on the CPU), give the old path's
    values bit for bit."""
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    want = _old_resize(x, *size, method, antialias)
    assert torch.equal(ti.resize(x, *size, method, antialias), want)
    monkeypatch.setattr(ti, "_weights", lambda *k: ti._on_device(*k))
    assert torch.equal(ti.resize(x, *size, method, antialias), want)


def test_the_device_cache_is_keyed_by_device_and_never_filled_on_the_cpu():
    ti._on_device.cache_clear()
    ti.resize(torch.rand(1, 16, 16, 3), 32, 32, "bicubic")
    cpu = ti._weights(16, 32, "bicubic", False, torch.device("cpu"))
    assert ti._on_device.cache_info().currsize == 0
    meta = ti._weights(16, 32, "bicubic", False, torch.device("meta"))
    assert meta.device.type == "meta" and meta.shape == cpu.shape
    assert meta is ti._weights(16, 32, "bicubic", False,
                               torch.device("meta"))
    assert ti._on_device.cache_info().currsize == 1
    # the same matrix on another device is another entry
    on_cpu = ti._on_device(16, 32, "bicubic", False, torch.device("cpu"))
    assert torch.equal(on_cpu, cpu)
    assert ti._on_device.cache_info().currsize == 2
    # FLAME's joint-tree index: one copy a device, the list's values
    joints = torch.rand(2, 5, 3)
    idx = lbs.index_on((0, 1, 1, 1), joints.device)
    assert idx is lbs.index_on((0, 1, 1, 1), torch.device("cpu"))
    assert torch.equal(joints[:, idx], joints[:, [0, 1, 1, 1]])
