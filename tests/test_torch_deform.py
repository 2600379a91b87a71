"""Deformable conv in the PyTorch port vs the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
gather path and the Pallas kernel in interpret mode, at the JAX suite's
deform tolerance (tests/test_pallas_deform.py). The CUDA kernel's legs are
in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from jspsr_tpu.ops.deform_conv import (
    insert_zero_center_offset as jax_insert_zero_center_offset,
)
from jspsr_tpu.ops.pallas_deform import deform_conv2d_pallas
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_plain,
    insert_zero_center_offset,
)

torch.set_num_threads(2)

# (batch, H, W, offset scale): zero offsets sample exact-integer positions,
# 20 px sends most samples far off the image, 12x20 is not a multiple of 8
CASES = [(2, 16, 16, 0.0), (2, 16, 16, 1.5), (2, 16, 16, 20.0),
         (1, 12, 20, 2.0)]


def _case(b, h, w, off_scale, seed):
    """NHWC numpy inputs; the mask is zero-sum over the taps, so signed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 18)) * off_scale).astype(np.float32)
    mask = rng.uniform(0, 1, size=(b, h, w, 9)).astype(np.float32)
    mask = mask - mask.mean(axis=-1, keepdims=True)
    wgt = rng.normal(size=(3, 3, 1, 1)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    return x, off, mask, wgt, bias


def _port_args(x, off, mask, wgt, bias, device="cpu"):
    """NHWC / HWIO numpy -> the port's NCHW / OIHW tensors."""
    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    return [t.to(device) for t in (
        nchw(x), nchw(off), torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(bias), nchw(mask))]


def _nhwc(y):
    return y.detach().cpu().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("b,h,w,scale", CASES)
def test_plain_matches_jax_gather(b, h, w, scale):
    x, off, mask, wgt, bias = _case(b, h, w, scale, seed=h + w)
    ref = jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                            jnp.asarray(wgt), jnp.asarray(bias),
                            jnp.asarray(mask), impl="gather")
    launches = dict(deform_cuda.LAUNCHES)
    got = deform_conv2d(*_port_args(x, off, mask, wgt, bias))
    assert deform_cuda.LAUNCHES == launches  # CPU tensors take the plain path
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,w,scale", CASES)
def test_plain_matches_jax_pallas_interpret(b, h, w, scale):
    x, off, mask, wgt, bias = _case(b, h, w, scale, seed=h * w)
    ref = deform_conv2d_pallas(jnp.asarray(x), jnp.asarray(off),
                               jnp.asarray(wgt), jnp.asarray(bias),
                               jnp.asarray(mask), 1)
    got = deform_conv2d_plain(*_port_args(x, off, mask, wgt, bias))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_insert_zero_center_offset_matches_jax():
    rng = np.random.default_rng(5)
    off = rng.normal(size=(2, 6, 7, 16)).astype(np.float32)
    ref = np.asarray(jax_insert_zero_center_offset(jnp.asarray(off), 3))
    got = insert_zero_center_offset(
        torch.from_numpy(np.ascontiguousarray(off.transpose(0, 3, 1, 2))))
    np.testing.assert_array_equal(_nhwc(got), ref)
    with pytest.raises(ValueError):
        insert_zero_center_offset(torch.zeros(1, 18, 4, 4))


@pytest.mark.parametrize("bad", ["x_channels", "offset", "mask", "weight"])
def test_wrapper_rejects_unsupported_shapes(bad):
    args = _port_args(*_case(1, 8, 8, 1.0, seed=0))
    x, off, wgt, bias, mask = args
    if bad == "x_channels":
        x = torch.zeros(1, 2, 8, 8)
    elif bad == "offset":
        off = off[:, :16]
    elif bad == "mask":
        mask = mask[:, :, :4]
    else:
        wgt = torch.zeros(1, 1, 5, 5)
    with pytest.raises(ValueError):
        deform_conv2d(x, off, wgt, bias, mask)
