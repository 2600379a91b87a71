"""Backward of the port's deformable conv vs the JAX package.

``deform_conv2d`` is a ``torch.autograd.Function``; on CPU tensors its
backward is ``deform_conv2d_backward_plain``, the closed forms the CUDA
backward kernel computes. It is held against three independent
derivations: torch autograd through the plain forward, the JAX Pallas
backward kernel (``_pallas_backward(..., x_grad=False)``, interpret mode)
and ``jax.grad`` through the JAX gather path, at the JAX suite's gradient
tolerance (rtol 1e-3 / atol 1e-4, tests/test_pallas_deform.py). The card's
legs are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jspsr_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from jspsr_tpu.ops.pallas_deform import _pallas_backward
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)

torch.set_num_threads(2)

# (batch, H, W, offset scale): scale 0 samples integer positions (the SPN
# generator's init, where the floor-based offset gradient must not vanish),
# 20 px sends most taps off the image, 13x20 is not a multiple of 8
CASES = [(2, 16, 16, 0.0), (2, 16, 16, 0.7), (2, 16, 16, 1.5),
         (2, 16, 16, 20.0), (1, 13, 20, 1.5)]
IDS = [f"{b}x{h}x{w}-s{s}" for b, h, w, s in CASES]
RTOL, ATOL = 1e-3, 1e-4


def _case(b, h, w, scale, seed):
    """NHWC numpy inputs and an upstream gradient; the mask is zero-sum
    over the taps (signed), as the SPN head makes it."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 18)) * scale).astype(np.float32)
    mask = rng.uniform(0, 1, size=(b, h, w, 9)).astype(np.float32)
    mask = mask - mask.mean(axis=-1, keepdims=True)
    wgt = rng.normal(size=(3, 3, 1, 1)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    g = rng.normal(size=(b, h, w)).astype(np.float32)
    return x, off, mask, wgt, bias, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_grads(x, off, mask, wgt, bias, g):
    """The Function's gradients, back in the JAX layouts: d_offset
    (B,H,W,18), d_mask (B,H,W,9), d_weight (3,3,1,1), d_bias (1,)."""
    xt = _nchw(x)
    offt = _nchw(off).requires_grad_(True)
    maskt = _nchw(mask).requires_grad_(True)
    wt = torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy())
    wt.requires_grad_(True)
    bt = torch.from_numpy(bias.copy()).requires_grad_(True)
    out = deform_conv2d(xt, offt, wt, bt, maskt)
    out.backward(torch.from_numpy(g)[:, None])
    nhwc = lambda t: t.grad.numpy().transpose(0, 2, 3, 1)
    return (nhwc(offt), nhwc(maskt),
            wt.grad.numpy().transpose(2, 3, 1, 0), bt.grad.numpy())


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_function_grads_match_autograd_of_plain_forward(b, h, w, scale):
    """torch autograd through the gather forward (``floor`` has a zero
    derivative there, so it too is floor-based) is an independent
    derivation of the same closed forms."""
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=h + w)
    launches = dict(deform_cuda.LAUNCHES)
    got = _port_grads(x, off, mask, wgt, bias, g)
    assert deform_cuda.LAUNCHES == launches  # CPU tensors: plain versions

    leaves = [_nchw(off), _nchw(mask),
              torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()),
              torch.from_numpy(bias.copy())]
    for t in leaves:
        t.requires_grad_(True)
    out = deform_conv2d_plain(_nchw(x), leaves[0], leaves[2], leaves[3],
                              leaves[1])
    out.backward(torch.from_numpy(g)[:, None])
    want = (leaves[0].grad.numpy().transpose(0, 2, 3, 1),
            leaves[1].grad.numpy().transpose(0, 2, 3, 1),
            leaves[2].grad.numpy().transpose(2, 3, 1, 0),
            leaves[3].grad.numpy())
    for name, a, r in zip(("offset", "mask", "weight", "bias"), got, want):
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_backward_matches_jax_pallas_interpret(b, h, w, scale):
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=h * w)
    _, d_off, d_mask, d_w, d_b = _pallas_backward(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt), jnp.asarray(bias),
        jnp.asarray(mask), jnp.asarray(g), padding=1, x_grad=False)
    got = _port_grads(x, off, mask, wgt, bias, g)
    if scale == 0.0:  # integer positions: the offset gradient is live
        assert np.abs(got[0]).max() > 0
    for name, a, r in zip(("offset", "mask", "weight", "bias"), got,
                          (d_off, d_mask, d_w, d_b)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_backward_matches_jax_grad_of_gather(b, h, w, scale):
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=3 * h + w)

    def loss(off, mask, wgt, bias):
        y = jax_deform_conv2d(jnp.asarray(x), off, wgt, bias, mask,
                              impl="gather")
        return jnp.sum(y[..., 0] * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(off), jnp.asarray(mask), jnp.asarray(wgt),
        jnp.asarray(bias))
    got = _port_grads(x, off, mask, wgt, bias, g)
    for name, a, r in zip(("offset", "mask", "weight", "bias"), got, want):
        np.testing.assert_allclose(a, np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_backward_plain_returns_shapes_of_its_inputs():
    x, off, mask, wgt, bias, g = _case(1, 9, 11, 1.5, seed=0)
    d_off, d_mask, d_w, d_b = deform_conv2d_backward_plain(
        _nchw(x), _nchw(off), torch.from_numpy(wgt.transpose(3, 2, 0, 1)
                                               .copy()),
        _nchw(mask), torch.from_numpy(g)[:, None])
    assert d_off.shape == (1, 18, 9, 11) and d_mask.shape == (1, 9, 9, 11)
    assert d_w.shape == (1, 1, 3, 3) and d_b.shape == (1,)


def test_expanded_grad_out_is_accepted():
    """``out.sum()`` hands the backward an expanded stride-0 gradient."""
    x, off, mask, wgt, bias, _ = _case(1, 8, 8, 1.0, seed=1)
    ones = np.ones((1, 8, 8), np.float32)
    want = _port_grads(x, off, mask, wgt, bias, ones)
    offt = _nchw(off).requires_grad_(True)
    deform_conv2d(_nchw(x), offt, torch.from_numpy(
        wgt.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias.copy()),
        _nchw(mask)).sum().backward()
    np.testing.assert_allclose(offt.grad.numpy().transpose(0, 2, 3, 1),
                               want[0], rtol=1e-6, atol=1e-6)


def test_input_gradient_raises_naming_k3():
    """Once a refusal naming K3, the input gradient now flows: the
    Function's d_x is the plain backward's and autograd's through the
    plain forward (tests/test_torch_deform_dx.py holds it against JAX)."""
    x, off, mask, wgt, bias, g = _case(1, 8, 8, 1.0, seed=2)
    w_t = torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy())
    grads = []
    for fn in (deform_conv2d, deform_conv2d_plain):
        xt = _nchw(x).requires_grad_(True)
        fn(xt, _nchw(off), w_t, torch.from_numpy(bias.copy()),
           _nchw(mask)).backward(torch.from_numpy(g)[:, None])
        grads.append(xt.grad)
    d_x = deform_conv2d_backward_plain(_nchw(x), _nchw(off), w_t, _nchw(mask),
                                       torch.from_numpy(g)[:, None],
                                       need_dx=True)[4]
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], d_x, rtol=0, atol=0)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


def test_k2_bound_counts_each_byte_once():
    """K2's bound: 224 bytes per output pixel (x, 18 offsets, 9 mask
    values and g in; 18 offset and 9 mask gradients out) and the 9
    weights in and out, or 315 fp32 operations per pixel."""
    from jspsr_torch.scripts.bench_deform_bwd import k2_bound

    ms, by = k2_bound(50, 128, 128, 3.35e12, 67e12)
    assert by == "bytes"
    assert ms == pytest.approx((50 * 128 * 128 * 224 + 72) / 3.35e12 * 1e3)
    ms, by = k2_bound(2, 64, 128, 1e30, 1e9)
    assert by == "operations"
    assert ms == pytest.approx(2 * 64 * 128 * 315 / 1e9 * 1e3)


@pytest.mark.parametrize("label", ["16x128", "slab_2x64of128"])
def test_bench_deform_bwd_inputs_are_rows_of_one_image(label):
    """The K2 bench's inputs: x the whole image, offset, mask and g the
    slab's rows of the image's own, contiguous, as a sharded rank holds
    them."""
    from jspsr_torch.scripts.bench_deform_bwd import SHAPES, bwd_inputs

    b, side, hs, y0 = SHAPES[label]
    b = min(b, 2)
    slab = bwd_inputs(b, side, hs, y0, torch.Generator().manual_seed(5),
                      torch.device("cpu"))
    whole = bwd_inputs(b, side, side, 0, torch.Generator().manual_seed(5),
                       torch.device("cpu"))
    assert slab[0].shape == (b, 1, side, side)
    for got, full in zip(slab[1:], whole[1:]):
        assert got.is_contiguous()
        want = full[:, :, y0:y0 + hs] if full.dim() == 4 and \
            full.shape[2] == side else full
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bench_deform_bwd_needs_cuda(monkeypatch):
    from jspsr_torch.scripts import bench_deform_bwd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_deform_bwd.main([])
