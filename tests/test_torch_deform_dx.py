"""The deformable conv's backward WITH the input gradient (the work of the
K3 kernel on the card) vs the JAX package.

NLSPN propagates a feature that needs its gradient, so ``deform_conv2d``'s
backward also returns d_x: each tap's g·w_t·m_t times its four bilinear
weights, scattered onto the corners it read. On CPU tensors that is
``deform_conv2d_backward_plain(..., need_dx=True)``. It is held, with
d_offset and d_mask from the same call, against the JAX Pallas backward
with ``x_grad=True`` (interpret mode) and ``jax.grad`` through the JAX
gather path, at the deform suite's 1e-4 (tests/test_pallas_deform.py), and
against numerical derivatives in float64 (``gradcheck``). K3's
bf16-sampling mode is the two halves of modes already held: d_x bit-equal
to the fp32 mode's, d_offset, d_mask and d_weight bit-equal to K2's bf16
mode's (tests/test_torch_sample_dtype.py holds it to JAX). The three
custom ops pass ``torch.library.opcheck``. The card's legs are in
tests/test_torch_gpu.py and ``chip_smoke.py``.
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
    bilinear_sample,
    deform_conv2d,
    deform_conv2d_backward_dx_op,
    deform_conv2d_backward_op,
    deform_conv2d_backward_plain,
    deform_conv2d_op,
    deform_conv2d_plain,
)

torch.set_num_threads(2)

# (batch, H, W, offset scale): scale 0 samples integer positions (NLSPN's
# zero-offset init), 20 px sends most taps off the image, 13x20 is not a
# multiple of the TPU kernel's row block
CASES = [(2, 16, 16, 0.0), (2, 16, 16, 0.7), (2, 16, 16, 1.5),
         (2, 16, 16, 20.0), (1, 13, 20, 1.5)]
IDS = [f"{b}x{h}x{w}-s{s}" for b, h, w, s in CASES]
TOL = 1e-4


def _case(b, h, w, scale, seed):
    """NHWC numpy inputs and an upstream gradient; the mask is an NLSPN
    affinity (signed, summing to 1 over the taps)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 18)) * scale).astype(np.float32)
    aff = rng.uniform(-0.3, 0.3, size=(b, h, w, 9))
    aff[..., 4] = 1.0 - (aff.sum(-1) - aff[..., 4])
    wgt = rng.normal(size=(3, 3, 1, 1)).astype(np.float32)
    bias = rng.normal(size=(1,)).astype(np.float32)
    g = rng.normal(size=(b, h, w)).astype(np.float32)
    return x, off, aff.astype(np.float32), wgt, bias, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port_grads(x, off, mask, wgt, bias, g):
    """The Function's d_x, d_offset, d_mask, back in the JAX layouts."""
    leaves = [_nchw(x), _nchw(off), _nchw(mask)]
    for t in leaves:
        t.requires_grad_(True)
    out = deform_conv2d(leaves[0], leaves[1],
                        torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(bias.copy()), leaves[2])
    out.backward(torch.from_numpy(g)[:, None])
    return [_nhwc(t.grad) for t in leaves]


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_input_grad_matches_jax_pallas_interpret(b, h, w, scale):
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=h * w + 1)
    d_x, d_off, d_mask, _, _ = _pallas_backward(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt), jnp.asarray(bias),
        jnp.asarray(mask), jnp.asarray(g), padding=1, x_grad=True)
    launches = dict(deform_cuda.LAUNCHES)
    got = _port_grads(x, off, mask, wgt, bias, g)
    assert deform_cuda.LAUNCHES == launches  # CPU tensors: plain versions
    assert np.abs(got[0]).max() > 0
    for name, a, r in zip(("x", "offset", "mask"), got, (d_x, d_off, d_mask)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_input_grad_matches_jax_grad_of_gather(b, h, w, scale):
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=5 * h + w)

    def loss(x, off, mask):
        y = jax_deform_conv2d(x, off, jnp.asarray(wgt), jnp.asarray(bias),
                              mask, impl="gather")
        return jnp.sum(y[..., 0] * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask))
    got = _port_grads(x, off, mask, wgt, bias, g)
    for name, a, r in zip(("x", "offset", "mask"), got, want):
        np.testing.assert_allclose(a, np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_plain_dx_matches_autograd_of_plain_forward(b, h, w, scale):
    """The ``index_add_`` scatter against autograd through the gathers of
    the plain forward; the other outputs are those of the form without
    d_x."""
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=b + h + w)
    args = (_nchw(x), _nchw(off),
            torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()), _nchw(mask),
            torch.from_numpy(g)[:, None])
    with_dx = deform_conv2d_backward_plain(*args, need_dx=True)
    without = deform_conv2d_backward_plain(*args)
    assert len(with_dx) == 5 and len(without) == 4
    for a, r in zip(with_dx[:4], without):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    xt = args[0].clone().requires_grad_(True)
    deform_conv2d_plain(xt, args[1], args[2], torch.from_numpy(bias.copy()),
                        args[3]).backward(args[4])
    torch.testing.assert_close(with_dx[4], xt.grad, rtol=1e-5, atol=1e-5)


def test_only_the_input_needs_grad():
    """x alone requires grad (the propagation's first step after a frozen
    backbone): d_x flows, nothing else is computed for the others."""
    x, off, mask, wgt, bias, g = _case(1, 12, 12, 1.5, seed=3)
    xt = _nchw(x).requires_grad_(True)
    offt = _nchw(off)
    deform_conv2d(xt, offt, torch.from_numpy(wgt.transpose(3, 2, 0, 1)
                                             .copy()),
                  torch.from_numpy(bias.copy()), _nchw(mask)).backward(
        torch.from_numpy(g)[:, None])
    want = _port_grads(x, off, mask, wgt, bias, g)[0]
    np.testing.assert_allclose(_nhwc(xt.grad), want, rtol=0, atol=0)
    assert offt.grad is None


@pytest.mark.parametrize("scale", [0.6, 3.0])
def test_gradcheck_float64_with_input(scale):
    """Numerical derivatives in float64 of every differentiable argument,
    x included. Positions are kept off the integers, where the bilinear
    form has kinks that a central difference would straddle."""
    rng = np.random.default_rng(int(scale * 10))
    b, h, w = 1, 6, 7
    off = rng.normal(size=(b, 18, h, w)) * scale
    off += 0.5 - np.mod(off, 1.0)  # every position at k + 0.5 +- 0.25
    off += rng.uniform(-0.25, 0.25, off.shape)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (
        rng.normal(size=(b, 1, h, w)), off, rng.normal(size=(1, 1, 3, 3)),
        rng.normal(size=(1,)), rng.uniform(-0.5, 1.0, size=(b, 9, h, w)))]
    assert torch.autograd.gradcheck(
        lambda *a: deform_conv2d(*a, 1), args, eps=1e-6,
        atol=1e-6, rtol=1e-5)


def test_bilinear_sample_matches_jax_one_by_one_deform():
    """NLSPN's confidence taps: a 1x1 deformable sample (padding 0) in the
    JAX package, ``bilinear_sample`` at y + dy, x + dx in the port; values
    and the gradient to the sampled image."""
    rng = np.random.default_rng(9)
    b, h, w = 2, 10, 12
    conf = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    off = rng.normal(0, 2.0, (b, h, w, 2)).astype(np.float32)
    g = rng.normal(size=(b, h, w)).astype(np.float32)

    def sample(conf):
        return jax_deform_conv2d(conf, jnp.asarray(off),
                                 jnp.ones((1, 1, 1, 1)), jnp.zeros((1,)),
                                 jnp.ones((b, h, w, 1)), padding=0,
                                 impl="gather")[..., 0]

    want, vjp = jax.vjp(sample, jnp.asarray(conf))
    confn = _nchw(conf).requires_grad_(True)
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    offn = _nchw(off)
    got = bilinear_sample(confn, yy + offn[:, :1], xx + offn[:, 1:])
    got.backward(torch.from_numpy(g)[:, None])
    np.testing.assert_allclose(got[:, 0].detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_nhwc(confn.grad),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=TOL, atol=TOL)


def _dx_atomics_brute(off, h, w, tile, margin, pad=1):
    """K3's scatter walked pixel by pixel, tap by tap, corner by corner, in
    float32 as the kernel computes positions: where each in-bounds corner's
    contribution goes, and which window cells the flush visits."""
    b = off.shape[0]
    th, tw = tile
    counts = {"corners": 0, "shared": 0, "direct": 0}
    cells = set()
    for bi in range(b):
        for y in range(h):
            for x in range(w):
                wy0, wx0 = y // th * th - margin, x // tw * tw - margin
                blk = (bi, y // th, x // tw)
                for t in range(9):
                    py = np.float32(y - pad + t // 3) + off[bi, 2 * t, y, x]
                    px = np.float32(x - pad + t % 3) + off[bi, 2 * t + 1, y, x]
                    y0, x0 = int(np.floor(py)), int(np.floor(px))
                    for yc, xc in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                                   (y0 + 1, x0 + 1)):
                        if not (0 <= yc < h and 0 <= xc < w):
                            continue
                        counts["corners"] += 1
                        ry, rx = yc - wy0, xc - wx0
                        if 0 <= ry < th + 2 * margin and \
                                0 <= rx < tw + 2 * margin:
                            counts["shared"] += 1
                            cells.add((blk, ry, rx))
                        else:
                            counts["direct"] += 1
    counts["flush"] = len(cells)
    counts["global"] = counts["direct"] + counts["flush"]
    return counts


@pytest.mark.parametrize("scale", [0.0, 1.5, 20.0])
@pytest.mark.parametrize("b,h,w,tile,margin", [
    (2, 13, 37, deform_cuda.DX_TILE, deform_cuda.DX_MARGIN),
    (1, 9, 20, (4, 8), 2),
])
def test_dx_atomics_matches_brute_force(b, h, w, tile, margin, scale):
    """``deform_cuda.dx_atomics`` against a loop over every corner, on
    tiles that divide neither H nor W (corners at the image edge, in the
    margin, across the window's edge and, at 20 px, off the image)."""
    rng = np.random.default_rng(int(scale * 10) + h)
    off = (rng.normal(size=(b, 18, h, w)) * scale).astype(np.float32)
    got = deform_cuda.dx_atomics(torch.from_numpy(off), h, w, tile=tile,
                                 margin=margin)
    want = _dx_atomics_brute(off, h, w, tile, margin)
    assert got == want
    assert got["corners"] == got["shared"] + got["direct"]
    if scale == 0.0:  # every corner within a pixel of its own: no escape
        assert got["direct"] == 0


def test_dx_atomics_at_nlspn_offsets_stay_below_a_tenth():
    """At 1.5 px, the train batch's 128² images send about 3 global atomics
    per pixel through the window of K3's 4 x 64 tiles (at most 3.4 flushes,
    a window's 12 x 72 cells over its tile's 256 pixels, plus the few
    corners that leave it) where a scatter without the window sends every
    corner, about 35."""
    rng = np.random.default_rng(0)
    off = torch.from_numpy((rng.normal(size=(2, 18, 128, 128)) * 1.5)
                           .astype(np.float32))
    got = deform_cuda.dx_atomics(off, 128, 128)
    pixels = 2 * 128 * 128
    (th, tw), margin = deform_cuda.DX_TILE, deform_cuda.DX_MARGIN
    assert got["global"] / pixels <= 0.1 * got["corners"] / pixels
    assert got["flush"] <= (2 * (128 // th) * (128 // tw) * (th + 2 * margin)
                            * (tw + 2 * margin))


@pytest.mark.parametrize("b,h,w,scale", CASES, ids=IDS)
def test_bf16_mode_input_gradient_halves(b, h, w, scale):
    """K3's bf16-sampling mode rounds only the image products: its d_x is
    the fp32 mode's and its d_offset, d_mask, d_weight and d_bias are K2's
    bf16 mode's, each bit for bit."""
    x, off, mask, wgt, bias, g = _case(b, h, w, scale, seed=7 * h + w)
    args = (_nchw(x), _nchw(off), torch.from_numpy(
        wgt.transpose(3, 2, 0, 1).copy()), _nchw(mask),
        torch.from_numpy(g)[:, None])
    bf16 = deform_conv2d_backward_plain(*args, need_dx=True,
                                        sample_dtype="bfloat16")
    fp32 = deform_conv2d_backward_plain(*args, need_dx=True)
    k2 = deform_conv2d_backward_plain(*args, sample_dtype="bfloat16")
    assert torch.equal(bf16[4], fp32[4]) and bf16[4].abs().max() > 0
    for name, a, r in zip(("d_offset", "d_mask", "d_weight", "d_bias"),
                          bf16[:4], k2):
        assert torch.equal(a, r), name
    assert (bf16[0] - fp32[0]).abs().max() > 1e-4  # the mode really rounds


@pytest.mark.parametrize("sample_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("op", ["forward", "backward", "backward_dx"])
def test_custom_ops_pass_opcheck(op, sample_dtype):
    """``torch.library.opcheck`` (schema, fake, autograd registration, AOT
    dispatch) on each op of ``jspsr::``, on CPU tensors; the forward also
    with every tensor argument requiring its gradient."""
    x, off, mask, wgt, bias, g = _case(2, 6, 7, 1.5, seed=11)
    x, off, mask, g = (_nchw(a) for a in (x, off, mask, g[..., None]))
    wgt = torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy())
    bias = torch.from_numpy(bias.copy())
    if op == "forward":
        torch.library.opcheck(deform_conv2d_op,
                              (x, off, wgt, bias, mask, 1, sample_dtype))
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, off, wgt, bias, mask)]
        torch.library.opcheck(deform_conv2d_op, (*leaves, 1, sample_dtype))
    else:
        fn = (deform_conv2d_backward_op if op == "backward"
              else deform_conv2d_backward_dx_op)
        torch.library.opcheck(fn, (x, off, wgt, mask, g, 1, sample_dtype))


@pytest.mark.parametrize("sample_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("y0", [0, 12], ids=["first_row", "past_last_row"])
@pytest.mark.parametrize("impl", ["plain", "op"])
def test_empty_slab_gives_zero_gradients(impl, y0, sample_dtype):
    """A slab of no rows (hs = 0) at image row 0 and at H: the plain
    backward and the ``jspsr::deform_conv2d_backward_dx`` op (on CPU
    tensors, the plain version; K3 returns the same without a launch) give
    empty d_offset and d_mask and zero d_x, d_weight and d_bias of their
    shapes, as the JAX package's backward over no output rows adds
    nothing."""
    x, off, mask, wgt, _, g = _case(2, 12, 10, 1.5, seed=19)
    x, off, mask, g = (_nchw(a) for a in (x, off, mask, g[..., None]))
    off, mask, g = (t[:, :, y0:y0].contiguous() for t in (off, mask, g))
    wgt = torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy())
    if impl == "plain":
        got = deform_conv2d_backward_plain(x, off, wgt, mask, g, need_dx=True,
                                           sample_dtype=sample_dtype, y0=y0)
    else:
        got = deform_conv2d_backward_dx_op(x, off, wgt, mask, g, 1,
                                           sample_dtype, y0)
    assert [tuple(t.shape) for t in got] == [(2, 18, 0, 10), (2, 9, 0, 10),
                                             (1, 1, 3, 3), (1,),
                                             (2, 1, 12, 10)]
    assert all(not t.any() for t in got[2:])


@pytest.mark.parametrize("b,hs,want", [(16, 128, 0.0178), (2, 64, 0.00115),
                                       (8, 64, 0.00462)],
                         ids=["16x128", "slab_2x64of128", "slab_8x64of128"])
def test_k3_bounds_give_the_recorded_figures(b, hs, want):
    """K3's bounds as ``chip_smoke.py`` and the K3 bench take them
    (``bench_deform_bwd_dx``), on an NVIDIA H100 80GB HBM3's published
    rates: the whole image at 16 x 128² and the row slabs 2 and 8 x 64 x
    128 of 128² are bytes-bound at PERF.md's 0.0178, 0.00115 and 0.00462
    ms, whatever the share of corners on the image."""
    from jspsr_torch.scripts.bench_deform_bwd_dx import (
        k3_bound,
        k3_slab_bound,
    )
    from jspsr_torch.scripts.bench_deform_fwd import card_peaks

    _, (bandwidth, fp32_peak, _) = card_peaks("NVIDIA H100 80GB HBM3")
    for atomics in (0, 36 * b * hs * 128):  # no corner, every corner
        bound, by = (k3_bound(b, 128, 128, atomics, bandwidth, fp32_peak)
                     if hs == 128 else
                     k3_slab_bound(b, 128, 128, hs, atomics, bandwidth,
                                   fp32_peak))
        assert by == "bytes"
        assert float(f"{bound:.3g}") == want
