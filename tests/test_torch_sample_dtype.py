"""The bf16-sampling mode of the deformable conv (``sample_dtype``) against
the JAX package's Pallas kernels.

The port's plain forward and backward (K1's and K2's outputs: d_offset,
d_mask, d_weight, d_bias) in the mode against ``deform_conv2d_pallas(...,
sample_dtype="bfloat16")``, which the CPU runs in interpret mode, at the
deform suite's tolerance 1e-4 (tests/test_pallas_deform.py); the largest
error seen is about 1e-6 (the sums run in another order). The mode must
differ from the fp32 mode. With a gradient to the input (K3's mode) the
port's plain backward is held to ``jax.grad`` of ``deform_conv2d_pallas(...,
x_grad=True, sample_dtype="bfloat16")`` in interpret mode, all five
gradients at the same 1e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from jspsr_tpu.ops.pallas_deform import _pallas_backward, deform_conv2d_pallas
from jspsr_torch.ops.deform_conv import (
    bf16_sampling,
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)

torch.set_num_threads(2)

TOL = 1e-4
# (B, H, W), offset scale: 0, 1.5 and 20 px, and an H that the JAX block
# does not divide
CASES = [((2, 16, 16), 0.0), ((2, 16, 16), 1.5), ((2, 16, 16), 20.0),
         ((1, 12, 20), 2.0)]
IDS = ["0px", "1.5px", "20px", "12x20"]


def _case(b, h, w, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, 1)).astype(np.float32),
            (rng.normal(size=(b, h, w, 18)) * scale).astype(np.float32),
            rng.uniform(0, 1, (b, h, w, 9)).astype(np.float32),
            rng.normal(size=(3, 3, 1, 1)).astype(np.float32),
            rng.normal(size=(1,)).astype(np.float32),
            rng.normal(size=(b, h, w)).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _port_args(x, off, mask, wgt, bias):
    return (_nchw(x), _nchw(off), torch.from_numpy(wgt.transpose(3, 2, 0, 1)
                                                   .copy()),
            torch.from_numpy(bias), _nchw(mask))


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_bf16_forward_matches_pallas(shape, scale):
    x, off, mask, wgt, bias, _ = _case(*shape, scale, seed=int(10 * scale))
    jargs = [jnp.asarray(a) for a in (x, off, wgt, bias, mask)]
    ref = np.asarray(deform_conv2d_pallas(*jargs, 1, False, "bfloat16"))
    ref32 = np.asarray(deform_conv2d_pallas(*jargs, 1, False, None))
    px, poff, pw, pb, pm = _port_args(x, off, mask, wgt, bias)
    got = deform_conv2d_plain(px, poff, pw, pb, pm, 1,
                              sample_dtype="bfloat16").numpy()
    err = np.abs(got - ref.transpose(0, 3, 1, 2)).max()
    print(f"bf16 forward {shape} {scale} px: max |port - pallas| {err:.3g}")
    np.testing.assert_allclose(got, ref.transpose(0, 3, 1, 2), rtol=TOL,
                               atol=TOL)
    # the mode is really quantised: both packages' bf16 and fp32 differ
    got32 = deform_conv2d_plain(px, poff, pw, pb, pm, 1).numpy()
    assert np.abs(got - got32).max() > 1e-3
    assert np.abs(ref - ref32).max() > 1e-3


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_bf16_backward_matches_pallas(shape, scale):
    x, off, mask, wgt, bias, g = _case(*shape, scale, seed=int(10 * scale) + 1)
    _, d_off, d_mask, d_w, d_b = _pallas_backward(
        *(jnp.asarray(a) for a in (x, off, wgt, bias, mask, g)), padding=1,
        x_grad=False, sample_dtype="bfloat16")
    px, poff, pw, _, pm = _port_args(x, off, mask, wgt, bias)
    got = deform_conv2d_backward_plain(px, poff, pw, pm,
                                       torch.from_numpy(g)[:, None], 1,
                                       sample_dtype="bfloat16")
    want = (np.asarray(d_off).transpose(0, 3, 1, 2),
            np.asarray(d_mask).transpose(0, 3, 1, 2),
            np.asarray(d_w).transpose(3, 2, 0, 1), np.asarray(d_b))
    for name, a, r in zip(("d_offset", "d_mask", "d_weight", "d_bias"),
                          got, want):
        a = a.numpy()
        print(f"bf16 backward {shape} {scale} px {name}: max |port - "
              f"pallas| {np.abs(a - r).max():.3g}")
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=name)
    fp32 = deform_conv2d_backward_plain(px, poff, pw, pm,
                                        torch.from_numpy(g)[:, None], 1)
    assert (got[0] - fp32[0]).abs().max() > 1e-3


def test_autograd_reaches_the_mode():
    """deform_conv2d's autograd takes the mode's backward: its gradients
    are the plain bf16 backward's, bit for bit."""
    x, off, mask, wgt, bias, g = _case(1, 12, 20, 1.5, seed=7)
    px, poff, pw, pb, pm = _port_args(x, off, mask, wgt, bias)
    leaves = [t.clone().requires_grad_(True) for t in (poff, pw, pb, pm)]
    out = deform_conv2d(px, leaves[0], leaves[1], leaves[2], leaves[3],
                        sample_dtype="bfloat16")
    out.backward(torch.from_numpy(g)[:, None])
    want = deform_conv2d_backward_plain(px, poff, pw, pm,
                                        torch.from_numpy(g)[:, None],
                                        sample_dtype="bfloat16")
    for leaf, w in zip(leaves, (want[0], want[2], want[3], want[1])):
        assert torch.equal(leaf.grad, w.view_as(leaf.grad))


def test_input_gradient_and_unknown_dtype_raise():
    """Once a refusal (K3's mode was not ported), the input gradient now
    flows in the mode: ``deform_conv2d``'s autograd gives the plain
    backward's d_x with ``need_dx``, bit for bit; an unknown sample_dtype
    raises; None and float32 are the fp32 mode."""
    x, off, mask, wgt, bias, g = _case(1, 8, 8, 1.0, seed=3)
    px, poff, pw, pb, pm = _port_args(x, off, mask, wgt, bias)
    xt = px.clone().requires_grad_(True)
    deform_conv2d(xt, poff, pw, pb, pm, sample_dtype="bfloat16").backward(
        torch.from_numpy(g)[:, None])
    want = deform_conv2d_backward_plain(px, poff, pw, pm,
                                        torch.from_numpy(g)[:, None],
                                        need_dx=True, sample_dtype="bfloat16")
    assert xt.grad.abs().max() > 0 and torch.equal(xt.grad, want[4])
    with pytest.raises(ValueError, match="sample_dtype"):
        bf16_sampling("float16")
    assert not bf16_sampling(None) and not bf16_sampling("float32")
    assert bf16_sampling("bfloat16")


@pytest.mark.parametrize("shape,scale", CASES, ids=IDS)
def test_bf16_input_gradient_matches_pallas(shape, scale):
    """K3's bf16-sampling mode: ``jax.grad`` of the Pallas op with
    ``x_grad=True`` in the mode (interpret mode) against the port's plain
    backward with ``need_dx``, d_x, d_offset, d_mask, d_weight and d_bias
    at 1e-4; through the port's autograd the same gradients, bit for
    bit."""
    x, off, mask, wgt, bias, g = _case(*shape, scale, seed=int(10 * scale) + 2)
    jargs = [jnp.asarray(a) for a in (x, off, wgt, bias, mask)]

    def loss(x, off, wgt, bias, mask):
        out = deform_conv2d_pallas(x, off, wgt, bias, mask, 1, True,
                                   "bfloat16")
        return jnp.sum(out[..., 0] * jnp.asarray(g))

    d_x, d_off, d_w, d_b, d_mask = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *jargs)
    px, poff, pw, pb, pm = _port_args(x, off, mask, wgt, bias)
    gt = torch.from_numpy(g)[:, None]
    got = deform_conv2d_backward_plain(px, poff, pw, pm, gt, 1, need_dx=True,
                                       sample_dtype="bfloat16")
    want = (np.asarray(d_off).transpose(0, 3, 1, 2),
            np.asarray(d_mask).transpose(0, 3, 1, 2),
            np.asarray(d_w).transpose(3, 2, 0, 1), np.asarray(d_b),
            np.asarray(d_x).transpose(0, 3, 1, 2))
    for name, a, r in zip(("d_offset", "d_mask", "d_weight", "d_bias",
                           "d_x"), got, want):
        a = a.numpy()
        print(f"bf16 input gradient {shape} {scale} px {name}: max |port - "
              f"pallas| {np.abs(a - r).max():.3g}")
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=name)
    assert np.abs(got[4].numpy()).max() > 0
    leaves = [t.clone().requires_grad_(True) for t in (px, poff, pw, pb, pm)]
    deform_conv2d(*leaves, sample_dtype="bfloat16").backward(gt)
    for leaf, w in zip(leaves, (got[4], got[0], got[2], got[3], got[1])):
        assert torch.equal(leaf.grad, w.view_as(leaf.grad))
