"""The port's bilinear and bicubic resizes (``F.interpolate``'s values, a
backward of two transposed matrix products, without atomics) against the
JAX package's ``bilinear_resize`` / ``bicubic_resize`` (matrix products)
and their VJPs, on the same seeded inputs: growing, shrinking and mixed,
with and without ``align_corners``. Both sum the same few fp32 products
per output, in other orders: rtol and atol 1e-5; likewise against the
gradient of ``F.interpolate`` itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jspsr_tpu.nn import layers as jax_layers
from jspsr_torch.nn import layers

SIZES = [((7, 9), (14, 18)), ((16, 12), (5, 7)), ((8, 8), (16, 5))]


def _jax_resize(mode, x, h, w, ac):
    if mode == "bicubic":
        return jax_layers.bicubic_resize(x, h, w)
    return jax_layers.bilinear_resize(x, h, w, align_corners=ac)


def _port_resize(mode, x, h, w, ac):
    if mode == "bicubic":
        return layers.bicubic_resize(x, h, w)
    return layers.bilinear_resize(x, h, w, align_corners=ac)


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("mode,ac", [("bilinear", False), ("bilinear", True),
                                     ("bicubic", False)])
def test_resize_forward_and_backward_match_jax(src, dst, mode, ac):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)  # NHWC
    g = rng.normal(size=(2, *dst, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: _jax_resize(mode, v, *dst, ac),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    got = _port_resize(mode, xt, *dst, ac)
    got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    # the gradient of torch's own resize (no antialias)
    xi = xt.detach().clone().requires_grad_()
    F.interpolate(xi, size=dst, mode=mode,
                  align_corners=ac if mode == "bilinear" else None).backward(
        torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(xt.grad.numpy(), xi.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_resize_to_the_same_size_is_the_input():
    x = torch.randn(1, 2, 5, 6)
    assert layers.bilinear_resize(x, 5, 6) is x
    assert layers.bicubic_resize(x, 5, 6) is x
