"""The port's last helpers against their JAX twins, on seeded numpy input:
the padding helpers (``eval/inference.py``), ``mosaic_profile``
(``eval/mosaic.py``), ``ToImage`` / ``ToDEM`` (``data/transforms.py``),
``torch_median`` (``metrics/meters.py``), all exactly equal, and
``entry()`` (``jspsr_torch/entry.py``) against the JAX package's
``__graft_entry__.entry`` on the JAX flagship's own weights, at the JAX
suite's whole-model tolerance (tests/test_parity_jspsr.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jspsr_tpu.data import transforms as JT
from jspsr_tpu.eval import inference as JI
from jspsr_tpu.eval.mosaic import mosaic_profile as jax_mosaic_profile
from jspsr_tpu.metrics.meters import torch_median as jax_torch_median
from jspsr_torch.data.transforms import ToDEM, ToImage
from jspsr_torch.entry import entry, example_inputs
from jspsr_torch.eval import inference as I
from jspsr_torch.eval.mosaic import mosaic_profile
from jspsr_torch.metrics.meters import torch_median

torch.set_num_threads(4)


def _img(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (H, W, C): square powers of two, odd sides, one side far shorter than
# the other (the edge-mode branch of the square and multiple pads)
SHAPES = [(100, 100, 2), (128, 128, 1), (97, 60, 3), (33, 33, 1),
          (3, 40, 1), (2, 5, 2), (1, 1, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cal_pad_add_and_remove_padding_match_jax(shape):
    img = _img(shape, 0)
    n = I.cal_pad(img)
    assert n == JI.cal_pad(img)
    padded = I.add_padding(img, n)
    np.testing.assert_array_equal(padded, JI.add_padding(img, n))
    np.testing.assert_array_equal(I.remove_padding(padded, n),
                                  JI.remove_padding(padded, n))
    np.testing.assert_array_equal(I.remove_padding(padded, n), img)
    side = max(shape[:2]) + 2 * n  # at or one past the power of two
    assert side & (side - 1) == 0 or (side - 1) & (side - 2) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pad_to_square_pow2_matches_jax(shape):
    img = _img(shape, 1)
    got, pads = I.pad_to_square_pow2(img)
    want, jpads = JI.pad_to_square_pow2(img)
    assert pads == jpads
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == got.shape[1]


@pytest.mark.parametrize("mult", [1, 8, 16, 32])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pad_to_multiple_matches_jax(shape, mult):
    img = _img(shape, 2)
    got, pads = I.pad_to_multiple(img, mult)
    want, jpads = JI.pad_to_multiple(img, mult)
    assert pads == jpads == I.pads_for_multiple(shape[0], shape[1], mult)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] % mult == 0 and got.shape[1] % mult == 0


PROFILES = [
    None, {}, {"transform": None, "crs": "EPSG:2154"},
    {"transform": [8.0, 0.0, 351000.0, 0.0, -8.0, 6790000.0],
     "crs": "EPSG:2154", "width": 128, "height": 128},
    {"transform": (3.0, 0.5, -12.5, 0.25, -3.0, 42.0), "width": 116},
]


@pytest.mark.parametrize("border_px", [0, 6])
@pytest.mark.parametrize("profile", PROFILES,
                         ids=["none", "empty", "no-transform", "affine",
                              "sheared"])
def test_mosaic_profile_matches_jax(profile, border_px):
    got = mosaic_profile(profile, 334, border_px)
    assert got == jax_mosaic_profile(profile, 334, border_px)
    if profile and profile.get("transform"):
        assert got is not profile and got["width"] == got["height"] == 334
        assert profile.get("width") != 334  # the input stays as it was
    else:
        assert got is profile


@pytest.mark.parametrize("shape", [(4, 4), (7, 5, 1), (1, 33, 31)], ids=str)
def test_to_image_matches_jax(shape):
    x = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    x.flat[0], x.flat[-1] = 0.0, 1.0
    got, want = ToImage()(x), JT.ToImage()(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert str(ToImage()) == str(JT.ToImage()) == "ToImage"


@pytest.mark.parametrize("elev_log", [False, True])
@pytest.mark.parametrize("lo,hi", [(-80, 929), (0, 4810)])
def test_to_dem_matches_jax(lo, hi, elev_log):
    x = np.random.default_rng(4).uniform(0, 1, (2, 9, 7)).astype(np.float32)
    x[0, 0, 0] = 0.0
    got = ToDEM(lo, hi, elev_log=elev_log)(x)
    want = JT.ToDEM(lo, hi, elev_log=elev_log)(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # exp(0) + min with the log scaling, min without
    assert got[0, 0, 0] == pytest.approx(lo + (1 if elev_log else 0))


@pytest.mark.parametrize("helper", [ToImage(), ToDEM(-80, 929)],
                         ids=["ToImage", "ToDEM"])
def test_to_image_and_to_dem_refuse_values_off_the_unit_range(helper):
    for bad in (np.array([0.5, 1.01]), np.array([-0.01, 0.5])):
        with pytest.raises(AssertionError):
            helper(bad)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 101])
def test_torch_median_is_the_lower_middle_as_jax_and_torch(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    x = x.reshape((1, n, 1, 1))
    got = torch_median(torch.from_numpy(x))
    assert got.shape == ()
    assert float(got) == float(jax_torch_median(jnp.asarray(x)))
    assert float(got) == float(torch.median(torch.from_numpy(x)))
    assert float(got) == float(np.sort(x.ravel())[(n - 1) // 2])


# ------------------------------------------------------------------ entry

def test_entry_matches_jax_entry_on_its_weights():
    """The port's forward with the JAX ``_flagship()``'s parameters and
    BatchNorm state against the JAX ``entry()``'s output, on the same
    example inputs (the port's are the JAX ones in NCHW, bit for bit)."""
    import __graft_entry__ as g

    jfn, jargs = g.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    _, params, bn_state = g._flagship()
    fn, args = entry(device="cpu", params=params, bn_state=bn_state)
    assert [tuple(a.shape) for a in args] == [(1, 1, 128, 128),
                                              (1, 3, 128, 128),
                                              (1, 15, 128, 128)]
    for a, ja in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(ja).transpose(0, 3, 1, 2))
    got = fn(*args)
    assert got.shape == (1, 1, 128, 128)
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=2e-5)


def test_entry_is_seeded_and_takes_the_card_by_default():
    fn, args = entry(device="cpu")
    fn2, args2 = entry(device="cpu")
    out = fn(*args)
    assert torch.isfinite(out).all() and out.shape == (1, 1, 128, 128)
    assert torch.equal(out, fn2(*args2))
    for a, b in zip(args, example_inputs(1, 128, 128)):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
