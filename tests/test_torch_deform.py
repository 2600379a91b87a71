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


def _fwd_window_brute(off, h, w, tile, margin, pad=1):
    """K1's reads walked pixel by pixel, tap by tap, in float32 as the
    kernel computes positions: a tap whose four corners lie in its tile's
    window reads them there, any other tap reads its in-image corners from
    global memory."""
    b = off.shape[0]
    th, tw = tile
    win_h, win_w = deform_cuda.fwd_window_shape(tile, margin)
    counts = {"taps": 0, "window_taps": 0, "window": 0, "global": 0,
              "corners": 0}
    for bi in range(b):
        for y in range(h):
            for x in range(w):
                wy0, wx0 = deform_cuda.fwd_window_origin(y, x, pad, tile,
                                                         margin)
                for t in range(9):
                    py = np.float32(y - pad + t // 3) + off[bi, 2 * t, y, x]
                    px = np.float32(x - pad + t % 3) + off[bi, 2 * t + 1, y, x]
                    y0, x0 = int(np.floor(py)), int(np.floor(px))
                    in_image = sum(0 <= yc < h and 0 <= xc < w
                                   for yc, xc in ((y0, x0), (y0, x0 + 1),
                                                  (y0 + 1, x0),
                                                  (y0 + 1, x0 + 1)))
                    counts["taps"] += 1
                    counts["corners"] += in_image
                    if (0 <= y0 - wy0 and y0 + 1 - wy0 < win_h
                            and 0 <= x0 - wx0 and x0 + 1 - wx0 < win_w):
                        counts["window_taps"] += 1
                        counts["window"] += 4
                    else:
                        counts["global"] += in_image
    return counts


@pytest.mark.parametrize("scale", [0.0, 1.5, 5.0, 20.0])
@pytest.mark.parametrize("b,h,w,tile,margin", [
    (2, 13, 20, deform_cuda.FWD_TILE, deform_cuda.FWD_MARGIN),
    (1, 19, 37, (4, 8), 2),
])
def test_fwd_window_matches_brute_force(b, h, w, tile, margin, scale):
    """``deform_cuda.fwd_window`` against a loop over every tap, on tiles
    that divide neither H nor W (taps at the image edge, in the margin,
    across the window's edge and, at 20 px, off the image)."""
    rng = np.random.default_rng(int(scale * 10) + h)
    off = (rng.normal(size=(b, 18, h, w)) * scale).astype(np.float32)
    got = deform_cuda.fwd_window(torch.from_numpy(off), h, w, tile=tile,
                                 margin=margin)
    assert got == _fwd_window_brute(off, h, w, tile, margin)
    if scale == 0.0:  # every tap within a pixel of its own: all in window
        assert got["window_taps"] == got["taps"] and got["global"] == 0


def test_fwd_window_shape_holds_every_tap_within_the_margin():
    """The window is the tile plus the taps' reach plus the margin, its
    left edge on a 16-byte group: 15 x 80 floats around a 4 x 64 tile."""
    assert deform_cuda.fwd_window_shape() == (15, 80)
    for x in range(0, 256, 64):
        for pad in (0, 1, 2):
            wx0 = deform_cuda.fwd_window_origin(0, x, pad)[1]
            assert wx0 % 4 == 0 and x - pad - 7 <= wx0 <= x - pad - 4
    off = torch.full((1, 18, 16, 128), float(deform_cuda.FWD_MARGIN))
    for sign in (1.0, -1.0):
        got = deform_cuda.fwd_window(sign * off, 16, 128)
        assert got["window_taps"] == got["taps"]


def test_build_hash_covers_every_kernel_source(tmp_path, monkeypatch):
    """Every library's path hashes every source under ``csrc/``, headers
    included: an edited shared header rebuilds K1 and K4, and a stale
    library is never loaded."""
    from jspsr_torch.ops import cuda_build

    for src in cuda_build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert {p.name for p in cuda_build.sources()} >= {
        "tma.cuh", "deform_fwd.cu", "conv_same_bf16.cu"}
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert {n: cuda_build.library_path(n)
            for n in cuda_build.SOURCES} == before
    header = tmp_path / "tma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert all(after[n] != before[n] for n in cuda_build.SOURCES)
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert cuda_build.library_path("deform_fwd") != after["deform_fwd"]
