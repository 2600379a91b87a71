"""K4's plain version in the PyTorch port vs the TPU probe's Pallas kernel,
on the CPU.

``scripts/bench_pallas_conv.py::pallas_conv_same`` runs in interpret mode
here (its own CPU route). The same numpy inputs go through it and through
``jspsr_torch.ops.conv_same``: fp32 and bf16, kk 1 and 3, and a ragged H
(the Pallas kernel needs H % bh == 0, so it runs those with bh = H; the
port's kernel takes any H). fp32 agrees at rtol 1e-5 (the same products,
summed in another order); bf16 within one bf16 rounding step (2^-7
relative), since both round an fp32 sum of exact bf16 products and the
sums' order may tip a rounding. On CPU tensors the wrapper is the plain
version, and it launches nothing.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jspsr_torch.ops import conv_same as K4
from jspsr_torch.scripts import bench_conv_same

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "bench_pallas_conv.py"


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("bench_pallas_conv", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(b, h, w, cin, cout, kk, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, w, cin)).astype(np.float32),
            rng.normal(0, 0.2, (kk, kk, cin, cout)).astype(np.float32))


# (B, H, W, Cin, Cout, kk, bh): the Pallas kernel's row block bh divides H
CASES = [(2, 16, 16, 8, 4, 3, 8), (2, 16, 16, 8, 4, 1, 8),
         (1, 13, 11, 8, 16, 3, 13), (1, 13, 11, 16, 8, 1, 13)]


@pytest.mark.parametrize("b,h,w,cin,cout,kk,bh", CASES)
def test_plain_matches_pallas_fp32(probe, b, h, w, cin, cout, kk, bh):
    x, wt = _inputs(b, h, w, cin, cout, kk)
    ref = np.asarray(probe.pallas_conv_same(jnp.asarray(x), jnp.asarray(wt),
                                            bh=bh, kk=kk))
    got = K4.conv_same_plain(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.dtype == torch.float32 and got.shape == (b, h, w, cout)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout,kk,bh", CASES)
def test_plain_matches_pallas_bf16(probe, b, h, w, cin, cout, kk, bh):
    x, wt = _inputs(b, h, w, cin, cout, kk, seed=1)
    xj, wj = (jnp.asarray(a, jnp.bfloat16) for a in (x, wt))
    ref = np.asarray(probe.pallas_conv_same(xj, wj, bh=bh, kk=kk)
                     .astype(jnp.float32))
    xt, wtt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, wt))
    got = K4.conv_same_plain(xt, wtt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2**-7,
                               atol=1e-3)


def test_plain_matches_the_probes_xla_conv(probe):
    """A 5x5 kernel too (the plain version takes any odd kk; the CUDA
    kernel only 1 and 3)."""
    x, wt = _inputs(2, 12, 10, 4, 6, 5, seed=2)
    ref = np.asarray(probe.xla_conv(jnp.asarray(x), jnp.asarray(wt)))
    got = K4.conv_same_plain(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_the_plain_version(dtype):
    x, wt = (torch.from_numpy(a).to(dtype)
             for a in _inputs(2, 9, 7, 16, 16, 3, seed=3))
    before = dict(K4.LAUNCHES)
    got = K4.conv_same(x, wt)
    assert K4.LAUNCHES == before
    torch.testing.assert_close(got, K4.conv_same_plain(x, wt), rtol=0,
                               atol=0)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 8, 8), (3, 3, 8, 4)),        # x not NHWC
    ((1, 8, 8, 16), (2, 2, 16, 4)),   # even kk
    ((1, 8, 8, 16), (3, 3, 7, 4)),    # Cin mismatch
    ((1, 8, 8, 16), (3, 1, 16, 4)),   # not square
])
def test_wrapper_refuses_bad_shapes(x_shape, w_shape):
    with pytest.raises(ValueError):
        K4.conv_same(torch.zeros(x_shape), torch.zeros(w_shape))


def test_probe_port_reference_wiring_on_cpu():
    """The probe's port feeds cuDNN a channels-last NCHW view of the same
    NHWC bytes and OIHW weights; on the CPU that conv equals the plain
    version, and its numerics check passes at the probe's tolerance."""
    x, w1, wb = bench_conv_same.case_inputs(2, 10, 12, 8, 16, 3,
                                            torch.float32, "cpu")
    assert wb.shape == (1, 1, 16, 8)
    ref = bench_conv_same.cudnn_conv(x, bench_conv_same.oihw(w1))
    torch.testing.assert_close(ref, K4.conv_same_plain(x, w1), rtol=1e-5,
                               atol=1e-5)
    row = bench_conv_same.check_numerics(x, w1)
    assert row["max_abs_err"] <= 1e-4 * max(1.0, row["ref_max_abs"])
    assert [c[0] for c in bench_conv_same.CASES] == [
        "stage1_64ch_bf16", "stage1_64ch_fp32", "gen_32to64_bf16",
        "gen_64to32_bf16"]


def test_probe_port_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_conv_same.main([])


# The bf16 kernel's launch plan (``plan_bf16``), over every shape its
# wrapper accepts: Cin and Cout multiples of 16 up to 128, kk 1 and 3.
BF16_CHANNELS = range(16, K4.MAX_CHANNELS + 1, 16)


def _bf16_smem(cin, cout, kk, stages):
    """Shared memory of a block that keeps ``cout`` channels' weights beside
    ``stages`` halo stages (alignment slack, mbarriers, ring, weights,
    staging)."""
    halo = (K4.BF16_ROWS + kk - 1) * (K4.BF16_TILE_W + kk - 1) * 16
    pitch = -(-halo // 128) * 128
    return 128 + 128 + stages * (cin // 8) * pitch \
        + kk * kk * cin * cout * 2 + K4.BF16_WARPS * 16 * (2 * cout + 16)


@pytest.mark.parametrize("kk", [1, 3])
@pytest.mark.parametrize("cin", BF16_CHANNELS)
def test_bf16_plan_fits_shared_memory(cin, kk):
    """For every Cout: the slices cover Cout in multiples of 16, the layout
    (mbarriers, ring, weights, staging, in that order, 128-byte aligned
    where TMA and the descriptors need it) fits the 232,448 bytes a block
    may have, the ring has two to four stages unless not even a 16-channel
    slice leaves room for two (then one), and the weights stay whole
    wherever they fit beside that ring."""
    least = 2 if _bf16_smem(cin, 16, kk, 2) <= K4.SMEM_LIMIT else 1
    assert least == 2 or (cin, kk) == (128, 3)
    for cout in BF16_CHANNELS:
        p = K4.plan_bf16(16, 128, 128, cin, cout, kk, n_sms=132)
        assert p.ns * p.n_split == cout and p.ns % 16 == 0
        assert least <= p.stages <= K4.MAX_STAGES
        halo = (K4.BF16_ROWS + kk - 1) * (K4.BF16_TILE_W + kk - 1) * 16
        assert p.pitch >= halo and p.pitch % 128 == 0
        assert p.ring >= 2 * 8 * p.stages and p.ring % 128 == 0
        assert p.weights >= p.ring + p.stages * (cin // 8) * p.pitch
        assert p.staging >= p.weights + kk * kk * cin * p.ns * 2
        assert p.weights % 128 == 0 and p.staging % 128 == 0
        staging = K4.BF16_WARPS * 16 * (2 * p.ns + 16)
        assert 128 + p.staging + staging <= p.smem <= K4.SMEM_LIMIT
        assert p.smem == _bf16_smem(cin, p.ns, kk, p.stages)
        whole = _bf16_smem(cin, cout, kk, least) <= K4.SMEM_LIMIT
        assert (p.n_split == 1) == whole


@pytest.mark.parametrize("b,h,w,cin,cout,kk,n_sms", [
    (16, 128, 128, 64, 64, 3, 132),   # the probe's shape
    (1, 300, 128, 32, 32, 3, 132),    # a ragged last round
    (2, 9, 130, 128, 128, 3, 132),    # Cout in 4 slices, W % 64 != 0
    (1, 5, 70, 128, 112, 3, 132),     # 7 slices
    (2, 1, 37, 16, 16, 1, 132),       # H = 1
    (3, 7, 65, 16, 32, 3, 5),         # fewer SMs than tiles
    (1, 2, 64, 16, 128, 1, 3),        # fewer SMs than slices would want
])
def test_bf16_plan_tiles_cover_each_output_once(b, h, w, cin, cout, kk,
                                                n_sms):
    """The schedule in ``PlanBf16``'s docstring, as the kernel walks it:
    every output pixel of every Cout slice is written by exactly one
    (block, tile, row), and no block is idle."""
    p = K4.plan_bf16(b, h, w, cin, cout, kk, n_sms)
    assert p.grid % p.n_split == 0 and p.grid <= max(n_sms, p.n_split)
    count = np.zeros((p.n_split, b, h, w), np.int64)
    step = p.grid // p.n_split
    for block in range(p.grid):
        s, first = block % p.n_split, block // p.n_split
        tiles = range(first, p.n_tiles, step)
        assert len(tiles) > 0
        for t in tiles:
            tx, ty, bi = t % p.tiles_x, t // p.tiles_x % p.tiles_y, \
                t // (p.tiles_x * p.tiles_y)
            for row in range(K4.BF16_ROWS):
                y = K4.BF16_ROWS * ty + row
                x0 = K4.BF16_TILE_W * tx
                if y < h:
                    count[s, bi, y, x0:x0 + K4.BF16_TILE_W] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dtype,shape,match", [
    (torch.bfloat16, (1, 8, 8, 8, 16, 3), "multiple of 16"),
    (torch.bfloat16, (1, 8, 8, 16, 24, 3), "multiple of 16"),
    (torch.bfloat16, (1, 8, 8, 144, 16, 3), "multiple of 16"),
    (torch.float32, (1, 8, 8, 16, 12, 3), "multiple of 8"),
    (torch.float32, (1, 8, 8, 129, 16, 3), r"Cin in \[1, 128\]"),
    (torch.float32, (1, 8, 8, 16, 16, 5), "kk must be 1 or 3"),
    (torch.bfloat16, (2**16, 256, 128, 16, 16, 3), "fewer than 2"),
    (torch.float32, (1, 2**16, 2**15, 4, 8, 1), "fewer than 2"),
])
def test_kernel_shape_refusals(dtype, shape, match):
    """What the CUDA kernels do not take raises before any launch; B*H*W
    of 2^31 or more is new (the kernels index pixels in 32 bits and the
    bf16 grid is persistent, so the batch is no longer capped at 65535)."""
    with pytest.raises(ValueError, match=match):
        K4.check_kernel_shape(dtype, *shape)


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (70000, 4, 4, 16, 16, 3)),
    (torch.bfloat16, (1, 1, 1, 128, 128, 1)),
    (torch.float32, (1, 5, 5, 3, 24, 1)),
    (torch.float32, (70000, 4, 4, 1, 8, 3)),
])
def test_kernel_shape_accepts(dtype, shape):
    K4.check_kernel_shape(dtype, *shape)


def test_kernel_profile_needs_cuda(monkeypatch):
    from jspsr_torch.scripts import profile_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_kernels.main([])
