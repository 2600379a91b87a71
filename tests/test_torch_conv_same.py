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
