"""Legs of the PyTorch port that need a CUDA card; each skips without one.

This file imports neither jax nor jspsr_tpu. The repo's tests/conftest.py
imports jax and the pytest settings ask for xdist, so the command below
runs it on any GPU host, with or without either:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import deform_conv2d, deform_conv2d_plain
from jspsr_torch.utils.device import set_strict_fp32

pytestmark = pytest.mark.gpu

# (batch, H, W, offset scale): integer positions, sub-pixel, far off the
# image, a width that is not a multiple of the block, and a served scene
CASES = [(2, 16, 16, 0.0), (2, 16, 16, 1.5), (2, 16, 16, 20.0),
         (1, 12, 20, 2.0), (1, 336, 336, 1.5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_strict_fp32()
    return torch.device("cuda")


def _args(b, h, w, scale, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 1, h, w, generator=g)
    offset = torch.randn(b, 18, h, w, generator=g) * scale
    aff = torch.rand(b, 9, h, w, generator=g)
    mask = aff - aff.mean(dim=1, keepdim=True)  # zero-sum, signed
    weight = torch.randn(1, 1, 3, 3, generator=g)
    bias = torch.randn(1, generator=g)
    return [t.to(device) for t in (x, offset, weight, bias, mask)]


@pytest.mark.parametrize("b,h,w,scale", CASES)
def test_kernel_matches_plain(cuda_device, b, h, w, scale):
    """Same fp32 arithmetic, only the order of the 9-term sum differs."""
    args = _args(b, h, w, scale, cuda_device)
    launches = deform_cuda.LAUNCHES
    with torch.inference_mode():
        got = deform_conv2d(*args)
        ref = deform_conv2d_plain(*args)
    torch.cuda.synchronize()
    assert deform_cuda.LAUNCHES == launches + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x, offset, weight, bias, mask = _args(1, 8, 8, 1.0, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        deform_conv2d(x.double(), offset, weight, bias, mask)
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv2d(x, offset.transpose(2, 3).contiguous().transpose(2, 3),
                      weight, bias, mask)
    with pytest.raises(ValueError, match="must be on"):
        deform_conv2d(x, offset, weight.cpu(), bias, mask)
    offset.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        deform_conv2d(x, offset, weight, bias, mask)


def test_jspsr_on_gpu_matches_cpu(cuda_device):
    """The card's forward (deform kernel, TF32 off) against the CPU's
    (plain deform) on the same weights."""
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    port = JSPSR(dict(in_channels), num_feature=8, layers=(1, 1, 1, 1)).eval()
    rng = np.random.default_rng(5)
    inputs = [torch.from_numpy(rng.uniform(0.05, 0.95, (2, c, 40, 48))
                               .astype(np.float32))
              for c in in_channels.values()]
    with torch.inference_mode():
        ref = port(inputs)
        launches = deform_cuda.LAUNCHES
        got = port.to(cuda_device)([x.to(cuda_device) for x in inputs])
    assert deform_cuda.LAUNCHES == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                               rtol=1e-4, atol=2e-5)
