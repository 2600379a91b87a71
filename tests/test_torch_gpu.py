"""Legs of the PyTorch port that need a CUDA card; each skips without one.

This file imports neither jax nor jspsr_tpu. The repo's tests/conftest.py
imports jax and the pytest settings ask for xdist, so the command below
runs it on any GPU host, with or without either:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from jspsr_torch.losses import build_criterion
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)
from jspsr_torch.train.step import make_train_step
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
    launches = deform_cuda.LAUNCHES["deform_fwd"]
    with torch.inference_mode():
        got = deform_conv2d(*args)
        ref = deform_conv2d_plain(*args)
    torch.cuda.synchronize()
    assert deform_cuda.LAUNCHES["deform_fwd"] == launches + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,scale", CASES)
def test_backward_kernel_matches_plain(cuda_device, b, h, w, scale):
    """d_offset and d_mask: the same fp32 arithmetic per element. d_weight
    sums b*h*w terms in another order (warp, block, then the partials): its
    error is held to 1e-5 of the sum of the terms' magnitudes, bounded by
    the same backward on |x|, |mask| and |g|."""
    x, offset, weight, _, mask = _args(b, h, w, scale, cuda_device)
    g = torch.randn(b, 1, h, w, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda_device)
    launches = deform_cuda.LAUNCHES["deform_bwd"]
    got = deform_cuda.deform_bwd(x, offset, weight, mask, g)
    ref = deform_conv2d_backward_plain(x, offset, weight, mask, g)
    scale_w = deform_conv2d_backward_plain(x.abs(), offset, weight, mask.abs(),
                                           g.abs())[2]
    torch.cuda.synchronize()
    assert deform_cuda.LAUNCHES["deform_bwd"] == launches + 1
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    assert ((got[2] - ref[2]).abs() <= 1e-5 * scale_w + 1e-6).all()
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-4)


def test_function_grads_on_gpu_match_cpu(cuda_device):
    args = _args(2, 24, 20, 1.5, "cpu")
    g = torch.randn(2, 1, 24, 20, generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().clone().to(dev).requires_grad_(i > 0)
                  for i, t in enumerate(args)]
        launches = dict(deform_cuda.LAUNCHES)
        deform_conv2d(*leaves).backward(g.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in leaves[1:]]
        if dev != "cpu":
            assert deform_cuda.LAUNCHES["deform_fwd"] == \
                launches["deform_fwd"] + 1
            assert deform_cuda.LAUNCHES["deform_bwd"] == \
                launches["deform_bwd"] + 1
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


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
    deform_conv2d(x, offset, weight, bias, mask).sum().backward()
    assert offset.grad is not None and offset.grad.is_cuda
    out = deform_conv2d(x.requires_grad_(True), offset, weight, bias, mask)
    with pytest.raises(NotImplementedError, match="K3"):
        out.sum().backward()


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
        launches = deform_cuda.LAUNCHES["deform_fwd"]
        got = port.to(cuda_device)([x.to(cuda_device) for x in inputs])
    assert deform_cuda.LAUNCHES["deform_fwd"] == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(),
                               rtol=1e-4, atol=2e-5)


def _rel_err(got, ref):
    """Relative L2 error of one tensor (absolute where ``ref`` is 0)."""
    diff = (got.double() - ref.double()).norm()
    return float(diff / max(float(ref.double().norm()), 1e-12))


def test_jspsr_train_step_on_gpu_matches_cpu(cuda_device):
    """One train step (BatchNorm in train mode, L1 + L2 + 0.1 Grad, AdamW)
    from the same weights and batch: loss, every gradient and the running
    statistics on the card against the CPU, each within 1e-3 relative
    L2 error (cuDNN and the CPU take other conv algorithms, and train-mode
    BatchNorm backward amplifies their rounding)."""
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    rng = np.random.default_rng(6)
    inputs = [torch.from_numpy(rng.uniform(0.05, 0.95, (2, c, 32, 32))
                               .astype(np.float32))
              for c in in_channels.values()]
    gt = torch.from_numpy(rng.uniform(0.05, 0.95, (2, 1, 32, 32))
                          .astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        model = JSPSR(dict(in_channels), num_feature=8,
                      layers=(1, 1, 1, 1)).to(dev)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-6, eps=1e-8)
        step = make_train_step(model, build_criterion(
            {"L1": 1, "L2": 1, "Grad": 0.1}), opt)
        launches = dict(deform_cuda.LAUNCHES)
        losses = step([x.to(dev) for x in inputs], gt.to(dev))
        if dev != "cpu":
            assert {k: deform_cuda.LAUNCHES[k] - launches[k]
                    for k in launches} == {"deform_fwd": 1, "deform_bwd": 1}
        out[str(dev)] = (
            float(losses["Total"]),
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in model.named_buffers()
             if "running" in n})
    (l_gpu, g_gpu, bn_gpu), (l_cpu, g_cpu, bn_cpu) = out[str(cuda_device)], \
        out["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for name in g_cpu:
        assert _rel_err(g_gpu[name], g_cpu[name]) < 1e-3, name
    for name in bn_cpu:
        assert _rel_err(bn_gpu[name], bn_cpu[name]) < 1e-4, name
