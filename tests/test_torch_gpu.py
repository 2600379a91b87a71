"""Legs of the PyTorch port that need a CUDA card; each skips without one.

This file imports neither jax nor jspsr_tpu. The repo's tests/conftest.py
imports jax and the pytest settings ask for xdist, so the command below
runs it on any GPU host, with or without either:

    python -m pytest --noconftest -o addopts="" tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval.inference import load_scene
from jspsr_torch.eval.scene import tile_inference_device
from jspsr_torch.eval.serve import discover_scenes, serve_scenes
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.completionformer import CompletionFormer
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.ops import conv_same as K4
from jspsr_torch.ops import deform_cuda
from jspsr_torch.ops.deform_conv import (
    deform_conv2d,
    deform_conv2d_backward_plain,
    deform_conv2d_plain,
)
from jspsr_torch.train.step import make_train_step
from jspsr_torch.utils.device import set_deterministic_cudnn, set_strict_fp32
from jspsr_torch.utils.perturb import perturb_weights

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


# K1's load paths: sides its 4 x 64 tile does not divide, one smaller
# than a tile (TMA), W % 4 != 0 (the copy path), at integer positions,
# sub-pixel offsets and far off the image
K1_PATH_CASES = [(b, h, w, scale) for b, h, w in ((2, 13, 20), (1, 333, 335),
                                                  (2, 13, 21))
                 for scale in (0.0, 1.5, 20.0)]


@pytest.mark.parametrize("b,h,w,scale", K1_PATH_CASES)
def test_kernel_load_paths_match_plain(cuda_device, b, h, w, scale):
    """A row pitch that is a multiple of 16 bytes takes TMA, any other the
    copy path; both hold the plain version as the main shapes do."""
    args = _args(b, h, w, scale, cuda_device)
    assert deform_cuda.fwd_path(args[0], args[1], args[4]) == \
        ("tma" if w % 4 == 0 else "copy")
    with torch.inference_mode():
        got = deform_cuda.deform_fwd(*args)
        ref = deform_conv2d_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_kernel_misaligned_base_takes_the_copy_path(cuda_device):
    """A contiguous view whose base is not 16-byte aligned cannot have a
    tensor map: it takes the copy path and gives the same result."""
    x, offset, weight, bias, mask = _args(2, 16, 128, 1.5, cuda_device)
    moved = torch.empty(offset.numel() + 1, device=cuda_device)[1:]
    moved = moved.view_as(offset).copy_(offset)
    assert deform_cuda.fwd_path(x, offset, mask) == "tma"
    assert deform_cuda.fwd_path(x, moved, mask) == "copy"
    with torch.inference_mode():
        got = deform_cuda.deform_fwd(x, moved, weight, bias, mask)
        ref = deform_cuda.deform_fwd(x, offset, weight, bias, mask)
    torch.cuda.synchronize()
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


# K3 at NLSPN's shapes: a narrow odd width, integer positions (NLSPN's
# zero-offset init) and the CompletionFormer train batch far off the image;
# then the window scatter's edges on tiles (8 x 32) that divide neither H
# nor W: corners in the 4-pixel margin (1.5 px), across the window's edge
# (3 and 5 px) and off the image (20 px)
DX_CASES = [(1, 12, 20, 2.0), (2, 32, 32, 0.0), (16, 128, 128, 20.0),
            (1, 7, 130, 1.5), (1, 7, 130, 3.0), (3, 33, 65, 1.5),
            (3, 33, 65, 5.0), (3, 33, 65, 20.0)]


@pytest.mark.parametrize("b,h,w,scale", DX_CASES)
def test_backward_dx_kernel_matches_plain(cuda_device, b, h, w, scale):
    """K3: d_offset and d_mask as K2's; d_x is summed in fixed point, in
    another order than the plain version's float sum, so its error is held
    to 1e-5 of the sum of its terms' magnitudes (the same scatter on
    |g w m|), as d_weight's is; a second launch on the same inputs gives
    every output bit for bit."""
    x, offset, weight, _, mask = _args(b, h, w, scale, cuda_device)
    g = torch.randn(b, 1, h, w, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda_device)
    launches = dict(deform_cuda.LAUNCHES)
    got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    torch.cuda.synchronize()
    assert {k: deform_cuda.LAUNCHES[k] - launches[k] for k in launches} == \
        {"deform_fwd": 0, "deform_bwd": 0, "deform_bwd_dx": 1}
    again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    launches = dict(deform_cuda.LAUNCHES)
    ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                       need_dx=True)
    abs_sum = deform_conv2d_backward_plain(x.abs(), offset, weight.abs(),
                                           mask.abs(), g.abs(), need_dx=True)
    torch.cuda.synchronize()
    assert ref[4].abs().max() > 0
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    assert ((got[2] - ref[2]).abs() <= 1e-5 * abs_sum[2] + 1e-6).all()
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-4)
    assert ((got[4] - ref[4]).abs() <= 1e-5 * abs_sum[4] + 1e-7).all()


def test_input_grad_on_gpu_matches_cpu(cuda_device):
    """Every gradient of the Function, x included, on the card (K1, K3)
    against the CPU (the plain versions)."""
    args = _args(2, 24, 20, 1.5, "cpu", seed=4)
    g = torch.randn(2, 1, 24, 20, generator=torch.Generator().manual_seed(4))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().clone().to(dev).requires_grad_(True)
                  for t in args]
        deform_conv2d(*leaves).backward(g.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


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
    # an input that needs its gradient takes the other backward kernel
    launches = dict(deform_cuda.LAUNCHES)
    x.requires_grad_(True)
    deform_conv2d(x, offset, weight, bias, mask).sum().backward()
    assert x.grad is not None and x.grad.is_cuda
    assert deform_cuda.LAUNCHES["deform_bwd_dx"] == \
        launches["deform_bwd_dx"] + 1
    assert deform_cuda.LAUNCHES["deform_bwd"] == launches["deform_bwd"]


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
                    for k in launches} == {"deform_fwd": 1, "deform_bwd": 1,
                                           "deform_bwd_dx": 0}
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


def test_jspsr_train_step_is_bit_reproducible(cuda_device):
    """With cuDNN held to deterministic algorithms (the Trainer's
    ``set_deterministic_cudnn``), K1 and K2 free of atomics and the Grad
    loss's padding built from slices, one JSPSR step from the same state
    and batch gives bit-equal weights, optimizer moments and BatchNorm
    statistics."""
    set_deterministic_cudnn()
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    rng = np.random.default_rng(7)
    inputs = [torch.from_numpy(rng.uniform(0.05, 0.95, (4, c, 64, 64))
                               .astype(np.float32)).to(cuda_device)
              for c in in_channels.values()]
    gt = torch.from_numpy(rng.uniform(0.05, 0.95, (4, 1, 64, 64))
                          .astype(np.float32)).to(cuda_device)
    state = JSPSR(dict(in_channels), num_feature=8,
                  layers=(1, 1, 1, 1)).state_dict()
    after = []
    for _ in range(2):
        model = JSPSR(dict(in_channels), num_feature=8, layers=(1, 1, 1, 1))
        model.load_state_dict(state)
        model = model.to(cuda_device)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        make_train_step(model, build_criterion(
            {"L1": 1, "L2": 1, "Grad": 0.1}), opt)(inputs, gt)
        torch.cuda.synchronize()
        after.append({**{n: t.detach().clone() for n, t in
                         [*model.named_parameters(),
                          *model.named_buffers()]},
                      **{f"exp_avg_sq.{i}": opt.state[q]["exp_avg_sq"]
                         for i, q in enumerate(model.parameters())}})
    unequal = [n for n in after[0] if not torch.equal(after[0][n],
                                                      after[1][n])]
    assert not unequal


CF_INPUTS = {"lr_dem": 1, "image": 3, "mask": 15}


@pytest.fixture(scope="module")
def completionformer():
    """The config's CompletionFormer at its fixed widths (83.7 M
    parameters), seeded, with BatchNorm statistics and NLSPN's
    offset/affinity conv perturbed away from their init (at the zero init
    the propagation is the identity and K3's d_x is trivial)."""
    model = perturb_weights(CompletionFormer(
        dict(CF_INPUTS), generator=torch.Generator().manual_seed(0)), seed=1)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _cf(state, device, dtype=torch.float32):
    model = CompletionFormer(dict(CF_INPUTS))
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype)


def _cf_batch(b, side, seed):
    rng = np.random.default_rng(seed)
    dem = rng.uniform(0.2, 0.8, (b, 1, side, side))
    guide = rng.uniform(0, 1, (b, 18, side, side))
    gt = dem + rng.normal(0, 0.02, dem.shape)
    return [torch.from_numpy(a) for a in (dem, guide)], torch.from_numpy(gt)


def test_completionformer_on_gpu_matches_cpu(cuda_device, completionformer):
    """The eval forward at 1 x 64²: 6 K1 launches on the card, and the
    JAX suite's CompletionFormer tolerance (rtol 1e-3 / atol 1e-4), set for
    outputs in a scaled DEM's [0, 1]; atol scales with the output's
    largest magnitude, which random weights put near 10 (as in
    ``chip_smoke.py``'s serving check)."""
    inputs, _ = _cf_batch(1, 64, seed=7)
    out = {}
    for dev in ("cpu", cuda_device):
        model = _cf(completionformer, dev).eval()
        launches = dict(deform_cuda.LAUNCHES)
        with torch.inference_mode():
            out[str(dev)] = model([x.float().to(dev) for x in inputs]).cpu()
        if dev != "cpu":
            assert {k: deform_cuda.LAUNCHES[k] - launches[k]
                    for k in launches} == {"deform_fwd": 6, "deform_bwd": 0,
                                           "deform_bwd_dx": 0}
    ref = out["cpu"].numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out[str(cuda_device)].numpy(), ref, rtol=1e-3,
                               atol=1e-4 * scale, err_msg=f"scale {scale}")


def test_completionformer_train_step_on_gpu_matches_cpu(cuda_device,
                                                        completionformer):
    """One train-mode forward and backward at 2 x 64² (L1 + L2 + 0.1 Grad),
    no drop path: 6 K1 and 6 K3 launches on the card, none of K2. The fp32
    step is ill-conditioned (the CPU's own fp32 gradients are percents from
    float64 on some tensors), so each gradient and running statistic of
    the card may be three times as far from float64 (relative L2) as the
    CPU's fp32 one, plus 5e-3; the loss within rtol 1e-4 of the CPU's."""
    inputs, gt = _cf_batch(2, 64, seed=8)
    crit = build_criterion({"L1": 1, "L2": 1, "Grad": 0.1})
    out = {}
    for key, dev, dtype in (("cpu", "cpu", torch.float32),
                            ("f64", "cpu", torch.float64),
                            ("card", cuda_device, torch.float32)):
        model = _cf(completionformer, dev, dtype).train()
        launches = dict(deform_cuda.LAUNCHES)
        loss = crit(model([x.to(dev, dtype) for x in inputs]),
                    gt.to(dev, dtype))["Total"]
        loss.backward()
        if key == "card":
            assert {k: deform_cuda.LAUNCHES[k] - launches[k]
                    for k in launches} == {"deform_fwd": 6, "deform_bwd": 0,
                                           "deform_bwd_dx": 6}
        out[key] = (loss.item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None},
                    {n: b.cpu() for n, b in model.named_buffers()
                     if "running" in n})
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for i in (1, 2):
        assert set(out["card"][i]) == set(out["f64"][i])
        for name, ref in out["f64"][i].items():
            e_card = _rel_err(out["card"][i][name], ref)
            e_cpu = _rel_err(out["cpu"][i][name], ref)
            assert e_card <= 3 * e_cpu + 5e-3, (name, e_card, e_cpu)


@pytest.mark.parametrize("mode,size", [("bilinear", (37, 53)),
                                       ("bilinear_ac", (64, 64)),
                                       ("bicubic", (96, 80))])
def test_resize_backward_and_k3_are_bit_reproducible(cuda_device, mode,
                                                     size):
    """The resize's backward (two transposed matrix products) and K3 (d_x
    in fixed point) give the same bits on every launch: the two sums that
    made a CompletionFormer step differ from run to run."""
    from jspsr_torch.nn.layers import bicubic_resize, bilinear_resize

    x = torch.randn(4, 8, 32, 32, generator=torch.Generator().manual_seed(5))
    g = torch.randn(4, 8, *size, generator=torch.Generator().manual_seed(6))
    grads = []
    for _ in range(2):
        leaf = x.to(cuda_device).requires_grad_(True)
        y = (bicubic_resize(leaf, *size) if mode == "bicubic" else
             bilinear_resize(leaf, *size, align_corners=mode.endswith("ac")))
        y.backward(g.to(cuda_device))
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])

    x, offset, weight, _, mask = _args(16, 128, 128, 1.5, cuda_device)
    g = torch.randn(16, 1, 128, 128,
                    generator=torch.Generator().manual_seed(7)).to(cuda_device)
    first = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    second = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,factor", [(16, 1e4), (16, 1e6), (2, 1e6)])
def test_backward_dx_kernel_heavy_tailed_gradient(cuda_device, b, factor):
    """K3 with a g whose 4 largest entries are ``factor`` times the rest:
    they set their images' fixed-point scale, and d_x still holds 1e-5 of
    the sum of its terms' magnitudes against the plain backward, as
    without them, bit-equal across two launches. (A reference in float64
    would differ from both by the fp32 rounding of the sample positions.)"""
    x, offset, weight, _, mask = _args(b, 128, 128, 20.0, cuda_device)
    gen = torch.Generator().manual_seed(11)
    g = torch.randn(b, 1, 128, 128, generator=gen)
    g.view(-1)[torch.randint(0, g.numel(), (4,), generator=gen)] *= factor
    g = g.to(cuda_device)
    got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    again = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                       need_dx=True)[4]
    abs_sum = deform_conv2d_backward_plain(x.abs(), offset, weight.abs(),
                                           mask.abs(), g.abs(),
                                           need_dx=True)[4]
    assert ((got[4] - ref).abs() <= 1e-5 * abs_sum + 1e-7).all()


def test_completionformer_train_step_is_bit_reproducible(cuda_device,
                                                         completionformer):
    """With cuDNN held to deterministic algorithms, K3's fixed-point d_x,
    the resizes' backward as matrix products and NLSPN's confidence
    sampling through sorted indexing, one train-mode forward and backward
    at 2 x 64² from the same state gives every gradient and BatchNorm
    statistic bit for bit. cuDNN's flags are process-wide: they are put
    back as they were for the legs after this one."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    set_deterministic_cudnn()
    try:
        inputs, gt = _cf_batch(2, 64, seed=9)
        crit = build_criterion({"L1": 1, "L2": 1, "Grad": 0.1})
        after = []
        for _ in range(2):
            model = _cf(completionformer, cuda_device).train()
            crit(model([x.float().to(cuda_device) for x in inputs]),
                 gt.float().to(cuda_device))["Total"].backward()
            torch.cuda.synchronize()
            after.append({**{n: q.grad for n, q in model.named_parameters()
                             if q.grad is not None},
                          **dict(model.named_buffers())})
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    unequal = [n for n in after[0] if not torch.equal(after[0][n],
                                                      after[1][n])]
    assert not unequal


# K4: the probe's four cases, kk 1, ragged H and W, and the widest channels;
# then the edges of the bf16 design (64-pixel rows, 2-row tiles, a
# persistent grid, Cout slices) and of the fp32 one (128-pixel tiles, Cin
# not a multiple of 4 or 16): W not a multiple of 64 (37, 130), H = 1, one
# image whose 300 tiles leave a ragged last round on 132 SMs, Cout in 7
# slices (128 -> 112) and in pieces of 64 + 16 (80), kk 1 in both types
K4_CASES = [(16, 128, 128, 64, 64, 3, torch.bfloat16),
            (16, 128, 128, 64, 64, 3, torch.float32),
            (16, 128, 128, 32, 64, 3, torch.bfloat16),
            (16, 128, 128, 64, 32, 3, torch.bfloat16),
            (2, 13, 37, 16, 16, 1, torch.bfloat16),
            (2, 13, 37, 8, 8, 3, torch.float32),
            (3, 21, 19, 32, 48, 3, torch.bfloat16),
            (1, 5, 5, 3, 24, 1, torch.float32),
            (2, 9, 130, 128, 128, 3, torch.bfloat16),
            (2, 9, 130, 128, 128, 3, torch.float32),
            (1, 6, 37, 64, 64, 3, torch.bfloat16),
            (1, 6, 37, 64, 64, 3, torch.float32),
            (2, 1, 64, 32, 32, 3, torch.bfloat16),
            (2, 1, 50, 12, 24, 3, torch.float32),
            (1, 300, 128, 32, 32, 3, torch.bfloat16),
            (1, 37, 41, 20, 16, 3, torch.float32),
            (1, 5, 70, 128, 112, 3, torch.bfloat16),
            (1, 4, 66, 48, 80, 3, torch.bfloat16),
            (1, 33, 70, 64, 64, 1, torch.bfloat16),
            (1, 33, 70, 64, 64, 1, torch.float32)]


@pytest.mark.parametrize("b,h,w,cin,cout,kk,dtype", K4_CASES)
def test_conv_same_kernel_matches_plain(cuda_device, b, h, w, cin, cout, kk,
                                        dtype):
    """The probe's tolerances (scripts/bench_pallas_conv.py:139-140): max
    |err| <= 0.03 (bf16) or 1e-4 (fp32) times max(1, max |plain|). Both
    sum exact products in fp32; in bf16 both round the sum once."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(b, h, w, cin, generator=g, device=cuda_device).to(dtype)
    wt = (torch.randn(kk, kk, cin, cout, generator=g, device=cuda_device)
          * 0.05).to(dtype)
    launches = K4.LAUNCHES["conv_same"]
    got = K4.conv_same(x, wt)
    ref = K4.conv_same_plain(x, wt)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["conv_same"] == launches + 1
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 0.03 if dtype == torch.bfloat16 else 1e-4
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


def test_conv_same_kernel_empty_input_launches_nothing(cuda_device):
    launches = K4.LAUNCHES["conv_same"]
    out = K4.conv_same(torch.zeros(0, 8, 8, 16, device=cuda_device),
                       torch.zeros(3, 3, 16, 16, device=cuda_device))
    assert out.shape == (0, 8, 8, 16)
    assert K4.LAUNCHES["conv_same"] == launches


def test_conv_same_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="kk must be 1 or 3"):
        K4.conv_same(x, torch.zeros(5, 5, 16, 16, device=cuda_device))
    with pytest.raises(TypeError, match="float32 or"):
        K4.conv_same(x.half(), torch.zeros(3, 3, 16, 16, device=cuda_device,
                                           dtype=torch.half))
    with pytest.raises(TypeError, match="float32 or"):
        K4.conv_same(x, torch.zeros(3, 3, 16, 16, device=cuda_device,
                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 16"):
        K4.conv_same(x[..., :8].contiguous().bfloat16(),
                     torch.zeros(3, 3, 8, 16, device=cuda_device,
                                 dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K4.conv_same(x.transpose(1, 2), torch.zeros(3, 3, 16, 16,
                                                    device=cuda_device))
    with pytest.raises(ValueError, match="must be on"):
        K4.conv_same(x, torch.zeros(3, 3, 16, 16))


TILED_P = {
    "model_name": "JSPSR", "relative": True, "normalize": False,
    "mask_channel": None, "patch_size": 64,
    "input_data": {"lr_dem": 1, "image": 3, "mask": 15},
    "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                      "scale_mask": True},
}


def _tiled_scenes(root, sizes, seed):
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        d = root / f"scene{i}"
        write_raster(d / "lr_dem.npy",
                     rng.uniform(10, 200, (h, w, 1)).astype(np.float32))
        write_raster(d / "image.npy",
                     rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        write_raster(d / "mask.npy", np.eye(15, dtype=np.uint8)[
            rng.integers(0, 15, (h, w))])
    return discover_scenes(root)


def _tiled_model():
    return perturb_weights(JSPSR(
        {"lr_dem": 1, "image": 3, "mask": 15}, num_feature=8,
        layers=(1, 1, 1, 1), generator=torch.Generator().manual_seed(9)),
        seed=10)


def test_tiled_scene_on_gpu_matches_cpu(cuda_device, tmp_path):
    """A rectangular scene (an exact grid down, a padded one across) with
    a bit-packed mask, device-tiled on the card (one K1 launch per chunk)
    against the CPU, in metres at rtol 1e-3 / atol 1e-2 m."""
    p = AttrDict(dict(TILED_P))
    (scene,) = _tiled_scenes(tmp_path, [(160, 200)], seed=1)
    sample, _ = load_scene(scene, p)
    model = _tiled_model()
    ref, _ = tile_inference_device(model, sample, p, tile=64, device="cpu")
    launches = deform_cuda.LAUNCHES["deform_fwd"]
    got, _ = tile_inference_device(model, sample, p, tile=64, cap=8,
                                   device=cuda_device)
    assert deform_cuda.LAUNCHES["deform_fwd"] == launches + 2  # 12 tiles
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-2)


def test_serve_on_gpu_matches_single_scene(cuda_device, tmp_path):
    """The pipelined server at scene_batch 2 (streams, pinned staging)
    against one scene at a time, at the JAX suite's tolerance between tile
    batch sizes (rtol 2e-4 / atol 5e-3 m)."""
    p = AttrDict(dict(TILED_P))
    scenes = _tiled_scenes(tmp_path / "batch", [(96, 96)] * 3 + [(130, 96)],
                           seed=2)
    model = _tiled_model().to(cuda_device)
    paths, _, sps = serve_scenes(model, p, scenes, tmp_path / "out",
                                 tile=64, scene_batch=2, device=cuda_device)
    assert sps > 0
    for scene, path in zip(scenes, paths):
        sample, _ = load_scene(scene, p)
        single, _ = tile_inference_device(model, sample, p, tile=64,
                                          device=cuda_device)
        np.testing.assert_allclose(read_raster(path), single, rtol=2e-4,
                                   atol=5e-3)


# EDSR with the SPN head and LRRU, at the shipped configs' widths
# (configs/edsr_r8_img.yml with spn: true, configs/lrru_r8_img.yml):
# K1 launches per forward, and K1 + K2 per train step
FAMILIES = {"edsr_spn": ("configs/edsr_r8_img.yml", 1),
            "lrru": ("configs/lrru_r8_img.yml", 4)}


def _family_model(name, state, device, dtype=torch.float32):
    from jspsr_torch.config.loader import create_config
    from jspsr_torch.models.factory import build_model

    p = create_config(FAMILIES[name][0])
    p.model_kwargs.spn = name == "edsr_spn"
    model = build_model(p, generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    return model.to(device=device, dtype=dtype)


def _family_batch(name, b, side, seed):
    """A DEM of smooth terrain with a tenth of its pixels 0 (where LRRU's
    rounds reach the output), an RGB image and the target; EDSR takes the
    two stacked."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    phase = rng.uniform(0, 6, (b, 1, 1, 1))
    dem = 0.5 + 0.3 * np.sin(3 * np.pi * xx + phase) * np.cos(2 * np.pi * yy)
    dem = np.where(rng.uniform(size=dem.shape) < 0.1, 0.0, dem)
    img = rng.uniform(0, 1, (b, 3, side, side))
    gt = dem + rng.normal(0, 0.02, dem.shape)
    inputs = [dem, img] if name == "lrru" else [np.concatenate([dem, img], 1)]
    return [torch.from_numpy(a) for a in inputs], torch.from_numpy(gt)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_and_step_on_gpu_match_cpu(cuda_device, name):
    """The eval forward at 1 x 64² against the CPU at the JAX suite's
    tolerances (EDSR rtol 1e-4 / atol 2e-5, LRRU rtol 1e-4 / atol 3e-5,
    atol times the output's largest magnitude, at least 1); then one
    train-mode forward and backward at 2 x 64² (L1 + L2 + 0.1 Grad) with
    exactly one K2 and no K3 (both detach the DEM), each gradient and
    running statistic of the card no further from float64 (relative L2)
    than three times the CPU's fp32 one plus 5e-3, as for
    CompletionFormer."""
    state = perturb_weights(_family_model(name, None, "cpu"), seed=1
                            ).state_dict()
    k1 = FAMILIES[name][1]
    inputs, gt = _family_batch(name, 1, 64, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        model = _family_model(name, state, dev).eval()
        launches = dict(deform_cuda.LAUNCHES)
        with torch.inference_mode():
            out[str(dev)] = model([x.float().to(dev) for x in inputs]).cpu()
        if dev != "cpu":
            assert {k: deform_cuda.LAUNCHES[k] - launches[k]
                    for k in launches} == {"deform_fwd": k1, "deform_bwd": 0,
                                           "deform_bwd_dx": 0}
    ref = out["cpu"].numpy()
    atol = (3e-5 if name == "lrru" else 2e-5) * max(1.0,
                                                    float(np.abs(ref).max()))
    np.testing.assert_allclose(out[str(cuda_device)].numpy(), ref, rtol=1e-4,
                               atol=atol)

    inputs, gt = _family_batch(name, 2, 64, seed=4)
    crit = build_criterion({"L1": 1, "L2": 1, "Grad": 0.1})
    out = {}
    for key, dev, dtype in (("cpu", "cpu", torch.float32),
                            ("f64", "cpu", torch.float64),
                            ("card", cuda_device, torch.float32)):
        model = _family_model(name, state, dev, dtype).train()
        launches = dict(deform_cuda.LAUNCHES)
        loss = crit(model([x.to(dev, dtype) for x in inputs]),
                    gt.to(dev, dtype))["Total"]
        loss.backward()
        if key == "card":
            assert {k: deform_cuda.LAUNCHES[k] - launches[k]
                    for k in launches} == {"deform_fwd": k1, "deform_bwd": 1,
                                           "deform_bwd_dx": 0}
        out[key] = (loss.item(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None},
                    {n: b.cpu() for n, b in model.named_buffers()
                     if "running" in n})
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for i in (1, 2):
        assert set(out["card"][i]) == set(out["f64"][i])
        for n, ref in out["f64"][i].items():
            e_card = _rel_err(out["card"][i][n], ref)
            e_cpu = _rel_err(out["cpu"][i][n], ref)
            assert e_card <= 3 * e_cpu + 5e-3, (n, e_card, e_cpu)
