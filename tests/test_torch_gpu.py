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

# every kernel's count at 0, each mode under its own name
NO_LAUNCHES = dict.fromkeys(deform_cuda.KERNELS, 0)

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


@pytest.mark.parametrize("h,w,y0,hs,scale", [
    (16, 16, 8, 8, 1.5), (128, 128, 64, 64, 20.0), (13, 20, 5, 6, 1.5),
    (333, 335, 111, 111, 1.5)])
def test_row_slab_kernels_are_the_whole_images_rows(cuda_device, h, w, y0,
                                                    hs, scale):
    """K1 and K2 on a row slab (``y0``; TMA and copy paths, slabs off K1's
    4-row tile): output, d_offset and d_mask bit-equal to those rows of the
    whole-image kernels' and within rtol = atol = 1e-5 of their plain
    versions; one ``deform_fwd_slab`` and one ``deform_bwd_slab`` launch."""
    x, offset, weight, bias, mask = _args(2, h, w, scale, cuda_device)
    rows = slice(y0, y0 + hs)
    off, msk = offset[:, :, rows].contiguous(), mask[:, :, rows].contiguous()
    g = torch.randn(2, 1, h, w, device=cuda_device)
    before = dict(deform_cuda.LAUNCHES)
    got = deform_cuda.deform_fwd(x, off, weight, bias, msk, y0=y0)
    got_b = deform_cuda.deform_bwd(x, off, weight, msk,
                                   g[:, :, rows].contiguous(), y0=y0)
    torch.cuda.synchronize()
    assert {k: deform_cuda.LAUNCHES[k] - before[k] for k in before} == {
        **NO_LAUNCHES, "deform_fwd_slab": 1, "deform_bwd_slab": 1}
    whole = deform_cuda.deform_fwd(x, offset, weight, bias, mask)
    whole_b = deform_cuda.deform_bwd(x, offset, weight, mask, g)
    assert torch.equal(got, whole[:, :, rows])
    for a, full in zip(got_b[:2], whole_b[:2]):
        assert torch.equal(a, full[:, :, rows])
    torch.testing.assert_close(got, deform_conv2d_plain(
        x, off, weight, bias, msk, y0=y0), rtol=1e-5, atol=1e-5)
    ref_b = deform_conv2d_backward_plain(x, off, weight, msk,
                                         g[:, :, rows].contiguous(), y0=y0)
    for a, r in zip(got_b[:2], ref_b[:2]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,y0,hs,scale", [
    (16, 16, 8, 8, 1.5), (128, 128, 64, 64, 20.0), (13, 20, 5, 6, 1.5),
    (128, 128, 0, 64, 0.0)])
def test_bf16_row_slab_kernels_are_the_whole_images_rows(cuda_device, h, w,
                                                         y0, hs, scale):
    """K1's and K2's bf16-sampling modes on a row slab (TMA and copy paths,
    a slab off K1's 4-row tile, integer positions): output, d_offset and
    d_mask bit-equal to those rows of the whole-image bf16 kernels' and
    within rtol = atol = 1e-5 of their plain bf16 versions (the same
    roundings); the slabs' d_weight and d_bias summed over a partition of
    the rows within 1e-6 of the whole image's terms' magnitude sums (sums
    of signed terms that cancel); one ``deform_fwd_bf16_slab`` and one
    ``deform_bwd_bf16_slab`` launch."""
    bf16 = "bfloat16"
    x, offset, weight, bias, mask = _args(2, h, w, scale, cuda_device,
                                          seed=9)
    rows = slice(y0, y0 + hs)
    off, msk = offset[:, :, rows].contiguous(), mask[:, :, rows].contiguous()
    g = torch.randn(2, 1, h, w, device=cuda_device)
    gs = g[:, :, rows].contiguous()
    before = dict(deform_cuda.LAUNCHES)
    got = deform_cuda.deform_fwd(x, off, weight, bias, msk, sample_dtype=bf16,
                                 y0=y0)
    got_b = deform_cuda.deform_bwd(x, off, weight, msk, gs, sample_dtype=bf16,
                                   y0=y0)
    torch.cuda.synchronize()
    assert {k: deform_cuda.LAUNCHES[k] - before[k] for k in before} == {
        **NO_LAUNCHES, "deform_fwd_bf16_slab": 1, "deform_bwd_bf16_slab": 1}
    whole = deform_cuda.deform_fwd(x, offset, weight, bias, mask,
                                   sample_dtype=bf16)
    whole_b = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                     sample_dtype=bf16)
    assert torch.equal(got, whole[:, :, rows])
    for a, full in zip(got_b[:2], whole_b[:2]):
        assert torch.equal(a, full[:, :, rows])
    torch.testing.assert_close(got, deform_conv2d_plain(
        x, off, weight, bias, msk, sample_dtype=bf16, y0=y0), rtol=1e-5,
        atol=1e-5)
    ref_b = deform_conv2d_backward_plain(x, off, weight, msk, gs,
                                         sample_dtype=bf16, y0=y0)
    for a, r in zip(got_b[:2], ref_b[:2]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    rest = [slice(0, y0), slice(y0 + hs, h)]
    sums = [got_b[2].clone(), got_b[3].clone()]
    for part in (r for r in rest if r.stop > r.start):
        b = deform_cuda.deform_bwd(
            x, offset[:, :, part].contiguous(), weight,
            mask[:, :, part].contiguous(), g[:, :, part].contiguous(),
            sample_dtype=bf16, y0=part.start)
        sums = [sums[0] + b[2], sums[1] + b[3]]
    abs_w = deform_conv2d_backward_plain(x.abs(), offset, weight,
                                         mask.abs(), g.abs(),
                                         sample_dtype=bf16)[2]
    assert ((sums[0] - whole_b[2]).abs() <= 1e-6 * abs_w).all()
    assert float((sums[1] - whole_b[3]).abs()) <= 1e-6 * float(g.abs().sum())


@pytest.mark.parametrize("sample_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("h,w,y0,hs,scale", [
    (16, 16, 8, 8, 1.5), (128, 128, 64, 64, 20.0), (30, 20, 5, 11, 1.5),
    (128, 128, 0, 64, 0.0)])
def test_k3_row_slab_is_the_whole_images(cuda_device, h, w, y0, hs, scale,
                                         sample_dtype):
    """K3 and K3-bf16 on a row slab (``y0``; a slab of 11 rows off K3's
    4-row tile, whose last tile row is partial): d_offset and d_mask
    bit-equal to those rows of the whole-image K3's; d_x the whole image's
    shape; over a partition of the rows the slabs' d_x and d_weight summed
    within 1e-6 of the whole image's terms' magnitude sums; each slab
    against its plain version (d_offset, d_mask at rtol = atol = 1e-5, d_x
    within 1e-5 of its magnitude sum); bit-equal across two launches; one
    ``deform_bwd_dx_slab`` (``deform_bwd_dx_bf16_slab``) launch per
    call."""
    x, offset, weight, _, mask = _args(2, h, w, scale, cuda_device, seed=11)
    g = torch.randn(2, 1, h, w, generator=torch.Generator().manual_seed(6))
    g = g.to(cuda_device)
    kw = {"sample_dtype": sample_dtype}
    name = ("deform_bwd_dx_bf16_slab" if sample_dtype
            else "deform_bwd_dx_slab")
    whole = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g, **kw)
    parts = [slice(0, y0), slice(y0, y0 + hs), slice(y0 + hs, h)]
    sums = [torch.zeros_like(whole[4]), torch.zeros_like(whole[2])]
    for rows in (r for r in parts if r.stop > r.start):
        off, msk, gs = (t[:, :, rows].contiguous() for t in (offset, mask,
                                                              g))
        before = dict(deform_cuda.LAUNCHES)
        got = deform_cuda.deform_bwd_dx(x, off, weight, msk, gs, y0=rows.start,
                                        **kw)
        torch.cuda.synchronize()
        assert {k: deform_cuda.LAUNCHES[k] - before[k] for k in before} == {
            **NO_LAUNCHES, name: 1}
        again = deform_cuda.deform_bwd_dx(x, off, weight, msk, gs,
                                          y0=rows.start, **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        assert got[4].shape == x.shape
        for a, full in zip(got[:2], whole[:2]):
            assert torch.equal(a, full[:, :, rows])
        ref = deform_conv2d_backward_plain(x, off, weight, msk, gs,
                                           need_dx=True, y0=rows.start, **kw)
        abs_x = deform_conv2d_backward_plain(x.abs(), off, weight.abs(),
                                             msk.abs(), gs.abs(),
                                             need_dx=True, y0=rows.start,
                                             **kw)[4]
        for a, r in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        assert ((got[4] - ref[4]).abs() <= 1e-5 * abs_x + 1e-7).all()
        sums = [sums[0] + got[4], sums[1] + got[2]]
    abs_sum = deform_conv2d_backward_plain(x.abs(), offset, weight.abs(),
                                           mask.abs(), g.abs(), need_dx=True,
                                           **kw)
    assert whole[4].abs().max() > 0
    assert ((sums[0] - whole[4]).abs() <= 1e-6 * abs_sum[4] + 1e-7).all()
    assert ((sums[1] - whole[2]).abs() <= 1e-6 * abs_sum[2] + 1e-6).all()


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
    sums b*h*w terms in another order (each thread's tiles, the warp, the
    block, then the blocks' rows, all in K2's launch): its
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


@pytest.mark.parametrize("b,h,w,scale", [(2, 16, 16, 1.5), (1, 13, 21, 1.5)],
                         ids=["tma", "copy"])
def test_bf16_sampling_kernels_match_plain(cuda_device, b, h, w, scale):
    """K1's and K2's bf16-sampling modes against their plain versions, on
    K1's TMA and copy paths: the same roundings, so rtol = atol = 1e-5;
    each launches under its own name, and the mode differs from fp32."""
    x, offset, weight, bias, mask = _args(b, h, w, scale, cuda_device, seed=9)
    g = torch.randn(b, 1, h, w, generator=torch.Generator().manual_seed(1))
    g = g.to(cuda_device)
    before = dict(deform_cuda.LAUNCHES)
    with torch.inference_mode():
        got = deform_cuda.deform_fwd(x, offset, weight, bias, mask,
                                     sample_dtype="bfloat16")
        ref = deform_conv2d_plain(x, offset, weight, bias, mask,
                                  sample_dtype="bfloat16")
        fp32 = deform_cuda.deform_fwd(x, offset, weight, bias, mask)
        grads = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                       sample_dtype="bfloat16")
        ref_g = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                             sample_dtype="bfloat16")
    torch.cuda.synchronize()
    assert {k: deform_cuda.LAUNCHES[k] - before[k] for k in before} == {
        **NO_LAUNCHES, "deform_fwd": 1, "deform_fwd_bf16": 1,
        "deform_bwd_bf16": 1}
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert (got - fp32).abs().max().item() > 1e-3
    torch.testing.assert_close(grads[0], ref_g[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[1], ref_g[1], rtol=1e-5, atol=1e-5)
    # d_weight and d_bias sum b*h*w terms in another order, as in
    # test_backward_kernel_matches_plain
    scale_w = deform_conv2d_backward_plain(
        x.abs(), offset, weight, mask.abs(), g.abs(),
        sample_dtype="bfloat16")[2]
    assert ((grads[2] - ref_g[2]).abs() <= 1e-5 * scale_w + 1e-6).all()
    torch.testing.assert_close(grads[3], ref_g[3], rtol=1e-5, atol=1e-4)


def _k2_case(b, h, w, scale, device, hs=None, y0=0, seed=3):
    """K2's inputs: x the whole image, offset, mask and g the slab of ``hs``
    rows from image row ``y0`` (the whole image by default)."""
    x, offset, weight, _, mask = _args(b, h, w, scale, device, seed=seed)
    g = torch.randn(b, 1, h, w, generator=torch.Generator().manual_seed(seed))
    rows = slice(y0, y0 + (h if hs is None else hs))
    offset, mask, g = (t[:, :, rows].contiguous() for t in
                       (offset, mask, g.to(device)))
    return x, offset, weight, mask, g


def _hold_k2_to_plain(got, x, offset, weight, mask, g, **kw):
    """As test_backward_kernel_matches_plain holds K2."""
    ref = deform_conv2d_backward_plain(x, offset, weight, mask, g, **kw)
    scale_w = deform_conv2d_backward_plain(x.abs(), offset, weight,
                                           mask.abs(), g.abs(), **kw)[2]
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    assert ((got[2] - ref[2]).abs() <= 1e-5 * scale_w + 1e-6).all()
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["whole", "slab"])
def test_backward_kernel_is_one_device_kernel(cuda_device, mode, slab):
    """K2 finishes d_weight and d_bias in its own launch: one device
    kernel per call, no memset, copy or reduction beside it."""
    from jspsr_torch.scripts.bench_deform_bwd import device_kernels

    kw = {"hs": 64, "y0": 64} if slab else {}
    x, offset, weight, mask, g = _k2_case(4, 128, 128, 1.5, cuda_device,
                                          **kw)
    kinds = device_kernels(lambda: deform_cuda.deform_bwd(
        x, offset, weight, mask, g, sample_dtype=mode, y0=kw.get("y0", 0)))
    assert list(kinds.values()) == [1.0], kinds
    assert "deform_bwd_kernel" in next(iter(kinds)), kinds


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_backward_kernel_is_bit_identical_across_calls_and_streams(
        cuda_device, mode):
    """Every output the same bits on every call: on the default stream, then
    on two side streams one after the other (each with its own ticket
    counter, left at 0 by every launch)."""
    x, offset, weight, mask, g = _k2_case(16, 128, 128, 1.5, cuda_device)
    first = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                   sample_dtype=mode)
    runs = [deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                   sample_dtype=mode) for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(2):
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs.append(deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                               sample_dtype=mode))
        side.synchronize()
    torch.cuda.synchronize()
    for got in runs:
        assert all(torch.equal(a, c) for a, c in zip(first, got))
    _hold_k2_to_plain(first, x, offset, weight, mask, g, sample_dtype=mode)


@pytest.mark.parametrize("b,h,w,hs,y0", [(2, 13, 21, 13, 0),
                                         (2, 40, 130, 17, 11),
                                         (1, 333, 335, 111, 111)],
                         ids=["small", "slab", "scene"])
@pytest.mark.parametrize("scale", [0.0, 1.5, 20.0])
def test_backward_kernel_copy_path_matches_plain(cuda_device, b, h, w, hs,
                                                 y0, scale):
    """W % 4 != 0 takes K2's cp.async path; its outputs hold the plain
    version as the TMA path's do, whole and on a slab."""
    args = _k2_case(b, h, w, scale, cuda_device, hs=hs, y0=y0)
    assert deform_cuda.fwd_path(args[0], args[1], args[3]) == "copy"
    got = deform_cuda.deform_bwd(*args, y0=y0)
    torch.cuda.synchronize()
    _hold_k2_to_plain(got, *args, y0=y0)


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_backward_kernel_misaligned_base_matches_aligned(cuda_device, mode):
    """A g whose base is not on 16 bytes cannot have a tensor map: K2 takes
    the copy path and gives the TMA path's d_offset and d_mask, bit for
    bit, and d_weight and d_bias within the plain version's tolerance."""
    x, offset, weight, mask, g = _k2_case(3, 64, 128, 1.5, cuda_device)
    moved = torch.empty(g.numel() + 1, device=cuda_device)[1:]
    moved = moved.view_as(g).copy_(g)
    got = deform_cuda.deform_bwd(x, offset, weight, mask, moved,
                                 sample_dtype=mode)
    ref = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                 sample_dtype=mode)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    _hold_k2_to_plain(got, x, offset, weight, mask, g, sample_dtype=mode)


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_backward_kernel_blocks_walk_several_tiles(cuda_device, mode):
    """At 60 x 128^2 (3,840 tiles of 4 x 64) each block of the persistent
    grid (at most 3 per SM) walks several tiles, carrying its sums across
    them; the outputs hold the plain version."""
    args = _k2_case(60, 128, 128, 1.5, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 60 * 32 * 2 >= 4 * 3 * sms
    got = deform_cuda.deform_bwd(*args, sample_dtype=mode)
    torch.cuda.synchronize()
    _hold_k2_to_plain(got, *args, sample_dtype=mode)


def test_backward_kernel_empty_batch_launches_nothing(cuda_device):
    """An empty batch or an empty slab: empty gradients, zero d_weight and
    d_bias, no launch counted."""
    before = dict(deform_cuda.LAUNCHES)
    for b, hs in ((0, 16), (2, 0)):
        x, offset, weight, mask, g = _k2_case(max(b, 1), 16, 16, 1.5,
                                              cuda_device, hs=hs)
        x, offset, mask, g = (t[:b] for t in (x, offset, mask, g))
        got = deform_cuda.deform_bwd(x, offset, weight, mask, g)
        torch.cuda.synchronize()
        assert got[0].shape == offset.shape and got[1].shape == mask.shape
        assert not got[2].any() and not got[3].any()
        assert got[2].shape == weight.shape and got[3].shape == (1,)
    assert deform_cuda.LAUNCHES == before


def _hold_k3_to_plain(got, x, offset, weight, mask, g, **kw):
    """As test_backward_dx_kernel_matches_plain holds K3 (on a row slab
    with ``y0``)."""
    ref = deform_conv2d_backward_plain(x, offset, weight, mask, g,
                                       need_dx=True, **kw)
    abs_sum = deform_conv2d_backward_plain(x.abs(), offset, weight.abs(),
                                           mask.abs(), g.abs(), need_dx=True,
                                           **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    assert ((got[2] - ref[2]).abs() <= 1e-5 * abs_sum[2] + 1e-6).all()
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-4)
    assert ((got[4] - ref[4]).abs() <= 1e-5 * abs_sum[4] + 1e-7).all()


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["whole", "slab"])
@pytest.mark.parametrize("side", [128, 333], ids=["tma", "copy"])
def test_backward_dx_kernel_is_one_device_kernel(cuda_device, mode, slab,
                                                 side):
    """K3 zeroes its accumulator, sums the bounds, scatters, converts d_x
    and finishes d_weight and d_bias in one launch: one device kernel per
    call, no memset, copy or reduction beside it, on the TMA path and on
    the copy path (W % 4 != 0), counted in a process of its own."""
    from jspsr_torch.scripts.bench_deform_bwd_dx import (
        kernels_per_call_child,
    )

    hs, y0 = (side // 3, side // 3) if slab else (side, 0)
    kinds, = kernels_per_call_child([[2, side, hs, y0, mode]])
    assert [n for n, _ in kinds.values()] == [1.0], kinds
    assert "deform_bwd_dx_kernel" in next(iter(kinds)), kinds


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["whole", "slab"])
def test_backward_dx_kernel_is_bit_identical_across_calls_and_streams(
        cuda_device, mode, slab):
    """Every output of K3 the same bits on every call: on the default
    stream, then on two side streams one after the other; the outputs
    hold the plain version."""
    kw = {"hs": 64, "y0": 64} if slab else {}
    x, offset, weight, mask, g = _k2_case(16, 128, 128, 1.5, cuda_device,
                                          **kw)

    def call():
        return deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                         sample_dtype=mode,
                                         y0=kw.get("y0", 0))

    first = call()
    runs = [call() for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(2):
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs.append(call())
        side.synchronize()
    torch.cuda.synchronize()
    for got in runs:
        assert all(torch.equal(a, c) for a, c in zip(first, got))
    _hold_k3_to_plain(first, x, offset, weight, mask, g, sample_dtype=mode,
                      y0=kw.get("y0", 0))


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_backward_dx_kernel_blocks_walk_several_tiles(cuda_device, mode):
    """At 60 x 128^2 (3,840 tiles of 4 x 64) each block of the persistent
    grid (at most 3 per SM) walks several tiles, carrying its sums and
    its image's scale across them and flushing its window after each;
    the outputs hold the plain version."""
    args = _k2_case(60, 128, 128, 1.5, cuda_device, seed=8)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 60 * 32 * 2 >= 4 * 3 * sms
    got = deform_cuda.deform_bwd_dx(*args, sample_dtype=mode)
    torch.cuda.synchronize()
    _hold_k3_to_plain(got, *args, sample_dtype=mode)


@pytest.mark.parametrize("b,h,w,hs,y0", [(2, 13, 21, 13, 0),
                                         (2, 40, 130, 17, 11),
                                         (1, 333, 335, 111, 111)],
                         ids=["small", "slab", "scene"])
@pytest.mark.parametrize("scale", [0.0, 1.5, 20.0])
def test_backward_dx_kernel_copy_path_matches_plain(cuda_device, b, h, w, hs,
                                                    y0, scale):
    """W % 4 != 0 takes K3's cp.async path; its outputs hold the plain
    version as the TMA path's do, whole and on a slab, bit-equal across
    two calls."""
    args = _k2_case(b, h, w, scale, cuda_device, hs=hs, y0=y0, seed=9)
    assert deform_cuda.fwd_path(args[0], args[1], args[3]) == "copy"
    got = deform_cuda.deform_bwd_dx(*args, y0=y0)
    again = deform_cuda.deform_bwd_dx(*args, y0=y0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _hold_k3_to_plain(got, *args, y0=y0)


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slab", [False, True], ids=["whole", "slab"])
def test_backward_dx_kernel_misaligned_base_matches_aligned(cuda_device,
                                                            mode, slab):
    """A g whose base is not on 16 bytes cannot have a tensor map: K3 takes
    the copy path and gives the TMA path's d_offset, d_mask and d_x, bit
    for bit (the fixed point's scale and sums do not depend on the path),
    and d_weight and d_bias within the plain version's tolerance."""
    kw = {"hs": 32, "y0": 16} if slab else {}
    x, offset, weight, mask, g = _k2_case(3, 64, 128, 1.5, cuda_device,
                                          seed=10, **kw)
    moved = torch.empty(g.numel() + 1, device=cuda_device)[1:]
    moved = moved.view_as(g).copy_(g)
    y0 = kw.get("y0", 0)
    got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, moved,
                                    sample_dtype=mode, y0=y0)
    ref = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                    sample_dtype=mode, y0=y0)
    torch.cuda.synchronize()
    for i in (0, 1, 4):
        assert torch.equal(got[i], ref[i])
    _hold_k3_to_plain(got, x, offset, weight, mask, g, sample_dtype=mode,
                      y0=y0)


@pytest.mark.parametrize("mode", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_backward_dx_kernel_empty_batch_or_slab_gives_zeros(cuda_device,
                                                            mode):
    """An empty batch, or a slab of no rows at y0 = 0 and at y0 = H: empty
    d_offset and d_mask, zero d_x, d_weight and d_bias of their shapes, no
    launch counted. A NaN tensor of d_x's size is made and freed before
    each call, so the caching allocator hands its block back: a d_x the
    call left unwritten shows as NaN."""
    x, offset, weight, mask, g = _k2_case(2, 16, 16, 1.5, cuda_device)
    before = dict(deform_cuda.LAUNCHES)
    for b, hs, y0 in ((0, 16, 0), (2, 0, 0), (2, 0, 16)):
        xs = x[:b]
        o, m, gs = (t[:b, :, y0:y0 + hs].contiguous()
                    for t in (offset, mask, g))
        torch.full_like(xs, float("nan"))  # made and freed at once
        got = deform_cuda.deform_bwd_dx(xs, o, weight, m, gs,
                                        sample_dtype=mode, y0=y0)
        torch.cuda.synchronize()
        assert got[0].shape == o.shape and got[1].shape == m.shape
        assert got[2].shape == weight.shape and got[3].shape == (1,)
        assert got[4].shape == xs.shape
        assert not got[2].any() and not got[3].any() and not got[4].any()
    assert deform_cuda.LAUNCHES == before


@pytest.mark.parametrize("kernel", ["deform_fwd", "deform_bwd",
                                    "deform_bwd_dx"])
def test_tma_kernels_launch_from_a_fresh_thread(cuda_device, kernel):
    """K1, K2 and K3 launched from a thread that has not touched the card
    (as autograd's device thread, when the deform op's backward is its
    first work there): the tensor-map encoder needs that thread's context
    bound first. The outputs are the main thread's, bit for bit."""
    import threading

    x, offset, weight, mask, g = _k2_case(2, 32, 64, 1.5, cuda_device)
    bias = torch.zeros(1, device=cuda_device)
    call = {"deform_fwd": lambda: (deform_cuda.deform_fwd(
                x, offset, weight, bias, mask),),
            "deform_bwd": lambda: deform_cuda.deform_bwd(
                x, offset, weight, mask, g),
            "deform_bwd_dx": lambda: deform_cuda.deform_bwd_dx(
                x, offset, weight, mask, g)}[kernel]
    want = call()
    got = []

    def run():
        try:
            got.append(call())
            torch.cuda.synchronize()
        except Exception as err:  # handed to the test's thread
            got.append(err)

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    if isinstance(got[0], Exception):
        raise got[0]
    assert all(torch.equal(a, c) for a, c in zip(want, got[0]))


# K3 at NLSPN's shapes: a narrow odd width, integer positions (NLSPN's
# zero-offset init) and the CompletionFormer train batch far off the image;
# then the window scatter's edges on tiles (4 x 64) that divide neither H
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
        {**NO_LAUNCHES, "deform_bwd_dx": 1}
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


@pytest.mark.parametrize("b,h,w,scale", DX_CASES[:4])
def test_backward_dx_bf16_kernel_is_its_two_halves(cuda_device, b, h, w,
                                                   scale):
    """K3's bf16-sampling mode: its d_x is fp32 K3's and its d_offset and
    d_mask K2-bf16's, bit for bit, on the same inputs; one launch under
    its own name; the op's autograd reaches it with ``x``'s gradient."""
    x, offset, weight, bias, mask = _args(b, h, w, scale, cuda_device)
    g = torch.randn(b, 1, h, w, generator=torch.Generator().manual_seed(5))
    g = g.to(cuda_device)
    launches = dict(deform_cuda.LAUNCHES)
    got = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g,
                                    sample_dtype="bfloat16")
    torch.cuda.synchronize()
    assert {k: deform_cuda.LAUNCHES[k] - launches[k] for k in launches} == \
        {**NO_LAUNCHES, "deform_bwd_dx_bf16": 1}
    fp32 = deform_cuda.deform_bwd_dx(x, offset, weight, mask, g)
    k2 = deform_cuda.deform_bwd(x, offset, weight, mask, g,
                                sample_dtype="bfloat16")
    assert torch.equal(got[4], fp32[4])
    assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1])
    xt = x.clone().requires_grad_(True)
    launches = dict(deform_cuda.LAUNCHES)
    deform_conv2d(xt, offset, weight, bias, mask,
                  sample_dtype="bfloat16").backward(g)
    assert deform_cuda.LAUNCHES["deform_bwd_dx_bf16"] == \
        launches["deform_bwd_dx_bf16"] + 1
    assert torch.equal(xt.grad, got[4])


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
                    for k in launches} == {**NO_LAUNCHES,
                                             "deform_fwd": 1,
                                             "deform_bwd": 1}
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
                    for k in launches} == {**NO_LAUNCHES,
                                             "deform_fwd": 6,
                                             "deform_bwd": 0}
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
                    for k in launches} == {**NO_LAUNCHES,
                                           "deform_fwd": 6,
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
                    for k in launches} == {**NO_LAUNCHES,
                                             "deform_fwd": k1,
                                             "deform_bwd": 0}
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
                    for k in launches} == {**NO_LAUNCHES,
                                             "deform_fwd": k1,
                                             "deform_bwd": 1}
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


# ---- the eleventh slice: JSPSR's execution options and recomputation ----

OPTION_CASES = [{"fuse_stems": True}, {"eval_grouped": True},
                {"fuse_stems": True, "eval_grouped": True}]


@pytest.mark.parametrize("options", OPTION_CASES,
                         ids=["fuse_stems", "eval_grouped", "both"])
def test_jspsr_options_on_gpu_match_separate(cuda_device, options):
    """The flagship's eval forward with each option against its separate
    path on the card (rtol 1e-4, atol 2e-5: the convs are regrouped, the
    precision is fp32), one K1 launch per forward."""
    in_channels = {"lr_dem": 1, "image": 3, "mask": 15}
    sep = perturb_weights(JSPSR(dict(in_channels), num_feature=16,
                                layers=(2, 2, 2, 2)), seed=3)
    opt = JSPSR(dict(in_channels), num_feature=16, layers=(2, 2, 2, 2),
                **options)
    opt.load_state_dict(sep.state_dict())
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.uniform(0.05, 0.95, (2, c, 64, 64))
                           .astype(np.float32)).to(cuda_device)
          for c in in_channels.values()]
    sep, opt = sep.to(cuda_device).eval(), opt.to(cuda_device).eval()
    with torch.inference_mode():
        want = sep(xs)
        before = dict(deform_cuda.LAUNCHES)
        got = opt(xs)
        torch.cuda.synchronize()
    assert deform_cuda.LAUNCHES["deform_fwd"] == before["deform_fwd"] + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


def _step_state(model, opt):
    return {**{n: t.detach().clone() for n, t in
               [*model.named_parameters(), *model.named_buffers()]},
            **{f"opt.{i}.{k}": v.clone()
               for i, q in enumerate(model.parameters())
               for k, v in opt.state.get(q, {}).items()}}


@pytest.mark.parametrize("remat,stages,k1", [(True, False, 2),
                                             (False, True, 1)],
                         ids=["remat", "remat_stages"])
def test_jspsr_remat_step_on_gpu_is_bit_equal(cuda_device, remat, stages,
                                              k1):
    """A JSPSR step with ``remat`` (the forward recomputed whole: K1 twice)
    or ``remat_stages`` (the stages recomputed, the head not: K1 once),
    from the state and batch of a step without, under deterministic cuDNN:
    every weight, buffer and moment bit-equal; one K2."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    set_deterministic_cudnn()
    try:
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
        for use in (False, True):
            model = JSPSR(dict(in_channels), num_feature=8,
                          layers=(1, 1, 1, 1), remat_stages=stages and use)
            model.load_state_dict(state)
            model = model.to(cuda_device)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            step = make_train_step(model, build_criterion(
                {"L1": 1, "L2": 1, "Grad": 0.1}), opt, remat=remat and use)
            before = dict(deform_cuda.LAUNCHES)
            step(inputs, gt)
            torch.cuda.synchronize()
            counts = {k: deform_cuda.LAUNCHES[k] - before[k] for k in before}
            assert counts == dict(NO_LAUNCHES, deform_fwd=k1 if use else 1,
                                  deform_bwd=1), counts
            after.append(_step_state(model, opt))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    unequal = [n for n in after[0] if not torch.equal(after[0][n],
                                                      after[1][n])]
    assert not unequal, unequal[:8]


def test_completionformer_remat_step_on_gpu_is_bit_equal(cuda_device,
                                                         completionformer):
    """CompletionFormer at 2 x 64² with drop path drawn from the step's
    CUDA generator: a step with ``remat`` (6 K1 forward, 6 in the
    recompute, 6 K3) is the step without, bit for bit."""
    from jspsr_torch.train.step import seed_step_generator

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    set_deterministic_cudnn()
    try:
        inputs, gt = _cf_batch(2, 64, seed=9)
        inputs = [x.float().to(cuda_device) for x in inputs]
        gt = gt.float().to(cuda_device)
        after = []
        for use in (False, True):
            model = _cf(completionformer, cuda_device)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
            gen = torch.Generator(cuda_device)
            step = make_train_step(model, build_criterion({"L1": 1}), opt,
                                   remat=use, generator=gen)
            seed_step_generator(gen, 7, 0)
            before = dict(deform_cuda.LAUNCHES)
            step(inputs, gt)
            torch.cuda.synchronize()
            counts = {k: deform_cuda.LAUNCHES[k] - before[k] for k in before}
            assert counts == dict(NO_LAUNCHES, deform_fwd=12 if use else 6,
                                  deform_bwd_dx=6), counts
            after.append(_step_state(model, opt))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    unequal = [n for n in after[0] if not torch.equal(after[0][n],
                                                      after[1][n])]
    assert not unequal, unequal[:8]


# ---------------------------------------------- summary and trace (phase 18)

def _flagship_step_inputs(device, b=4, side=64, seed=11):
    rng = np.random.default_rng(seed)
    inputs = [torch.from_numpy(rng.uniform(0.05, 0.95, (b, c, side, side))
                               .astype(np.float32)).to(device)
              for c in CF_INPUTS.values()]
    gt = torch.from_numpy(rng.uniform(0.05, 0.95, (b, 1, side, side))
                          .astype(np.float32)).to(device)
    return inputs, gt


def test_model_summary_on_gpu_allocates_nothing_and_counts_as_cpu(
        cuda_device):
    """The summary of a model on the card takes no device memory, launches
    no kernel, and its FLOPs are the same model's on the CPU."""
    from jspsr_torch.utils.summary import forward_cost, model_summary

    model = JSPSR(dict(CF_INPUTS), num_feature=8, layers=(1, 1, 1, 1))
    inputs, _ = _flagship_step_inputs("cpu")
    cpu = forward_cost(model, inputs)
    model.to(cuda_device)
    inputs = [x.to(cuda_device) for x in inputs]
    torch.cuda.synchronize()
    # a process's first fake tensor on the card probes the CUDA context
    # once (torch.empty(1), freed at once)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    card = forward_cost(model, inputs)
    assert torch.cuda.max_memory_allocated() - held <= 512
    assert torch.cuda.memory_allocated() == held
    torch.cuda.reset_peak_memory_stats()
    deform_cuda.reset_launches()
    text = model_summary(model, inputs)
    assert torch.cuda.max_memory_allocated() == held
    assert deform_cuda.LAUNCHES == NO_LAUNCHES
    assert card == cpu
    assert text.splitlines()[-2] == "output: (4, 1, 64, 64) torch.float32"


def test_trace_step_on_gpu_sees_k1_and_k2_once_per_step(cuda_device,
                                                       tmp_path):
    """A warm train step traced: one K1 and one K2 device kernel, and the
    step bit-equal to an untraced one from the same state; an eval
    forward traced: one K1, no K2."""
    from jspsr_torch.utils.summary import trace_kernels, trace_step

    set_deterministic_cudnn()
    inputs, gt = _flagship_step_inputs(cuda_device)
    state = JSPSR(dict(CF_INPUTS), num_feature=8,
                  layers=(1, 1, 1, 1)).state_dict()
    after = []
    for traced in (False, True):
        model = JSPSR(dict(CF_INPUTS), num_feature=8, layers=(1, 1, 1, 1))
        model.load_state_dict(state)
        model = model.to(cuda_device)
        step = make_train_step(model, build_criterion(
            {"L1": 1, "L2": 1, "Grad": 0.1}),
            torch.optim.AdamW(model.parameters(), lr=1e-3))
        step(inputs, gt)  # warm
        if traced:
            losses, log_dir = trace_step(step, inputs, gt,
                                         log_dir=tmp_path / "step")
        else:
            losses = step(inputs, gt)
        torch.cuda.synchronize()
        after.append({**losses, **{n: t.detach().clone() for n, t in
                                   [*model.named_parameters(),
                                    *model.named_buffers()]}})
    assert not [n for n in after[0] if not torch.equal(after[0][n],
                                                       after[1][n])]
    names = [e["name"] for e in trace_kernels(log_dir / "trace_000.json")]
    assert sum("deform_fwd_kernel" in n for n in names) == 1
    assert sum("deform_bwd_kernel" in n for n in names) == 1

    model.eval()

    def forward(x):
        with torch.inference_mode():
            return model(x)

    out, log_dir = trace_step(forward, inputs, log_dir=tmp_path / "fwd")
    assert torch.equal(out, forward(inputs))
    names = [e["name"] for e in trace_kernels(log_dir / "trace_000.json")]
    assert sum("deform_fwd_kernel" in n for n in names) == 1
    assert not any("deform_bwd" in n for n in names)


def test_entry_on_gpu_launches_k1_and_matches_the_cpu(cuda_device):
    """``entry()`` with its default device: the flagship's forward at
    1 x 128^2 on the card launches K1 once and matches ``entry("cpu")``
    on the same seeded weights at the JAX suite's tolerance."""
    from jspsr_torch.entry import entry

    fn, args = entry()
    assert all(a.is_cuda for a in args)
    deform_cuda.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    assert deform_cuda.LAUNCHES == {**NO_LAUNCHES, "deform_fwd": 1}
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    assert out.shape == want.shape == (1, 1, 128, 128)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=2e-5)


def test_profiled_serve_group_names_its_stages_beside_the_kernels(
        cuda_device, tmp_path):
    """A ``serve_scenes`` call under ``torch.profiler`` on the card: the
    dispatch thread's spans (``serve.wait_input``, ``serve.dispatch``) and
    the runner's range (``scene.run``) are in the Chrome trace with the
    kernels, and K1 ran inside ``scene.run`` on the device's clock."""
    import json

    from jspsr_torch.utils import tracing

    p = AttrDict(dict(TILED_P))
    scenes = _tiled_scenes(tmp_path / "batch", [(96, 96)] * 2, seed=3)
    model = _tiled_model().to(cuda_device)
    serve_scenes(model, p, scenes, tmp_path / "warm", tile=64,
                 scene_batch=2, device=cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve_scenes(model, p, scenes, tmp_path / "out", tile=64,
                     scene_batch=2, device=cuda_device)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation"}
    assert {"serve.wait_input", "serve.dispatch", "scene.run"} <= set(
        ranges), sorted(ranges)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("deform_fwd_kernel" in e["name"] for e in kernels)
    run = ranges["scene.run"]
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and run["ts"] <= e["ts"] <= run["ts"] + run["dur"]]
    assert launches  # the group's kernels were launched inside scene.run
    work = tracing.units("serve.call")[-1]
    assert work.counts == {"scenes": 2, "groups": 1}
