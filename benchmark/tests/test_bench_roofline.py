"""The FLOP and byte formulas against hand counts, and the benchmark's
model counts against the port's own (``jspsr_torch.utils.summary``)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import cells, roofline
from benchmark.reference import reference_model
from benchmark.reference.train import losses


def test_one_3x3_conv_by_hand():
    # 2 x 16 x 32 x 32 in, 32 x 16 x 3 x 3 weight, stride 1, pad 1: every
    # one of 2 x 32 x 32 x 32 outputs takes 16 x 9 multiply-adds
    flops, nbytes = roofline.conv_cost(
        "aten::convolution", [[2, 16, 32, 32], [32, 16, 3, 3], []],
        ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"],
        ["float"])
    assert flops == 2 * (2 * 32 * 32 * 32) * (16 * 9)
    assert nbytes == 4 * (2 * 16 * 1024 + 32 * 16 * 9 + 2 * 32 * 1024)
    # stride 2: a quarter of the outputs
    f2, _ = roofline.conv_cost(
        "aten::convolution", [[2, 16, 32, 32], [32, 16, 3, 3], []],
        ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"],
        ["float"])
    assert f2 == flops // 4
    # transposed 3x3 stride 2 (16 -> 8 channels): per input pixel
    ft, bt = roofline.conv_cost(
        "aten::convolution", [[1, 16, 8, 8], [16, 8, 3, 3], []],
        ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "True", "[1, 1]", "1"],
        ["float"])
    assert ft == 2 * 64 * 16 * 8 * 9
    assert bt == 4 * (16 * 64 + 16 * 8 * 9 + 8 * 16 * 16)


def test_conv_backward_counts_what_its_mask_asks():
    dims = [[2, 32, 32, 32], [2, 16, 32, 32], [32, 16, 3, 3]]
    conc = ["", "", "", "[32]", "[1, 1]", "[1, 1]", "[1, 1]", "False",
            "[0, 0]", "1"]
    both, _ = roofline.conv_cost("aten::convolution_backward", dims,
                                 conc + ["[True, True, False]"], ["float"])
    wonly, wb = roofline.conv_cost("aten::convolution_backward", dims,
                                   conc + ["[False, True, False]"],
                                   ["float"])
    assert both == 2 * wonly == 2 * 2 * (2 * 32 * 32 * 32) * (16 * 9)
    assert wb == 4 * (2 * 32 * 1024 + 2 * 16 * 1024 + 32 * 16 * 9)


def test_one_deform_call_by_hand():
    dims = [[3, 1, 20, 24], [3, 18, 20, 24]]
    pix = 3 * 20 * 24
    assert roofline.deform_cost("jspsr::deform_conv2d", dims) == (
        9 * 15 * pix, 4 * (1 + 18 + 9 + 1) * pix)
    assert roofline.deform_cost("jspsr::deform_conv2d_backward", dims) == (
        (9 * 30 + 1) * pix, 4 * (29 + 18 + 9) * pix)
    assert roofline.deform_cost("jspsr::deform_conv2d_backward_dx",
                                dims) == ((9 * 38 + 1) * pix,
                                          4 * (29 + 27 + 1) * pix)


def _program(name, **mk):
    prog = json.loads(json.dumps(cells.config(name)["program"]))
    prog["model_kwargs"].update(mk)
    return prog


def test_jspsr_counts_reconcile_with_the_port(tmp_path):
    """Forward: the port's ``forward_cost`` exactly (its deform formula is
    the benchmark's forward one). Step: the port's ``count_flops`` of a
    forward, the loss and a backward, plus the deform backward (271 a
    pixel), which the port has no formula for."""
    from jspsr_torch.config.loader import create_config
    from jspsr_torch.losses import build_criterion
    from jspsr_torch.models.factory import build_model
    from jspsr_torch.utils.summary import count_flops, forward_cost
    from torch._subclasses.fake_tensor import FakeTensorMode

    prog = _program("jspsr_r8_img_msk", num_feature=8, num_block=1)
    (tmp_path / "c.json").write_text(json.dumps(prog))
    p = create_config(tmp_path / "c.json")
    shapes = [(2, 1, 64, 64), (2, 3, 64, 64), (2, 15, 64, 64)]
    port = build_model(p)
    fwd = forward_cost(port, [torch.zeros(s) for s in shapes])[2]
    mine = roofline.step_flops(reference_model(prog), shapes, False)
    assert mine == fwd
    crit = build_criterion(dict(p.loss))
    port.train()
    with FakeTensorMode():
        xs = [torch.empty(s) for s in shapes]
        params = {k: torch.empty(v.shape).requires_grad_(v.requires_grad)
                  for k, v in port.named_parameters()}
        bufs = {k: torch.empty(v.shape, dtype=v.dtype)
                for k, v in port.named_buffers()}

        def step():
            out = torch.func.functional_call(port, {**params, **bufs},
                                             (xs,))
            crit(out, out.detach())["Total"].backward()

        _, step_port = count_flops(step)
    mine_step = roofline.step_flops(
        reference_model(prog), shapes, True,
        lambda o: losses(o, o.detach(), prog["loss"])["Total"])
    assert mine_step - step_port == 271 * 2 * 64 * 64


def test_completionformer_counts_its_k3_backward():
    prog = _program("completionformer_r8_img_msk")
    model = reference_model(prog)
    shapes = [(1, 1, 64, 64), (1, 18, 64, 64)]
    fwd = roofline.step_flops(model, shapes, False)
    step = roofline.step_flops(
        model, shapes, True,
        lambda o: losses(o, o.detach(), prog["loss"])["Total"])
    assert fwd > 0 and step > 2 * fwd
    from benchmark.reference import deform
    with deform.counting() as calls:
        pass
    assert calls == []
