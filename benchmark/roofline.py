"""The yardstick's arithmetic: the H100's published peaks, and the FLOPs
and bytes of the ops whose rooflines the benchmark reports.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit; the run prints the card's ``power.limit`` beside
them): 67 TFLOP/s in float32 outside the tensor cores, 495 TFLOP/s in
TF32, 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.

A conv (``aten::convolution``) counts 2 FLOPs per multiply-add over every
tap, padding included: 2 x numel(weight) per output pixel of a standard
conv, per input pixel of a transposed one. Its backward
(``aten::convolution_backward``) counts the same once for the input's
gradient and once for the weight's, as its output mask asks. Bytes: each
input read once and each output written once (the tensors' own dtype).

The deform op (one channel, 3 x 3, the SPN head's and NLSPN's), per output
pixel and tap:

- forward (``jspsr::deform_conv2d``): the four bilinear weights (4
  products), the sample (4 multiply-adds, 8), the modulation and the sum
  (tap weight x mask x sample, accumulated: 3): 15, so 135 a pixel, as
  the port's own formula;
- backward without the input's gradient (``..._backward``): the sample
  again (12), g x w (1), x m (1), d_mask (1), d_weight's g m val
  accumulated (3), d_py and d_px from the corner differences (6 each):
  30 a tap, plus d_bias's one add: 271 a pixel;
- backward with it (``..._backward_dx``): also the scatter of g w m onto
  four corners (4 products, 4 adds): 38 a tap, 343 a pixel.

Its bytes (fp32): forward reads x, offset (18 ch), mask (9 ch) and writes
the output, 29 x 4 = 116 B a pixel; the backward reads x, offset, mask
and g (116 B) and writes d_offset and d_mask (108 B): 224 B; with d_x
228 B. The weight, bias and their gradients are a few bytes a call.

``step_flops`` counts a whole step or forward: ``FlopCounterMode`` over
the plain reference on fake tensors (no arithmetic, no device memory) at
the cell's shapes, for the convs and matrix products, plus the deform
formulas above for each deform call it makes."""

from __future__ import annotations

import math

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float": 4, "c10::Half": 2, "c10::BFloat16": 2,
               "double": 8, "float32": 4, "bfloat16": 2, "float16": 2}

DEFORM_FLOPS_PER_PIXEL = {"forward": 9 * 15, "backward": 9 * 30 + 1,
                          "backward_dx": 9 * 38 + 1}
DEFORM_BYTES_PER_PIXEL = {"forward": 116, "backward": 224,
                          "backward_dx": 228}
DEFORM_OPS = {"jspsr::deform_conv2d": "forward",
              "jspsr::deform_conv2d_backward": "backward",
              "jspsr::deform_conv2d_backward_dx": "backward_dx"}
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def _list(s):
    """'[1, 2]' or '1' or 'False' (a profiler's concrete input) -> value."""
    s = str(s).strip()
    if s in ("True", "False"):
        return s == "True"
    if s.startswith("["):
        return [_list(x) for x in s[1:-1].split(",") if x.strip()]
    return int(s)


def _out_hw(h, w, k, stride, pad, dil, transposed, out_pad):
    if transposed:
        return tuple((i - 1) * s - 2 * p + d * (kk - 1) + op + 1
                     for i, kk, s, p, d, op in zip(
                         (h, w), k, stride, pad, dil, out_pad))
    return tuple((i + 2 * p - d * (kk - 1) - 1) // s + 1
                 for i, kk, s, p, d in zip((h, w), k, stride, pad, dil))


def conv_cost(name: str, dims: list, concrete: list, types: list):
    """(FLOPs, bytes) of one ``aten::convolution`` or
    ``aten::convolution_backward`` call from its recorded input dims,
    concrete scalar inputs and types."""
    esize = DTYPE_BYTES.get(types[0], 4)
    if name == "aten::convolution":
        x, w, b = dims[0], dims[1], dims[2]
        stride, pad, dil = (_list(c) for c in concrete[3:6])
        transposed, out_pad = _list(concrete[6]), _list(concrete[7])
        groups = _list(concrete[8])
        n, h, wd = x[0], x[2], x[3]
        oh, ow = _out_hw(h, wd, w[2:], stride, pad, dil, transposed, out_pad)
        cout = w[1] * groups if transposed else w[0]
        pixels = n * (h * wd if transposed else oh * ow)
        flops = 2 * math.prod(w) * pixels
        nbytes = esize * (math.prod(x) + math.prod(w) + math.prod(b or [0])
                          + n * cout * oh * ow)
        return flops, nbytes
    if name == "aten::convolution_backward":
        g, x, w = dims[0], dims[1], dims[2]
        transposed = _list(concrete[7])
        mask = _list(concrete[10])
        pixels = (x[0] * x[2] * x[3]) if transposed else (
            g[0] * g[2] * g[3])
        per = 2 * math.prod(w) * pixels
        flops = per * (int(mask[0]) + int(mask[1]))
        cout = g[1]
        nbytes = esize * (math.prod(g)
                          + (math.prod(x) if mask[1] else 0)
                          + (math.prod(w) if mask[0] else 0)
                          + (math.prod(x) if mask[0] else 0)
                          + (math.prod(w) if mask[1] else 0)
                          + (cout if mask[2] else 0))
        return flops, nbytes
    raise ValueError(f"not a conv op: {name}")


def deform_cost(name: str, dims: list):
    """(FLOPs, bytes) of one call of the deform op's forward or backward
    from its recorded input dims: x (B, 1, H, W) first, then offset
    (B, 18, Hs, W)."""
    form = DEFORM_OPS[name]
    off = dims[1]
    pixels = off[0] * off[2] * off[3]
    return (DEFORM_FLOPS_PER_PIXEL[form] * pixels,
            DEFORM_BYTES_PER_PIXEL[form] * pixels)


def step_flops(model, inputs_shapes: list, train: bool, loss_fn=None) -> int:
    """FLOPs of one forward (``train`` False) or one train step's forward
    and backward (``train`` True, through ``loss_fn(pred)``) of ``model``
    (a module on the meta device) on inputs of ``inputs_shapes``: convs
    and matrix products by ``FlopCounterMode``, the deform op by the
    formulas above. The optimizer and elementwise work are not counted."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import deform

    with FakeTensorMode():
        params = {k: torch.empty(v.shape, dtype=v.dtype).requires_grad_(
            train and v.requires_grad)
            for k, v in model.named_parameters()}
        buffers = {k: torch.empty(v.shape, dtype=v.dtype)
                   for k, v in model.named_buffers()}
        inputs = [torch.empty(s) for s in inputs_shapes]
        model.train(train)
        with deform.counting() as calls, FlopCounterMode(
                display=False) as counter:
            with torch.set_grad_enabled(train):
                out = torch.func.functional_call(
                    model, {**params, **buffers}, (inputs,))
                if train:
                    leaves = [p for p in params.values() if p.requires_grad]
                    torch.autograd.grad(loss_fn(out), leaves)
        total = int(counter.get_total_flops())
    for x_shape, off_shape, x_grad in calls:
        pixels = off_shape[0] * off_shape[2] * off_shape[3]
        total += DEFORM_FLOPS_PER_PIXEL["forward"] * pixels
        if train:
            form = "backward_dx" if x_grad else "backward"
            total += DEFORM_FLOPS_PER_PIXEL[form] * pixels
    return total
