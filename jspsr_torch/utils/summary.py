"""Model summaries and step traces (counterpart of
``jspsr_tpu/utils/summary.py``; reference utils/utils.py:80-135,709-720).

- ``count_parameters``: the model's parameter count;
- ``count_flops``: the FLOPs of one call (a train step's, for example);
- ``model_summary``: per-subtree parameter counts, the eval forward's
  output shape and dtype, and its FLOPs. Shape and FLOPs come from one
  eval forward on fake tensors (``FakeTensorMode``) under
  ``FlopCounterMode``, the counterpart of ``jax.eval_shape`` plus the
  lowered program's cost analysis: no arithmetic is done and no device
  memory is taken. The count is of the convolutions (a conv counts
  2 x Cin/groups x Cout x kh x kw FLOPs per output pixel, a transposed one
  the same per input pixel, padding taps included), matrix products and
  the deform op (its formula is in ``ops/deform_conv.py``); elementwise
  work is not counted;
- ``trace_step``: a ``torch.profiler`` trace around one call, exported as
  Chrome JSON; ``start_profile`` / ``stop_profile`` start and stop such a
  trace, for it and for the Trainer's ``profile_steps``.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch
from torch.utils import _pytree as pytree


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)`` once under ``FlopCounterMode``; returns
    ``(out, flops)``. The count is of the ops with a FLOP formula: the
    convolutions and their backward, matrix products and their backward,
    and the deform forward (``ops/deform_conv.py``). The deform op's two
    backward ops have no formula, so a train step's count leaves them
    out; elementwise work and the optimizer are not counted either."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, int(counter.get_total_flops())


def forward_cost(model: torch.nn.Module, example_inputs):
    """(output shape, output dtype, FLOPs) of ``model``'s eval forward on
    ``example_inputs`` (its one positional argument: a list of NCHW
    tensors, or one tensor for EDSR), from one forward on fake tensors of
    the inputs' shapes, dtypes and devices under ``FlopCounterMode``. The
    model's training flag is restored afterwards. Raises if the forward
    or the count fails."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    was_training = model.training
    model.eval()
    try:
        # every tensor the forward sees is fake, the weights too: a real
        # one-element tensor would be a constant, on which fake tensors run
        # the op for real (on the card, a real allocation)
        with FakeTensorMode() as fake_mode:
            fake = pytree.tree_map_only(
                torch.Tensor, fake_mode.from_tensor,
                ({**dict(model.named_parameters()),
                  **dict(model.named_buffers())}, example_inputs))
            with torch.no_grad():
                out, flops = count_flops(torch.func.functional_call, model,
                                         fake[0], (fake[1],))
    finally:
        model.train(was_training)
    return tuple(out.shape), out.dtype, flops


def model_summary(model: torch.nn.Module, example_inputs,
                  max_depth: int = 1) -> str:
    """A text table of per-subtree parameter counts (``named_parameters``
    grouped by their first ``max_depth`` names), ``TOTAL``, the eval
    forward's ``output: <shape> <dtype>`` (NCHW) and ``forward flops``
    (``forward_cost``), in the JAX package's layout."""
    groups: dict = {}
    for name, param in model.named_parameters():
        top = ".".join(name.split(".")[:max_depth])
        groups[top] = groups.get(top, 0) + param.numel()
    width = max(len(k) for k in groups)
    lines = [f"{k:<{width}}  {groups[k]:>12,}" for k in sorted(groups)]
    lines.append(f"{'TOTAL':<{width}}  {count_parameters(model):>12,}")
    shape, dtype, flops = forward_cost(model, example_inputs)
    lines.append(f"output: {shape} {dtype}")
    lines.append(f"forward flops: {flops:.3e}")
    return "\n".join(lines)


def start_profile(cuda: bool) -> torch.profiler.profile:
    """A started ``torch.profiler`` trace of the host and, with ``cuda``,
    of the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, path, device=None) -> Path:
    """Wait for the card (with a CUDA ``device``), stop ``prof`` and write
    its trace as Chrome JSON to ``path``; returns the path."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return path


def _cuda_device(tree):
    """The device of the first CUDA tensor in ``tree``, or None."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def trace_kernels(trace_path) -> list:
    """The device-kernel events (``"cat": "kernel"``) of a Chrome trace."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def trace_step(fn, *args, log_dir=None, **kwargs):
    """Call ``fn(*args, **kwargs)`` once under a ``torch.profiler`` trace,
    with the card's activity when a tensor argument is on the card, and
    wait for the card before the profiler stops (the counterpart of
    ``jax.block_until_ready``). The trace is written to
    ``log_dir/trace_<n>.json`` (``log_dir`` defaults to ``jspsr_trace``
    under the temporary directory; ``n`` counts the traces already there).
    Returns ``(out, log_dir)``. A trace on the card without one device
    kernel (the profiler's CUDA tracing missing) raises."""
    log_dir = Path(log_dir) if log_dir is not None \
        else Path(tempfile.gettempdir()) / "jspsr_trace"
    device = _cuda_device((args, kwargs))
    prof = start_profile(device is not None)
    try:
        with torch.profiler.record_function("trace_step"):
            out = fn(*args, **kwargs)
            if device is not None:
                torch.cuda.synchronize(device)
    finally:
        n = len(list(log_dir.glob("trace_*.json"))) if log_dir.is_dir() \
            else 0
        path = stop_profile(prof, log_dir / f"trace_{n:03d}.json", device)
    if device is not None and not trace_kernels(path):
        raise RuntimeError(f"trace_step: the trace {path} holds no device "
                           "kernel; the profiler did not trace the card")
    return out, log_dir
