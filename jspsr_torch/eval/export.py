"""Deployable inference artifacts through ``torch.export`` (counterpart of
``jspsr_tpu/eval/export.py``).

``save_exported`` writes the model's eval forward, weights inside, to one
``.pt2`` file (``torch.export.save``); ``load_exported`` reads it back with
``torch`` and the port's op library alone (``jspsr_torch.ops.deform_conv``,
whose import registers ``jspsr::deform_conv2d``): no model class, config
or checkpoint code. The batch dimension is symbolic (``torch.export.Dim``),
so one file serves any batch; the spatial sizes stay static, the tile size
the model serves (``eval/scene.py`` batches tiles of larger scenes).

Contract, the JAX package's in the port's layout: per-modality NCHW
float32 inputs in the model's input order, normalised exactly as in
training, go in; the normalised prediction (B, 1, H, W) comes out.
Normalising and descaling stay outside (``data/normalize.py``,
``eval/inference.py``): they belong to the dataset's config, not to the
weights.

The deformable conv is one node of the graph, ``jspsr::deform_conv2d`` (a
``torch.library.custom_op`` with a fake; ``ops/deform_conv.py``). At run
time it launches K1 on a CUDA tensor and takes the plain version on a CPU
tensor, so one artifact serves both, as the JAX package's default artifact
serves CPU and TPU, and it keeps the kernel, as the JAX ``[tpu]`` artifact
keeps the Pallas call. ``export_platforms`` therefore chooses nothing
here: ``[cpu, tpu]`` (the JAX default, a portable lowering without the
kernel) and ``[tpu]`` (the JAX artifact that keeps the kernel) both map
onto this one artifact, ``tpu`` read as the accelerator; ``cuda`` names it
directly. A scalar string is a one-element list, and a name outside those
raises: no value swaps the kernel for another implementation.

An example batch of 1 would specialise the symbolic batch (``torch.export``
takes a dimension of size 1 as constant), so the trace uses a batch of
``EXAMPLE_BATCH``. A forward must not read a value on the host (``.item()``,
numpy, a Python branch on data) to trace; every family of the port traces
as it is. Tensors that a forward makes with an explicit device (NLSPN's
position grids) are traced on the model's device; ``load_exported`` moves
the program, constants and such device arguments included, to the device
asked for (``torch.export.passes.move_to_device_pass``).
"""

from __future__ import annotations

from pathlib import Path

import torch

# registers jspsr::deform_conv2d and its backward ops, with their fakes
import jspsr_torch.ops.deform_conv  # noqa: F401

ARTIFACT_SUFFIX = ".pt2"
EXAMPLE_BATCH = 2
MAX_BATCH = 65535
# the names ``export_platforms`` may hold (module docstring)
PLATFORMS = ("cpu", "tpu", "cuda")


def export_platforms(value) -> tuple:
    """The config's ``export_platforms`` as a tuple of names (default the
    JAX package's ``("cpu", "tpu")``; a scalar string is one name); raises
    on a name outside ``PLATFORMS``. Every value gives the same artifact."""
    names = (value,) if isinstance(value, str) else tuple(value or
                                                          ("cpu", "tpu"))
    unknown = [n for n in names if n not in PLATFORMS]
    if unknown or not names:
        raise ValueError(f"export_platforms {value!r}: each must be one of "
                         f"{PLATFORMS}")
    return names


class _Flat(torch.nn.Module):
    """The model's forward on flat per-modality inputs."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *inputs):
        return self.model(list(inputs))


def export_inference(model: torch.nn.Module, example_inputs,
                     batch_symbol: str = "b"):
    """``torch.export`` of ``model``'s eval forward on its device: an
    ``ExportedProgram``. Only the shapes and types of ``example_inputs``
    (per-modality NCHW tensors at the served tile size) are read; the batch
    becomes the symbolic dimension ``batch_symbol``."""
    device = next(model.parameters()).device
    examples = tuple(
        torch.zeros((EXAMPLE_BATCH, *x.shape[1:]), dtype=x.dtype,
                    device=device) for x in example_inputs)
    # a trace on the card bounds the batch at 65,535 (torch 2.11's CUDA
    # ops guard it); without the bound that guard refuses the export
    batch = torch.export.Dim(batch_symbol, max=MAX_BATCH)
    return torch.export.export(
        _Flat(model.eval()), examples,
        dynamic_shapes=(tuple({0: batch} for _ in examples),))


def save_exported(path, model: torch.nn.Module, example_inputs) -> Path:
    """``export_inference`` written to ``path`` (suffix ``.pt2`` added
    where missing)."""
    path = Path(path)
    if path.suffix != ARTIFACT_SUFFIX:
        path = path.with_suffix(path.suffix + ARTIFACT_SUFFIX)
    program = export_inference(model, example_inputs)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path, device="cuda"):
    """Read an artifact onto ``device`` (the card unless ``"cpu"``): a
    callable ``fn(*inputs) -> pred`` that runs without autograd. Needs
    ``torch`` and the op library only; raises where CUDA is asked for and
    absent."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_exported: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"load_exported: unsupported device {device}")
    module = move_to_device_pass(torch.export.load(path), device).module()

    def fn(*inputs):
        with torch.inference_mode():
            return module(*inputs)

    return fn
