"""Plain PyTorch reference of what the benchmark's cells run: the models
(frozen copies of the port's architectures, without its kernels, options
or sharding), the DFC30 feed, the losses, AdamW and the tiled scene
server's arithmetic. It imports neither JAX nor anything of ``jspsr_torch``
and takes nothing the port made: it reads the raw tree and scenes that the
benchmark wrote, and builds its weights from the seed itself."""

import importlib


def reference_model(program: dict):
    """The reference model of a port config: ``reference/<model_name, lower
    case>.py``'s ``build(program)``, on the meta device."""
    name = program["model_name"].lower()
    return importlib.import_module(f"benchmark.reference.{name}").build(
        program)
