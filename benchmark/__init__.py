"""The benchmark of the PyTorch/CUDA port ``jspsr_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Everything is found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``traffic/<traffic>.json``,
``drivers/<kind>.py`` and ``metrics/<metric>.py``. ``reference/`` is the
plain PyTorch reference that decides ``correct``; it imports nothing of
the port.
"""
