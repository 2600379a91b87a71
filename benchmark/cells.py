"""Everything of the benchmark found by name: the manifest
(``BENCHMARK.json`` at the root), a cell (``workloads/<cell>.json``), its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its driver (``drivers/<kind>.py``) and the
per-layer readers (``metrics/<metric>.py``). A new cell, configuration,
traffic mix or metric is a new file; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """``drivers/<kind>.py``: ``run(ctx) -> Result``."""
    return _module(HERE / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def reader(metric: str):
    """``metrics/<metric>.py``: ``read(record) -> float | None``."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "benchmark_metric_" + metric.replace(".", "_"))


def cell_metrics(man: dict, cell_name: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that a
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in man[section]
            if cell_name in m.get("workloads", [cell_name])]


@dataclasses.dataclass
class Ctx:
    """One run: the cell and what it names, the run's arguments, its
    scratch directory and device. ``program`` overrides keys of the
    configuration's port config and ``traffic`` of the traffic spec (the
    CPU tests' small sizes); a real run passes none."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    tmp: Path
    device: str = "cuda"
    program: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, name: str, **kw) -> "Ctx":
        c = cell(name)
        tr = traffic(c["traffic"])
        tr.update(kw.pop("traffic", None) or {})
        return cls(name=name, cell=c, config=config(c["config"]),
                   traffic=tr, **kw)

    def port_config(self):
        """The port's config (``jspsr_torch.config.loader.create_config``
        on the configuration's ``program`` with this run's overrides), its
        ``data_root`` and ``work_root`` in the scratch directory and its
        ``seed`` the run's."""
        from jspsr_torch.config.loader import create_config

        prog = json.loads(json.dumps(self.config["program"]))
        prog.update(self.program)
        prog.update(data_root=str(self.tmp), work_root=str(self.tmp),
                    seed=int(self.seed))
        path = self.tmp / "config.json"
        path.write_text(json.dumps(prog))
        return create_config(path)

    def reference_program(self) -> dict:
        prog = json.loads(json.dumps(self.config["program"]))
        prog.update(self.program)
        return prog


@dataclasses.dataclass
class Result:
    """What a driver hands back: the counts, the end-to-end metrics of the
    window (``--trace 0``), the record the per-layer readers read
    (``--trace 1``), the numbers compared (name -> (value, limit)) and
    the device's peak memory."""

    attempted: int
    failed: int
    end_to_end: dict
    record: dict
    compared: dict
    memory_peak_bytes: int
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.compared.values())
