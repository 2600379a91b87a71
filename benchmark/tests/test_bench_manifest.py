"""BENCHMARK.json against the contract's rules, and every piece of each
cell found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = cells.manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"bound"} if "bound" in metric else {"layer", "moves"}
    assert set(metric) <= keys and set(metric) >= keys - {"workloads"}
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        if metric["name"].endswith("_roofline") or "_roofline." in \
                metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_setup_s_is_an_end_to_end_metric():
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    c = cells.cell(cell["name"])
    assert c["config"] == cell["config"] and c["traffic"] == cell["traffic"]
    assert cell["chips"] == c["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cells.config(c["config"])["program"]
    assert cells.traffic(c["traffic"])["kind"]
    assert callable(cells.driver(c["driver"]).run)
    assert set(c["limits"]) >= ({"loss", "grad", "change"}
                                if c["driver"] == "train"
                                else {"raster_m", "missing"})
    reported = {m["name"] for m in cells.cell_metrics(MAN, cell["name"],
                                                      "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    layer = cells.cell_metrics(MAN, cell["name"], "per_layer")
    assert layer
    for m in layer:
        assert callable(cells.reader(m["name"]).read)
        assert m["moves"] in reported


def test_configs_used_and_files_under_paths():
    used = {c["config"] for c in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = cells.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(c["config"], c["traffic"]) for c in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
