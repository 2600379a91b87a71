"""Shared fixtures of the benchmark's CPU tests: tiny cells on the CPU,
the port's plain kernels standing in for the card's."""

from __future__ import annotations

import pytest

from benchmark import cells

TINY_CITIES = ["Brest", "Caen", "Calais_Dunkerque", "Cherbourg",
               "Clermont-Ferrand", "LeMans", "Lorient", "Marseille_Martigues"]


def tiny_ctx(name: str, tmp_path, seed: int = 2 ** 31 + 11, **kw):
    """A cell at a test's size on the CPU: JSPSR at num_feature 8 and one
    block, batches of 2 from 8 samples; scenes of 160² (a 2 x 2 grid)."""
    kind = cells.cell(name)["driver"]
    if kind == "train":
        program = {"model_kwargs": {"num_feature": 8, "num_block": 1},
                   "train_batch_size": 2, "workers": 1}
        traffic = {"n_per_city": 1, "train_cities": TINY_CITIES}
    else:
        program = {"model_kwargs": {"num_feature": 8, "num_block": 1}}
        traffic = {"n_scenes": 4, "side": 160}
    program.update(kw.pop("program", {}))
    traffic.update(kw.pop("traffic", {}))
    return cells.Ctx.load(name, seed=seed, seconds=kw.pop("seconds", 0.5),
                          trace=kw.pop("trace", False), tmp=tmp_path,
                          device="cpu", program=program, traffic=traffic,
                          **kw)


@pytest.fixture
def tiny():
    return tiny_ctx
