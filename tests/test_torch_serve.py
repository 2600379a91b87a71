"""Pipelined multi-scene serving in the PyTorch port vs the JAX package, on
the CPU (mirrors tests/test_serve.py).

A tiny JSPSR (num_feature 8, layers (1,1,1,1), lr_dem + RGB) is built once
in the port and carried into JAX with ``import_torch_state_dict``; both
packages' ``serve_scenes`` run the same scene directories. Outputs in
metres agree at the whole-model rtol 1e-4 with the JAX suite's tiled atol
5e-3 m (tests/test_scene_device.py:141; see tests/test_torch_scene.py for
why the rtol); the port's batched and unbatched runs at the JAX suite's
tolerance between tile batch sizes (rtol 2e-4 / atol 5e-3 m); the loader
pool and the serial loader bit for bit. Both CLIs' ``--infer --tile`` over
a directory and over one scene agree at rtol 1e-3 / atol 1e-2 m
(test_torch_infer.py's rtol for metres).
"""

import copy
import sys

import numpy as np
import pytest
import torch
import yaml

from jspsr_tpu.cli.main import main as jax_cli_main
from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.eval import serve as jax_serve
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.checkpoint import save_checkpoint
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.cli.main import main as port_cli_main
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval import serve
from jspsr_torch.eval.inference import load_scene
from jspsr_torch.eval.scene import tile_inference_device
from jspsr_torch.models.jspsr import JSPSR

torch.set_num_threads(4)

BASE_P = {
    "model_name": "JSPSR", "relative": True, "normalize": False,
    "mask_channel": None, "patch_size": 64,
    "input_data": {"lr_dem": 1, "image": 3},
    "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                      "scale_mask": True},
    "model_kwargs": {"num_feature": 8, "num_block": 1},
}
METRES = dict(rtol=1e-4, atol=5e-3)
BATCHES = dict(rtol=2e-4, atol=5e-3)
CLI = dict(rtol=1e-3, atol=1e-2)


def _p(**over):
    d = copy.deepcopy(BASE_P)
    d.update(over)
    return AttrDict(copy.deepcopy(d)), JaxAttrDict(copy.deepcopy(d))


def _write_scenes(root, sizes, seed):
    rng = np.random.default_rng(seed)
    for i, size in enumerate(sizes):
        h, w = (size, size) if isinstance(size, int) else size
        d = root / f"scene{i}"
        write_raster(d / "lr_dem.npy",
                     rng.uniform(10, 200, (h, w, 1)).astype(np.float32))
        write_raster(d / "image.npy",
                     rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    port = JSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                 layers=(1, 1, 1, 1),
                 generator=torch.Generator().manual_seed(3)).eval()
    jm = JaxJSPSR({"lr_dem": 1, "image": 3}, num_feature=8,
                  layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jm, port.state_dict())
    root = tmp_path_factory.mktemp("serve")
    batch = _write_scenes(root / "batch", [96] * 5, seed=13)
    return port, (jm, params, bn), root, serve.discover_scenes(batch)


def _read_all(paths):
    return [read_raster(q) for q in paths]


def test_discover_scenes(tiny):
    _, _, root, scenes = tiny
    assert [s.name for s in scenes] == [f"scene{i}" for i in range(5)]
    assert serve.discover_scenes(root / "batch" / "scene0") == []
    assert serve.discover_scenes(root / "missing") == []


@pytest.mark.parametrize("scene_batch", [1, 2])
def test_serve_matches_jax(tiny, tmp_path, scene_batch):
    """Five scenes; at scene_batch 2 two full groups and a padded tail."""
    port, (jm, params, bn), _, scenes = tiny
    p, jp = _p()
    got, t_ms, sps = serve.serve_scenes(port, p, scenes, tmp_path / "port",
                                        tile=64, scene_batch=scene_batch,
                                        device="cpu")
    ref, _, _ = jax_serve.serve_scenes(jm, params, bn, jp, scenes,
                                       tmp_path / "jax", tile=64,
                                       scene_batch=scene_batch)
    assert t_ms > 0 and sps > 0
    assert [q.name for q in got] == [q.name for q in ref] == [
        f"scene{i}_sr.npy" for i in range(5)]
    for a, b in zip(_read_all(got), _read_all(ref)):
        assert a.shape == (96, 96, 1)
        np.testing.assert_allclose(a, b, **METRES)


def test_serve_matches_single_scene(tiny, tmp_path):
    """Batched serving against one-at-a-time ``tile_inference_device``."""
    port, _, _, scenes = tiny
    p, _ = _p()
    paths, _, _ = serve.serve_scenes(port, p, scenes, tmp_path, tile=64,
                                     scene_batch=4, device="cpu")
    for sp, op in zip(scenes, paths):
        sample, _ = load_scene(sp, p)
        single, _ = tile_inference_device(port, sample, p, tile=64,
                                          device="cpu")
        np.testing.assert_allclose(read_raster(op), single, **BATCHES)


def test_serve_mixed_shapes(tiny, tmp_path):
    """A shape change mid-stream flushes the group; every scene completes
    with its own shape, rectangles and padded grids included."""
    port, _, _, _ = tiny
    p, _ = _p()
    sizes = (96, 96, 130, (96, 150), 96)
    scenes = serve.discover_scenes(_write_scenes(tmp_path / "mixed", sizes,
                                                 seed=17))
    paths, _, _ = serve.serve_scenes(port, p, scenes, tmp_path / "out",
                                     tile=64, scene_batch=3, device="cpu")
    got = {q.name: read_raster(q) for q in paths}
    assert {k: v.shape for k, v in got.items()} == {
        "scene0_sr.npy": (96, 96, 1), "scene1_sr.npy": (96, 96, 1),
        "scene2_sr.npy": (130, 130, 1), "scene3_sr.npy": (96, 150, 1),
        "scene4_sr.npy": (96, 96, 1)}
    assert all(np.isfinite(v).all() for v in got.values())


def test_serve_loader_pool_matches_serial(tiny, tmp_path):
    """loader_threads=2 (concurrent decode+prepare, in-order hand-off)
    writes bit-identical rasters in the same order as the serial loader,
    with scene_batch grouping; a broken scene still surfaces."""
    port, _, _, scenes = tiny
    p, _ = _p()
    serial, _, _ = serve.serve_scenes(port, p, scenes, tmp_path / "o1",
                                      tile=64, scene_batch=2, device="cpu")
    pooled, _, sps = serve.serve_scenes(port, p, scenes, tmp_path / "o2",
                                        tile=64, scene_batch=2,
                                        loader_threads=2, device="cpu")
    assert sps > 0 and [q.name for q in pooled] == [q.name for q in serial]
    for a, b in zip(_read_all(serial), _read_all(pooled)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("loader_threads", [1, 3])
def test_serve_bad_scene_raises_after_drain(tiny, tmp_path, loader_threads):
    port, _, _, _ = tiny
    p, _ = _p()
    batch = _write_scenes(tmp_path / "bad", [96] * 3, seed=2)
    (batch / "scene1" / "image.npy").unlink()  # image required by config
    with pytest.raises(FileNotFoundError, match="missing 'image'"):
        serve.serve_scenes(port, p, serve.discover_scenes(batch),
                           tmp_path / "out", tile=64,
                           loader_threads=loader_threads, device="cpu")


def test_serve_refuses_mesh_and_needs_cuda(tiny, tmp_path, monkeypatch):
    port, _, _, scenes = tiny
    p, _ = _p()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        serve.serve_scenes(port, p, scenes, tmp_path, tile=64, mesh=object(),
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_scenes(port, p, scenes, tmp_path, tile=64)


@pytest.mark.parametrize("cap_tiles", [176, serve.CAP_TILES, 100])
def test_auto_scene_batch_matches_jax(cap_tiles):
    sizes = [(128, 128), (200, 200), (334, 334), (512, 512), (768, 768),
             (1024, 1024), (1500, 1500), (2048, 2048), (334, 1024),
             (1024, 334), (500, 700), (90, 60)]
    for hw in sizes:
        for n in (None, 1, 3, 16):
            assert serve.auto_scene_batch(hw, n_scenes=n,
                                          cap_tiles=cap_tiles) == \
                jax_serve.auto_scene_batch(hw, n_scenes=n,
                                           cap_tiles=cap_tiles), (hw, n)
    assert serve.auto_scene_batch((334, 334), cap_tiles=176) == 8
    assert serve.auto_scene_batch((1024, 1024), cap_tiles=176) == 2


def test_probe_scene_hw(tmp_path):
    d = tmp_path / "scene0"
    write_raster(d / "lr_dem.npy", np.zeros((40, 56, 1), np.float32))
    assert serve.probe_scene_hw(d) == (40, 56)
    assert serve.probe_scene_hw(d / "lr_dem.npy") == (40, 56)
    with pytest.raises(FileNotFoundError):
        serve.probe_scene_hw(tmp_path)


def _run_cli(main, argv):
    """Both CLIs tee sys.stdout into their result dir; restore it."""
    real_stdout = sys.stdout
    try:
        return main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()


def test_cli_tile_matches_jax_cli(tiny, tmp_path):
    """``--infer <dir> --tile`` (the pipelined server, auto batch) and
    ``--infer <scene> --tile`` (one 96 x 150 scene, device-tiled) through
    both CLIs, one JAX ``.npz`` checkpoint and one config."""
    port, (jm, params, bn), root, _ = tiny
    save_checkpoint(tmp_path / "m.npz", params, bn)
    cfg = {**copy.deepcopy(BASE_P), "name": "t", "dataset": "DFC30",
           "resolution": 8, "input_data": {"COP30": 1, "image": 3},
           "model_kwargs": {"num_block": 1, "num_feature": 8,
                            "checkpoint": str(tmp_path / "m.npz")},
           "loss": {"L1": 1}, "optimizer": "Adam",
           "optimizer_kwargs": {"lr": 1e-3}, "metric": {}}
    (tmp_path / "c.yml").write_text(yaml.safe_dump(cfg))
    rect = _write_scenes(tmp_path / "rect", [(96, 150)], seed=5) / "scene0"
    outs = {}
    for name, main, extra in (("jax", jax_cli_main, []),
                              ("port", port_cli_main, ["--device", "cpu"])):
        common = ["--config", str(tmp_path / "c.yml"), "--tile", *extra]
        dir_paths = _run_cli(main, common + [
            "--infer", str(root / "batch"), "--out", str(tmp_path / name),
            "--result-dir", str(tmp_path / f"res_{name}")])
        one = _run_cli(main, common + [
            "--infer", str(rect), "--out", str(tmp_path / f"{name}.npy"),
            "--result-dir", str(tmp_path / f"res1_{name}")])
        outs[name] = _read_all(list(dir_paths) + [one])
    assert len(outs["port"]) == 6 and outs["port"][-1].shape == (96, 150, 1)
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, b, **CLI)
    log = (tmp_path / "res_port" / "train.log").read_text()
    assert "Inference: 5 scenes" in log and "scenes/s" in log


def test_compat_key_separates_overlaps():
    """The overlap sets the grid: scenes of two overlaps never stack into
    one batched run, even where their padded arrays share a shape."""
    from jspsr_torch.eval.scene import prepare_scene

    p, _ = _p()
    rng = np.random.default_rng(12)
    s = {"lr_dem": rng.uniform(10, 200, (160, 160, 1)).astype(np.float32),
         "image": rng.integers(0, 255, (160, 160, 3)).astype(np.float32)}
    a, b, c = (prepare_scene(s, p, tile=64, min_overlap=o)
               for o in (16, 32, 16))
    assert a.arrays["lr_dem"].shape == b.arrays["lr_dem"].shape
    assert serve._compat_key(a) != serve._compat_key(b)
    assert serve._compat_key(a) == serve._compat_key(c)
