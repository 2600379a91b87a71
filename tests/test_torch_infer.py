"""The slice end to end: whole-scene ``--infer`` through the PyTorch port's
CLI vs the JAX package's, on the CPU.

Two scenes of 44x52 (padded to the /8 stride multiple and cropped back), a
JAX ``.npz`` checkpoint, and one config read by both CLIs. The [0,1]
prediction of ``upscale_dem`` agrees at the whole-model tolerance; the
rasters in metres at rtol 1e-3, because the log descale multiplies errors
by about ln(1009) * (z + 80).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from jspsr_tpu.cli.main import main as jax_cli_main
from jspsr_tpu.eval.inference import upscale_dem as jax_upscale_dem
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.checkpoint import save_checkpoint
from jspsr_tpu.train.step import make_forward as jax_make_forward
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.cli.main import main as port_cli_main
from jspsr_torch.config.loader import create_config
from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.eval.inference import (
    load_scene,
    make_forward,
    run_scene_inference,
    upscale_dem,
)
from jspsr_torch.models.factory import build_model
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.train.checkpoint import load_model_params

torch.set_num_threads(2)

FLAGSHIP = {"lr_dem": 1, "image": 3, "mask": 15}
H, W = 44, 52


def _terrain(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 120 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + 0.3 * xx
    return (z + rng.normal(0, 1.0, (h, w))).astype(np.float32)[..., None]


def _write_scene(root, name, seed, flat_names):
    rng = np.random.default_rng(seed)
    scene = root / name
    dem = _terrain(rng, H, W)
    img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    mask = np.eye(15, dtype=np.float32)[rng.integers(0, 15, (H, W))]
    if flat_names:
        write_raster(scene / "lr_dem.npy", dem)
        write_raster(scene / "image.npy", img)
        write_raster(scene / "mask.npy", mask)
    else:  # DFC30 subdir aliases
        write_raster(scene / "COP30" / "dem.npy", dem)
        write_raster(scene / "BDORTHO" / "ortho.npy", img)
        write_raster(scene / "UA2012" / "ua.npy", mask)
    return scene


def _perturb_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def _run_cli(main, argv):
    """Both CLIs tee sys.stdout into their result dir; restore it."""
    real_stdout = sys.stdout
    try:
        return main(argv)
    finally:
        logger, sys.stdout = sys.stdout, real_stdout
        if logger is not real_stdout:
            logger.close()


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    batch = root / "scenes"
    _write_scene(batch, "scene_a", seed=1, flat_names=False)
    _write_scene(batch, "scene_b", seed=2, flat_names=True)

    # weights: a seeded port model, carried to a JAX .npz checkpoint
    port = _perturb_bn(JSPSR(dict(FLAGSHIP), num_feature=8,
                             layers=(1, 1, 1, 1),
                             generator=torch.Generator().manual_seed(11)), 12)
    jax_model = JaxJSPSR(dict(FLAGSHIP), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jax_model, port.state_dict())
    save_checkpoint(root / "m.npz", params, bn)
    torch.save(port.state_dict(), root / "m.pt")

    cfg = {
        "name": "infer_test", "dataset": "DFC30", "resolution": 8,
        "model_name": "JSPSR", "relative": True,
        "input_data": {"COP30": 1, "image": 3, "mask": 15},
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_kwargs": {"num_block": 1, "num_feature": 8,
                         "checkpoint": str(root / "m.npz")},
        "loss": {"L1": 1}, "optimizer": "AdamW",
        "optimizer_kwargs": {"lr": 1e-3},
        "scheduler": "ConstantLR", "scheduler_kwargs": {},
        "train_batch_size": 2, "epochs": 1, "metric": {},
    }
    (root / "c.yml").write_text(yaml.safe_dump(cfg))
    cfg["model_kwargs"]["checkpoint"] = str(root / "m.pt")
    (root / "c_pt.yml").write_text(yaml.safe_dump(cfg))
    return root, jax_model, params, bn


def test_cli_infer_matches_jax(fixture_dir):
    root, *_ = fixture_dir
    common = ["--config", str(root / "c.yml"), "--infer", str(root / "scenes")]
    jax_paths = _run_cli(jax_cli_main, common + [
        "--out", str(root / "out_jax"), "--result-dir", str(root / "res_jax")])
    port_paths = _run_cli(port_cli_main, common + [
        "--out", str(root / "out_port"), "--result-dir", str(root / "res_port"),
        "--device", "cpu"])
    assert [p.name for p in port_paths] == [p.name for p in jax_paths] \
        == ["scene_a_sr.npy", "scene_b_sr.npy"]
    for pj, pp in zip(jax_paths, port_paths):
        ref, got = read_raster(pj), read_raster(pp)
        assert got.shape == (H, W, 1) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-3)
    log = (root / "res_port" / "train.log").read_text()
    assert "Inference: 2 scenes" in log


def test_upscale_dem_matches_jax(fixture_dir):
    root, jax_model, params, bn = fixture_dir
    p = create_config(root / "c.yml")
    sample, _ = load_scene(root / "scenes" / "scene_a", p)
    fwd = jax_make_forward(jax_model)
    ref, _, _ = jax_upscale_dem(lambda x: fwd(params, bn, x), sample, p)
    model = load_model_params(build_model(p), root / "m.npz")
    got, t_ms, _ = upscale_dem(make_forward(model), sample, p, device="cpu")
    assert got.shape == (H, W, 1) and t_ms > 0
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=2e-5)


def test_pt_checkpoint_matches_npz(fixture_dir):
    root, *_ = fixture_dir
    outs = []
    for cfg in ("c.yml", "c_pt.yml"):
        p = create_config(root / cfg)
        model = load_model_params(build_model(p), p.model_kwargs.checkpoint)
        path, _, _ = run_scene_inference(model, p, root / "scenes" / "scene_b",
                                         root / f"pt_{cfg}.npy", device="cpu")
        outs.append(read_raster(path))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_entry_points_need_cuda_or_explicit_cpu(fixture_dir, monkeypatch):
    root, *_ = fixture_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = create_config(root / "c.yml")
    model = load_model_params(build_model(p), root / "m.npz")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scene_inference(model, p, root / "scenes" / "scene_a",
                            root / "never.npy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_cli(port_cli_main, ["--config", str(root / "c.yml"), "--infer",
                                 str(root / "scenes" / "scene_a"),
                                 "--result-dir", str(root / "res_nocuda")])
    assert not (root / "never.npy").exists()


@pytest.mark.parametrize("flags", [["--tile", "--val"], ["--val"],
                                   ["--export", "x"], []])
def test_cli_unported_modes_raise(fixture_dir, tmp_path, flags):
    """None of the CLI's modes raises now. --export is ported: it goes
    before --infer (as in the JAX CLI) and writes a ``.pt2`` whose forward
    is the checkpoint's model (tests/test_torch_export.py holds it to JAX).
    --val is ported: with --infer, inference goes first (as the JAX CLI),
    whole or --tile; without --infer (``[]``) the CLI trains:
    ``Trainer.fit`` on a DFC30 tree, ending in a best checkpoint named with
    its RMSE."""
    root, *_ = fixture_dir
    argv = ["--config", str(root / "c.yml"), "--device", "cpu",
            "--result-dir", str(tmp_path / "res"), *flags]
    if flags:
        argv += ["--infer", str(root / "scenes"), "--out",
                 str(tmp_path / "out")]
    if flags and flags[0] == "--export":
        argv[argv.index("x")] = str(tmp_path / "x")
        out = _run_cli(port_cli_main, argv)
        assert out == tmp_path / "x.pt2" and out.exists()
        from jspsr_torch.eval.export import load_exported

        p = create_config(root / "c.yml")
        model = load_model_params(build_model(p), root / "m.npz").eval()
        rng = np.random.default_rng(0)
        side = p.patch_size  # the export's static size, the config's
        xs = [torch.from_numpy(rng.uniform(0, 1, (2, c, side, side)).astype(
            np.float32)) for c in (1, 3, 15)]
        with torch.no_grad():
            want = model(xs)
        torch.testing.assert_close(load_exported(out, device="cpu")(*xs),
                                   want, rtol=0, atol=1e-6)
        return
    if flags:
        if "--tile" in flags:  # tiles of 32 px: the scenes are 44 x 52
            cfg = yaml.safe_load((root / "c.yml").read_text())
            (tmp_path / "c32.yml").write_text(yaml.safe_dump(
                dict(cfg, patch_size=32)))
            argv[1] = str(tmp_path / "c32.yml")
        paths = _run_cli(port_cli_main, argv)
        assert [q.name for q in paths] == ["scene_a_sr.npy", "scene_b_sr.npy"]
        assert all(np.isfinite(read_raster(q)).all() for q in paths)
        return
    tree, train, valid = generate_mini_dfc30(
        tmp_path / "DFC30_8m", train_cities=("Brest",),
        valid_cities=("Vannes",), n_per_city=2, size=32)
    cfg = yaml.safe_load((root / "c.yml").read_text())
    cfg.update(data_root=str(tmp_path), train_set=train, valid_set=valid,
               patch_size=32, crop_mode="random", workers=1, verbose=False,
               metric={"RMSE": {"package": "local", "min": -80, "max": 929}})
    cfg["model_kwargs"]["checkpoint"] = None
    (tmp_path / "train.yml").write_text(yaml.safe_dump(cfg))
    argv[1] = str(tmp_path / "train.yml")
    out = _run_cli(port_cli_main, argv)
    assert "RMSE" in Path(out["checkpoint"]).name
    assert np.isfinite(out["result"]["RMSE"])


@pytest.fixture(scope="module")
def coord_dir(tmp_path_factory):
    """One ``lr_dem + image + coord`` scene (the DEM's profile places it
    inside the DFC30 bounds) and a JAX ``.npz`` checkpoint of a seeded
    coord-guided JSPSR."""
    from jspsr_torch.data.raster_io import default_profile

    root = tmp_path_factory.mktemp("coord")
    rng = np.random.default_rng(3)
    scene = root / "scene_c"
    write_raster(scene / "lr_dem.npy", _terrain(rng, H, W),
                 default_profile(H, W, 1, "float32", 300_000.0,
                                 6_800_000.0, 8.0))
    write_raster(scene / "image.npy",
                 rng.uniform(0, 255, (H, W, 3)).astype(np.float32))
    branches = {"lr_dem": 1, "image": 3, "coord": 2}
    port = _perturb_bn(JSPSR(dict(branches), num_feature=8,
                             layers=(1, 1, 1, 1),
                             generator=torch.Generator().manual_seed(13)), 14)
    jax_model = JaxJSPSR(dict(branches), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jax_model, port.state_dict())
    save_checkpoint(root / "m.npz", params, bn)
    return root, scene, jax_model, params, bn


@pytest.mark.parametrize("tile", [False, True], ids=["whole", "tile"])
@pytest.mark.parametrize("mode", ["local", "global"])
def test_coord_scene_matches_jax(coord_dir, tmp_path, mode, tile):
    """Coordinate guidance at ``--infer``: ``load_scene`` builds the coord
    channels from the LR DEM's grid as the dataset does (``coord_mode``
    local or global), and the scene in metres, whole or device-tiled (32²
    tiles; the float channels ride as f32), agrees with the JAX package's
    at rtol 1e-3 (the log descale, as above)."""
    from jspsr_tpu.eval.inference import load_scene as jax_load_scene
    from jspsr_tpu.eval.inference import \
        run_scene_inference as jax_run_scene_inference
    from jspsr_torch.eval.scene import prepare_scene

    root, scene, jax_model, params, bn = coord_dir
    cfg = {"name": "coord_test", "dataset": "DFC30", "resolution": 8,
           "model_name": "JSPSR", "relative": True, "patch_size": 32,
           "coord_mode": mode,
           "input_data": {"COP30": 1, "image": 3, "coord": 2},
           "tensor_kwargs": {"log": True, "min": -80, "max": 929},
           "model_kwargs": {"num_block": 1, "num_feature": 8,
                            "checkpoint": str(root / "m.npz")},
           "loss": {"L1": 1}, "optimizer": "AdamW",
           "optimizer_kwargs": {"lr": 1e-3}, "scheduler": "ConstantLR",
           "scheduler_kwargs": {}, "train_batch_size": 2, "epochs": 1,
           "metric": {}}
    (tmp_path / "c.yml").write_text(yaml.safe_dump(cfg))
    p = create_config(tmp_path / "c.yml")
    sample, _ = load_scene(scene, p)
    want, _ = jax_load_scene(scene, p)
    assert sample["coord"].dtype == np.float32
    np.testing.assert_array_equal(sample["coord"], want["coord"])
    if tile:
        assert prepare_scene(sample, p, tile=32).enc["coord"] == ("f32", 2)
    model = load_model_params(build_model(p), root / "m.npz")
    got_path, _, _ = run_scene_inference(model, p, scene,
                                         tmp_path / "port.npy", tile=tile,
                                         device="cpu")
    ref_path, _, _ = jax_run_scene_inference(jax_model, params, bn, p, scene,
                                             tmp_path / "jax.npy", tile=tile)
    got, ref = read_raster(got_path), read_raster(ref_path)
    assert got.shape == (H, W, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3)
