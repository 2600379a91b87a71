"""The port's evaluation (``eval/loop.py``, ``eval/summarise.py``) against
the JAX package's on one mini-DFC30 tree with the same weights.

``eval_model``: the loss and every score at rtol 1e-4 (the JAX suite's
whole-model tolerance; the metres of Median and LE95, which pick one
sorted element, also at atol 1e-4 m), with a valid batch of 3 over 4
samples, so that the last batch holds 1 sample padded to 3; the
bicubic-input baseline (``compare_input``) likewise; the saved prediction
rasters, in metres, at rtol 1e-3 / atol 1e-2 m (the tolerance for metres
of ``test_torch_infer.py`` and ``chip_smoke.py``: the model's atol of 2e-5
on the log-scaled DEM grows by the descaling's factor, log(1009) times the
elevation above -80 m) and their profiles equal. ``summarise_run`` reads the
same rasters in both packages with the same numpy: rtol 1e-6.
"""

import json

import numpy as np
import pytest
import torch

from jspsr_tpu.config.loader import AttrDict as JaxAttrDict
from jspsr_tpu.data.dfc30 import DFC30 as JaxDFC30
from jspsr_tpu.data.loader import DataLoader as JaxDataLoader
from jspsr_tpu.data.transforms import build_transforms as jax_build_transforms
from jspsr_tpu.eval.loop import eval_model as jax_eval_model
from jspsr_tpu.eval.loop import get_visual_id as jax_get_visual_id
from jspsr_tpu.eval.summarise import summarise_run as jax_summarise_run
from jspsr_tpu.losses import build_criterion as jax_build_criterion
from jspsr_tpu.models.jspsr import JSPSR as JaxJSPSR
from jspsr_tpu.train.step import make_eval_step as jax_make_eval_step
from jspsr_tpu.utils.torch_import import import_torch_state_dict
from jspsr_torch.config.loader import AttrDict
from jspsr_torch.data.dfc30 import DFC30
from jspsr_torch.data.loader import DataLoader
from jspsr_torch.data.raster_io import read_raster
from jspsr_torch.data.synthetic import generate_mini_dfc30
from jspsr_torch.data.transforms import build_transforms
from jspsr_torch.eval.loop import eval_model, get_visual_id, save_prediction
from jspsr_torch.eval.summarise import summarise_run
from jspsr_torch.losses import build_criterion
from jspsr_torch.models.jspsr import JSPSR
from jspsr_torch.train.step import make_eval_step
from jspsr_torch.utils.perturb import perturb_weights

torch.set_num_threads(2)

INPUTS = {"lr_dem": 1, "image": 3, "mask": 15}
ELEV = {"border": 0.05, "min": -80, "max": 929}
METRIC = {"PSNR": {"package": "piq", **ELEV},
          "SSIM": {"package": "piq", **ELEV},
          "RMSE": {"package": "local", **ELEV},
          "Median": {"package": "local", **ELEV},
          "NMAD": {"package": "local", **ELEV},
          "LE95": {"package": "local", **ELEV},
          "Slope": {"package": "local", **ELEV}}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tree, the config, the port model and, once per fixture, the
    JAX package's eval of it (its compiles are the slow part)."""
    tmp = tmp_path_factory.mktemp("eval")
    root, train, valid = generate_mini_dfc30(
        tmp / "DFC30_8m", train_cities=("Brest",), valid_cities=("Vannes",),
        n_per_city=4, size=48)
    cfg = {
        "name": "eval_test", "dataset": "DFC30", "dataset_path": str(root),
        "resolution": 8, "train_set": train, "valid_set": valid,
        "input_data": {"lr_dem": 1, "COP30": 1, "image": 3, "mask": 15},
        "relative": True, "patch_size": 32, "crop_mode": "random",
        "patches_per_image": 1,
        "tensor_kwargs": {"log": True, "min": -80, "max": 929,
                          "scale_mask": True},
        "model_name": "JSPSR", "loss": {"L1": 1, "L2": 1, "Grad": 0.1},
        "valid_batch_size": 3, "metric": METRIC, "seed": 0,
    }
    port = perturb_weights(JSPSR(dict(INPUTS), num_feature=8,
                                 layers=(1, 1, 1, 1),
                                 generator=torch.Generator().manual_seed(5)),
                           seed=6, affine=True).eval()
    jax_model = JaxJSPSR(dict(INPUTS), num_feature=8, layers=(1, 1, 1, 1))
    params, bn = import_torch_state_dict(jax_model, port.state_dict())

    pj = JaxAttrDict(cfg)
    criterion = jax_build_criterion(dict(pj.loss))
    want = jax_eval_model(pj, _loader("jax", pj, 3), jax_make_eval_step(
        jax_model, criterion), params, bn, criterion, compare_input=True,
        save_dir=tmp / "jax_pred")
    return tmp, cfg, port, want


def _loader(pkg, p, batch):
    dfc, tf, dl = ((DFC30, build_transforms, DataLoader) if pkg == "torch"
                   else (JaxDFC30, jax_build_transforms, JaxDataLoader))
    data_kwargs = {k: v for k, v in p.items() if k != "seed"}
    ds = dfc(split="valid", transform=tf(p)[1], seed=p["seed"],
             **data_kwargs)
    return dl(ds, batch, shuffle=False, num_workers=1)


def _port_eval(cfg, port, batch, **kw):
    p = AttrDict(dict(cfg, valid_batch_size=batch))
    step = make_eval_step(port, build_criterion(dict(p.loss)))
    return eval_model(p, _loader("torch", p, batch), step, "cpu", **kw)


def _assert_scores(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        atol = 1e-4 if k in ("Median", "LE95") else 0.0
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=atol,
                                   err_msg=k)


def test_eval_model_matches_jax(env):
    """Batch 3 over 4 samples: one full batch, then 1 sample padded to 3;
    the input baseline compared too; the predictions saved as rasters."""
    tmp, cfg, port, want = env
    got = _port_eval(cfg, port, 3, compare_input=True,
                     save_dir=tmp / "port_pred")
    _assert_scores(got["input"], want["input"])
    _assert_scores({k: v for k, v in got.items() if k != "input"},
                   {k: v for k, v in want.items() if k != "input"})


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_eval_batch_changes_nothing(env, batch):
    """Any valid batch gives the scores of batch 3 (one sample at a time
    in effect: per-sample meters and losses, padded samples dropped)."""
    _, cfg, port, want = env
    got = _port_eval(cfg, port, batch)
    _assert_scores(got, {k: v for k, v in want.items() if k != "input"})


def test_saved_predictions_match_jax(env):
    tmp, cfg, port, _ = env
    if not (tmp / "port_pred").exists():
        _port_eval(cfg, port, 3, save_dir=tmp / "port_pred")
    names = sorted(q.name for q in (tmp / "jax_pred").iterdir())
    assert names == sorted(q.name for q in (tmp / "port_pred").iterdir())
    assert len([n for n in names if n.endswith((".npy", ".tif"))]) == 4
    for name in names:
        a, b = tmp / "jax_pred" / name, tmp / "port_pred" / name
        if name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text())
        else:
            np.testing.assert_allclose(read_raster(b), read_raster(a),
                                       rtol=1e-3, atol=1e-2)


def test_save_prediction_clips_and_descales(tmp_path):
    pred = torch.tensor([[[-0.5, 0.0], [0.5, 1.5]]])
    path = save_prediction(pred, {"id": "s0", "profile": {"crs": None}},
                           tmp_path, {"min": -80, "max": 929, "log": True},
                           base_elev=10.0)
    want = np.exp(np.clip([[-0.5, 0.0], [0.5, 1.5]], 0, 1)
                  * np.log(1009.0)) - 80 + 10
    np.testing.assert_allclose(read_raster(path)[..., 0], want, rtol=1e-6)


def test_get_visual_id_matches_jax():
    for args in [(-1, 5, None), (0, 5, None), (2, 5, None), (3, 10, 7),
                 (2, 10, 40), (1, 1, 0), (4, 3, 2)]:
        assert get_visual_id(*args) == jax_get_visual_id(*args), args


def test_eval_draws_the_visual_panels(env, tmp_path):
    _, cfg, port, _ = env
    cfg = dict(cfg, val_num_visual=2, val_id_visual=1)
    _port_eval(cfg, port, 3, visual_dir=tmp_path)
    assert len(list(tmp_path.glob("*.png"))) == len(get_visual_id(2, 4, 1))


def test_summarise_run_matches_jax(env, tmp_path):
    """Both packages' summaries of the JAX eval's prediction rasters."""
    tmp, cfg, _, _ = env
    pj, p = JaxAttrDict(cfg), AttrDict(cfg)
    data_kwargs = {k: v for k, v in cfg.items() if k != "seed"}
    want = jax_summarise_run(pj, JaxDFC30(split="valid", **data_kwargs),
                             tmp / "jax_pred", tmp_path / "jax",
                             plots=False)
    got = summarise_run(p, DFC30(split="valid", **data_kwargs),
                        tmp / "jax_pred", tmp_path / "port", plots=False)
    assert got["n_samples"] == want["n_samples"] == 4
    for view in ("online", "offline"):
        assert got[view].keys() == want[view].keys()
        for product, stats in want[view].items():
            for k, v in stats.items():
                np.testing.assert_allclose(got[view][product][k], v,
                                           rtol=1e-6, err_msg=(view, k))
    assert (tmp_path / "port" / "summary.csv").read_text() == \
        (tmp_path / "jax" / "summary.csv").read_text()
