"""The port's meters, metric filters and early stopping against the JAX
package's, on the same seeded numpy inputs (NHWC for JAX, NCHW for the
port).

Tolerances: rtol 1e-5 for the mean-type meters (PSNR, RMSE, NMAD); 1e-4
for SSIM and Slope (window sums of fp32 products, which the two run in
other orders); Median and LE95 pick one element of the sorted errors, so
they agree to the descaling's rounding: 1e-4 m (JAX runs the meters
jitted, where the descaling may differ by an ulp). The filters: rtol 1e-5
plus atol 1e-6 (a few fp32 roundings of values of order 1).
"""

import numpy as np
import pytest
import torch

from jspsr_tpu.metrics import meters as jax_meters
from jspsr_tpu.ops import filters as jax_filters
from jspsr_tpu.train import early_stop as jax_es
from jspsr_torch.metrics import meters
from jspsr_torch.ops import filters
from jspsr_torch.train import early_stop as es

ELEV = {"min": -80, "max": 929}


def _pair(b=3, h=24, w=28, c=1, seed=0):
    """(pred, gt) NHWC fp32: pred partly outside [0, 1] (the meters clamp
    it), gt inside."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.05, 1.05, (b, h, w, c)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.05, pred.shape), 0.02, 0.98)
    return pred, gt.astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _scores(cls_jax, cls_port, pred, gt, updates, elev_log, **kw):
    """Both meters fed the same updates ((start, stop, n_valid) slices of
    the batch, padded to the slice's length): their scores."""
    mj, mp = cls_jax(**kw), cls_port(**kw)
    for start, stop, n_valid in updates:
        pj, gj = pred[start:stop], gt[start:stop]
        mj.update(pj, gj, elev_log=elev_log, n_valid=n_valid)
        mp.update(_nchw(pj), _nchw(gj), elev_log=elev_log, n_valid=n_valid)
    return mj.get_score(), mp.get_score()


# (meter, package, kwargs, rtol, atol)
METER_CASES = [
    ("PSNR", "piq", {}, 1e-5, 0), ("PSNR", "skimage", {}, 1e-5, 0),
    ("PSNR", "local", {}, 1e-5, 0),
    ("SSIM", "piq", {}, 1e-4, 0), ("SSIM", "skimage", {}, 1e-4, 0),
    ("SSIM", "local", {}, 1e-4, 0),
    ("RMSE", "local", ELEV, 1e-5, 0), ("Median", "local", ELEV, 0, 1e-4),
    ("NMAD", "local", ELEV, 1e-5, 0), ("LE95", "local", ELEV, 0, 1e-4),
    ("Slope", "local", ELEV, 1e-4, 0), ("Slope", "kornia", ELEV, 1e-4, 0),
    ("Slope", "richdem", ELEV, 1e-4, 0),
]


@pytest.mark.parametrize("name,package,extra,rtol,atol", METER_CASES)
@pytest.mark.parametrize("elev_log,border", [(True, 0.05), (False, 0.0)])
def test_meter_matches_jax(name, package, extra, rtol, atol, elev_log,
                           border):
    """Every meter and package, with and without the border crop and the
    log-minmax descaling; one update of two samples, then a remainder
    batch padded to 2 with n_valid 1."""
    pred, gt = _pair()
    kw = dict(extra, package=package, border=border)
    want, got = _scores(jax_meters.get_meter(name, **kw).__class__,
                        meters.get_meter(name, **kw).__class__, pred, gt,
                        [(0, 2, None), (1, 3, 1)], elev_log, **kw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("package", ["piq", "skimage", "local"])
def test_psnr_luma_matches_jax(package):
    """``psnr_type: y`` on 3-channel inputs: piq's luma, or MATLAB's."""
    pred, gt = _pair(c=3, seed=1)
    kw = {"package": package, "psnr_type": "y"}
    want, got = _scores(jax_meters.MeterPSNR, meters.MeterPSNR, pred, gt,
                        [(0, 3, None)], False, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("tensor_range,scale,shift",
                         [("[-1, 1]", 2.0, -1.0), ("[0, 255]", 255.0, 0.0)])
def test_tensor_range_matches_jax(tensor_range, scale, shift):
    pred, gt = _pair(seed=2)
    pred, gt = pred * scale + shift, gt * scale + shift
    for cj, cp in ((jax_meters.MeterPSNR, meters.MeterPSNR),
                   (jax_meters.MeterRMSE, meters.MeterRMSE)):
        kw = {"tensor_range": tensor_range, **ELEV}
        want, got = _scores(cj, cp, pred, gt, [(0, 3, None)], True, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_performance_meter_matches_jax():
    """The flagship config's meters together, over a padded remainder
    batch, with the border crop and log-minmax descaling."""
    cfg = {"PSNR": {"package": "piq", "border": 0.05, **ELEV},
           "SSIM": {"package": "piq", "border": 0.05},
           "RMSE": {"package": "local", "border": 0.05, **ELEV},
           "Median": {"package": "local", "border": 0.05, **ELEV},
           "NMAD": {"package": "local", "border": 0.05, **ELEV},
           "LE95": {"package": "local", "border": 0.05, **ELEV},
           "Slope": {"package": "local", "border": 0.05, **ELEV}}
    pred, gt = _pair(b=4, seed=3)
    mj, mp = jax_meters.PerformanceMeter(cfg), meters.PerformanceMeter(cfg)
    for start, stop, n_valid in ((0, 3, None), (3, 4, None), (2, 4, 1)):
        mj.update(pred[start:stop], gt[start:stop], elev_log=True,
                  n_valid=n_valid)
        mp.update(_nchw(pred[start:stop]), _nchw(gt[start:stop]),
                  elev_log=True, n_valid=n_valid)
    want, got = mj.get_score(), mp.get_score()
    assert list(got) == list(want)
    for k in want:
        tol = {"rtol": 1e-4} if k in ("SSIM", "Slope") else (
            {"rtol": 0, "atol": 1e-4} if k in ("Median", "LE95")
            else {"rtol": 1e-5})
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    mp.reset()
    assert mp.meters["RMSE"].total_n == 0


def test_meters_refuse_unknown_names_and_packages():
    with pytest.raises(NotImplementedError, match="Undefined metric"):
        meters.get_meter("MAE")
    with pytest.raises(NotImplementedError, match="available: piq"):
        meters.get_meter("SSIM", package="kornia")


@pytest.mark.parametrize("fn", ["sobel_magnitude", "ssim_skimage_rows",
                                "uniform_filter_w", "horn_slope",
                                "reference_exp_window"])
def test_metric_filters_match_jax(fn):
    pred, gt = _pair(b=2, h=19, w=23, c=2, seed=4)
    if fn == "sobel_magnitude":
        want, got = jax_filters.sobel_magnitude(pred), \
            filters.sobel_magnitude(_nchw(pred))
    elif fn == "ssim_skimage_rows":
        want = jax_filters.ssim_skimage_rows(pred, gt, per_sample=True)
        got = filters.ssim_skimage_rows(_nchw(pred), _nchw(gt),
                                        per_sample=True)
    elif fn == "uniform_filter_w":
        want, got = jax_filters._uniform_filter_w(pred), \
            filters._uniform_filter_w(_nchw(pred))
    elif fn == "horn_slope":
        want = jax_filters.horn_slope(pred * 500, 19.0, 23.0)
        got = filters.horn_slope(_nchw(pred * 500), 19.0, 23.0)
    else:
        want, got = jax_filters.reference_exp_window(11, 1.5), \
            filters.reference_exp_window(11, 1.5)
    want = np.asarray(want)
    if want.ndim == 4:
        want = want.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


MONITOR_SEQ = [5.0, 4.0, 4.5, 4.2, 3.0, 3.1, 3.2, 3.3]


@pytest.mark.parametrize("monitor", ["val_loss", "trainval_loss",
                                     "val_psnr", "val_ssim", "val_rmse"])
def test_early_stopper_matches_jax(monitor):
    """The same decisions, best and counter on the same sequences of
    results, for every monitor (PSNR/SSIM higher is better)."""
    sj, sp = jax_es.EarlyStopper(2, monitor), es.EarlyStopper(2, monitor)
    for i, v in enumerate(MONITOR_SEQ):
        result = {"PSNR": v, "SSIM": v / 10, "RMSE": v}
        mj = sj.metric_from(v, result, train_loss=0.5 * i)
        mp = sp.metric_from(v, result, train_loss=0.5 * i)
        assert mp == mj
        assert sp(mp) == sj(mj)
        assert (sp.best, sp.counter) == (sj.best, sj.counter)
    assert not es.EarlyStopper(None)(1.0)
    with pytest.raises(NotImplementedError):
        es.EarlyStopper(1, "val_mae").metric_from(1.0, {})


def test_validate_results_and_do_eval_match_jax():
    results = [{"RMSE": 3.0, "PSNR": 30.0}, {"RMSE": 2.0, "PSNR": 29.0},
               {"RMSE": 2.5, "PSNR": 31.0}, {"SSIM": 0.9}]
    for best in [None, *results[:3]]:
        for cur in results[:3]:
            for key in ("RMSE", "PSNR", "SSIM", "NMAD"):
                assert es.validate_results(best, cur, key) == \
                    jax_es.validate_results(best, cur, key)
    for args in [(e, n, iv, st, wu) for n in (1, 5, 12) for e in range(n)
                 for iv in (1, 3) for st in (1, 4) for wu in (0, 2)]:
        assert es.do_eval(*args) == jax_es.do_eval(*args), args
    m = es.AverageMeter()
    m.update(torch.tensor(2.0), 3)
    m.update(4.0, 1)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 10.0, 4, 2.5)
