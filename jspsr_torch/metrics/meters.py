"""Evaluation meters on NCHW tensors (counterpart of
``jspsr_tpu/metrics/meters.py``; reference evaluation/metrics.py).

The JAX package's semantics, kept exactly:

- a fractional border crop with int truncation: int(h*border) pixels per
  side;
- the prediction clamped to [0, 1], the ground truth not;
- the elevation meters (RMSE, Median, NMAD, LE95, Slope) descale both
  tensors to metres (log-minmax aware) first;
- Median is torch's lower median, taken per sample; LE95 takes the k-th
  smallest |dh| with k = 1 + round(0.95 (n - 1));
- every ``package:`` value: PSNR piq/skimage/local (and ``psnr_type:
  y``), SSIM piq/skimage/local, Slope local/kornia/richdem, each with the
  JAX meter's convention.

Every meter reduces per sample (a (B,) vector) and accumulates its sum and
count, so averages are the same whatever the eval batch; ``n_valid`` drops
the padded samples of a remainder batch. The sums stay on the tensors'
device; ``get_score`` reads them back once.
"""

from __future__ import annotations

import torch

from jspsr_torch.data.normalize import descale_data
from jspsr_torch.ops.filters import (
    horn_slope,
    reference_exp_window,
    sobel_magnitude,
    spatial_gradient,
    ssim as ssim_fn,
    ssim_skimage_rows,
)


def crop_border(x: torch.Tensor, border: float) -> torch.Tensor:
    if not border:
        return x
    h, w = x.shape[-2:]
    bh, bw = int(h * border), int(w * border)
    return x[..., bh: h - bh, bw: w - bw]


def _prepare(pred, gt, border: float, tensor_range: str = "[0, 1]"):
    pred, gt = crop_border(pred, border), crop_border(gt, border)
    if tensor_range == "[-1, 1]":
        pred, gt = (pred + 1) / 2.0, (gt + 1) / 2.0
    elif tensor_range == "[0, 255]":
        pred, gt = pred / 255.0, gt / 255.0
    return pred.clamp(0.0, 1.0), gt


def torch_median(x: torch.Tensor) -> torch.Tensor:
    """The lower median of the whole tensor (the JAX helper's twin; the
    meters take ``_per_sample_median``)."""
    return x.median()


def _per_sample_median(x: torch.Tensor) -> torch.Tensor:
    """torch.median per sample: x (B, ...) -> (B,), the lower median."""
    return x.reshape(x.shape[0], -1).median(dim=-1).values


def _luma(x: torch.Tensor, weights, offset: float = 0.0,
          div: float = 1.0) -> torch.Tensor:
    """A weighted sum over 3 channels (NCHW), identity for any other count."""
    if x.shape[1] != 3:
        return x
    w = torch.tensor(weights, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return ((x * w).sum(dim=1, keepdim=True) + offset) / div


def _luma_piq(x):
    """piq's greyscale: BT.601 luma [0.299, 0.587, 0.114]."""
    return _luma(x, (0.299, 0.587, 0.114))


def _luma_matlab(x):
    """MATLAB's BT.601 Y channel scaled back to [0, 1] (the evident intent
    of the reference's broken skimage/local ``psnr_type: y`` paths)."""
    return _luma(x, (65.481, 128.553, 24.966), 16.0, 255.0)


class MeterBase:
    name = "base"
    # packages this meter branches on; None: the package is informational
    packages = None

    def __init__(self, package: str = "local", tensor_range: str = "[0, 1]",
                 border: float = 0.0, min: float = 0.0, max: float = 1.0,
                 verbose: bool = False, **_):
        if self.packages is not None and package.lower() not in self.packages:
            raise NotImplementedError(
                f"{self.name} package '{package}' not implemented "
                f"(available: {', '.join(self.packages)})")
        self.package = package
        self.tensor_range = tensor_range
        self.border = border
        self.value_min = min
        self.value_max = max
        self.verbose = verbose
        self.reset()

    def reset(self):
        self.total = 0.0
        self.total_n = 0

    def _accumulate(self, pred, gt, elev_log, n_valid):
        with torch.no_grad():
            v = self._compute(pred, gt, elev_log)  # (B,), on the device
        if n_valid is not None and n_valid < v.shape[0]:
            v = v[:n_valid]
        self.total = self.total + v.double().sum()
        self.total_n += int(v.shape[0])
        return v

    def update(self, pred, gt, meta=None, base_elev=0, elev_log=False,
               n_valid=None):
        self._accumulate(pred, gt, elev_log, n_valid)

    def get_score(self):
        score = float(self.total) / max(self.total_n, 1)
        if self.verbose:
            print(f"{self.package[:3]} {self.name} {1 - self.border}\t"
                  f"{score:5.4f}")
        return score

    def _descale(self, pred, gt, elev_log):
        pred, gt = _prepare(pred, gt, self.border, self.tensor_range)
        pred = descale_data(pred, self.value_min, self.value_max, elev_log)
        gt = descale_data(gt, self.value_min, self.value_max, elev_log)
        return pred, gt


class MeterPSNR(MeterBase):
    """PSNR of the normalized [0, 1] tensors: 'piq' and 'skimage'
    -10 log10(mse) per sample, 'local' the same with mse == 0 -> 100;
    ``psnr_type: y`` takes piq's luma (piq) or MATLAB's (the others) of
    3-channel inputs."""

    name = "PSNR"
    packages = ("piq", "skimage", "local")

    def __init__(self, psnr_type: str = "rgb", **kw):
        super().__init__(**kw)
        self.psnr_type = psnr_type

    def _compute(self, pred, gt, elev_log):
        pred, gt = _prepare(pred, gt, self.border, self.tensor_range)
        if self.psnr_type == "y":
            luma = _luma_piq if self.package == "piq" else _luma_matlab
            pred, gt = luma(pred), luma(gt)
        mse = (gt - pred).square().mean(dim=(1, 2, 3))
        psnr = -10.0 * torch.log10(mse.clamp_min(1e-10))
        if self.package == "local":
            psnr = torch.where(mse == 0, torch.full_like(psnr, 100.0), psnr)
        return psnr


class MeterSSIM(MeterBase):
    """SSIM of the normalized [0, 1] tensors: 'piq' a gaussian 11 x 11
    window (sigma 1.5), valid; 'skimage' the reference's per-row 1-D SSIM
    (``ssim_skimage_rows``); 'local' zero-padded 'same' with the
    reference's exponential window."""

    name = "SSIM"
    packages = ("piq", "skimage", "local")

    def _compute(self, pred, gt, elev_log):
        pred, gt = _prepare(pred, gt, self.border, self.tensor_range)
        if self.package == "skimage":
            return ssim_skimage_rows(pred, gt, data_range=1.0,
                                     per_sample=True)
        if self.package == "local":
            return ssim_fn(pred, gt, data_range=1.0, padding="same",
                           window=reference_exp_window(11, 1.5, pred.device),
                           per_sample=True)
        return ssim_fn(pred, gt, data_range=1.0, padding="valid",
                       per_sample=True)


class MeterRMSE(MeterBase):
    """Elevation RMSE in metres; verbose, it names the worst 3 samples."""

    name = "RMSE"

    def reset(self):
        super().reset()
        self.sample_rmse = []
        self.sample_id = []

    def _compute(self, pred, gt, elev_log):
        pred, gt = self._descale(pred, gt, elev_log)
        return (pred - gt).square().mean(dim=(1, 2, 3)).sqrt()

    def update(self, pred, gt, meta=None, base_elev=0, elev_log=False,
               n_valid=None):
        v = self._accumulate(pred, gt, elev_log, n_valid)
        self.sample_rmse.append(v)
        self.sample_id.extend(_sample_ids(meta, int(v.shape[0])))

    def get_score(self):
        score = float(self.total) / max(self.total_n, 1)
        if self.verbose and self.total_n > 3:
            values = torch.cat(self.sample_rmse).cpu().tolist()
            worst = sorted(zip(values, self.sample_id), reverse=True)[:3]
            worst_s = ", ".join(f"{i} {v:.2f}" for v, i in worst)
            print(f"{self.package[:3]} {self.name} {1 - self.border}\t"
                  f"{score:5.4f}, {worst_s}")
        return score


class MeterMedian(MeterBase):
    name = "Median"

    def _compute(self, pred, gt, elev_log):
        pred, gt = self._descale(pred, gt, elev_log)
        return _per_sample_median(pred - gt)


class MeterNMAD(MeterBase):
    name = "NMAD"

    def _compute(self, pred, gt, elev_log):
        pred, gt = self._descale(pred, gt, elev_log)
        dh = pred - gt
        mdh = _per_sample_median(dh)
        return 1.4826 * _per_sample_median((dh - mdh.view(-1, 1, 1, 1)).abs())


class MeterLE95(MeterBase):
    name = "LE95"

    def _compute(self, pred, gt, elev_log):
        pred, gt = self._descale(pred, gt, elev_log)
        dh = (pred - gt).abs().reshape(pred.shape[0], -1)
        k = 1 + round(0.95 * (dh.shape[1] - 1))  # 1-based k-th smallest
        return dh.kthvalue(k, dim=-1).values


class MeterSlope(MeterBase):
    """Slope-difference RMSE in metres: 'local' the 2x Sobel magnitude
    (valid), 'kornia' the normalized Sobel gradient's (gx, gy) field,
    'richdem' Horn's slope with the reference's cell sizes taken from the
    array's shape (cell_x = H, cell_y = W)."""

    name = "Slop"
    packages = ("local", "kornia", "richdem")

    def _compute(self, pred, gt, elev_log):
        pred, gt = self._descale(pred, gt, elev_log)
        if self.package.lower() == "kornia":
            pgx, pgy = spatial_gradient(pred)
            ggx, ggy = spatial_gradient(gt)
            d2 = (pgx - ggx).square() + (pgy - ggy).square()
            return (d2.mean(dim=(1, 2, 3)) / 2.0).sqrt()
        if self.package.lower() == "richdem":
            h, w = pred.shape[-2:]
            ps = horn_slope(pred, float(h), float(w))
            gs = horn_slope(gt, float(h), float(w))
        else:  # 'local'
            ps, gs = sobel_magnitude(pred), sobel_magnitude(gt)
        return (ps - gs).square().mean(dim=(1, 2, 3)).sqrt()


def _short_id(m) -> str:
    """A worst-sample id (reference metrics.py:363-367) from a DFC30
    ``a-b-c-d`` id; any other format is kept as it is."""
    if not isinstance(m, dict):
        return str(m) if m else "?"
    subset = str(m.get("subset", "?")).split("_")[0]
    subset = subset if len(subset) < 6 else subset[:7]
    raw = str(m.get("id", "?"))
    parts = raw.split("-")
    sid = "-".join(parts[2:4]) if len(parts) >= 4 else raw
    return f"{subset}_{sid}"


def _sample_ids(meta, n: int):
    """Per-sample ids of a batch: ``meta`` is the collated list of sample
    meta dicts (or one dict)."""
    if meta is None:
        return ["?"] * n
    if isinstance(meta, dict):
        return [_short_id(meta)] * n
    ids = [_short_id(m) for m in meta]
    return (ids + ["?"] * max(n - len(ids), 0))[:n]


_METERS = {
    "psnr": MeterPSNR,
    "ssim": MeterSSIM,
    "rmse": MeterRMSE,
    "median": MeterMedian,
    "nmad": MeterNMAD,
    "le95": MeterLE95,
    "slope": MeterSlope,
}


def get_meter(name: str, **kwargs):
    key = name.lower()
    if key not in _METERS:
        raise NotImplementedError(f"Undefined metric: {name}")
    return _METERS[key](**kwargs)


class PerformanceMeter:
    """The config's meters together (reference evaluate_utils.py:26-118)."""

    def __init__(self, metric_cfg: dict):
        self.meters = {name: get_meter(name, **(kw or {}))
                       for name, kw in metric_cfg.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def update(self, pred, gt, meta=None, base_elev=0, elev_log=False,
               n_valid=None):
        for m in self.meters.values():
            m.update(pred, gt, meta, base_elev, elev_log, n_valid=n_valid)

    def get_score(self, verbose: bool = False):
        """With ``verbose`` every meter prints its line, whatever its own
        config says."""
        out = {}
        for name, m in self.meters.items():
            saved = m.verbose
            m.verbose = saved or verbose
            try:
                out[name] = m.get_score()
            finally:
                m.verbose = saved
        return out
