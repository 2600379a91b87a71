"""Whole-split evaluation summary (copy of ``jspsr_tpu/eval/summarise.py``,
numpy with the port's ``raster_io`` and ``mosaic``; reference
utils/utils.py:970-1497).

Two views over the saved predictions of a validation run:

- **online**: per-patch metrics (meters domain) averaged over patches —
  matches the live PerformanceMeter protocol;
- **offline**: pooled-pixel metrics over the whole split; for tiled (r3)
  datasets the 9 border-cropped tiles are first feather-merged back into
  full scenes (eval.mosaic).

Both views compare the SR prediction AND the public input products
(COP30/FABDEM, + FATHOM where present) against the RGEALTI ground truth —
the reference's built-in oracles. PSNR uses the DEM convention
20*log10(elev_max / RMSE) (reference utils.py:1353-1356).

Optionally writes error-distribution KDE plots (seaborn, if available) and
a summary JSON/CSV.
"""

from __future__ import annotations

import csv
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from jspsr_torch.data.raster_io import read_raster, write_raster
from jspsr_torch.eval.mosaic import merge_tiles

# the public DEM products the reference auto-discovers next to the GT
# (utils/utils.py:1001-1004: COP30/FABDEM/FATHOM subdir file lists)
PUBLIC_PRODUCTS = ("COP30", "FABDEM", "FATHOM")


def discover_products(dataset_path, ids, products=PUBLIC_PRODUCTS):
    """Find the public DEM products stored alongside the ground truth.

    Mirrors the reference's offline-summary discovery
    (utils/utils.py:996-1004): every ``<city>/<PRODUCT>/<id>_<PRODUCT>.*``
    raster under ``dataset_path`` whose id overlaps ``ids`` is reported as a
    baseline product. Products with no overlapping rasters are simply
    absent (the reference hard-requires all four lists; here a dataset
    without FATHOM still summarises).

    Returns {product_name: {sample_id: path}}.
    """
    dataset_path = Path(dataset_path)
    want = set(str(i) for i in ids)
    found = {}
    for prod in products:
        files = {}
        for sub in sorted(dataset_path.glob(f"*/{prod}")):
            if not sub.is_dir():
                continue
            for f in sorted(sub.iterdir()):
                if f.suffix not in (".tif", ".tiff", ".npy"):
                    continue
                sid = f.stem
                if sid.endswith(f"_{prod}"):
                    sid = sid[: -len(prod) - 1]
                if sid in want:
                    files[sid] = f
        if files:
            found[prod] = files
    return found


def _stats(err: np.ndarray, elev_max: float) -> dict:
    err = err[np.isfinite(err)]
    rmse = float(np.sqrt(np.mean(err**2)))
    med = float(np.median(err))
    nmad = float(1.4826 * np.median(np.abs(err - np.median(err))))
    le95 = float(np.quantile(np.abs(err), 0.95))
    psnr = float(20 * np.log10(elev_max / rmse)) if rmse > 0 else float("inf")
    return {"RMSE": rmse, "Median": med, "NMAD": nmad, "LE95": le95,
            "PSNR": psnr}


def _crop(a: np.ndarray, border: float) -> np.ndarray:
    if not border:
        return a
    h, w = a.shape[:2]
    bh, bw = int(h * border), int(w * border)
    return a[bh:h - bh, bw:w - bw]


def merge_tiled_predictions(pred_files: dict, tiles_per_scene: int,
                            full_size: int, save_dir=None):
    """Group per-tile predictions '<scene_id>_<t>' into full scenes via the
    feathered mosaic (reference merge_dem, utils/utils.py:914-967).
    Returns {scene_id: path-or-array}."""
    groups = defaultdict(dict)
    for sid, path in pred_files.items():
        base, _, t = str(sid).rpartition("_")
        groups[base][int(t)] = path
    merged = {}
    for base, tiles in groups.items():
        if len(tiles) != tiles_per_scene:
            raise ValueError(f"scene {base}: tiles {sorted(tiles)}, expected "
                             f"{tiles_per_scene}")
        arrs = [np.squeeze(read_raster(tiles[t]))
                for t in range(tiles_per_scene)]
        scene = merge_tiles(arrs, full_size=full_size)
        if save_dir is not None:
            path = Path(save_dir) / f"{base}.npy"
            write_raster(path, scene.astype(np.float32))
            merged[base] = path
        else:
            merged[base] = scene
    return merged


def summarise_evaluation(
    pred_files: dict,
    gt_files: dict,
    baseline_files: dict | None = None,
    elev_max: float = 929.0,
    border: float = 0.0,
    save_dir=None,
    plots: bool = False,
    tiles_per_scene: int | None = None,
    full_size: int | None = None,
):
    """pred_files / gt_files: {sample_id: path}; baseline_files:
    {product_name: {sample_id: path}}. With tiles_per_scene/full_size set
    (the r3 protocol: 9 tiles, 334), per-tile predictions are feather-merged
    into full scenes first. Returns {'online': ..., 'offline': ...}."""
    if tiles_per_scene and tiles_per_scene > 1:
        pred_files = merge_tiled_predictions(
            pred_files, tiles_per_scene, full_size,
            save_dir=Path(save_dir) / "mosaics" if save_dir else None,
        )
    ids = sorted(set(pred_files) & set(gt_files))
    if not ids:
        raise ValueError("no overlapping prediction/gt ids")
    products = {"SR": pred_files}
    for name, files in (baseline_files or {}).items():
        products[name] = files

    per_patch = {name: [] for name in products}
    pooled = {name: [] for name in products}
    for sid in ids:
        gt = _crop(np.squeeze(read_raster(gt_files[sid])), border)
        for name, files in products.items():
            if sid not in files:
                continue
            src = files[sid]
            arr = np.squeeze(
                src if isinstance(src, np.ndarray) else read_raster(src)
            ).astype(np.float64)
            if name != "SR":
                arr = _crop(arr, border)
            if arr.shape != gt.shape:  # SR predictions may be pre-cropped
                g = gt if arr.shape == gt.shape else _crop_to(arr, gt)
                err = (arr - g).ravel()
            else:
                err = (arr - gt).ravel()
            per_patch[name].append(_stats(err, elev_max))
            pooled[name].append(err)

    online = {
        name: {k: float(np.mean([s[k] for s in stats]))
               for k in stats[0]} if stats else {}
        for name, stats in per_patch.items()
    }
    offline = {
        name: _stats(np.concatenate(errs), elev_max) if errs else {}
        for name, errs in pooled.items()
    }
    result = {"online": online, "offline": offline, "n_samples": len(ids)}

    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "summary.json").write_text(
            json.dumps(result, indent=2)
        )
        _write_summary_csv(result, save_dir / "summary.csv")
        if plots:
            _plot_error_distributions(pooled, save_dir)
            _plot_final_dist(pooled, offline, save_dir)
    return result


def _write_summary_csv(result: dict, path: Path):
    """Tabular per-product summary (the reference's df_metric table,
    utils/utils.py:1371-1392, as a CSV instead of an in-memory frame):
    one row per (view, product) with the five headline statistics."""
    metrics = ("RMSE", "Median", "NMAD", "LE95", "PSNR")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("view", "product") + metrics)
        for view in ("online", "offline"):
            for name, stats in result.get(view, {}).items():
                if stats:
                    w.writerow([view, name] +
                               [f"{stats[m]:.6f}" for m in metrics])


def _plot_final_dist(pooled: dict, offline: dict, save_dir: Path):
    """Two-panel summary figure matching the reference's final_dist
    (utils/utils.py:1420-1490): left a per-product error KDE clipped to
    [-5, 5] m, right a horizontal bar chart of the offline RMSE / Median /
    NMAD / LE95 per product."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError:
        return
    fig, axs = plt.subplots(
        1, 2, figsize=(17, 5), gridspec_kw={"width_ratios": [3, 1]})
    rng = np.random.default_rng(0)
    for name, errs in pooled.items():
        if not errs:
            continue
        sample = np.concatenate(errs)
        sample = sample[(sample >= -5) & (sample <= 5)]  # reference's clip
        if sample.size > 200_000:
            sample = rng.choice(sample, 200_000, replace=False)
        if sample.size:
            sns.kdeplot(sample, ax=axs[0], label=name, bw_adjust=1, cut=0.5,
                        common_norm=False, linewidth=1)
    axs[0].set(xlabel="Elevation Error [m]", ylabel="Density")
    axs[0].set_title("Elevation Error Distribution in [-5, 5] m",
                     weight="bold")
    axs[0].legend()

    metrics = ("RMSE", "Median", "NMAD", "LE95")
    names = [n for n, s in offline.items() if s]
    width = 0.8 / max(len(names), 1)
    ys = np.arange(len(metrics), dtype=float)
    for j, name in enumerate(names):
        vals = [offline[name][m] for m in metrics]
        axs[1].barh(ys + j * width, vals, height=width, label=name)
    axs[1].set_yticks(ys + width * (len(names) - 1) / 2, metrics)
    axs[1].invert_yaxis()
    axs[1].set(xlabel="Metric Value [m]")
    axs[1].set_title("Metrics", weight="bold")
    axs[1].legend(fontsize=8)
    sns.despine()
    fig.tight_layout()
    fig.savefig(save_dir / "final_dist.png", dpi=150)
    plt.close(fig)


def summarise_run(p, valid_set, pred_dir, save_dir, plots: bool = True,
                  lr_files: dict | None = None):
    """Whole-split offline summary for a finished run: collect the saved
    predictions, the GT rasters and every public product found in the
    dataset tree, then run :func:`summarise_evaluation`.

    The reference ends both its ``--val`` flow (main.py:148-159) and its
    post-training best-checkpoint eval (main.py:294-311) here. ``lr_files``
    optionally injects the LR-source mapping when product discovery finds
    nothing (single-raster scenes outside the DFC30 layout).
    """
    pred_dir = Path(pred_dir)
    gt_files = {sid: f for sid, f in
                zip(valid_set.id, valid_set.files["hr_dem"])}
    pred_files = {f.stem: f for f in pred_dir.iterdir()
                  if f.suffix in (".tif", ".tiff", ".npy")}
    if not pred_files:
        raise ValueError(f"no predictions under {pred_dir}")
    baselines = discover_products(valid_set.path, gt_files.keys())
    if not baselines and lr_files:
        baselines = {getattr(valid_set, "lr_source", "LR"): lr_files}
    tiles = p.get("patches_per_image") or 1
    full_size = None
    if tiles > 1:  # r3 tiled protocol: merge back to the GT scene size
        full_size = int(np.squeeze(
            read_raster(next(iter(gt_files.values())))).shape[0])
    return summarise_evaluation(
        pred_files, gt_files, baselines,
        elev_max=p.tensor_kwargs.get("max", 929),
        border=0.0, save_dir=save_dir, plots=plots,
        tiles_per_scene=tiles if tiles > 1 else None,
        full_size=full_size,
    )


def _crop_to(small: np.ndarray, big: np.ndarray) -> np.ndarray:
    """Center-crop ``big`` to ``small``'s shape."""
    dh = (big.shape[0] - small.shape[0]) // 2
    dw = (big.shape[1] - small.shape[1]) // 2
    return big[dh:dh + small.shape[0], dw:dw + small.shape[1]]


def _plot_error_distributions(pooled: dict, save_dir: Path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, errs in pooled.items():
        if not errs:
            continue
        sample = np.concatenate(errs)
        if sample.size > 200_000:
            sample = np.random.default_rng(0).choice(sample, 200_000,
                                                     replace=False)
        sns.kdeplot(sample, ax=ax, label=name, clip=(-10, 10))
    ax.set_xlabel("elevation error (m)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_dir / "error_kde.png", dpi=120)
    plt.close(fig)
