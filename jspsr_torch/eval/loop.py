"""Evaluation loop (counterpart of ``jspsr_tpu/eval/loop.py``; reference
evaluation/evaluate_utils.py:154-357).

Per batch: the eval step (an eval-mode forward and its losses), the
meters on the device (they descale where the metric is in metres), an
optional bicubic-input baseline (the reference's built-in oracle), and an
optional dump of each prediction as a raster in metres with its sample's
geo profile.

Any ``valid_batch_size`` works: meters reduce per sample, the remainder
batch is padded to the configured batch by repeating its last sample, and
the padded samples are dropped through ``n_valid``, so the scores are those
of one sample at a time. With ``normalize`` (``device_normalize``:
``data.normalize.make_device_normalize``) the loader ships raw crops,
which go to the device as they are (the one-hot mask bit-packed with
``pack_mask``) and are normalised there, inputs and ground truth; the
bicubic-input baseline scales the raw input DEM there too and the visual
panels on the host.

``mesh`` (a ``parallel.mesh.Mesh`` or a list of local devices) splits
each valid batch over its devices, as the JAX package shards it over its
mesh (``jspsr_tpu/eval/loop.py:119-125,150-171``): slice i runs on
``mesh.devices[i]`` with a replica of the eval step's model there, and the
predictions and per-sample losses come back to ``device`` in the batch's
order before the meters see them. Where ``valid_batch_size`` does not
divide by the mesh size the whole batch runs on ``device``, as in the
JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from jspsr_torch.data.loader import build_batch_inputs, input_kinds, \
    pack_mask_np
from jspsr_torch.data.normalize import descale_data, modality_scale, \
    modality_scaling
from jspsr_torch.data.raster_io import HAS_RASTERIO, write_raster
from jspsr_torch.metrics.meters import PerformanceMeter
from jspsr_torch.nn.layers import bicubic_resize
from jspsr_torch.parallel.mesh import as_mesh, pad_batch_to
from jspsr_torch.train.early_stop import AverageMeter


def save_prediction(pred, meta, save_dir, tensor_kwargs, base_elev=0.0):
    """Clip to [0, 1], descale to metres (plus the tile's base), and write
    the raster with the sample's geo profile (reference
    evaluate_utils.py:242-271). ``pred`` is one sample, (C, H, W), as a
    tensor or an array."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if isinstance(pred, torch.Tensor):
        pred = pred.detach().cpu().numpy()
    arr = np.clip(np.asarray(pred).transpose(1, 2, 0), 0.0, 1.0)
    arr = descale_data(arr, tensor_kwargs["min"], tensor_kwargs["max"],
                       tensor_kwargs.get("log", False)) + base_elev
    suffix = ".tif" if HAS_RASTERIO else ".npy"
    path = save_dir / f"{meta['id']}{suffix}"
    write_raster(path, arr.astype(np.float32), dict(meta.get("profile") or {}))
    return path


def get_visual_id(num_visual: int, num_samples: int, id_visual=None):
    """Sample indices to draw (reference evaluate_utils.py:154-175): -1 all,
    N evenly spaced; ``id_visual`` adds one."""
    if num_visual == -1:
        return list(range(num_samples))
    ids = list(np.linspace(0, num_samples - 1, max(num_visual, 0),
                           dtype=int)) if num_visual else []
    if id_visual is not None and 0 <= id_visual < num_samples:
        ids.append(int(id_visual))
    return sorted(set(int(i) for i in ids))


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(device)


def _raw(a: np.ndarray, device) -> torch.Tensor:
    """A raw-feed array on ``device`` as it is (NHWC, its own dtype)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _split_eval(mesh, eval_step, device):
    """``eval_step`` with each batch split over ``mesh`` (a replica of its
    model per device) and gathered on ``device``: the predictions and
    per-sample totals concatenated in order, every other loss the mean of
    the slices' (equal slices: the batch's mean)."""
    model = getattr(eval_step, "model", None)
    if model is None:
        raise TypeError("eval over a mesh needs an eval step made by "
                        "train.step.make_eval_step (its model is replicated "
                        "over the mesh)")

    def run(inputs, gt):
        outs = mesh.split_forward(
            model, [*inputs, gt],
            call=lambda m, xs: eval_step(xs[:-1], xs[-1], model=m),
            out_device=device)
        pred = torch.cat([o[0] for o in outs])
        losses = {}
        for k in outs[0][1]:
            parts = [o[1][k] for o in outs]
            losses[k] = (torch.cat(parts) if k == "_total_per_sample"
                         else torch.stack(parts).mean())
        return pred, losses

    return run


def eval_model(p, loader, eval_step, device, compare_input: bool = False,
               save_dir=None, visual_dir=None, verbose: bool = False,
               mesh=None, normalize=None):
    """Returns ``{"loss": ..., <metric>: ...}`` and, with
    ``compare_input``, the bicubic-input baseline's scores under
    ``"input"``. ``eval_step(inputs, gt) -> (pred, losses)`` is
    ``train.step.make_eval_step``'s; its ``_total_per_sample`` gives the
    loss, so padding and batch-statistic losses change nothing."""
    device = torch.device(device)
    batch_cfg = int(p.get("valid_batch_size", 1) or 1)
    mesh = as_mesh(mesh)
    if mesh is not None and batch_cfg % mesh.size:
        mesh = None  # the batch does not divide over the mesh: one device
    run = eval_step if mesh is None else _split_eval(mesh, eval_step, device)
    scaling = modality_scaling(p)
    mask_idx = None
    if normalize is not None and p.get("pack_mask"):
        kinds = input_kinds(p.input_data)
        mask_idx = kinds.index("mask") if "mask" in kinds else None
    meter = PerformanceMeter({k: dict(v) for k, v in p.metric.items()})
    meter_in = (PerformanceMeter({k: dict(v) for k, v in p.metric.items()})
                if compare_input else None)
    loss_meter = AverageMeter("val_loss")
    elev_log = bool(p.tensor_kwargs.get("log", False))
    visual_ids = set()
    if visual_dir is not None and p.get("val_num_visual"):
        visual_ids = set(get_visual_id(p.val_num_visual, len(loader.dataset),
                                       p.get("val_id_visual")))
    sample_idx = 0

    def pad(x):  # up to the configured batch, repeating the last sample
        return pad_batch_to(x, batch_cfg)[0]

    for batch in loader:
        inputs_np, gt_np, base_elev, meta = build_batch_inputs(
            batch, p.model_name, p.input_data)
        n_real = gt_np.shape[0]
        if normalize is None:
            inputs = [_nchw(pad(x), device)
                      for x in inputs_np]
            gt = _nchw(pad(gt_np), device)
        else:
            inputs_np = list(inputs_np)
            if mask_idx is not None:
                inputs_np[mask_idx] = pack_mask_np(inputs_np[mask_idx])
            base_dev = _raw(pad(base_elev), device)
            inputs, gt = normalize(
                [_raw(pad(x), device) for x in inputs_np],
                _raw(pad(gt_np), device), base_dev)
        pred, losses = run(inputs, gt)
        if losses:
            per_sample = losses.get("_total_per_sample")
            if per_sample is not None:
                loss_meter.update(per_sample[:n_real].mean(), n_real)
            else:  # an eval step without per-sample totals
                loss_meter.update(losses["Total"], n_real)
        meter.update(pred, gt, meta, base_elev, elev_log, n_valid=n_real)
        if meter_in is not None:
            lr_dem = _nchw(pad(batch["lr_dem"]), device)
            if normalize is not None:
                # the raw feed: ToArray's scaling of the input DEM (one
                # channel, so NCHW serves), on the device, before the
                # resize as on the host
                lr_dem = modality_scale("lr_dem", lr_dem,
                                        base_dev.view(-1, 1, 1, 1),
                                        **scaling)
            if lr_dem.shape[-2:] != gt.shape[-2:]:
                lr_dem = bicubic_resize(lr_dem, *gt.shape[-2:])
            meter_in.update(lr_dem, gt, meta, base_elev, elev_log,
                            n_valid=n_real)
        if save_dir is not None:
            for i, m in enumerate(meta):
                save_prediction(pred[i], m, save_dir, p.tensor_kwargs,
                                base_elev=float(base_elev[i]))
        if visual_ids:
            from jspsr_torch.eval.visualize import display_predictions

            for i, m in enumerate(meta):
                if sample_idx + i in visual_ids:
                    sample = {k: batch[k][i] for k in
                              ("lr_dem", "hr_dem", "image", "mask", "canopy")
                              if k in batch}
                    if normalize is not None:  # ToArray's scaling
                        sample = {k: modality_scale(
                            k, torch.from_numpy(np.asarray(v, np.float32)),
                            float(base_elev[i]), **scaling).numpy()
                            for k, v in sample.items()}
                    display_predictions(
                        sample, pred[i].cpu().numpy().transpose(1, 2, 0),
                        dict(p.tensor_kwargs), base_elev=float(base_elev[i]),
                        save_path=Path(visual_dir) / f"{m['id']}.png")
        sample_idx += len(meta)

    result = {"loss": loss_meter.avg, **meter.get_score(verbose=verbose)}
    if meter_in is not None:
        result["input"] = meter_in.get_score(verbose=verbose)
    return result
