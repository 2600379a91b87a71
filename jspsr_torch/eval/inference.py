"""Scene inference (counterpart of ``jspsr_tpu/eval/inference.py``;
reference utils/utils.py:1501-1655).

- ``upscale_dem``: pad one raw HWC sample to the encoder's stride multiple,
  normalize it, run the eval forward, crop back; reports latency and the
  device's peak memory;
- ``tile_inference``: the host tiled path for the square reference grids
  (normalize on the host, one batched forward over the tile grid, numpy
  feathered mosaic), for configs the device-tiled path
  (``eval/scene.py``) does not cover;
- ``load_scene`` / ``run_scene_inference``: the CLI ``--infer`` driver
  (load rasters, run whole or tiled, descale to metres, write).

Public functions take and return HWC numpy arrays, like the JAX package's;
tensors are NCHW only between ``_model_inputs`` and the forward's output.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.config.loader import get_tile
from jspsr_torch.data.loader import model_inputs
from jspsr_torch.data.transforms import ToArray, TransformCtx
from jspsr_torch.eval.mosaic import merge_tiles
from jspsr_torch.utils.device import resolve_device, set_strict_fp32


def _normalize_sample(sample: dict, p) -> dict:
    to_array = ToArray(p.get("normalize"), p.get("mask_channel"),
                       p.get("relative", False),
                       **(p.get("tensor_kwargs") or {}))
    s = dict(sample)
    s.setdefault("meta", {"base": float(np.min(sample["lr_dem"]))
                          if p.get("relative") else 0.0,
                          "id": "scene"})
    return to_array(s, TransformCtx())


def _model_inputs(sample: dict, p, device, batched: bool = False) -> list:
    """HWC numpy modalities (NHWC with ``batched``) -> list of contiguous
    (B, C, H, W) tensors in the model's input layout
    (``data.loader.model_inputs``)."""
    batch = {k: v if batched else v[None] for k, v in sample.items()
             if k != "meta"}
    arrays = model_inputs(batch, p.model_name, p.get("input_data") or {})
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
            .to(device) for a in arrays]


def device_peak_memory_mb(device) -> float:
    """The allocator's peak on a CUDA ``device`` since the last
    ``torch.cuda.reset_peak_memory_stats``, in MB; NaN on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 1024 / 1024


def _pad_hwc(img: np.ndarray, pads):
    t, b, l, r = pads
    if not any(pads):
        return img
    h, w, _ = img.shape
    spec = ((t, b), (l, r), (0, 0))
    mode = "reflect" if (t < h and b < h and l < w and r < w) else "edge"
    return np.pad(img, spec, mode=mode)


def model_stride_multiple(p) -> int:
    """Smallest H/W divisor the model's encoder/decoder round-trip needs
    (stride product of the downsampling path): JSPSR's encoder is
    s1,s2,s2,s2 (/8); LRRU's s1,s2,s2,s2,s2 (/16: at a multiple of 8 that
    is not one of 16 its decoder's sums would not line up);
    CompletionFormer's backbone goes to /32; EDSR never downsamples."""
    return {"jspsr": 8, "lrru": 16, "completionformer": 32,
            "edsr": 1}.get(p.model_name.lower(), 8)


def pads_for_multiple(h: int, w: int, mult: int):
    """(t, b, l, r) pads taking (h, w) to the next multiples of ``mult``."""
    nh = -(-h // mult) * mult if mult > 1 else h
    nw = -(-w // mult) * mult if mult > 1 else w
    dh, dw = nh - h, nw - w
    return (dh // 2, dh - dh // 2, dw // 2, dw - dw // 2)


def make_forward(model: torch.nn.Module):
    """Eval-mode inference forward: inputs list -> (B, 1, H, W) prediction
    (the counterpart of ``jspsr_tpu/train/step.py::make_forward``)."""
    model.eval()

    def forward(inputs):
        with torch.inference_mode():
            return model(inputs)

    return forward


def upscale_dem(forward_fn, sample: dict, p, device=None):
    """Run one full scene through the model on ``device`` (default cuda).

    forward_fn(inputs_list) -> (1, 1, H, W) prediction tensor.
    Returns (pred HWC in [0,1] scale space, latency_ms, peak_mem_mb); the
    peak is the device's allocator peak during this forward (NaN on CPU).
    """
    device = resolve_device(device)
    s = dict(sample)
    # pads derive from the LR DEM's shape; every modality shares its HxW
    # (validated in load_scene), so one pad spec applies to all
    h0, w0 = np.asarray(s["lr_dem"]).shape[:2]
    pads = pads_for_multiple(h0, w0, model_stride_multiple(p))
    for k in list(s):
        if k != "meta":
            s[k] = _pad_hwc(np.asarray(s[k]), pads)
    s = _normalize_sample(s, p)
    inputs = _model_inputs(s, p, device)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter_ns()
    y = forward_fn(inputs)
    if cuda:
        torch.cuda.synchronize(device)
    t_infer = (time.perf_counter_ns() - t0) // 1000 / 1000  # ms
    mem = device_peak_memory_mb(device)

    y = y[0].permute(1, 2, 0).cpu().numpy()
    t, b, l, r = pads
    return y[t:y.shape[0] - b, l:y.shape[1] - r, :], t_infer, mem


def tile_inference(forward_fn, sample: dict, p, tile: int = 128,
                   n_tile: int | None = None, device=None):
    """Tiled scene inference on the host's reference grid: normalize the
    square scene, cut the overlapping tile grid (``get_tile``), one batched
    forward on ``device`` (default cuda), feathered numpy mosaic. Returns
    the (H, W, 1) prediction in [0,1] scale space, unclipped."""
    device = resolve_device(device)
    s = _normalize_sample(dict(sample), p)
    h, w, _ = s["lr_dem"].shape
    if h != w:
        raise ValueError(f"the host tiled path takes square scenes only, "
                         f"got {h}x{w}")
    stride, n = get_tile(h, tile, n_tile)
    n_x = int(round(n**0.5))
    batch = {k: np.stack([v[stride * (t // n_x):stride * (t // n_x) + tile,
                            stride * (t % n_x):stride * (t % n_x) + tile]
                          for t in range(n)])
             for k, v in s.items() if k != "meta"}
    pred = forward_fn(_model_inputs(batch, p, device, batched=True))
    pred = pred.permute(0, 2, 3, 1).cpu().numpy()  # (n, tile, tile, 1)
    return merge_tiles([pred[i] for i in range(n)], full_size=h)


# ---------------------------------------------------------------------------
# Scene loading for the CLI --infer flow.

_SCENE_ALIASES = {
    "lr_dem": ("lr_dem", "COP30", "FABDEM"),
    "image": ("image", "BDORTHO"),
    "mask": ("mask", "UA2012"),
    "canopy": ("canopy", "CHM"),
}


def _find_modality(scene_dir, names):
    """A modality raster is <name>.<ext> or <name>/<single file>."""
    scene_dir = Path(scene_dir)
    for name in names:
        for ext in (".tif", ".tiff", ".npy"):
            f = scene_dir / f"{name}{ext}"
            if f.exists():
                return f
        sub = scene_dir / name
        if sub.is_dir():
            rasters = [f for f in sub.iterdir()
                       if f.suffix in (".tif", ".tiff", ".npy")]
            if len(rasters) == 1:
                return rasters[0]
    return None


def load_scene(path, p):
    """Assemble a raw sample dict for inference.

    ``path`` is either a single LR-DEM raster or a directory holding one
    raster per needed modality, named by modality (lr_dem/image/mask/
    canopy) or by the DFC30 subdir convention (COP30|FABDEM/BDORTHO/
    UA2012/CHM). Returns (sample dict of HWC arrays, geo profile of the LR
    DEM).
    """
    from jspsr_torch.data.raster_io import read_raster

    path = Path(path)
    input_data = p.get("input_data") or {}
    if input_data.get("coord"):
        raise NotImplementedError("coord guidance is not yet ported")
    need = [k for k in ("image", "mask", "canopy") if input_data.get(k)]
    sample = {}
    if path.is_file():
        lr_file = path
    else:
        lr_file = _find_modality(path, _SCENE_ALIASES["lr_dem"])
        if lr_file is None:
            raise FileNotFoundError(f"no LR DEM raster found under {path}")
    lr, profile = read_raster(lr_file, with_profile=True)
    sample["lr_dem"] = lr.astype(np.float32)

    for key in need:
        if not path.is_dir():
            raise ValueError(f"model needs '{key}' guidance: pass a scene "
                             f"DIRECTORY containing it (got file {path})")
        f = _find_modality(path, _SCENE_ALIASES[key])
        if f is None:
            raise FileNotFoundError(f"missing '{key}' raster under {path}")
        arr = read_raster(f)
        if key == "image":
            # ToArray divides images by 255 (the reference's uint8
            # convention), so deliver 0-255 here. uint8 rasters are decided
            # by dtype; a float raster with values > 1.5 is taken as
            # 0-255-valued, otherwise [0,1]. ``infer_image_range: "255" |
            # "unit"`` overrides either way.
            rng_mode = p.get("infer_image_range")
            if rng_mode is None:
                if arr.dtype == np.uint8:
                    rng_mode = "255"
                else:
                    rng_mode = "255" if float(arr.max()) > 1.5 else "unit"
                    print(f"--infer: float image raster {f} assumed "
                          f"{'0-255' if rng_mode == '255' else '[0,1]'}-"
                          f"valued (max={float(arr.max()):.3g}); set "
                          f"infer_image_range to override")
            if arr.dtype != np.uint8:
                arr = arr.astype(np.float32)
                if str(rng_mode) == "unit":
                    arr = arr * 255.0
        elif arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        if arr.shape[:2] != sample["lr_dem"].shape[:2]:
            raise ValueError(
                f"'{key}' raster {f} is {arr.shape[:2]} but the LR DEM is "
                f"{sample['lr_dem'].shape[:2]}: all modalities must share "
                f"the LR DEM's grid (resample the raster first)")
        if key == "mask" and p.get("mask_channel"):
            arr = arr[:, :, list(p["mask_channel"])]
        sample[key] = arr
    return sample, profile


def run_scene_inference(model, p, scene_path, out_path, tile: bool = False,
                        device=None):
    """CLI --infer driver: load scene, run on ``device`` (default cuda),
    descale to metres, write raster. ``model`` is moved to ``device``.

    With ``tile``: the device-tiled path (``eval/scene.py``, the whole
    pipeline on the card, output already in metres) where
    ``device_tiling_supported(p)`` and ``infer_device_tiling`` (default
    true) allow it, else the host tiled path (``tile_inference``).

    Returns (output path, latency ms, peak device MB)."""
    from jspsr_torch.data.normalize import descale_data
    from jspsr_torch.data.raster_io import write_raster
    from jspsr_torch.eval.scene import (device_tiling_supported,
                                        tile_inference_device)

    device = resolve_device(device)
    # every ported config is fp32: no TF32 in cuDNN convs or matmuls
    set_strict_fp32()
    sample, profile = load_scene(scene_path, p)
    fwd = make_forward(model.to(device))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if tile and device_tiling_supported(p) \
            and p.get("infer_device_tiling", True):
        arr, t_ms = tile_inference_device(model, sample, p,
                                          tile=p.get("patch_size", 128),
                                          device=device)
        mem = device_peak_memory_mb(device)
        write_raster(out_path, arr.astype(np.float32), dict(profile))
        return out_path, t_ms, mem
    if tile:
        t0 = time.perf_counter_ns()
        pred = tile_inference(fwd, sample, p, tile=p.get("patch_size", 128),
                              device=device)
        t_ms = (time.perf_counter_ns() - t0) // 1000 / 1000
        mem = device_peak_memory_mb(device)
    else:
        pred, t_ms, mem = upscale_dem(fwd, sample, p, device)
    tk = p.get("tensor_kwargs") or {}
    base = float(np.min(sample["lr_dem"])) if p.get("relative") else 0.0
    arr = np.clip(pred, 0.0, 1.0)
    arr = descale_data(arr, tk.get("min", -80), tk.get("max", 929),
                       tk.get("log", False)) + base
    write_raster(out_path, arr.astype(np.float32), dict(profile))
    return out_path, t_ms, mem
