"""Device-tiled scene inference (counterpart of ``jspsr_tpu/eval/scene.py``).

The host ships the RAW scene to the card once, in its cheapest exact
encoding (``transfer_encodings``), and one eager function on the card

  1. decodes each modality (u8, bit-packed mask, or f32 as uploaded) and
     normalizes it as ToArray does (``data.normalize.modality_scale``:
     log-minmax elevation with the scene-relative base, /255 images, mask
     channel scaling, canopy /68);
  2. gathers the overlapping tile grid with ``unfold`` at the grid's
     (stride_r, stride_c);
  3. runs the batched forward over the tiles in chunks of at most
     ``infer_tile_batch`` (default 96), bounding activation memory;
  4. feather-blends the predictions with the reference's linear cross-fade
     weights (``eval.mosaic.edge_ramp``) by ``fold``, divides by the weight
     mosaic, clips to [0, 1], descales to metres and adds the base.

The gather and the mosaic are deterministic: ``unfold`` copies, and
``fold`` sums each output pixel over the tiles that cover it in a fixed
order (no ``index_put_`` with CUDA atomics). The host's only work per scene
is one upload and one (H, W, 1) download.

Beyond the reference: the grid takes any scene size >= the tile side,
rectangles included (per-axis grids with a minimum overlap, mirror padding
only up to the next stride multiple).

Public functions take and return HWC numpy arrays; the runner's tensors are
channels-last on the way in and NCHW from the gather on. ``mesh``
(tile-parallel inference over several devices) is not yet ported.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from jspsr_torch.data.normalize import (
    descale_data,
    modality_scale,
    scale_data,
    unpack_mask_bits,
)
from jspsr_torch.eval.mosaic import edge_ramp
from jspsr_torch.utils.device import resolve_device, set_strict_fp32


def tile_grid(size: int, tile: int, min_overlap: int = 16):
    """Per-axis overlapping tile grid: (stride, n, padded_size).

    Reproduces the reference grid (config/loader.get_tile) whenever its
    exact-division constraint holds (334 -> stride 103 x3, 1024 -> stride
    112 x9), and otherwise picks the smallest tile count with >=
    min_overlap px overlap, padding the scene up to the next stride
    multiple."""
    assert size >= tile, f"scene side {size} < tile {tile}"
    if size == tile:
        return tile, 1, size
    n_x = (size - size % tile) // tile + 1
    if n_x >= 2 and (size - tile) % (n_x - 1) == 0:
        stride = (size - tile) // (n_x - 1)
        if stride < tile:  # reference grid is exact: no padding
            return stride, n_x, size
    n_x = math.ceil((size - tile) / (tile - min_overlap)) + 1
    stride = math.ceil((size - tile) / (n_x - 1))
    return stride, n_x, stride * (n_x - 1) + tile


def grid_weights(tile: int, stride_r: int, n_r: int, stride_c: int,
                 n_c: int) -> np.ndarray:
    """(n_r*n_c, tile, tile) feathering weights for a rect tile grid
    (row-major). Linear cross-fade over each overlap strip; sums to 1 at
    every covered pixel by construction (reference utils.py:802-898)."""
    ov_r, ov_c = tile - stride_r, tile - stride_c
    w = np.empty((n_r * n_c, tile, tile), np.float32)
    for r in range(n_r):
        wr = edge_ramp(tile, ov_r, r > 0, r < n_r - 1) if n_r > 1 \
            else np.ones(tile)
        for c in range(n_c):
            wc = edge_ramp(tile, ov_c, c > 0, c < n_c - 1) if n_c > 1 \
                else np.ones(tile)
            w[r * n_c + c] = (wr[:, None] * wc[None, :]).astype(np.float32)
    return w


def device_tiling_supported(p) -> bool:
    """The on-device normalizer replicates ToArray's default surface:
    per-modality [0,1] ranges, no dataset-stats Normalize list."""
    tk = p.get("tensor_kwargs") or {}
    return (not p.get("normalize")
            and tk.get("image_range") != "[-1, 1]"
            and tk.get("label_range") != "[-1, 1]")


def _assemble(tiles: dict, keys: list, model_name: str) -> list:
    """Model-family input assembly on NCHW tiles (``data.loader.
    model_inputs``; reference get_batch_pair, utils/utils.py:152-321)."""
    name = model_name.lower()
    if name in ("jspsr", "lrru"):
        return [tiles[k] for k in keys]
    if name == "completionformer":
        return [tiles["lr_dem"], torch.cat([tiles[k] for k in keys[1:]], 1)]
    return [torch.cat([tiles[k] for k in keys], 1)]


def transfer_encodings(sample: dict, keys: list) -> dict:
    """Pick the cheapest exact host->device encoding per modality: binary
    masks bit-pack 8x, integer-valued 0-255 rasters (orthophotos) ride as
    uint8, float-valued rasters stay fp32. A uint8 raster is decided by its
    dtype with at most one max-scan. Returns {key: ("f32" | "u8" | "bits",
    n_channels)}."""
    enc = {}
    for k in keys:
        arr = np.asarray(sample[k])
        c = arr.shape[-1]
        if k == "lr_dem":
            enc[k] = ("f32", c)
        elif arr.dtype == np.uint8:
            if c >= 8 and arr.size and int(arr.max()) <= 1:
                enc[k] = ("bits", c)
            else:
                enc[k] = ("u8", c)
        elif c >= 8 and arr.size and ((arr == 0) | (arr == 1)).all():
            enc[k] = ("bits", c)
        elif (arr.size and float(arr.min()) >= 0 and float(arr.max()) <= 255
              and np.array_equal(arr, arr.astype(np.uint8))):
            enc[k] = ("u8", c)
        else:
            enc[k] = ("f32", c)
    return enc


class PreparedScene:
    """Host-side product of prepare_scene: padded + compact-encoded
    modality arrays ready for upload, plus everything the runner cache
    keys on. Building one is the pure-host work (reflect pads, packbits,
    integrality scans); a serving loop does it in its loader thread so it
    overlaps the previous scene's device compute."""

    __slots__ = ("arrays", "keys", "hw", "enc", "base", "tile",
                 "min_overlap")

    def __init__(self, arrays, keys, hw, enc, base, tile, min_overlap):
        self.arrays = arrays
        self.keys = keys
        self.hw = hw
        self.enc = enc
        self.base = base
        self.tile = tile
        self.min_overlap = min_overlap


def prepare_scene(sample: dict, p, tile: int = 128,
                  min_overlap: int = 16) -> PreparedScene:
    """Validate + pad + compact-encode one raw scene on the host.

    Validates the DEM against the configured elevation range BEFORE
    upload: nodata pixels (-9999 and friends) or out-of-range elevations
    raise here with the scene range in the message, the loud failure
    ToArray gives the host path, instead of silent NaN rasters."""
    keys = [k for k in ("lr_dem", "image", "mask", "canopy", "coord")
            if k in sample]
    dem = np.asarray(sample["lr_dem"])
    hw = dem.shape[:2]
    tk = p.get("tensor_kwargs") or {}
    lo, hi = float(dem.min()), float(dem.max())
    base = lo if p.get("relative") else 0.0
    with np.errstate(invalid="ignore"):  # nodata -> NaN is the signal
        scaled = scale_data(np.array([lo, hi]), tk.get("min", -80),
                            tk.get("max", 929), tk.get("log", False),
                            base_elev=base)
    if not (np.isfinite(scaled).all()
            and -1e-6 <= scaled[0] and scaled[1] <= 1 + 1e-6):
        raise ValueError(
            f"scene lr_dem range [{lo}, {hi}] (base={base}) falls outside "
            f"the configured elevation range min={tk.get('min', -80)} "
            f"max={tk.get('max', 929)}: nodata pixels? Mask/fill them "
            f"before inference (ToArray would reject this scene too)")

    enc = transfer_encodings(sample, keys)
    pad_r = tile_grid(hw[0], tile, min_overlap)[2] - hw[0]
    pad_c = tile_grid(hw[1], tile, min_overlap)[2] - hw[1]
    arrays = {}
    for k in keys:
        kind = enc[k][0]
        arr = np.asarray(sample[k],
                         np.uint8 if kind in ("u8", "bits") else np.float32)
        if pad_r or pad_c:
            arr = np.pad(arr, ((0, pad_r), (0, pad_c), (0, 0)),
                         mode="reflect")
        if kind == "bits":
            arr = np.packbits(arr, axis=-1)
        arrays[k] = arr
    return PreparedScene(arrays, keys, hw, enc, base, tile, min_overlap)


def make_scene_runner(model, p, keys: list, scene_hw, tile: int = 128,
                      cap: int | None = None, min_overlap: int = 16,
                      mesh=None, encodings: dict | None = None,
                      scene_batch: int = 1, device=None):
    """Build the scene function for one scene shape on ``device``.

    Returns run(scenes, base) -> the (S, H, W, 1) mosaics in METRES on the
    device (blend the raw tile predictions, clip the mosaic to [0, 1],
    then descale, as ``run_scene_inference`` orders its host
    post-processing). ``scenes[k]`` is the (S, ph, pw, C) upload of
    prepare_scene's arrays for modality k, stacked on a leading scene axis
    of size ``scene_batch``; ``base`` is (S,).

    The grid's weights and weight mosaic live on the device with the
    function (eager mode has no program to cache). The forward runs in
    ``ceil(S*n / cap)`` chunks of equal size (the last one shorter)."""
    if mesh is not None:
        raise NotImplementedError("mesh (tile-parallel scene inference over "
                                  "several devices) is not yet ported")
    device = resolve_device(device)
    h, w = scene_hw
    stride_r, n_r, ph = tile_grid(h, tile, min_overlap)
    stride_c, n_c, pw = tile_grid(w, tile, min_overlap)
    n = n_r * n_c  # tiles per scene
    S = int(scene_batch)
    total = S * n
    cap = int(cap or p.get("infer_tile_batch") or 96)
    m = math.ceil(total / cap)
    chunk = math.ceil(total / m)

    weights = grid_weights(tile, stride_r, n_r, stride_c, n_c)
    # Cross-fade ramps sum to 1 wherever exactly two tiles meet (every
    # reference grid); a ceil'd generalized grid could triple-overlap, so
    # normalize by the weight mosaic (exactly 1.0 on reference grids).
    wsum = np.zeros((ph, pw), np.float32)
    for t in range(n):
        r0, c0 = stride_r * (t // n_c), stride_c * (t % n_c)
        wsum[r0:r0 + tile, c0:c0 + tile] += weights[t]
    weights_d = torch.from_numpy(weights).reshape(1, n, tile * tile).to(device)
    wsum_d = torch.from_numpy(wsum).to(device)

    tk = p.get("tensor_kwargs") or {}
    emin, emax = tk.get("min", -80), tk.get("max", 929)
    elog = tk.get("log", False)
    scale = dict(emin=emin, emax=emax, elog=elog,
                 scale_mask=tk.get("scale_mask", False),
                 n_div=len(p.get("mask_channel") or list(range(15))) + 1,
                 relative=bool(p.get("relative")))
    enc = encodings or {}

    def tiles_of(k, x, b4):
        # decode, normalize (channels last), then gather the grid as NCHW
        kind, n_ch = enc.get(k, ("f32", None))
        if kind == "bits":
            x = unpack_mask_bits(x, n_ch)
        x = modality_scale(k, x.float(), b4, **scale).permute(0, 3, 1, 2)
        t = x.unfold(2, tile, stride_r).unfold(3, tile, stride_c)
        # (S, C, n_r, n_c, tile, tile) -> (S*n, C, tile, tile), row-major
        return t.permute(0, 2, 3, 1, 4, 5).reshape(total, x.shape[1], tile,
                                                   tile)

    def run(scenes: dict, base: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            b4 = base.view(S, 1, 1, 1)
            inputs = _assemble({k: tiles_of(k, v, b4)
                                for k, v in scenes.items()},
                               keys, p.model_name)
            preds = [model([x[j * chunk:(j + 1) * chunk] for x in inputs])
                     for j in range(m)]
            pred = torch.cat(preds) if m > 1 else preds[0]
            pred = pred.float().reshape(S, n, tile * tile) * weights_d
            out = F.fold(pred.transpose(1, 2), (ph, pw), (tile, tile),
                         stride=(stride_r, stride_c))  # (S, 1, ph, pw)
            out = torch.clamp(out / wsum_d, 0.0, 1.0)[:, 0, :h, :w]
            out = descale_data(out, emin, emax, elog) + base.view(S, 1, 1)
            return out[..., None].contiguous()

    return run


# Runner cache: repeated scenes of one shape (benchmark trials, batch CLI
# runs) reuse the grid's device tensors. Bounded LRU: a long-lived server
# seeing many shapes (or reloading models) must not pin them and model
# references forever.
_RUNNER_CACHE: OrderedDict = OrderedDict()
_RUNNER_CACHE_MAX = 8


def _host_stack(arrays: list, pin: bool) -> torch.Tensor:
    """Stack same-shape numpy arrays on a new leading axis into one host
    tensor, pinned for an asynchronous copy when ``pin``; one copy each.
    On the CPU a single array is a zero-copy view."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if not pin and len(tensors) == 1:
        return tensors[0][None]
    out = torch.empty((len(tensors),) + tuple(tensors[0].shape),
                      dtype=tensors[0].dtype, pin_memory=pin)
    for i, t in enumerate(tensors):
        out[i].copy_(t)
    return out


def upload_scenes(prepared_list, device, copy_stream=None):
    """The stacked modality arrays and bases of same-shape PreparedScenes
    on ``device``: ({key: (S, ph, pw, C)}, (S,) float32). On CUDA they go
    through pinned host memory without blocking the host, on
    ``copy_stream`` when given (the current stream then waits for the
    copies), else on the current stream."""
    keys = prepared_list[0].keys
    cuda = device.type == "cuda"
    host = {k: _host_stack([pr.arrays[k] for pr in prepared_list], cuda)
            for k in keys}
    base = _host_stack([np.asarray([pr.base], np.float32)
                        for pr in prepared_list], cuda).view(-1)
    if not cuda:
        return host, base
    ctx = (torch.cuda.stream(copy_stream) if copy_stream is not None
           else contextlib.nullcontext())
    with ctx:
        scenes = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        base = base.to(device, non_blocking=True)
    if copy_stream is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_stream(copy_stream)
        for t in (*scenes.values(), base):
            t.record_stream(compute)  # allocated on the copy stream
    return scenes, base


def scene_dispatch_batch(model, prepared_list, p, cap: int | None = None,
                         mesh=None, device=None, copy_stream=None):
    """Upload S same-shape PreparedScenes and enqueue ONE stacked run
    without waiting for it: returns the (S, H, W, 1) metres mosaics on the
    device. All scenes must share (keys, hw, enc, tile, min_overlap);
    group first (``serve._compat_key``). The model is moved to ``device``
    and put in eval mode; on CUDA, TF32 is turned off (fp32 means
    fp32)."""
    if mesh is not None:
        raise NotImplementedError("mesh (tile-parallel scene inference over "
                                  "several devices) is not yet ported")
    device = resolve_device(device)
    first = prepared_list[0]
    S = len(prepared_list)
    if not all(pr.keys == first.keys and pr.hw == first.hw
               and pr.enc == first.enc and pr.tile == first.tile
               and pr.min_overlap == first.min_overlap
               for pr in prepared_list):
        raise ValueError("scene batch must be homogeneous")
    tk = p.get("tensor_kwargs") or {}
    # min_overlap sets the grid: scenes of two overlaps never share a runner
    key = (id(model), tuple(first.keys), first.hw, first.tile,
           first.min_overlap, cap, S,
           tuple(sorted(first.enc.items())), tk.get("min"), tk.get("max"),
           tk.get("log", False), tk.get("scale_mask", False),
           bool(p.get("relative")),
           len(p.get("mask_channel") or list(range(15))),
           p.get("infer_tile_batch"), p.model_name.lower(), str(device))
    if device.type == "cuda":
        set_strict_fp32()
    model.to(device).eval()  # a no-op once it is there
    hit = _RUNNER_CACHE.get(key)
    if hit is None:
        # the entry holds the model so its id cannot be recycled onto a
        # different object while the entry lives
        hit = (model, make_scene_runner(
            model, p, first.keys, first.hw, tile=first.tile, cap=cap,
            encodings=first.enc, min_overlap=first.min_overlap,
            scene_batch=S, device=device))
        _RUNNER_CACHE[key] = hit
        if len(_RUNNER_CACHE) > _RUNNER_CACHE_MAX:
            _RUNNER_CACHE.popitem(last=False)
    else:
        _RUNNER_CACHE.move_to_end(key)
    scenes, base = upload_scenes(prepared_list, device, copy_stream)
    return hit[1](scenes, base)


def scene_dispatch(model, sample, p, tile: int = 128, cap: int | None = None,
                   mesh=None, device=None):
    """Enqueue one scene through the device-tiled function: returns the
    (H, W, 1) metres mosaic on the device. ``sample`` is a raw scene dict
    or an already-built PreparedScene (serving loops prepare in their
    loader thread)."""
    prepared = (sample if isinstance(sample, PreparedScene)
                else prepare_scene(sample, p, tile=tile))
    return scene_dispatch_batch(model, [prepared], p, cap=cap, mesh=mesh,
                                device=device)[0]


def tile_inference_device(model, sample: dict, p, tile: int = 128,
                          cap: int | None = None, mesh=None, device=None):
    """End-to-end device-tiled scene inference on ``device`` (default
    cuda). Returns (dem_metres (H, W, 1) float32 numpy, latency_ms): host
    prep, upload, compute and the mosaic's download. The first call per
    shape also builds the runner and cuDNN's plans; a caller timing the
    steady state times a second call."""
    device = resolve_device(device)
    t0 = time.perf_counter_ns()
    out = scene_dispatch(model, sample, p, tile=tile, cap=cap, mesh=mesh,
                         device=device).cpu().numpy()
    t_ms = (time.perf_counter_ns() - t0) // 1000 / 1000
    return out, t_ms
