"""Pipelined multi-scene serving (counterpart of ``jspsr_tpu/eval/serve.py``)
around the device-tiled scene function (``eval/scene.py``):

  loader thread : raster decode (load_scene) + pad/pack/validate
                  (prepare_scene) of the next scenes, pure host work
  main thread   : pinned staging, upload on a copy stream, and the
                  group's run enqueued on the compute stream; an event is
                  recorded after its mosaic
  writer thread : waits on that event on a side stream, copies the mosaic
                  into pinned host memory there, waits for that copy only,
                  and writes the rasters

so raster IO, host->device copies, the forward and the output writes
overlap. A device->host copy on the compute stream would wait for
everything enqueued before it, the next group's forward included; the side
stream waits for this group's event alone. Same-shape scenes share one
runner (``scene._RUNNER_CACHE``); ``scene_batch`` > 1 stacks that many
consecutive same-shape scenes into one run.

Each call is a unit of work of ``utils/tracing.py`` (``serve.call``),
handed to the loader and writer threads. It counts the ``scenes`` and
``groups`` dispatched and holds the host time of each stage's spans:
``serve.load`` and ``serve.prep`` (the loader's ``load_scene`` and
``prepare_scene``), ``serve.wait_input`` (the dispatch loop waiting for a
loaded scene), ``serve.dispatch`` (a group's ``scene_dispatch_batch`` and
its event), ``serve.wait_output`` (waiting for room in the writer's
queue), and one ``serve.scene`` latency sample a scene, from the loader
taking it up to its raster written. The writer's fetch and writes are the
profiler range ``serve.write``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from jspsr_torch.eval.inference import _SCENE_ALIASES, _find_modality
from jspsr_torch.utils import tracing

# The largest stacked run ``auto_scene_batch`` allows, in tiles, from the
# scene_batch sweep of ``eval/profile_serve.py`` on an H100 (PERF.md): at
# 334^2 batch 8 (72 tiles) was fastest, at 1024^2 batch 1 (81 tiles), so
# the cap lies in [81, 161]; 96 is one default forward chunk
# (``infer_tile_batch``). The JAX package's 176 was tuned on a TPU.
CAP_TILES = 96


def scene_ext(path) -> str:
    """Output raster extension for a scene: mirror the LR-DEM raster's
    format (flat and <modality>/<file> subdir layouts alike) so .npy
    scenes round-trip without a raster backend."""
    path = Path(path)
    if path.is_file():
        return ".npy" if path.suffix == ".npy" else ".tif"
    lr = _find_modality(path, _SCENE_ALIASES["lr_dem"])
    return ".npy" if (lr is not None and lr.suffix == ".npy") else ".tif"


def discover_scenes(batch_dir) -> list:
    """A batch directory holds one subdirectory per scene (each in the
    load_scene layout). Returns the sorted scene dirs; empty if
    ``batch_dir`` itself looks like a single scene."""
    batch_dir = Path(batch_dir)
    if not batch_dir.is_dir():
        return []
    if _find_modality(batch_dir, _SCENE_ALIASES["lr_dem"]) is not None:
        return []  # single scene
    return [d for d in sorted(batch_dir.iterdir())
            if d.is_dir()
            and _find_modality(d, _SCENE_ALIASES["lr_dem"]) is not None]


def probe_scene_hw(scene_path):
    """(h, w) of a scene's LR-DEM raster from the header only (no pixel
    read): the pre-flight input to auto_scene_batch."""
    from jspsr_torch.data.raster_io import probe_shape

    path = Path(scene_path)
    lr = path if path.is_file() else _find_modality(
        path, _SCENE_ALIASES["lr_dem"])
    if lr is None:
        raise FileNotFoundError(f"no LR-DEM raster under {path}")
    return probe_shape(lr)


def auto_scene_batch(hw, tile: int = 128, n_scenes: int | None = None,
                     cap_tiles: int = CAP_TILES) -> int:
    """Size-aware ``scene_batch``: the largest batch in {8, 4, 2, 1} whose
    stacked run stays at or under ``cap_tiles`` tiles (with the default:
    batch 8 at 334^2, 72 tiles; batch 1 at 1024^2, 81 tiles), capped by
    the number of scenes. ``infer_scene_batch`` in the config overrides
    it."""
    from jspsr_torch.eval.scene import tile_grid

    h, w = hw
    n_tiles = (tile_grid(max(int(h), tile), tile)[1]
               * tile_grid(max(int(w), tile), tile)[1])
    sb = 8
    while sb > 1 and sb * n_tiles > cap_tiles:
        sb //= 2
    if n_scenes:
        sb = max(1, min(sb, int(n_scenes)))
    return sb


def _compat_key(prepared):
    """Scenes sharing this key can stack into one batched run (the
    overlap sets the grid, as the tile does)."""
    return (tuple(prepared.keys), prepared.hw,
            tuple(sorted(prepared.enc.items())), prepared.tile,
            prepared.min_overlap)


def _fetch(dev_out: torch.Tensor, ready, stream) -> np.ndarray:
    """The mosaic on the host. On CUDA: on ``stream``, after the event
    ``ready`` recorded behind its computation, into pinned memory; waits
    for that copy alone."""
    if stream is None:
        return dev_out.numpy()
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host = torch.empty(dev_out.shape, dtype=dev_out.dtype,
                           pin_memory=True)
        host.copy_(dev_out, non_blocking=True)
        dev_out.record_stream(stream)  # allocated on the compute stream
        copied = stream.record_event()
    copied.synchronize()
    return host.numpy()


def serve_scenes(model, p, scene_paths, out_dir, tile: int = 128,
                 prefetch: int = 2, mesh=None, scene_batch: int = 1,
                 loader_threads: int = 1, device=None):
    """Run device-tiled inference over many scenes on ``device`` (default
    cuda) with the 3-stage pipeline. Returns (list of output paths,
    elapsed_ms, scenes_per_s).

    ``scene_paths``: scene directories (or single LR-DEM rasters) in the
    load_scene format. Outputs land in ``out_dir/<scene name>_sr.tif``
    (``.npy`` when the scene raster was .npy). Exceptions from any stage
    propagate to the caller after the pipeline drains.

    ``scene_batch`` > 1 stacks that many consecutive same-shape scenes into
    one run (``scene.scene_dispatch_batch``). Partial tail groups pad by
    repeating the last scene (outputs dropped); an incompatible shape
    flushes the group.

    ``loader_threads`` > 1 decodes and prepares that many scenes at once
    with in-order hand-off: the same grouping and outputs as the serial
    loader (config key ``infer_loader_threads``).

    ``mesh`` (a ``parallel.mesh.Mesh`` or a list of local devices) runs
    each group's forward tile-parallel over its devices
    (``scene.make_scene_runner``); the mosaics stay on ``device``."""
    from jspsr_torch.data.raster_io import write_raster
    from jspsr_torch.eval.inference import load_scene
    from jspsr_torch.eval.scene import prepare_scene, scene_dispatch_batch
    from jspsr_torch.utils.device import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    d2h_stream = torch.cuda.Stream(device) if cuda else None
    scene_paths = [Path(s) for s in scene_paths]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scene_batch = max(1, int(scene_batch))

    loaded: queue.Queue = queue.Queue(maxsize=max(scene_batch, prefetch))
    done: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    errors: list = []
    out_paths: list = [None] * len(scene_paths)

    def _load_one(i, path):
        taken = time.perf_counter_ns()  # the scene's latency starts here
        with tracing.span("serve.load", work):
            sample, profile = load_scene(path, p)
        with tracing.span("serve.prep", work):
            prepared = prepare_scene(sample, p, tile=tile)
        return (i, path, prepared, profile, taken)

    def loader():
        for i, path in enumerate(scene_paths):
            try:
                item = _load_one(i, path)
            except Exception as e:  # surface after drain
                errors.append(e)
                loaded.put(None)
                return
            loaded.put(item)
        loaded.put(None)

    def loader_pool():
        # decode+prepare ``loader_threads`` scenes at once (raster codecs
        # and numpy release the GIL), handed off in submission order so
        # grouping and output naming match the serial loader; at most
        # ``loader_threads`` scenes are in flight
        ex = ThreadPoolExecutor(loader_threads)
        window: deque = deque()
        it = iter(enumerate(scene_paths))
        try:
            while True:
                while len(window) < loader_threads:
                    try:
                        i, path = next(it)
                    except StopIteration:
                        break
                    window.append(ex.submit(_load_one, i, path))
                if not window:
                    break
                loaded.put(window.popleft().result())
        except Exception as e:
            errors.append(e)
            loaded.put(None)
            return
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
        loaded.put(None)

    def writer():
        while True:
            item = done.get()
            if item is None:
                return
            idxs, paths, dev_out, profiles, taken, ready = item
            try:
                with tracing.ranged("serve.write"):
                    arr = _fetch(dev_out, ready, d2h_stream)
                    for j, (i, path, profile) in enumerate(
                            zip(idxs, paths, profiles)):
                        out_path = (out_dir
                                    / f"{path.stem}_sr{scene_ext(path)}")
                        write_raster(out_path, arr[j].astype(np.float32),
                                     dict(profile) if profile else None)
                        out_paths[i] = out_path
                        work.sample("serve.scene",
                                    time.perf_counter_ns() - taken[j])
            except Exception as e:
                errors.append(e)

    n_done = 0
    buf: list = []

    def flush():
        nonlocal n_done
        if not buf:
            return True
        group = [b[2] for b in buf]
        if scene_batch > 1:  # pad the tail so one runner serves all
            group = group + [group[-1]] * (scene_batch - len(group))
        try:
            with tracing.span("serve.dispatch", work):
                dev = scene_dispatch_batch(model, group, p, mesh=mesh,
                                           device=device,
                                           copy_stream=copy_stream)
                ready = (torch.cuda.current_stream(device).record_event()
                         if cuda else None)
        except Exception as e:
            errors.append(e)
            return False
        with tracing.span("serve.wait_output", work):
            done.put(([b[0] for b in buf], [b[1] for b in buf], dev,
                      [b[3] for b in buf], [b[4] for b in buf], ready))
        n_done += len(buf)
        work.count("groups")
        work.count("scenes", len(buf))
        buf.clear()
        return True

    t_loader = threading.Thread(
        target=loader_pool if loader_threads > 1 else loader, daemon=True)
    t_writer = threading.Thread(target=writer, daemon=True)
    with tracing.unit("serve.call") as work:
        t0 = time.perf_counter_ns()
        t_loader.start()
        t_writer.start()
        ok = True
        while ok:
            with tracing.span("serve.wait_input", work):
                item = loaded.get()
            if item is None:
                ok = flush()
                break
            if buf and (_compat_key(item[2]) != _compat_key(buf[0][2])
                        or len(buf) == scene_batch):
                if not flush():
                    # drain the loader so it can finish (it may be blocked
                    # on a full queue); items are discarded
                    while loaded.get() is not None:
                        pass
                    break
            buf.append(item)
            if len(buf) == scene_batch:
                if not flush():
                    while loaded.get() is not None:
                        pass
                    break
        done.put(None)
        t_writer.join()
        t_loader.join()
        elapsed_ms = (time.perf_counter_ns() - t0) // 1000 / 1000
    if errors:
        raise errors[0]
    return out_paths, elapsed_ms, n_done / max(elapsed_ms, 1e-9) * 1000.0
