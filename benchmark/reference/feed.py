"""The DFC30 training feed, in plain numpy: which samples make each batch
of an epoch, and how each is cropped, augmented and scaled.

- The epoch's order is ``np.random.default_rng(SeedSequence([seed,
  epoch]))`` shuffling ``arange(n)``; batch i is the order's slice ``[i
  * B, (i + 1) * B)`` (the remainder is dropped).
- Crop: the 8 m configs crop in tile mode with one tile per raster, so a
  raster of the patch's size is taken whole (no other size is supported
  here).
- Sample ``index`` draws from ``default_rng(SeedSequence([seed, epoch,
  index]))``: with probability 1/2 a rotation by 90, 180 or 270 degrees
  followed by an optional left-right and an optional up-down flip (the
  reference's ``RandomFlipRotate90``).
- Scaling (the reference's ``ToArray``): images / 255; DEMs (low and
  high resolution) relative to the low-resolution scene's minimum, then
  log-minmax, ``log(x - min) / log(max - min) + 1e-8``; mask channel i
  times (i + 1) / 16.

Returns NCHW float32 tensors in the model's input order: [lr_dem, image,
mask] and the target."""

from __future__ import annotations

import numpy as np
import torch


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    idx = np.arange(n)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(idx)
    return idx


def scale_dem(x, base, emin, emax):
    return (np.log(x - base - emin) / np.log(emax - emin) + 1e-8).astype(
        np.float32)


def sample(files: dict, index: int, seed: int, epoch: int, patch: int,
           tk: dict) -> dict:
    raw = {k: np.load(f) for k, f in files.items()}
    base = float(raw["lr_dem"].min())
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, index]))
    if raw["image"].shape[:2] != (patch, patch):
        raise ValueError(f"a {raw['image'].shape[:2]} raster for patch "
                         f"{patch}: the reference feed takes whole tiles")
    if rng.random() < 0.5:
        angle = int(rng.choice([1, 2, 3]))
        lr = bool(rng.choice([True, False]))
        ud = bool(rng.choice([True, False]))
        for k, v in raw.items():
            v = np.rot90(v, angle)
            v = np.fliplr(v) if lr else v
            raw[k] = np.flipud(v) if ud else v
    emin, emax = tk["min"], tk["max"]
    n_mask = raw["mask"].shape[-1]
    return {
        "lr_dem": scale_dem(raw["lr_dem"].astype(np.float32), base, emin,
                            emax),
        "hr_dem": scale_dem(raw["hr_dem"].astype(np.float32), base, emin,
                            emax),
        "image": raw["image"].astype(np.float32) / 255.0,
        "mask": raw["mask"].astype(np.float32)
        * np.arange(1, n_mask + 1, dtype=np.float32) / (n_mask + 1),
    }


def batch(files: list, step: int, batch_size: int, seed: int, epoch: int,
          patch: int, tk: dict, device, rows=None):
    """Step ``step`` of ``epoch``: ([lr_dem, image, mask], gt) as NCHW
    tensors on ``device``; ``rows`` keeps only those rows of the batch."""
    if not tk.get("log"):
        raise ValueError("the reference feed scales DEMs log-minmax only")
    order = epoch_order(len(files), seed, epoch)
    idx = order[step * batch_size:(step + 1) * batch_size]
    if rows is not None:
        idx = idx[rows]
    samples = [sample(files[i], int(i), seed, epoch, patch, tk) for i in idx]

    def nchw(key):
        a = np.stack([np.ascontiguousarray(s[key]) for s in samples])
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(device)

    return [nchw("lr_dem"), nchw("image"), nchw("mask")], nchw("hr_dem")


def model_inputs(inputs: list, model_name: str) -> list:
    """[lr_dem, image, mask] in a model's layout: per modality for JSPSR,
    [lr_dem, guidance channels stacked] for CompletionFormer."""
    if model_name.lower() == "completionformer":
        return [inputs[0], torch.cat(inputs[1:], 1)]
    return inputs
