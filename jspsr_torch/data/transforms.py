"""Deterministic, shard-safe sample transforms (copy of
``jspsr_tpu/data/transforms.py``: ``TransformCtx``, ``Compose``,
``RandomFlipRotate90``, ``RandomCrop``, ``TileCrop``, ``ToArray``,
``Normalize``, ``build_transforms``, the output helpers ``ToImage`` and
``ToDEM`` and the BT.601 helpers ``RGB2YCbCr``, ``rgb2ycbcr`` and
``ycbcr2rgb``).

Every transform is a pure function of (sample, ctx): ``ctx.rng`` is a numpy
Generator seeded from (seed, epoch, sample index) and ``ctx.tile_index``
drives ``TileCrop``, so the draws, and the samples, are the JAX package's
exactly. Samples stay HWC numpy; the trainer turns batches into NCHW
tensors. With ``device_normalize`` both loaders ship raw crops (uint8
stays uint8) and ``data.normalize.make_device_normalize`` applies
ToArray's arithmetic on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jspsr_torch.config.loader import get_tile
from jspsr_torch.data.normalize import descale_data, scale_data
from jspsr_torch.data.raster_io import affine_xy


@dataclass
class TransformCtx:
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0)
    )
    tile_index: int = 0


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, sample, ctx: TransformCtx):
        for t in self.transforms:
            sample = t(sample, ctx)
        return sample

    def __str__(self):
        return " -> ".join(str(t) for t in self.transforms)


def _spatial_keys(sample):
    return [k for k in sample if "meta" not in k]


class RandomFlipRotate90:
    """Joint rot90/flip augmentation with p=0.5, recorded into meta
    (reference data_utils.py:9-33)."""

    def draw(self, ctx: TransformCtx):
        """Consume this transform's RNG draws; returns (rot90, flip_lr,
        flip_ud) or None."""
        rng = ctx.rng
        if rng.random() < 0.5:
            angle = int(rng.choice([1, 2, 3]))
            do_lr = bool(rng.choice([True, False]))
            do_ud = bool(rng.choice([True, False]))
            return angle, do_lr, do_ud
        return None

    def __call__(self, sample, ctx: TransformCtx):
        drawn = self.draw(ctx)
        if drawn is not None:
            angle, do_lr, do_ud = drawn
            for k in _spatial_keys(sample):
                tmp = np.rot90(sample[k], angle)
                tmp = np.fliplr(tmp) if do_lr else tmp
                tmp = np.flipud(tmp) if do_ud else tmp
                sample[k] = tmp
            sample["meta"]["augmentation"] = {
                "rot90": angle, "flip_lr": do_lr, "flip_ud": do_ud,
            }
        return sample

    def __str__(self):
        return "RandomFlipRotate90"


def _ref_size(sample):
    for k in ("image", "lr_img", "lr_dem"):
        if k in sample:
            return sample[k].shape[:2]
    raise ValueError(f"sample has no image-like key: {list(sample)}")


class RandomCrop:
    """Random crop (reference data_utils.py:36-84)."""

    def __init__(self, crop_size: int = 128, scale=None):
        self.crop_size = crop_size
        self.scale = scale

    def draw(self, ctx: TransformCtx, h: int, w: int):
        """Consume this transform's RNG draws; returns (row0, col0) or None
        when no crop applies (sample smaller/equal to the crop)."""
        cs = self.crop_size
        if cs > h or cs > w or (cs == h == w):
            return None
        return int(ctx.rng.integers(0, h - cs)), int(ctx.rng.integers(0, w - cs))

    def __call__(self, sample, ctx: TransformCtx):
        h, w = _ref_size(sample)
        drawn = self.draw(ctx, h, w)
        if drawn is None:
            return sample
        cs = self.crop_size
        _h, _w = drawn
        for k in list(sample):
            if k == "hr_img" and self.scale is not None:
                s = self.scale
                sample[k] = sample[k][_h * s:(_h + cs) * s, _w * s:(_w + cs) * s, :]
            elif "meta" in k:
                sample[k]["bbox"] = (_h, _w, _h + cs, _w + cs)
            else:
                sample[k] = sample[k][_h:_h + cs, _w:_w + cs, :]
        return sample

    def __str__(self):
        return "RandomCrop"


class TileCrop:
    """Deterministic overlapping tiling (reference data_utils.py:87-197),
    driven by ctx.tile_index instead of internal counters.

    Tiles cover the image in row-major order with stride (w-k)/(n_x-1);
    the geo profile/bbox in meta are rewritten to the tile window.
    """

    def __init__(self, crop_size: int = 128, scale=None, n_tile=None):
        self.crop_size = crop_size
        self.scale = scale
        self.n_tile = n_tile

    def draw(self, ctx: TransformCtx, h: int, w: int):
        """Deterministic tile window for ctx.tile_index; returns (row0,
        col0) or None when no crop applies. No RNG draws."""
        cs = self.crop_size
        if cs > h or cs > w or (cs == h == w):
            return None
        stride, n_tile = get_tile(w, cs, self.n_tile)
        n_x = int(round(n_tile**0.5))
        t = ctx.tile_index % n_tile
        return stride * (t // n_x), stride * (t % n_x)

    def __call__(self, sample, ctx: TransformCtx):
        h, w = _ref_size(sample)
        cs = self.crop_size
        if cs > h or cs > w or (cs == h == w):
            return sample
        stride, n_tile = get_tile(w, cs, self.n_tile)
        n_x = int(round(n_tile**0.5))
        t = ctx.tile_index % n_tile
        row, col = t // n_x, t % n_x
        for k in list(sample):
            if k == "hr_img" and self.scale is not None:
                s = self.scale
                sample[k] = sample[k][
                    stride * row * s:(stride * row + cs) * s,
                    stride * col * s:(stride * col + cs) * s, :,
                ]
            elif "meta" in k:
                sample[k]["bbox"] = (
                    stride * col, stride * row,
                    stride * col + cs, stride * row + cs,
                )
                profile = dict(sample[k].get("profile") or {})
                if profile.get("transform"):
                    tfm = profile["transform"]
                    res = tfm[0]
                    x, y = affine_xy(tfm, stride * col, stride * row)
                    profile["transform"] = [res, 0.0, x, 0.0, -res, y]
                    profile["width"] = cs
                    profile["height"] = cs
                    sample[k]["profile"] = profile
            else:
                sample[k] = sample[k][
                    stride * row:stride * row + cs,
                    stride * col:stride * col + cs, :,
                ]
        return sample

    def __str__(self):
        return "TileCrop"


class ToArray:
    """Numeric conversion to float32 HWC in [0, 1] (reference ToTensor,
    data_utils.py:200-312, minus the CHW transpose).

    - images: uint8 -> /255
    - DEMs: minmax or log-minmax elevation scaling, optional per-tile
      relative base (= tile min elevation from meta['base'])
    - mask: channel i scaled to (i+1)/(n+1) when scale_mask
    - canopy: /68 (max canopy height)
    """

    def __init__(self, normalize_list=None, mask_channel=None,
                 relative: bool = False, **kwargs):
        self.normalize_list = normalize_list or []
        self.image_range = kwargs.get("image_range")
        self.label_range = kwargs.get("label_range")
        self.elev_min = kwargs.get("min")
        self.elev_max = kwargs.get("max")
        self.elev_log = kwargs.get("log", False)
        self.relative = relative
        self.scale_mask = kwargs.get("scale_mask", False)
        self.mask_channel = mask_channel if mask_channel else list(range(15))

    def __call__(self, sample, ctx: TransformCtx):
        base_elev = sample["meta"]["base"] if self.relative else 0.0
        sid = sample["meta"]["id"]
        for k in list(sample):
            if "meta" in k:
                continue
            tmp = sample[k]
            if "img" in k or "image" in k:
                tmp = tmp.astype(np.float32) / 255.0
                if self.label_range == "[-1, 1]" and k == "hr_img":
                    tmp = 2.0 * tmp - 1.0
                if self.image_range == "[-1, 1]" and k in {"lr_img", "image"}:
                    tmp = 2.0 * tmp - 1.0
                sample[k] = np.ascontiguousarray(tmp, np.float32)
                continue
            tmp = tmp.astype(np.float32)
            if "dem" in k and k not in self.normalize_list:
                assert self.elev_min is not None and self.elev_max is not None
                tmp = scale_data(tmp, self.elev_min, self.elev_max,
                                 self.elev_log, base_elev=base_elev)
                assert 0 <= tmp.min() and tmp.max() <= 1, (
                    f"{sid} {k}: [{tmp.min()}, {tmp.max()}] out of range; "
                    f"base={base_elev} min={self.elev_min} max={self.elev_max}"
                )
                if self.label_range == "[-1, 1]" and k == "hr_dem":
                    tmp = tmp * 2 - 1
                if self.image_range == "[-1, 1]" and k == "lr_dem":
                    tmp = tmp * 2 - 1
            if "mask" in k and self.scale_mask:
                chans = np.arange(1, tmp.shape[2] + 1, dtype=np.float32)
                tmp = tmp * chans[None, None, :] / (len(self.mask_channel) + 1)
            if "canopy" in k:
                tmp = tmp / 68.0
            assert tmp.min() >= 0 and tmp.max() <= 1, f"{sid} {k} out of [0,1]"
            sample[k] = np.ascontiguousarray(tmp, np.float32)
        return sample

    def __str__(self):
        return "ToArray"


class Normalize:
    """Dataset mean/std normalization (reference data_utils.py:316-397;
    explicitly discouraged for DEMs, kept for completeness)."""

    _STATS = {
        8: {
            "mean": {"image": [104.5478121, 113.53916278, 91.06393941],
                     "lr_dem": [201.49762], "hr_dem": [200.50319]},
            "std": {"image": [48.61966393, 36.84840044, 33.2264289],
                    "lr_dem": [386.18207], "hr_dem": [386.5053]},
        },
        3: {
            "mean": {"image": [104.55297366, 113.54333935, 91.0669583],
                     "lr_dem": [201.48833], "hr_dem": [200.49414]},
            "std": {"image": [50.76874938, 38.8785096, 34.9372223],
                    "lr_dem": [386.1985], "hr_dem": [386.50452]},
        },
    }

    def __init__(self, normalize_list=None, resolution=None):
        self.normalize_list = normalize_list or []
        stats = self._STATS.get(resolution, self._STATS[8])
        self.mean, self.std = stats["mean"], stats["std"]

    def __call__(self, sample, ctx: TransformCtx):
        for k in self.normalize_list:
            if k not in sample:
                continue
            mean = np.asarray(self.mean[k], np.float32)
            std = np.asarray(self.std[k], np.float32)
            sample[k] = (sample[k].astype(np.float32) - mean) / std
        return sample

    def __str__(self):
        return "Normalize"


class ToImage:
    """[0,1] float array -> [0,255] int image (reference data_utils.py:400-417)."""

    def __call__(self, data):
        data = np.asarray(data, np.float32)
        assert data.min() >= 0 and data.max() <= 1, (data.min(), data.max())
        return (255.0 * data).astype(int)

    def __str__(self):
        return "ToImage"


class ToDEM:
    """[0,1] float array -> elevation meters (reference data_utils.py:419-457)."""

    def __init__(self, elev_min, elev_max, elev_log: bool = False):
        self.elev_min = elev_min
        self.elev_max = elev_max
        self.elev_log = elev_log

    def __call__(self, data):
        data = np.asarray(data, np.float32)
        assert data.min() >= 0 and data.max() <= 1, (data.min(), data.max())
        return descale_data(data, self.elev_min, self.elev_max, self.elev_log)

    def __str__(self):
        return "ToDEM"


def build_transforms(p):
    """Train/eval transform composition (reference common_config.py:112-161).

    Order: crop -> [Normalize] -> [RandomFlipRotate90] -> ToArray for train;
    crop -> ToArray for eval.
    """
    crop_mode = (p.get("crop_mode") or "random").lower()
    if crop_mode == "random":
        crop = RandomCrop(p.patch_size, None if "dfc" in p.dataset.lower()
                          else p.get("scale"))
    elif crop_mode == "tile":
        crop = TileCrop(p.patch_size,
                        None if "dfc" in p.dataset.lower() else p.get("scale"),
                        n_tile=p.get("patches_per_image"))
    else:
        raise NotImplementedError(crop_mode)

    to_array = ToArray(p.get("normalize"), p.get("mask_channel"),
                       p.get("relative", False),
                       **(p.get("tensor_kwargs") or {}))
    # device_normalize: both loaders ship raw crops and the device applies
    # ToArray's arithmetic (data/normalize.make_device_normalize)
    device_norm = bool(p.get("device_normalize"))
    eval_tf = Compose([crop] if device_norm else [crop, to_array])

    train_list = [crop]
    if p.get("augment"):
        train_list.append(RandomFlipRotate90())
    if p.get("normalize"):
        train_list.insert(1, Normalize(p.normalize, p.get("resolution")))
    if not device_norm:
        train_list.append(to_array)
    return Compose(train_list), eval_tf


class RGB2YCbCr:
    """Pipeline transform applying BT.601 RGB->YCbCr to image-like keys
    (reference data_utils.py:460-478)."""

    def __init__(self, y_channel_only: bool = False):
        self.y_channel_only = y_channel_only

    def __call__(self, sample, ctx: TransformCtx):
        for k in list(sample):
            if "img" in k or "image" in k:
                sample[k] = rgb2ycbcr(sample[k], self.y_channel_only)
        return sample

    def __str__(self):
        return ("RGB2YCbCr channel Y only" if self.y_channel_only
                else "RGB2YCbCr channel Y Cb CR")


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """ITU-R BT.601 RGB->YCbCr (matches MATLAB; reference
    data_utils.py:480-520). uint8 [0,255] or float32 [0,1] input."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if y_only:
        return np.dot(img, [65.481, 128.553, 24.966]) + 16.0
    return np.matmul(
        img,
        [[65.481, -37.797, 112.0],
         [128.553, -74.203, -93.786],
         [24.966, 112.0, -18.214]],
    ) + [16, 128, 128]


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """Inverse BT.601 conversion (reference data_utils.py:522-563)."""
    if img.dtype == np.float32:
        img = (img * 255.0).astype(np.uint8)
    return np.matmul(
        img,
        [[0.00456621, 0.00456621, 0.00456621],
         [0, -0.00153632, 0.00791071],
         [0.00625893, -0.00318811, 0]],
    ) * 255.0 + [-222.921, 135.576, -276.836]
