"""DFC30 guided DEM super-resolution dataset (copy of
``jspsr_tpu/data/dfc30.py``; reference data/dfc30.py).

Directory schema (reference ReadMe.md:28-68): one folder per French city,
with modality subfolders:

  <city>/COP30/<id>_COP30.tif     low-res DEM (resampled to target grid)
  <city>/FABDEM/<id>_FABDEM.tif   alternative LR DEM source
  <city>/BDORTHO/...              RGB orthophoto guidance
  <city>/RGEALTI/...              ground-truth bare-earth DEM
  <city>/UA2012/...               15-channel land-use mask
  <city>/CHM/...                  canopy height model

Redesign vs the reference:
- raster reads go through the backend-agnostic raster_io (npy fixtures work
  without GDAL), with a small thread-safe LRU cache instead of the
  last-raster cache that relied on sequential access (dfc30.py:67-78);
- tiling/augmentation are driven by a pure per-index TransformCtx
  (tile = index % patches_per_image), so samples are reproducible under
  shuffling and multi-host sharding;
- per-city sample-count validation against the published table is optional
  (strict_counts) so synthetic fixtures can be small.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np

from jspsr_torch.data.raster_io import natsorted, read_raster
from jspsr_torch.data.transforms import TransformCtx

# Published per-city sample counts (reference dfc30.py:368-385), 3981 total.
REF_CITY_SIZES = {
    "Angers": 246, "Brest": 172, "Caen": 251, "Calais_Dunkerque": 256,
    "Cherbourg": 113, "Clermont-Ferrand": 300, "LeMans": 214,
    "Lille_Arras_Lens_Douai_Henin": 407, "Lorient": 120,
    "Marseille_Martigues": 309, "Nantes_Saint-Nazaire": 433, "Nice": 333,
    "Quimper": 154, "Rennes": 391, "Saint-Brieuc": 136, "Vannes": 146,
}

# DFC30 global bounds: minx, miny, maxx, maxy (reference dfc30.py:23-28)
DFC30_BOUNDS = [100000, 6200000, 1100000, 7120000]

_SPLITS = {"train", "tra", "valid", "val", "test", "trainval", "all"}


class _LRU:
    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self.lock = threading.Lock()
        self.data: OrderedDict = OrderedDict()

    def get_or_load(self, key, load):
        with self.lock:
            if key in self.data:
                self.data.move_to_end(key)
                return self.data[key]
        value = load()
        with self.lock:
            self.data[key] = value
            self.data.move_to_end(key)
            while len(self.data) > self.capacity:
                self.data.popitem(last=False)
        return value


class DFC30:
    def __init__(self, split="valid", transform=None, seed: int = 0,
                 strict_counts: bool = False, **kwargs):
        self.p = kwargs
        self.transform = transform
        self.seed = seed
        self.epoch = 0
        self.path = kwargs.get("dataset_path", "../datasets/DFC30_8m")
        self.resolution = kwargs.get("resolution", 8)
        self.input_data = kwargs.get("input_data") or {}
        self.mask_channel = kwargs.get("mask_channel") or list(range(15))
        self.coord_mode = kwargs.get("coord_mode")
        self.relative = kwargs.get("relative", False)
        self.patches_per_image = kwargs.get("patches_per_image") or 1
        self.strict_counts = strict_counts

        self.split = [split] if isinstance(split, str) else natsorted(split)
        assert all(s in _SPLITS for s in self.split), f"invalid split {self.split}"

        if self.input_data.get("FABDEM") == 1:
            self.lr_source = "FABDEM"
        else:
            self.lr_source = "COP30"

        self._cache = _LRU(capacity=16)
        self.id, self.subset = [], []
        self.files = {"lr_dem": [], "hr_dem": []}
        if self.input_data.get("image"):
            self.files["image"] = []
        if self.input_data.get("mask"):
            self.files["mask"] = []
        if self.input_data.get("canopy"):
            self.files["canopy"] = []

        data_dirs = [d for d in Path(self.path).glob("*") if d.is_dir()]
        by_name = {d.name: d for d in data_dirs}
        modality_dirs = {
            "lr_dem": self.lr_source, "image": "BDORTHO", "hr_dem": "RGEALTI",
            "mask": "UA2012", "canopy": "CHM",
        }

        for sp in self.split:
            if sp in ("train", "tra"):
                cities = kwargs.get("train_set", [])
            elif sp in ("valid", "val", "test"):
                cities = kwargs.get("valid_set", [])
            else:  # trainval / all
                cities = (kwargs.get("train_set", [])
                          + kwargs.get("valid_set", []))
            cities = [c for c in cities if c in by_name]
            assert cities, f"no city folders found for split {sp} in {self.path}"
            for city in cities:
                city_dir = by_name[city]
                per_mod = {}
                for key in self.files:
                    sub = city_dir / modality_dirs[key]
                    fl = natsorted(
                        str(f) for f in sub.glob("*")
                        if f.suffix in (".tif", ".tiff", ".npy")
                    )
                    per_mod[key] = fl
                n = len(per_mod["lr_dem"])
                assert n > 0, f"no LR DEMs in {city_dir / self.lr_source}"
                for key, fl in per_mod.items():
                    assert len(fl) == n, (
                        f"{city}: {key} has {len(fl)} files, expected {n}"
                    )
                    self.files[key].extend(fl)
                suffix = f"_{self.lr_source}"
                self.id.extend(
                    Path(f).stem[: -len(suffix)] if Path(f).stem.endswith(suffix)
                    else Path(f).stem
                    for f in per_mod["lr_dem"]
                )
                self.subset.extend([city] * n)
                if self.strict_counts:
                    assert n == REF_CITY_SIZES[city], (
                        f"{city}: {n} != published {REF_CITY_SIZES[city]}"
                    )

        self.base_len = len(self.id)
        if kwargs.get("preload"):
            # decode every raster once into an unbounded cache (reference
            # 'preload' config key; ~GBs for the real dataset)
            self._cache = _LRU(capacity=10**9)
            from concurrent.futures import ThreadPoolExecutor

            unique = sorted({f for fl in self.files.values() for f in fl})
            with ThreadPoolExecutor(8) as pool:
                list(pool.map(self._read, unique))
        if kwargs.get("verbose"):
            print(f"DFC30 {self.resolution}m {self.split}: {len(self)} samples "
                  f"({self.base_len} images x {self.patches_per_image} tiles)")

    # ------------------------------------------------------------------
    def __len__(self):
        return self.base_len * self.patches_per_image

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _read(self, path):
        return self._cache.get_or_load(
            path, lambda: read_raster(path, with_profile=True)
        )

    def __getitem__(self, index):
        img_idx = index // self.patches_per_image
        tile_idx = index % self.patches_per_image
        sample = self.raw_scene(img_idx, tile_idx)
        if self.transform is not None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, index])
            )
            sample = self.transform(sample, TransformCtx(rng, tile_idx))
        return sample

    def raw_scene(self, img_idx: int, tile_idx: int = 0):
        """Untransformed full scene (every modality + meta)."""
        sample = {}
        lr_dem, profile = self._read(self.files["lr_dem"][img_idx])
        lr_dem = lr_dem.astype(np.float32)
        sample["lr_dem"] = lr_dem

        if "image" in self.files:
            img, _ = self._read(self.files["image"][img_idx])
            assert img.shape[2] == self.input_data["image"]
            sample["image"] = img

        hr_dem, _ = self._read(self.files["hr_dem"][img_idx])
        sample["hr_dem"] = hr_dem.astype(np.float32)

        if self.input_data.get("coord"):
            sample["coord"] = self._gen_coord(lr_dem, profile, self.coord_mode)

        if "mask" in self.files:
            mask, _ = self._read(self.files["mask"][img_idx])
            if self.mask_channel:
                mask = mask[:, :, self.mask_channel]
            sample["mask"] = mask

        if "canopy" in self.files:
            canopy, _ = self._read(self.files["canopy"][img_idx])
            sample["canopy"] = canopy

        num_channels = sum(v.shape[2] for k, v in sample.items())
        sample["meta"] = {
            "id": (f"{self.id[img_idx]}_{tile_idx}"
                   if self.patches_per_image > 1 else str(self.id[img_idx])),
            "subset": str(self.subset[img_idx]),
            "shape": (lr_dem.shape[0], lr_dem.shape[1], num_channels),
            "augmentation": {"rot90": 0, "flip_lr": False, "flip_ud": False},
            "bbox": (0, 0, lr_dem.shape[0], lr_dem.shape[1]),
            "base": float(np.min(lr_dem)) if self.relative else 0,
            "profile": dict(profile),
        }
        return sample

    @staticmethod
    def _gen_coord(dem, profile, coord_mode):
        """Coordinate channels (reference dfc30.py:292-337)."""
        mode = (coord_mode or "local").lower()
        h, w = dem.shape[:2]
        if mode == "local":
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            yy = yy / (h - 1)
            xx = xx / (w - 1)
            return np.stack([yy, xx], axis=2)
        if mode == "global":
            a, b, c, d, e, f = profile["transform"]
            xs = c + a * (np.arange(w) + 0.5)
            ys = f + e * (np.arange(h) + 0.5)
            xx, yy = np.meshgrid(np.sort(xs), np.sort(ys))
            xx = (xx.astype(np.float32) - DFC30_BOUNDS[0]) / DFC30_BOUNDS[2]
            yy = (yy.astype(np.float32) - DFC30_BOUNDS[1]) / DFC30_BOUNDS[3]
            return np.concatenate([xx[:, :, None], yy[:, :, None]], axis=2)
        raise NotImplementedError(mode)

    @staticmethod
    def collate(batch):
        """Stack samples into NHWC numpy arrays; keep meta as a list
        (reference dfc30.py:347-364)."""
        out = {}
        for key in ("lr_dem", "image", "mask", "canopy", "coord", "hr_dem"):
            if all(key in b for b in batch):
                out[key] = np.stack([b[key] for b in batch])
        out["meta"] = [b["meta"] for b in batch]
        return out
