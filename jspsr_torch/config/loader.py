"""Config loader (copy of ``jspsr_tpu/config/loader.py``): the reference's
YAML surface and derived defaults (reference utils/config.py:8-120).

`AttrDict` replaces easydict. Derived defaults preserved:

- resolution -> dataset path / patch_size / patches_per_image (r3 tile mode:
  9 tiles of 128 from 334x334, via get_tile);
- input_data.lr_dem forced to 1; COP30 xor FABDEM validation;
- metric kwargs inherit border/tensor_range/min/max from tensor_kwargs;
- model_kwargs.spn default: True for JSPSR, False for EDSR;
- misc default fills (scale, normalize, diff_lr, ...).

``.json`` configs load with the ``json`` module (JSON is a subset of YAML,
so the same file gives the same dict); other files need PyYAML.
"""

from __future__ import annotations

import json
import math
from pathlib import Path


class AttrDict(dict):
    """dict with attribute access, recursive wrapping, and .get semantics."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, AttrDict):
        return AttrDict(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def get_tile(w: int, k: int, n: int | None = None):
    """Tile grid parameters for covering a w x w image with k x k tiles
    (reference data/data_utils.py:170-194): returns (stride, n_tiles)."""
    if n is None:
        n_x = (w - w % k) / k + 1
    else:
        n_x = math.ceil(n**0.5)
    assert n_x % 1 == 0, "cannot divide the image into n tiles"
    stride = (w - k) / (n_x - 1)
    assert stride % 1 == 0, "tiles must cover the image without padding"
    return int(stride), int(n_x**2)


def _read(config_file) -> dict:
    with open(config_file, "r") as stream:
        if str(config_file).endswith(".json"):
            return json.load(stream)
        import yaml

        return yaml.safe_load(stream)


def create_config(config_file) -> AttrDict:
    cfg = AttrDict(_read(config_file))

    cfg.work_root = cfg.get("work_root") or "./"
    cfg.data_root = cfg.get("data_root") or "../datasets"

    if "dfc" in cfg.dataset.lower():
        if cfg.get("patch_size") is None:
            cfg.patch_size = 128
        if cfg.resolution == 8:
            cfg.dataset_path = (Path(cfg.data_root) / "DFC30_8m").as_posix()
            cfg.patches_per_image = 1
        elif cfg.resolution == 3:
            cfg.dataset_path = (Path(cfg.data_root) / "DFC30_3m").as_posix()
        if cfg.get("crop_mode") is None:
            cfg.crop_mode = "tile"
        if (
            cfg.resolution == 3
            and cfg.crop_mode.lower() == "tile"
            and cfg.get("patches_per_image") is None
        ):
            _, n_tile = get_tile(334, cfg.patch_size)
            cfg.patches_per_image = n_tile
        cfg.input_data = cfg.get("input_data") or AttrDict()
        cfg.input_data.lr_dem = 1
        if cfg.input_data.get("COP30") is None and cfg.input_data.get("FABDEM") is None:
            cfg.input_data.COP30 = 1
        assert (
            cfg.input_data.get("COP30") is not None
            or cfg.input_data.get("FABDEM") is not None
        ), "Either COP30 or FABDEM must be configured as lr_dem"
    else:
        raise NotImplementedError(f"Dataset {cfg.dataset} not implemented yet.")

    tk = cfg.get("tensor_kwargs")
    if tk and tk.get("min") is not None and tk.get("max") is not None:
        if tk.get("log") is True:
            assert tk.max - tk.min > 1, "log minmax requires max - min > 1"
        else:
            tk.log = False
        for key, kwargs in cfg.metric.items():
            if kwargs.get("border") is None:
                kwargs.border = cfg.get("val_border") or 0
            if kwargs.get("tensor_range") is None:
                kwargs.tensor_range = tk.get("label_range") or "[0, 1]"
            if kwargs.get("min") is None:
                kwargs["min"] = tk.min
            if kwargs.get("max") is None:
                kwargs["max"] = tk.max

    if (
        cfg.resolution == 3
        and cfg.get("val_id_visual") is not None
        and cfg.crop_mode.lower() == "tile"
    ):
        cfg.val_id_visual = cfg.val_id_visual * 9 + 4

    if cfg.model_kwargs.get("spn") is None:
        if cfg.model_name.lower() == "edsr":
            cfg.model_kwargs.spn = False
        if cfg.model_name.lower() == "jspsr":
            cfg.model_kwargs.spn = True

    for key, default in [
        ("scale", None), ("normalize", False), ("train_num_visual", 0),
        ("monitor_value", None), ("mask_channel", None),
    ]:
        if cfg.get(key) is None:
            cfg[key] = default
    if cfg.optimizer_kwargs.get("diff_lr") is None:
        cfg.optimizer_kwargs.diff_lr = False

    return cfg
