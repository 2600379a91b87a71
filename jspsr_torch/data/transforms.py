"""Sample transforms needed for inference (copy of ``TransformCtx`` and
``ToArray`` from ``jspsr_tpu/data/transforms.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jspsr_torch.data.normalize import scale_data


@dataclass
class TransformCtx:
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0)
    )
    tile_index: int = 0


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
