"""Prediction panels (copy of ``jspsr_tpu/eval/visualize.py``; reference
utils/utils.py:479-705): a matplotlib figure of image / LR DEM / GT DEM /
mask / canopy / prediction on a shared elevation colour map, optionally
saved. Without matplotlib it draws nothing and returns None."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from jspsr_torch.data.normalize import descale_data


def display_predictions(sample: dict, pred, tensor_kwargs: dict,
                        base_elev: float = 0.0, save_path=None, show=False,
                        cmap: str = "turbo"):
    """``sample``: HWC arrays in the normalized [0, 1] space (lr_dem,
    hr_dem, optionally image, mask, canopy); ``pred``: the HWC normalized
    prediction."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    vmin = tensor_kwargs.get("min", 0)
    vmax = tensor_kwargs.get("max", 1)
    log = tensor_kwargs.get("log", False)

    def to_m(a):
        return descale_data(np.clip(np.squeeze(np.asarray(a)), 0, 1),
                            vmin, vmax, log) + base_elev

    panels = []
    if "image" in sample:
        panels.append(("image", np.asarray(sample["image"]), None))
    lr = to_m(sample["lr_dem"])
    gt = to_m(sample["hr_dem"]) if "hr_dem" in sample else None
    pr = to_m(pred)
    elo = min(np.min(lr), np.min(pr), np.min(gt) if gt is not None else np.inf)
    ehi = max(np.max(lr), np.max(pr),
              np.max(gt) if gt is not None else -np.inf)
    panels.append(("LR DEM", lr, (elo, ehi)))
    if gt is not None:
        panels.append(("GT DEM", gt, (elo, ehi)))
    if "mask" in sample:
        panels.append(("mask", np.argmax(np.asarray(sample["mask"]), axis=2),
                       None))
    if "canopy" in sample:
        panels.append(("canopy", np.squeeze(np.asarray(sample["canopy"])),
                       None))
    panels.append(("prediction", pr, (elo, ehi)))

    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.4))
    if n == 1:
        axes = [axes]
    for ax, (title, data, rng) in zip(axes, panels):
        if data.ndim == 3 and data.shape[2] == 3:
            ax.imshow(data)
        elif rng is not None:
            im = ax.imshow(data, cmap=cmap, vmin=rng[0], vmax=rng[1],
                           interpolation="none")
            fig.colorbar(im, ax=ax, fraction=0.046)
        else:
            ax.imshow(data, cmap="tab20", interpolation="none")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=110)
    if not show:
        plt.close(fig)
    return fig
