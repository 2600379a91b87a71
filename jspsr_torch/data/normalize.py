"""Elevation scaling on numpy arrays (copy of the host half of
``jspsr_tpu/data/normalize.py``; reference data/data_utils.py:289-312,
441-457).

- minmax:       y = (x - min) / (max - min)
- log-minmax:   y = log(x - min) / log(max - min) + 1e-8

with an optional relative base (x -> x - base) applied before scaling.
"""

from __future__ import annotations

import numpy as np


def scale_data(data, elev_min, elev_max, elev_log: bool = False,
               base_elev=0.0):
    data = data - base_elev if float(base_elev) != 0.0 else data
    if elev_log:
        return np.log(data - elev_min) / np.log(elev_max - elev_min) + 1e-8
    return (data - elev_min) / (elev_max - elev_min)


def descale_data(data, elev_min, elev_max, elev_log: bool = False):
    if elev_log:
        return np.exp(data * np.log(elev_max - elev_min)) + elev_min
    return data * (elev_max - elev_min) + elev_min
