"""The 95th percentile of a scene's host ms from the loader taking it up
to its raster written (the port's ``serve.scene`` samples, one a scene) in
the traced window's call."""

import statistics

from benchmark import cells


def read(rec):
    call = cells.reader("loader_ms.serve").window_call(rec)
    got = call.samples.get("serve.scene") if call is not None else None
    if not got or len(got) < 2:
        return None
    return statistics.quantiles(got, n=20)[18] / 1e6
