"""The 95th percentile of the window's eval-only generations' wall
times, ms (the driver's loop, ``optimizers/cma_base.py``)."""

import statistics


def read(trace):
    walls = trace["generation_s"]
    if len(walls) < 20:
        return None
    return 1e3 * statistics.quantiles(walls, n=20)[18]
