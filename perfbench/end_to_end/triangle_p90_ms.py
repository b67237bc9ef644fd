"""triangle_p90_ms: the 90th percentile of every analysis' wall time in the
window (host clock, each ending in a device synchronize)."""

import statistics


def read(run):
    walls = run["walls"]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[-1] * 1e3
