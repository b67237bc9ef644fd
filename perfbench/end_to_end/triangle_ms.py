"""triangle_ms: the mean wall time per analysis, the window (from the first
analysis' start to the last one's end, each ending in a device
synchronize) over the analyses completed in it."""


def read(run):
    if not run["completed"]:
        return None
    return run["window_s"] / run["completed"] * 1e3
