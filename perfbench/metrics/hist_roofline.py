"""hist_roofline (%), layer kernels (pair histograms): the least time of the
analyses' histogram work (``work.analysis_hist_ms``: each index row and
weight read once, each served pair's histogram written once) over the
device time of the kernels that bin them, matched by name below."""

from perfbench.work import analysis_hist_ms

KERNELS = ("pair_hist_",)


def read(window):
    busy = window.device_seconds(lambda name: any(k in name for k in KERNELS))
    if busy <= 0 or not window.analyses:
        return None
    return 100.0 * sum(analysis_hist_ms(a) for a in window.analyses) / (busy * 1e3)
