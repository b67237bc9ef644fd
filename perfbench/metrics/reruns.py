"""reruns (groups/analysis), layer entry: the reruns the entry makes after
its programs (corr-adaptive regrids, sheared assists, fragile pairs, the
clamped-window rescue), from ``MCSamples.fast_regrid_groups`` after each
traced call."""


def read(window):
    if not window.analyses:
        return None
    return sum(a["reruns"] for a in window.analyses) / len(window.analyses)
