"""idle_share (%), layer device: the share of the traced window in which no
operation ran on the card (the union of the kernels', copies' and memsets'
intervals, without the stage ranges' device spans)."""


def read(window):
    if window.seconds <= 0 or not window.device_ops:
        return None
    return 100.0 * (1.0 - window.busy_seconds() / window.seconds)
