"""Utility helpers: device timing and profiling."""

from getdist_tpu_torch.utils.profiling import device_timer, trace_to

__all__ = ["device_timer", "trace_to"]
