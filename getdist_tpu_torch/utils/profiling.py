"""Profiling and tracing helpers, the port's copy of
``getdist_tpu/utils/profiling.py``: a wall-clock timer that waits for the
timed device work, and a ``torch.profiler`` trace."""

import contextlib
import logging
import time

__all__ = ["device_timer", "trace_to"]


def _synchronize(value):
    """Wait until the device work that produces ``value`` has finished: a
    CUDA tensor synchronizes its device, anything else (a CPU tensor, a
    numpy array) is ready once it exists."""
    import torch

    tensors = value if isinstance(value, (list, tuple)) else [value]
    for tensor in tensors:
        if isinstance(tensor, torch.Tensor) and tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)


@contextlib.contextmanager
def device_timer(label, sync_value=None, logger=None):
    """Wall-clock a device computation up to the completion of ``sync_value``
    (or of ``holder["sync"]``, set inside the block). The yielded holder
    gets ``seconds``."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        value = holder.get("sync", sync_value)
        if value is not None:
            _synchronize(value)
        dt = time.perf_counter() - t0
        holder["seconds"] = dt
        (logger or logging.getLogger("getdist_tpu_torch")).debug("%s: %.3f s", label, dt)


@contextlib.contextmanager
def trace_to(log_dir):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is a
    card, CUDA activity, written to ``log_dir`` as a Chrome trace (view
    with TensorBoard or ``chrome://tracing``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
