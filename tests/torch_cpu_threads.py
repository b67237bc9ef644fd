"""A module fixture for the port's CPU tests: under pytest-xdist, torch's
intra-op threads are capped at one worker's share of the CPU cores.

At torch's default every worker runs as many threads as the machine has
cores, so the workers together oversubscribe it several times over, and
each parallel region's barrier then waits on descheduled threads: with
eight cores kept busy, one call of the public fused entry on a 2000 x 3
chain took ~6x longer at 8 threads than at 1. Test modules import
``torch_threads_per_worker``; the count comes back when the module ends.

``tests/test_torch_fast_triangle.py`` does not: its
``test_pair_cumulant_score_matches_jax`` holds f32 fourth-moment sums of
a heavy-tailed chain within 1e-4 of the f64 result, which the reduction
order of torch's default 8 threads meets (4.3e-5) and that of 1, 2, 4 or
6 threads does not (1.0e-4 to 4.8e-4).
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        yield
        return
    saved = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    try:
        yield
    finally:
        torch.set_num_threads(saved)
