"""The yardstick's work counting (``perfbench/work.py``) at the main path's
shapes, against the kernel table's bound column (PERF.md): K1 0.043 ms, K2
0.155 ms, K3 0.668 ms on the 30 x 1M bench chain (435 pairs, 256 bins,
kernels of 61 x 61 at frame 384)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import work  # noqa: E402

N, P, K = 1_000_000, 30, 435


@pytest.mark.parametrize(
    "name, bound_fn, want_ms, by",
    [
        ("K1", lambda: work.hist_bound(N, P, 1, 1, K, 256), 0.043, "bytes"),
        ("K2", lambda: work.spectrum_bound(K, 61, 384), 0.155, "bytes"),
        ("K3", lambda: work.conv_bound(K, 256, 384, 256), 0.668, "operations"),
    ],
)
def test_kernel_bounds_at_the_main_path(name, bound_fn, want_ms, by):
    ms, bound_by = bound_fn()
    assert round(ms, 3) == want_ms, name
    assert bound_by == by


def test_frozen_frames():
    assert work.frame_for(256 + 4 * 30 + 1) == 384
    assert work.frame_for(256 + 4 * 126 + 1) == 768
    assert work.frame_for(100) == 384


def _info(params, meanlikes=False, routes=None):
    routes = routes or {}
    pairs = [(a, b) + routes.get((a, b), (256, 30)) for a in range(len(params)) for b in range(a + 1, len(params))]
    return {"samples": N, "integer_weights": True, "meanlikes": meanlikes, "params": params, "pairs": pairs,
            "reruns": 0}


FREE = {"limited": False, "periodic": False}
LIMITED = {"limited": True, "periodic": False}
PERIODIC = {"limited": False, "periodic": True}


def test_bench_analysis_is_one_k1_k2_and_two_k3():
    info = _info([FREE] * P)
    assert work.analysis_hist_ms(info) == pytest.approx(work.hist_bound(N, P, 1, 1, K, 256)[0])
    parts = [work.spectrum_work(K, 61, 384), work.conv_work(2 * K, 256, 384, 256)]
    want = max(sum(b for b, _ in parts) / work.HBM_BYTES_S, sum(f for _, f in parts) / work.TF32X3_FLOPS) * 1e3
    assert work.analysis_conv_ms(info) == pytest.approx(want)
    # the analysis needs at most the three launches' bounds, at least the largest
    k2, k3 = work.spectrum_bound(K, 61, 384)[0], work.conv_bound(K, 256, 384, 256)[0]
    assert k3 < work.analysis_conv_ms(info) <= k2 + 2 * k3


def test_limits_periodic_axes_likes_and_reruns_add_work():
    base = work.analysis_conv_ms(_info([FREE] * 4))
    limited = work.analysis_conv_ms(_info([LIMITED] + [FREE] * 3))
    periodic = work.analysis_conv_ms(_info([PERIODIC] + [FREE] * 3))
    likes = work.analysis_conv_ms(_info([FREE] * 4, meanlikes=True))
    rescued = work.analysis_conv_ms(_info([FREE] * 4, routes={(0, 1): (256, 126)}))
    assert base < periodic < limited
    assert base < likes and base < rescued
    assert work.analysis_hist_ms(_info([FREE] * 4, meanlikes=True)) > work.analysis_hist_ms(_info([FREE] * 4))
    wide = work.analysis_hist_ms(_info([FREE] * 4, routes={(0, 1): (960, 107)}))
    assert wide > work.analysis_hist_ms(_info([FREE] * 4))
