"""getdist_tpu_torch's f64 2D convolution program against the JAX package.

Parity mode's use of ``all_2d_densities``: the same exact pair histograms
(``hists_in``), host bandwidths (``bandwidth_override``) and kernel supports
on both sides, ``exact_mult_bias``, f64 throughout (the session's x64
mode), with and without a hard-bounded parameter. The JAX side runs its
FFT convolutions, the port its DFT-matmul kernels' plain versions, so
the two agree to f64 rounding of different transforms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops import batched as jb  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402

CONTOURS = np.array([0.68, 0.95])


def _inputs(fine, bounded):
    rng = np.random.RandomState(11)
    n = 6000
    x = rng.standard_normal(n)
    y = 0.5 * x + rng.standard_normal(n)
    z = np.abs(rng.standard_normal(n)) if bounded else rng.standard_normal(n) * 2
    samples = np.column_stack([x, y, z])
    weights = rng.randint(1, 4, n).astype(np.float64)
    binmin = samples.min(0) - 0.1 * np.ptp(samples, 0)
    binmax = samples.max(0) + 0.1 * np.ptp(samples, 0)
    active_lo = np.array([False, False, bounded])
    if bounded:
        binmin[2] = 0.0
    fw = (binmax - binmin) / (fine - 1)
    ix = ((samples - binmin) / fw + 0.5).astype(np.int64)
    pairs = [(0, 1), (0, 2), (1, 2)]
    hists = np.stack(
        [np.bincount(ix[:, b] * fine + ix[:, a], weights=weights, minlength=fine * fine).reshape(fine, fine) for a, b in pairs]
    )
    return samples, weights, pairs, hists, binmin, binmax, active_lo


@pytest.mark.parametrize(
    "fine,winw,bounded",
    [(256, 18, False), (256, 66, True), (384, 18, True), (384, 66, False)],
    ids=["256-w18", "256-w66-bounded", "384-w18-bounded", "384-w66"],
)
def test_conv_program_matches_jax(fine, winw, bounded):
    samples, weights, pairs, hists, binmin, binmax, active_lo = _inputs(fine, bounded)
    fw = (binmax - binmin) / (fine - 1)
    pa = np.array([a for a, _ in pairs])
    pb = np.array([b for _, b in pairs])
    # kernel widths of a few bins, one correlated pair; supports within winw
    rx = np.array([2.5, 4.0, 3.0]) * (winw / 18) ** 0.5
    ry = np.array([3.0, 2.0, 5.0]) * (winw / 18) ** 0.5
    override = (rx * fw[pa], ry * fw[pb], np.array([0.4, 0.0, -0.2]))
    support = np.minimum(np.round(2.5 * np.maximum(rx, ry)), winw - 3)
    neff = np.array([4000.0, 5000.0, 4500.0])
    sigma = samples.std(0)
    kw = dict(
        fine_bins=fine, winw=winw, bandwidth_override=override, kernel_support=support, sigma_range=sigma,
        active_lo=active_lo if bounded else None, active_hi=np.zeros(3, bool) if bounded else None,
        enable_shear=False, exact_mult_bias=True, hists_in=hists,
    )
    args = (samples, weights, pa.astype(np.int32), pb.astype(np.int32), neff, binmin, binmax, CONTOURS)
    want = jb.all_2d_densities(
        *(jnp.asarray(a) for a in args),
        use_pallas=False,
        **{k: (tuple(jnp.asarray(v) for v in val) if isinstance(val, tuple) else val if np.isscalar(val) or val is None else jnp.asarray(val)) for k, val in kw.items()},
    )
    got = tb.all_2d_densities(torch.from_numpy(samples), torch.from_numpy(weights), *args[2:], **kw)
    assert got["P"].dtype == torch.float64 and tuple(got["P"].shape) == (3, fine, fine)
    np.testing.assert_allclose(got["P"].numpy(), np.asarray(want["P"]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["contours"].numpy(), np.asarray(want["contours"]), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["rx"].numpy(), np.asarray(want["rx"]), rtol=1e-14)
