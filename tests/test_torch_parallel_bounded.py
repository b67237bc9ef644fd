"""getdist_tpu_torch.parallel with hard limits, periodic axes and like
weights, on 4 gloo ranks on the CPU.

The ranks are spawned once for the module. Each runs
``sharded_triangle_densities`` on the dry run's bounded, periodic and
correlated chain (``parallel.dryrun.dryrun_chain``, the chain of the JAX
package's ``dryrun_multichip``) with likelihood weights from its
loglikes, and the public ``MCSamples.fastTriangleDensities(mesh=group)``
with meanlikes on a chain with a limit, a periodic axis and a
0.8-correlated pair (``tests/test_parallel.py``'s). Their outputs are held
against each other (every rank's bits equal), against the JAX sharded
function on a 4-device CPU mesh, and against the port's unsharded path.
The rank worker and the module's top level import no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from getdist_tpu_torch.parallel import (  # noqa: E402
    shard_samples,
    shard_values,
    sharded_all_2d_densities,
    sharded_moments,
    sharded_triangle_densities,
    spawn_ranks,
)
from getdist_tpu_torch.parallel.dryrun import dryrun_chain, dryrun_multirank  # noqa: E402

WORLD = 4
# the dry run's chain on 4 ranks, and one 3 samples short (the last rank
# pads with zero-weight, zero-like-weight samples)
TRIANGLE_N = {"even": 512 * WORLD, "padded": 512 * WORLD - 3}


def _bounded_chain(n):
    """(samples, weights, limits_lo, limits_hi, periodic, like_weights):
    the dry run's first ``n`` samples, like weights w exp(<chi2/2> - chi2/2)
    of loglikes chi2/2 = 0.5 sum x^2."""
    samples, weights, lo, hi, per = dryrun_chain(WORLD)
    samples, weights = samples[:n], weights[:n]
    loglikes = 0.5 * np.sum(samples.astype(np.float64) ** 2, axis=1)
    mean_ll = np.sum(weights * loglikes) / np.sum(weights)
    like = (weights * np.exp(mean_ll - loglikes)).astype(np.float32)
    return samples, weights, lo, hi, per, like


def _entry_chain():
    """tests/test_parallel.py's public-path chain: 3000 x 4 per rank, a
    pair at corr ~0.8, one column bounded at 0 and one periodic on [0, 2),
    integer weights, and loglikes for the meanlikes grids."""
    rng = np.random.RandomState(5)
    n = WORLD * 3000
    s = rng.standard_normal((n, 4))
    s[:, 1] = 0.8 * s[:, 0] + 0.6 * s[:, 1]
    s[:, 2] = np.abs(s[:, 2])
    s[:, 3] = np.mod(s[:, 3], 2.0)
    return dict(samples=s, weights=rng.randint(1, 4, n).astype(np.float64), loglikes=0.5 * np.sum(s**2, axis=1),
                names=["a", "b", "c", "d"], ranges={"c": [0, None], "d": [0, 2, True]})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _like_hist_args(d1):
    """(pair_a, pair_b, neff, binmin, binmax, contours) of all_2d_densities
    over every pair, from a triangle's 1D output."""
    p = d1["neff"].shape[0]
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)])
    return pairs[:, 0], pairs[:, 1], d1["neff"], d1["range"][0], d1["range"][1], np.array([0.68, 0.95], np.float32)


def _rank_work(group):
    out = {}
    for name, n in TRIANGLE_N.items():
        s, w, lo, hi, per, like = _bounded_chain(n)
        local = shard_samples(group, s, w, device="cpu")
        out[f"triangle_{name}"] = _np(sharded_triangle_densities(
            group, *local, limits_lo=lo, limits_hi=hi, periodic=per, like_weights=shard_values(group, like, "cpu"),
            enable_shear=True, n_samples=n,
        ))
        # the like weights as the fractional weights of all_2d_densities, the
        # route that bins the like histograms, at the triangle's N_eff and ranges
        d1 = out[f"triangle_{name}"][0]
        out[f"like_hists_{name}"] = _np(sharded_all_2d_densities(
            group, local[0], shard_values(group, like, "cpu"), *_like_hist_args(d1), int8_weights=False, n_samples=n,
            export_hists=True,
        )["hists"])
        out[f"moments_{name}"] = _np(sharded_moments(group, *local))
        out[f"score_{name}"] = _np(tb.pair_cumulant_score(*local, group=group))
    mc = MCSamples(device="cpu", **_entry_chain())
    d1, d2, pairs = mc.fastTriangleDensities(mesh=group, meanlikes=True)
    regrid = {key: _np(entry) for key, entry in d2.pop("regrid").items()}
    out["entry"] = (_np(d1), _np(d2), regrid, pairs, mc.fast_regrid_groups)
    st = mc._fast_chain_cache
    out["entry_state"] = {"whole_chain": st["samples"] is not None, "whole_like": st["like_weights"] is not None,
                          "block": tuple(st["block"][2].shape), "cum_score": st["cum_score"]}
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_rank_work, WORLD, "gloo", timeout_s=900)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix: tree}


def test_every_rank_returns_identical_bits(ranks):
    """The ranges, active limits, like histograms and moments are
    all-reduced before any grid-local stage reads them: a rank that decided
    on its own block would return other grids."""
    want = _flat(ranks[0])
    assert len(want) > 60
    for rank, got in enumerate(ranks[1:], start=1):
        got = _flat(got)
        assert set(got) == set(want)
        for key, value in got.items():
            np.testing.assert_array_equal(value, want[key], err_msg=f"rank {rank}: {key}")


def test_limits_and_periodic_flags_kept(ranks):
    g1, g2 = ranks[0]["triangle_even"]
    assert g1["P"].shape == (4, 1024) and g2["P"].shape == (6, 256, 256)
    assert bool(g1["active_lo"][2]) and bool(g1["periodic"][3])
    assert g1["likes"].shape == (4, 1024) and g2["likes"].shape == (6, 256, 256)
    for grid in (g1["P"], g2["P"], g1["likes"], g2["likes"]):
        assert np.all(np.isfinite(grid))


def test_bounded_triangle_matches_jax(ranks):
    """Against the JAX function on a 4-device CPU mesh (f32), at the slice
    tolerances of tests/test_torch_parallel.py. The JAX package's f32 2D
    like grids are wrong where a tail rounds below zero (ROADMAP C10), so
    the 2D like grids are held against the unsharded port instead; its 1D
    like curves are compared here."""
    import jax

    from getdist_tpu.parallel import make_mesh
    from getdist_tpu.parallel.reductions import sharded_triangle_densities as jax_triangle

    s, w, lo, hi, per, like = _bounded_chain(TRIANGLE_N["even"])
    with jax.enable_x64(False):
        j1, j2 = jax_triangle(make_mesh(WORLD), s, w, limits_lo=lo, limits_hi=hi, periodic=per, like_weights=like,
                              enable_shear=True)
        j1 = {k: np.asarray(v) for k, v in j1.items() if k != "range" and v is not None}
        j2 = {k: np.asarray(v) for k, v in j2.items() if v is not None}
    g1, g2 = ranks[0]["triangle_even"]
    for key in ("active_lo", "active_hi", "periodic"):
        np.testing.assert_array_equal(g1[key], j1[key])
    np.testing.assert_allclose(g1["neff"], j1["neff"], rtol=1e-4)
    np.testing.assert_allclose(g1["P"], j1["P"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g1["likes"], j1["likes"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g2["P"], j2["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g2["contours"], j2["contours"], rtol=0.02)


@pytest.mark.parametrize("name", list(TRIANGLE_N))
def test_bounded_triangle_matches_unsharded_port(ranks, name):
    """At tests/test_parallel.py's tolerances; the like grids (f32 like
    weights summed in another order over many decades) within 1e-4."""
    s, w, lo, hi, per, like = _bounded_chain(TRIANGLE_N[name])
    u1, u2 = _np(tb.triangle_densities(s, w, limits_lo=lo, limits_hi=hi, periodic=per, like_weights=like,
                                       int8_weights=False, enable_shear=True, device="cpu"))
    g1, g2 = ranks[0][f"triangle_{name}"]
    np.testing.assert_allclose(g1["neff"], u1["neff"], rtol=1e-3)
    np.testing.assert_allclose(g1["P"], u1["P"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g2["P"], u2["P"], rtol=0, atol=3e-5)
    np.testing.assert_allclose(g2["contours"], u2["contours"], rtol=1e-3)
    np.testing.assert_allclose(g1["likes"], u1["likes"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g2["likes"], u2["likes"], rtol=0, atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(g1["range"][i], u1["range"][i], rtol=1e-5)


@pytest.mark.parametrize("name", list(TRIANGLE_N))
def test_like_histograms_of_ranks_equal_one_rank(ranks, name):
    """The like-weighted pair histograms (fractional weights) of 4 ranks are
    bitwise one rank's: each rank bins in 64-bit fixed point on the group's
    scale (max |w| over the ranks, the chain's length) and the ranks'
    int64 sums are all-reduced exactly (ROADMAP C13 (a)); f32 partial sums
    all-reduced differ from one rank's in their last bits. The padded chain
    ends in zero-weight samples on the last rank. The histograms are those
    of all_2d_densities with the like weights as its fractional weights:
    the like histograms' route, exported."""
    s, _, _, _, _, like = _bounded_chain(TRIANGLE_N[name])
    d1 = ranks[0][f"triangle_{name}"][0]
    want = tb.all_2d_densities(torch.from_numpy(s), torch.from_numpy(like), *_like_hist_args(d1), int8_weights=False,
                               export_hists=True)["hists"].numpy()
    assert not np.array_equal(like, np.round(like))  # fractional like weights
    for rank in ranks:
        np.testing.assert_array_equal(rank[f"like_hists_{name}"], want)


@pytest.mark.parametrize("name", list(TRIANGLE_N))
def test_reduced_moments_and_grids_of_ranks_equal_one_rank(ranks, name):
    """ROADMAP C13 (c): every moment the fused program sums over samples and
    all-reduces (norm, means, variances and covariance, the N_eff lag sums,
    the cumulant score's sums) runs in f64 partial sums cast once, so 4
    ranks give one rank's f32 values bit for bit, and with the histograms'
    fixed point (C13 (a)) the 1D and 2D grids, contours, kernels and like
    grids are one rank's too. f32 partial sums all-reduced differ from one
    rank's in their last bits, which the like grids' density floor
    magnifies."""
    s, w, lo, hi, per, like = _bounded_chain(TRIANGLE_N[name])
    u1, u2 = _np(tb.triangle_densities(s, w, limits_lo=lo, limits_hi=hi, periodic=per, like_weights=like,
                                       int8_weights=False, enable_shear=True, device="cpu"))
    s32, w32 = torch.from_numpy(s.astype(np.float32)), torch.from_numpy(w.astype(np.float32))
    moments = _np(sharded_moments(None, s32, w32))
    score = tb.pair_cumulant_score(s32, w32).numpy()
    for rank in ranks:
        for got, want in zip(rank[f"moments_{name}"], moments):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rank[f"score_{name}"], score)
        g1, g2 = rank[f"triangle_{name}"]
        for key in ("mean", "sigma", "neff", "bandwidth", "P", "likes"):
            np.testing.assert_array_equal(g1[key], u1[key], err_msg=key)
        for i in range(2):
            np.testing.assert_array_equal(g1["range"][i], u1["range"][i])
        for key in ("rx", "ry", "corr", "P", "contours", "likes"):
            np.testing.assert_array_equal(g2[key], u2[key], err_msg=key)


def test_public_entry_mesh_matches_unsharded(ranks):
    """``fastTriangleDensities(mesh=group)`` against the unsharded entry,
    with tests/test_parallel.py:207-249's features and tolerances: equal
    regrid keys, the served grids within 2e-5; the like grids (the reruns'
    too) within 1e-4."""
    g1, g2, g_regrid, pairs, groups = ranks[0]["entry"]
    mc = MCSamples(device="cpu", **_entry_chain())
    u1, u2, u_pairs = mc.fastTriangleDensities(meanlikes=True)
    assert pairs == u_pairs
    assert sorted(g_regrid) == sorted(u2["regrid"])
    assert [(g["fine"], g["pairs"], g["bandwidths"]) for g in groups] == [
        (g["fine"], g["pairs"], g["bandwidths"]) for g in mc.fast_regrid_groups
    ]
    np.testing.assert_allclose(g1["neff"], u1["neff"].numpy(), rtol=1e-3)
    np.testing.assert_allclose(g1["P"], u1["P"].numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(g1["likes"], u1["likes"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(g2["P"], u2["P"].numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(g2["contours"], u2["contours"].numpy(), rtol=1e-3)
    np.testing.assert_allclose(g2["likes"], u2["likes"].numpy(), rtol=0, atol=1e-4)
    for key, entry in u2["regrid"].items():
        np.testing.assert_allclose(g_regrid[key]["P"], entry["P"].numpy(), rtol=0, atol=2e-5)
        # a rerun bins the like weights at its own grid
        np.testing.assert_allclose(g_regrid[key]["likes"], entry["likes"].numpy(), rtol=0, atol=1e-4)


def test_public_entry_mesh_holds_only_its_block(ranks):
    """With ``mesh=`` each rank uploads only its block of the chain (no
    whole-chain copy, no whole like-weight copy), and the cumulant score
    gating the plan comes from the blocks with its sums all-reduced: within
    1e-4 of the f64 score of the whole chain, as
    ``test_pair_cumulant_score_matches_jax`` holds the unsharded f32 one."""
    state = ranks[0]["entry_state"]
    assert not state["whole_chain"] and not state["whole_like"]
    assert state["block"] == (3000, 4)
    chain = _entry_chain()
    exact = tb.pair_cumulant_score(torch.from_numpy(chain["samples"].astype(np.float32).astype(np.float64)),
                                   torch.from_numpy(chain["weights"]))
    np.testing.assert_allclose(state["cum_score"], exact.numpy(), rtol=1e-4)


def test_dryrun_multirank():
    """The multi-rank dry run on 8 gloo ranks: shapes, flags, and every
    rank's grids equal to rank 0's."""
    out = dryrun_multirank(8)
    assert out["P1"].shape == (4, 1024) and out["P2"].shape == (6, 256, 256)
