"""getdist_tpu_torch.parallel on 4 gloo ranks on the CPU.

The ranks are spawned once for the module: each runs every sharded
function on the same numpy chains and returns its outputs. They are held
against the JAX sharded functions on a 4-device (and, for N_eff, a
3-device) CPU mesh, against the port's unsharded path, and against each
other (every rank's outputs bitwise identical). The rank worker and this
module's top level import no JAX (the JAX imports sit inside the tests),
so the spawned processes never load it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import torch.distributed as dist  # noqa: E402

from getdist_tpu_torch.ops import batched as tb  # noqa: E402
from getdist_tpu_torch.ops import pair_hist as tph  # noqa: E402
from getdist_tpu_torch.parallel import (  # noqa: E402
    shard_samples,
    sharded_all_1d_densities,
    sharded_hist_1d,
    sharded_moments,
    sharded_pair_hists,
    sharded_triangle_densities,
    sharded_triangle_step,
    spawn_ranks,
)

WORLD = 4
RHOS = (0.8, 0.99)
STEP_PAIRS = ([0, 0, 1], [1, 2, 2])
# the triangle chains: one that 4 divides, one that leaves 3 padding samples
TRIANGLE_N = {"even": 4 * 4000, "padded": 4 * 4000 - 3}


def _ar1_chain(n, p, rho=0.8, seed=8):
    """Strongly autocorrelated AR(1) chain (tests/test_parallel.py's)."""
    rng = np.random.RandomState(seed)
    innov = rng.standard_normal((n, p))
    s = np.empty((n, p), np.float64)
    s[0] = innov[0]
    for i in range(1, n):
        s[i] = rho * s[i - 1] + np.sqrt(1 - rho**2) * innov[i]
    s += 0.3 * np.arange(p)
    return s.astype(np.float32)


def _moments_chain():
    """tests/test_parallel.py's chain: 16384 x 4, one 0.45-correlated pair."""
    rng = np.random.RandomState(3)
    samples = rng.standard_normal((16384, 4))
    samples[:, 1] += 0.5 * samples[:, 0]
    return samples, rng.randint(1, 4, 16384).astype(np.float64)


def _hist_ix(samples, nbins=64):
    lo, hi = samples.min(axis=0), samples.max(axis=0)
    return np.clip(((samples - lo) / (hi - lo) * (nbins - 1)).astype(np.int32), 0, nbins - 1).T


def _pair_case():
    """tests/test_parallel.py's K5 case: 5 parameters x 4800 samples."""
    rng = np.random.RandomState(3)
    p, n = 5, 8 * 600
    ix = rng.randint(0, 256, (p, n)).astype(np.int32)
    w = rng.randint(1, 4, n).astype(np.float32)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    return ix, w, pairs


def _neff_case(rho):
    n = 12 * 2048  # 3 and 4 divide it
    s = _ar1_chain(n, 3, rho=rho)
    w = np.random.RandomState(5).randint(1, 4, n).astype(np.float32)
    sigmas = s.std(axis=0).astype(np.float32)
    return np.ascontiguousarray(s.T), w, sigmas, tb._lag_grid(n, max_lag=n // 8)


def _triangle_chain(n):
    return _ar1_chain(n, 4, seed=11), np.random.RandomState(8).randint(1, 4, n).astype(np.float32)


def _block(x, rank, world):
    """This rank's block of the last axis (which ``world`` divides)."""
    n = x.shape[-1] // world
    return torch.from_numpy(np.ascontiguousarray(x[..., rank * n : (rank + 1) * n]))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy()


def _rank_work(group):
    """Every sharded function on this rank's blocks; numpy outputs."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    out = {}
    samples, weights = _moments_chain()
    local_s, local_w = shard_samples(group, samples, weights, device="cpu", dtype=torch.float64)
    out["moments"] = _np(sharded_moments(group, local_s, local_w))
    out["hist_1d"] = _np(sharded_hist_1d(group, _block(_hist_ix(samples), rank, world), local_w, 64))

    ix, w, pairs = _pair_case()
    local_ix, local_pw = _block(ix, rank, world), _block(w, rank, world)
    pa, pb = [a for a, _ in pairs], [b for _, b in pairs]
    for name, kw in (("static", dict(static_pairs=pairs)), ("static_int8", dict(static_pairs=pairs, int8_weights=True)),
                     ("dynamic", {})):
        out[f"pairs_{name}"] = _np(sharded_pair_hists(group, local_ix, local_pw, pa, pb, **kw))

    three = dist.new_group([0, 1, 2])  # every rank takes part in making it
    for rho in RHOS:
        values, nw, sigmas, lags = _neff_case(rho)
        sig = torch.from_numpy(sigmas)
        out[f"neff_{rho}_4"] = _np(tb._neff_kde_batch(_block(values, rank, world), _block(nw, rank, world), sig, lags, group))
        if rank < 3:
            out[f"neff_{rho}_3"] = _np(tb._neff_kde_batch(_block(values, rank, 3), _block(nw, rank, 3), sig, lags, three))

    for name, n in TRIANGLE_N.items():
        s, tw = _triangle_chain(n)
        local = shard_samples(group, s, tw, device="cpu")
        out[f"triangle_{name}"] = _np(sharded_triangle_densities(group, *local, n_samples=n))
    # a padded chain without its length, or with a length its blocks cannot hold
    for case, kw in (("missing", {}), ("wrong", dict(n_samples=n - 4000))):
        try:
            sharded_all_1d_densities(group, *local, **kw)
            out[f"refused_{case}"] = "accepted"
        except ValueError as err:
            out[f"refused_{case}"] = str(err)

    local_s, local_w = shard_samples(group, samples, weights, device="cpu")
    out["step"] = _np(sharded_triangle_step(group, local_s, local_w, *STEP_PAIRS))
    out["shard"] = _np(shard_samples(group, *_triangle_chain(10), device="cpu"))  # the one per-rank output
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
    """Nothing grid-local may come from a rank's own block: every rank's
    outputs equal rank 0's bit for bit."""
    want = {k: v for k, v in _flat(ranks[0]).items() if not k.startswith("shard/")}
    assert len(want) > 50
    for rank, got in enumerate(ranks[1:], start=1):
        got = {k: v for k, v in _flat(got).items() if not k.startswith("shard/")}
        # rank 3 is outside the 3-rank group
        assert set(got) == {k for k in want if rank < 3 or "_3/" not in k}
        for key, value in got.items():
            np.testing.assert_array_equal(value, want[key], err_msg=f"rank {rank}: {key}")


def test_shard_samples_pads_the_last_rank(ranks):
    """10 samples on 4 ranks: blocks of 3, the last one real sample and two
    zero-weight copies of it (C2: the JAX package drops 2 samples)."""
    s, w = _triangle_chain(10)
    blocks = [r["shard"] for r in ranks]
    assert all(b[0].shape == (3, 4) and b[1].shape == (3,) for b in blocks)
    got_s = np.concatenate([b[0] for b in blocks])
    got_w = np.concatenate([b[1] for b in blocks])
    np.testing.assert_array_equal(got_s[:10], s)
    np.testing.assert_array_equal(got_w[:10], w)
    np.testing.assert_array_equal(got_s[10:], s[[-1, -1]])
    np.testing.assert_array_equal(got_w[10:], 0.0)


@pytest.mark.parametrize("case", ["missing", "wrong"])
def test_sharded_1d_refuses_a_missing_or_wrong_chain_length(ranks, case):
    """Without the real length, N_eff would take the padded one and move
    the bandwidths with nothing failing: a sharded call needs ``n_samples``,
    and one that blocks of this length cannot hold raises too."""
    message = ranks[0][f"refused_{case}"]
    assert "n_samples" in message and "blocks of 4000 samples on 4 ranks" in message


def _mesh(n):
    from getdist_tpu.parallel import make_mesh

    return make_mesh(n)


def test_moments_match_jax(ranks):
    from getdist_tpu.parallel import shard_samples as jax_shard
    from getdist_tpu.parallel import sharded_moments as jax_moments

    samples, weights = _moments_chain()
    mesh = _mesh(WORLD)
    norm, means, cov = (np.asarray(x) for x in jax_moments(mesh, *jax_shard(mesh, samples, weights)))
    got = ranks[0]["moments"]
    assert got[0] == norm == weights.sum()
    np.testing.assert_allclose(got[1], means, rtol=1e-12)
    np.testing.assert_allclose(got[2], cov, rtol=1e-12)


def test_hist_1d_matches_jax_exactly(ranks):
    import jax
    import jax.numpy as jnp

    from getdist_tpu.parallel import sharded_hist_1d as jax_hist

    samples, weights = _moments_chain()
    mesh = _mesh(WORLD)
    cols = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "samples"))
    rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("samples"))
    ix = jax.device_put(jnp.asarray(_hist_ix(samples)), cols)
    want = np.asarray(jax_hist(mesh, ix, jax.device_put(jnp.asarray(weights), rows), 64))
    np.testing.assert_array_equal(ranks[0]["hist_1d"], want)


@pytest.mark.parametrize("name", ["static", "static_int8", "dynamic"])
def test_pair_hists_match_jax_exactly(ranks, name):
    """K5 per rank (static pairs) and K4 per rank, all-reduced, against the
    JAX interpret-mode K5 and its XLA route on a 4-device mesh."""
    import jax
    import jax.numpy as jnp

    from getdist_tpu.parallel import sharded_pair_hists as jax_pairs

    ix, w, pairs = _pair_case()
    pa = jnp.asarray(np.array([a for a, _ in pairs], np.int32))
    pb = jnp.asarray(np.array([b for _, b in pairs], np.int32))
    mesh = _mesh(WORLD)
    with jax.enable_x64(False):
        xla = np.asarray(jax_pairs(mesh, jnp.asarray(ix), jnp.asarray(w), pa, pb))
        pallas = np.asarray(jax_pairs(mesh, jnp.asarray(ix), jnp.asarray(w), pa, pb, static_pairs=tuple(pairs), interpret=True))
    np.testing.assert_array_equal(pallas, xla)
    got = ranks[0][f"pairs_{name}"]
    assert got.dtype == np.float32 and got.shape == (len(pairs), 256, 256)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("rho", RHOS)
def test_neff_halo_matches_jax(ranks, rho, world):
    """The halo and far-baseline exchanges against the JAX ppermutes, at an
    even and an odd rank count."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from getdist_tpu.ops.batched import _neff_kde_batch

    values, w, sigmas, lags = _neff_case(rho)

    @partial(shard_map, mesh=_mesh(world), in_specs=(P(None, "samples"), P("samples"), P()), out_specs=P())
    def sharded(cols, weights, sig):
        return _neff_kde_batch(cols, weights, sig, lags, axis_name="samples", axis_size=world)

    with jax.enable_x64(False):
        want = np.asarray(jax.jit(sharded)(jnp.asarray(values), jnp.asarray(w), jnp.asarray(sigmas)))
    np.testing.assert_allclose(ranks[0][f"neff_{rho}_{world}"], want, rtol=1e-3)
    # the real lag estimator: well below the weight proxy on these chains
    assert want.max() < 0.7 * w.sum() ** 2 / (w * w).sum()


def _jax_triangle(n):
    import jax

    from getdist_tpu.parallel.reductions import sharded_triangle_densities as jax_triangle

    s, w = _triangle_chain(n)
    with jax.enable_x64(False):
        d1, d2 = jax_triangle(_mesh(WORLD), s, w)
        return {k: np.asarray(v) for k, v in d1.items() if k != "range"}, {k: np.asarray(v) for k, v in d2.items()}


def test_triangle_densities_match_jax(ranks):
    """At the slice tolerances of tests/test_torch_batched.py."""
    w1, w2 = _jax_triangle(TRIANGLE_N["even"])
    g1, g2 = ranks[0]["triangle_even"]
    np.testing.assert_allclose(g1["neff"], w1["neff"], rtol=1e-4)
    np.testing.assert_allclose(g1["P"], w1["P"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g2["P"], w2["P"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(g2["contours"], w2["contours"], rtol=0.02)


@pytest.mark.parametrize("name", list(TRIANGLE_N))
def test_triangle_densities_match_unsharded_port(ranks, name):
    """At tests/test_parallel.py's tolerances; "padded" leaves the last rank
    3 zero-weight samples (the JAX package would drop 3 real ones)."""
    s, w = _triangle_chain(TRIANGLE_N[name])
    u1, u2 = _np(tb.triangle_densities(s, w, int8_weights=False, enable_shear=True, device="cpu"))
    g1, g2 = ranks[0][f"triangle_{name}"]
    np.testing.assert_allclose(g1["neff"], u1["neff"], rtol=1e-3)
    np.testing.assert_allclose(g1["P"], u1["P"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g2["P"], u2["P"], rtol=0, atol=3e-5)
    np.testing.assert_allclose(g2["contours"], u2["contours"], rtol=1e-3)
    for i in range(2):  # f32 moments summed in another order
        np.testing.assert_allclose(g1["range"][i], u1["range"][i], rtol=1e-5)


def test_triangle_step_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    from getdist_tpu.parallel import shard_samples as jax_shard
    from getdist_tpu.parallel import sharded_triangle_step as jax_step

    samples, weights = _moments_chain()
    mesh = _mesh(WORLD)
    with jax.enable_x64(False):
        dev_s, dev_w = jax_shard(mesh, samples.astype(np.float32), weights.astype(np.float32))
        want = [np.asarray(x) for x in jax_step(mesh, dev_s, dev_w, *(jnp.asarray(p) for p in STEP_PAIRS))]
    got = ranks[0]["step"]
    assert got[0].shape == (4, 128) and got[1].shape == (3, 128, 128)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("p", [5, 11, 30])
def test_group_pairs_match_jax(p):
    from getdist_tpu.ops.pallas_kernels import group_pairs as jax_group_pairs

    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    shuffled = [pairs[k] for k in np.random.default_rng(p).permutation(len(pairs))]
    for case in (pairs, shuffled):
        for got, want in zip(tph.group_pairs(case), jax_group_pairs(case)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    grp_a, grp_b, inv = tph.group_pairs(pairs)
    if p == 30:  # the main path's plan: 68 groups of 8, 109 of the 544 slots padding
        assert grp_a.shape == (68, 8) and grp_a.size - len(pairs) == 109


def test_shard_samples_without_group_is_the_whole_chain():
    s, w = _triangle_chain(10)
    whole, whole_w = shard_samples(None, s, w, device="cpu")
    assert torch.equal(whole, torch.from_numpy(s)) and torch.equal(whole_w, torch.from_numpy(w))
