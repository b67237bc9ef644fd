"""getdist_tpu_torch pair histograms (kernels K1 and K5, and the wide
kernels past 256 bins) against the JAX package.

The port's plain versions must equal the TPU tiled and grouped kernels
(run in interpret mode) and, past 256 bins, the XLA one-hot binning bit for
bit: integer weights, and float weights that bf16 holds exactly (the TPU
kernels round weights to bf16). The CUDA kernels themselves are held
against the plain version by tests/test_torch_cuda.py and by chip_smoke.py
on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops.batched import _pair_hist_256  # noqa: E402
from getdist_tpu.ops.pallas_kernels import group_pairs, pair_histograms_grouped, pair_histograms_tiled, tile_plan  # noqa: E402
from getdist_tpu_torch.ops import pair_hist  # noqa: E402


def _indices(p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, n))
    return np.clip(x * 40 + 128, 0, 255).astype(np.uint8)


def _all_pairs(p):
    return np.array([(i, j) for i in range(p) for j in range(i + 1, p)], np.int32)


def _port(ix, w, pairs, integer_weights):
    return pair_hist.pair_histograms(
        torch.from_numpy(ix),
        torch.from_numpy(w),
        torch.from_numpy(pairs[:, 0].copy()),
        torch.from_numpy(pairs[:, 1].copy()),
        integer_weights=integer_weights,
    ).numpy()


@pytest.mark.parametrize("int8_weights", [True, False], ids=["int8", "bf16-exact-float"])
def test_plain_matches_tiled_tpu_kernel(int8_weights):
    """P = 7 with groups of 4: one off-diagonal and two diagonal tiles."""
    p, n = 7, 16384
    rng = np.random.default_rng(1)
    ix = _indices(p, n, seed=0)
    if int8_weights:
        w = rng.integers(1, 5, n).astype(np.float32)
    else:
        w = (rng.integers(1, 64, n) / 16.0).astype(np.float32)  # bf16-representable, non-integer
    pairs = _all_pairs(p)
    _, _, _, gather = tile_plan(p, [tuple(pr) for pr in pairs], group=4)
    with jax.enable_x64(False):
        want = np.asarray(
            pair_histograms_tiled(
                jnp.asarray(ix),
                jnp.asarray(w),
                p,
                tuple(int(g) for g in gather),
                group=4,
                n_chunks=1,
                int8_weights=int8_weights,
                interpret=True,
            )
        )
    got = _port(ix, w, pairs, int8_weights)
    assert got.dtype == np.float32 and got.shape == (len(pairs), 256, 256)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("int8_weights", [True, False], ids=["int8", "bf16-exact-float"])
def test_grouped_plain_matches_grouped_tpu_kernel(int8_weights):
    """K5 on 11 parameters in groups of 8: b = 9 and b = 10 end in short
    groups, whose a = b padding slots must not reach the output."""
    p, n = 11, 1024
    rng = np.random.default_rng(6)
    ix = _indices(p, n, seed=5)
    if int8_weights:
        w = rng.integers(1, 5, n).astype(np.float32)
    else:
        w = (rng.integers(1, 64, n) / 16.0).astype(np.float32)
    pairs = [tuple(int(x) for x in pr) for pr in _all_pairs(p)]
    plan = group_pairs(pairs)
    with jax.enable_x64(False):
        want = np.asarray(
            pair_histograms_grouped(
                jnp.asarray(ix), jnp.asarray(w), *(jnp.asarray(x) for x in plan), block=512,
                interpret=True, int8_weights=int8_weights,
            )
        )
    got = pair_hist.pair_histograms_grouped(
        torch.from_numpy(ix), torch.from_numpy(w), *(torch.from_numpy(x) for x in pair_hist.group_pairs(pairs)),
        int8_weights=int8_weights,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (len(pairs), 256, 256)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port(ix, w, _all_pairs(p), int8_weights))


def test_plain_matches_onehot_on_ragged_n():
    """No padding: a sample count that is no multiple of any block."""
    p, n = 4, 10007
    ix = _indices(p, n, seed=2)
    w = np.random.default_rng(3).integers(1, 4, n).astype(np.float32)
    pairs = np.array([(0, 1), (2, 3), (1, 3)], np.int32)
    with jax.enable_x64(False):
        want = np.stack(
            [
                np.asarray(_pair_hist_256(jnp.asarray(ix[a], jnp.int32), jnp.asarray(ix[b], jnp.int32), jnp.asarray(w)))
                for a, b in pairs
            ]
        )
    np.testing.assert_array_equal(_port(ix, w, pairs, True), want)
    np.testing.assert_array_equal(_port(ix, w, pairs, False), want)


@pytest.mark.parametrize("nbins", [384, 576, 960])
def test_plain_matches_onehot_at_wide_grids(nbins):
    """The wide kernels' oracle at the regrid reruns' fine grids, on int16
    rows, against the JAX package's XLA one-hot binning past 256 bins
    (``_pair_hist_256(..., nbins=fine)``): bit-exact with integer weights,
    N ragged against its block, and indices outside [0, nbins), which both
    drop (``jax.nn.one_hot`` gives such an index an all-zero row)."""
    p, n = 3, 2003
    rng = np.random.default_rng(nbins)
    ix = np.clip(rng.standard_normal((p, n)) * nbins / 6 + nbins / 2, 0, nbins - 1).astype(np.int16)
    ix[0, :7] = -3
    ix[1, 7:12] = nbins + 5
    ix[2, 12:14] = nbins
    w = rng.integers(1, 5, n).astype(np.float32)
    pairs = np.array([(0, 1), (1, 2), (0, 2)], np.int32)
    with jax.enable_x64(False):
        want = np.stack([
            np.asarray(_pair_hist_256(jnp.asarray(ix[a], jnp.int32), jnp.asarray(ix[b], jnp.int32), jnp.asarray(w),
                                      block=512, nbins=nbins))
            for a, b in pairs
        ])
    got = pair_hist.pair_histograms_plain(
        torch.from_numpy(ix), torch.from_numpy(w), torch.from_numpy(pairs[:, 0].copy()),
        torch.from_numpy(pairs[:, 1].copy()), integer_weights=True, nbins=nbins,
    ).numpy()
    assert got.shape == (3, nbins, nbins) and got.sum() < 3 * w.sum()  # dropped indices
    np.testing.assert_array_equal(got, want)


def test_rows_are_b_and_columns_are_a():
    ix = np.array([[3, 3], [7, 200]], np.uint8)
    w = np.array([2.0, 5.0], np.float32)
    got = _port(ix, w, np.array([(0, 1)], np.int32), True)[0]
    assert got[7, 3] == 2.0 and got[200, 3] == 5.0 and got.sum() == 7.0


def test_wrapper_refuses_non_cuda_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises, never falls back."""
    ix = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    pa = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pair_hist.pair_histograms(ix, torch.ones(8, device="meta"), pa, pa)


@pytest.mark.parametrize("group", [5, 16])
def test_grouped_wrapper_refuses_other_group_widths(group):
    """K5 is built for groups of 8 pairs; another width raises on the CPU
    too, so both devices accept the same plans."""
    ix = torch.from_numpy(_indices(6, 64, seed=4))
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    plan = [torch.from_numpy(x) for x in pair_hist.group_pairs(pairs, group=group)]
    with pytest.raises(ValueError, match="groups of 8"):
        pair_hist.pair_histograms_grouped(ix, torch.ones(64), *plan)


def test_grouped_wrapper_refuses_non_cuda_devices():
    ix = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    grp = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pair_hist.pair_histograms_grouped(ix, torch.ones(8, device="meta"), grp, one, one)


@pytest.mark.parametrize(
    "k,n,sms,want",
    [
        (435, 1_000_000, 132, 1),  # the paths' 435 pairs: 870 blocks, each owns and writes half a histogram
        (66, 1_000_000, 132, 1),  # exactly one wave
        (15, 200_003, 132, 3),  # few pairs: samples split, at least SPLIT_MIN_SAMPLES a chunk
        (36, 200_008, 132, 2),  # enough chunks to fill the card, no more
        (15, 20_000, 132, 1),  # too few samples to split
        (1, 10**8, 132, 66),
    ],
)
def test_split_plan(k, n, sms, want):
    assert pair_hist.split_plan(k, n, sms) == want


@pytest.mark.parametrize(
    "k,n,sms,want",
    [
        (435, 1_000_000, 132, 1),  # fixed-point bins: four blocks a pair, each a quarter of its rows
        (33, 1_000_000, 132, 1),  # exactly one wave
        (66, 1_000_000, 132, 1),  # one chunk a pair where int32 bins also need one
        (15, 200_003, 132, 3),  # 60 blocks a chunk: three chunks
        (20, 1_000_000, 132, 2),  # 80 blocks a chunk: two fill the card
        (1, 10**8, 132, 33),
    ],
)
def test_split_plan_fixed_point(k, n, sms, want):
    assert pair_hist.split_plan(k, n, sms, parts=4) == want


@pytest.mark.parametrize(
    "k,n,nbins,sms,want",
    [
        # the hard chain's 0.99 pair: few pair samples, the direct route
        (1, 1_000_000, 960, 132, ("direct", 60, 16, 245, 15152)),
        # the degenerate chain's fine groups: the bucket route, about 12
        # slabs (16 where a 960-bin slab's tile would not fit), two bin
        # blocks' worth of entries a multiprocessor
        (10, 1_000_000, 960, 132, ("bucket", 60, 16, 53, 151516)),
        (10, 1_000_000, 576, 132, ("bucket", 48, 12, 53, 151516)),
        (6, 1_000_000, 384, 132, ("bucket", 32, 12, 88, 90910)),
        (26, 1_000_000, 960, 132, ("bucket", 60, 16, 21, 393940)),
        (2, 1_000_000, 1024, 132, ("direct", 56, 19, 245, 30304)),
        (3, 1_000_000, 257, 132, ("bucket", 22, 12, 176, 45456)),
        # wide rows at 256 bins (indices outside the grid)
        (9, 200_003, 256, 132, ("direct", 22, 12, 49, 27274)),
        (1, 1_000, 960, 132, ("direct", 60, 16, 1, 8192)),
    ],
)
def test_wide_plan(k, n, nbins, sms, want):
    plan = pair_hist.wide_plan(k, n, nbins, sms)
    assert (plan.route, plan.rows, plan.slabs, plan.chunks, plan.part) == want
    assert plan.rows * nbins <= pair_hist.TILE_WORDS and plan.slabs * plan.rows >= nbins > (plan.slabs - 1) * plan.rows
    # a slab of more than `part` entries takes an accumulator slot
    assert plan.split_slots == min(k * plan.slabs, k * n // plan.part)
    assert (plan.route == "direct") == (k * n <= pair_hist.DIRECT_MAX_SAMPLES)


@pytest.mark.parametrize("p,seed", [(11, None), (30, None), (9, 3)])
def test_grouped_work_list_matches_jax_group_pairs(p, seed):
    """K5's work list, built from the JAX package's plan (group_pairs /
    inv_perm) of the same pairs, is the pair list itself, in order; the
    a = b padding slots never enter it. The port's plan equals JAX's."""
    pairs = [(int(a), int(b)) for a, b in _all_pairs(p)]
    if seed is not None:  # an arbitrary pair list: repeated b rows, any order
        rng = np.random.default_rng(seed)
        pairs = [pairs[i] for i in rng.permutation(len(pairs))][: len(pairs) // 2]
    want = group_pairs(pairs)
    for got, ref in zip(pair_hist.group_pairs(pairs), want):
        np.testing.assert_array_equal(got, ref)
    grp_a, grp_b, inv = (torch.from_numpy(np.asarray(x, np.int32)) for x in want)
    assert int((grp_a == grp_b[:, None]).sum()) > 0  # the plan pads
    pa, pb = pair_hist.grouped_work_list(grp_a, grp_b, inv)
    assert pa.dtype == torch.int32 and list(zip(pa.tolist(), pb.tolist())) == pairs
    assert not bool((pa == pb).any())


def test_plain_takes_uint8_weights():
    ix = _indices(3, 5000, seed=8)
    w = np.random.default_rng(9).integers(0, 256, 5000).astype(np.float32)
    pairs = _all_pairs(3)
    want = _port(ix, w, pairs, True)
    got = pair_hist.pair_histograms_plain(
        torch.from_numpy(ix), torch.from_numpy(w).to(torch.uint8), torch.from_numpy(pairs[:, 0].copy()),
        torch.from_numpy(pairs[:, 1].copy()), integer_weights=True,
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "values,narrowed",
    [
        ([1.0, 4.0, 3.0], True),
        ([0.0, 255.0], True),
        ([-0.4, 255.4], True),  # rounds into [0, 255], as the kernel rounds
        ([0.0, 255.5], False),  # rounds to 256
        ([-0.6, 3.0], False),
        ([1.0, 300.0], False),
    ],
)
def test_narrow_weights(values, narrowed):
    """Integer weights go to the uint8 kernel as uint8 where every rounded
    value fits, with the values the kernel would take from f32."""
    w = torch.tensor(values, dtype=torch.float32)
    got = pair_hist.narrow_weights(w)
    assert (got.dtype == torch.uint8) == narrowed
    if narrowed:
        np.testing.assert_array_equal(got.numpy(), np.round(np.asarray(values, np.float32)))
    else:
        assert got is w


def _f64_bincount(ix, w, pairs, nbins):
    """Per pair, the f64 sums of the weights by (b, a) bin."""
    ix = ix.astype(np.int64)
    return np.stack([
        np.bincount(ix[b] * nbins + ix[a], weights=w.astype(np.float64), minlength=nbins * nbins).reshape(nbins, nbins)
        for a, b in pairs
    ])


@pytest.mark.parametrize("weights", ["fractional", "negative", "many-decades"])
@pytest.mark.parametrize("nbins", [256, 384])
def test_fixed_point_plain_within_one_f32_rounding(weights, nbins):
    """The plain version adds fractional weights in the kernels' 64-bit
    fixed point: each bin within one f32 rounding (half an ulp of the f32
    of the exact sum, after its rounding to f64: 2^-53 of it) of the f64
    ``bincount``, plus the weights' own
    rounding (half a multiple of 2^-62 of max |w| * N each, at most 2^-62 *
    max |w| * N a sample in the bin); uint8 and int16 rows alike."""
    p, n = 4, 20_011
    rng = np.random.default_rng(nbins + len(weights))
    ix = np.clip(rng.standard_normal((p, n)) * nbins / 6 + nbins / 2, 0, nbins - 1)
    ix = ix.astype(np.uint8 if nbins <= 256 else np.int16)
    w = {
        "fractional": rng.random(n),
        "negative": rng.normal(0.5, 1.0, n),
        "many-decades": np.exp(-0.5 * rng.uniform(0, 140, n)),
    }[weights].astype(np.float32)
    pairs = _all_pairs(p)
    got = pair_hist.pair_histograms_plain(
        torch.from_numpy(ix), torch.from_numpy(w), torch.from_numpy(pairs[:, 0].copy()),
        torch.from_numpy(pairs[:, 1].copy()), nbins=nbins,
    ).numpy()
    exact = _f64_bincount(ix, w, pairs, nbins)
    counts = _f64_bincount(ix, np.ones(n), pairs, nbins)
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    floor = 2.0**-53 * np.abs(exact) + counts * 2.0**-62 * float(np.abs(w).max()) * n
    assert np.all(np.abs(got - exact) <= 0.5 * ulp + floor)
    assert np.all(got[exact == 0] == 0)


def test_fixed_to_f32_twin_is_one_rounding():
    """The conversion of int64 fixed-point sums: the sum rounded to f64,
    scaled by 2^(e - 62), rounded to f32 once (numpy's own roundings)."""
    rng = np.random.default_rng(5)
    acc = rng.integers(-(2**62), 2**62, 4096, dtype=np.int64)
    wmax, count = np.float32(3.7), 123_457
    scale = (torch.tensor(wmax), count)
    got = pair_hist.fixed_to_f32(torch.from_numpy(acc), scale).numpy()
    _, e = np.frexp(np.float64(wmax) * count)
    np.testing.assert_array_equal(got, (acc.astype(np.float64) * 2.0 ** (int(e) - 62)).astype(np.float32))
    s, inv = pair_hist.fixed_scale(scale)
    assert float(s) == 2.0 ** (62 - int(e)) and float(inv) * float(s) == 1.0


@pytest.mark.parametrize("nbins,index_dtype", [(256, np.uint8), (960, np.int16)])
def test_raw_block_sums_equal_one_call(nbins, index_dtype):
    """Four blocks of a chain, each binned raw on the whole chain's scale
    (:func:`group_scale`), summed as int64 and converted once, give the
    bits of one call on the whole chain: what W ranks all-reduce."""
    p, n = 4, 12_007
    rng = np.random.default_rng(nbins)
    ix = np.clip(rng.standard_normal((p, n)) * nbins / 6 + nbins / 2, 0, nbins - 1).astype(index_dtype)
    w = np.exp(-0.5 * rng.uniform(0, 60, n)).astype(np.float32)
    pairs = _all_pairs(p)
    pa, pb = torch.from_numpy(pairs[:, 0].copy()), torch.from_numpy(pairs[:, 1].copy())
    ix_t, w_t = torch.from_numpy(ix), torch.from_numpy(w)
    whole = pair_hist.pair_histograms(ix_t, w_t, pa, pb, nbins=nbins)
    scale = pair_hist.group_scale(w_t, n)
    total = sum(
        pair_hist.pair_histograms(ix_t[:, s].contiguous(), w_t[s].contiguous(), pa, pb, nbins=nbins, scale=scale,
                                  raw=True)
        for s in np.array_split(np.arange(n), 4)
    )
    assert total.dtype == torch.int64
    np.testing.assert_array_equal(pair_hist.fixed_to_f32(total, scale).numpy(), whole.numpy())
    with pytest.raises(ValueError, match="fractional"):
        pair_hist.pair_histograms(ix_t, w_t, pa, pb, integer_weights=True, nbins=nbins, raw=True)


def _timing_script():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "time_pair_hist_torch.py"
    spec = importlib.util.spec_from_file_location("time_pair_hist_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("variant", ["no adds", "low words only", "no skip"])
def test_fixed_timing_variants_find_their_targets(variant):
    """``scripts/time_pair_hist_torch.py --fixed`` times scratch copies of
    ``csrc/pair_hist.cu`` with the fixed-point adds (or the row skip)
    replaced: every replacement finds its text in the source and changes
    it, and the integer route's adds are left as they are."""
    script = _timing_script()
    source = (pair_hist._cuda.CSRC / "pair_hist.cu").read_text()
    changed = script._variant_source(source, variant)
    assert changed is not None and changed != source
    for old, _ in script.NEW_VARIANTS[variant]:
        assert old in source and old not in changed
    assert script._OLD_ADD in changed  # the int32 bins' add
    assert script._variant_source(source, "reads only") is None  # an older tree's variants only
