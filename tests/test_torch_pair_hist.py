"""getdist_tpu_torch pair histograms (kernel K1) against the JAX package.

The port's plain version must equal the TPU tiled kernel (run in interpret
mode) bit for bit: integer weights, and float weights that bf16 holds
exactly (the TPU kernel rounds weights to bf16). The CUDA kernel itself
is held against the plain version by tests/test_torch_cuda.py and by
chip_smoke.py on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from getdist_tpu.ops.batched import _pair_hist_256  # noqa: E402
from getdist_tpu.ops.pallas_kernels import pair_histograms_tiled, tile_plan  # noqa: E402
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

