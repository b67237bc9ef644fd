#!/usr/bin/env python
"""Time the port's pair-histogram kernels K1, K4 and K5 on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_pair_hist_torch.py

On the fused path's inputs (``bench.make_chain(1_000_000, 30)``, uint8 fine
indices at 256 bins over the 1D stage's ranges, all 435 pairs): checks K1
(``pair_histograms``) and K5 (``pair_histograms_grouped`` on
``group_pairs``) bit-exact against the plain version in both weight modes
(the chain's weights are integers, passed as uint8 as the paths pass them,
as f32, and as f32 without ``integer_weights``), then prints CUDA-event
times (mean of 10 calls after a warm-up, taken in turns) of K1 and K5 in
those modes and with fractional f32 weights, K4 (``pair_histograms_dynamic``,
the slab kernel) on the same rows and pairs, K1 on the same chain at
N = 1,000,003 (misaligned columns), and the ``torch.bincount`` yardstick of
``chip_smoke.py``. Prints the pair-histogram
kernels' ptxas lines of a fresh build.
Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import cuda_ms, hist_bound, library_hist_ms, ptxas_lines  # noqa: E402
from getdist_tpu_torch.ops import _cuda, batched, pair_hist  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
    print(card)
    lib = _cuda.library()
    print(f"build {lib.build_seconds:.1f} s")
    for line in ptxas_lines(lib.log, "pair_hist"):
        print(f"ptxas: {line}")

    samples, weights = make_chain(1_000_000, 30)
    s_dev, w_dev = batched.prepare_chain(samples, weights, "cuda")
    binmin, binmax = batched.all_1d_densities(s_dev, w_dev)["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    p = ix.shape[0]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    # the same chain with 3 more samples: every column but the first starts off a 16-byte boundary
    ix_odd = torch.cat([ix, ix[:, :3]], dim=1).contiguous()
    w_odd = torch.cat([w_dev, w_dev[:3]]).contiguous()
    w_frac = w_dev * 0.37

    # the integer weights as the paths pass them (f32 before the uint8 kernel took uint8 weights)
    w8 = pair_hist.narrow_weights(w_dev) if hasattr(pair_hist, "narrow_weights") else w_dev
    print(f"integer weights passed as {w8.dtype}")
    ref = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    checks = {}
    for name, w, mode in (("uint8", w8, True), ("f32 integer", w_dev, True), ("f32", w_dev, False)):
        checks[f"K1 {name} weights"] = torch.equal(pair_hist.pair_histograms(ix, w, pa, pb, mode), ref)
        checks[f"K5 {name} weights"] = torch.equal(pair_hist.pair_histograms_grouped(ix, w, *plan, int8_weights=mode), ref)
    ref_odd = pair_hist.pair_histograms_plain(ix_odd, w_odd, pa, pb, integer_weights=True)
    checks["K1 N=1000003"] = torch.equal(pair_hist.pair_histograms(ix_odd, w_odd, pa, pb, True), ref_odd)
    del ref, ref_odd
    print(f"bit-exact against the plain version: {json.dumps(checks)}")

    runs = {
        "K1 uint8 weights": lambda: pair_hist.pair_histograms(ix, w8, pa, pb, integer_weights=True),
        "K1 f32 integer weights": lambda: pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=True),
        "K1 f32 weights": lambda: pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=False),
        "K1 f32 fractional weights": lambda: pair_hist.pair_histograms(ix, w_frac, pa, pb, integer_weights=False),
        "K5 uint8 weights": lambda: pair_hist.pair_histograms_grouped(ix, w8, *plan, int8_weights=True),
        "K5 f32 weights": lambda: pair_hist.pair_histograms_grouped(ix, w_dev, *plan, int8_weights=False),
        "K4 (same rows and pairs)": lambda: pair_hist.pair_histograms_dynamic(ix, w_dev, pa, pb, True),
        "K1 f32 integer weights, N=1000003": lambda: pair_hist.pair_histograms(ix_odd, w_odd, pa, pb, True),
    }
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(cuda_ms(runs[name], 10))
    times["library bincount"] = [library_hist_ms(ix, w_dev, pa, pb, 256, 3)]
    bound_ms, bound_by = hist_bound(ix, w8, len(pairs), 256)
    print(f"{card}: ms per call, two turns each: {json.dumps(times)}; bound {bound_ms:.4f} ms ({bound_by})")
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
