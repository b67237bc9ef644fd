#!/usr/bin/env python
"""Smoke run of the PyTorch + CUDA port (getdist_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases: require CUDA and print the card's name and power limit; build the
CUDA kernels from ``getdist_tpu_torch/csrc``. Then three paths on
``bench.make_chain(1_000_000, 30)`` (30 1D and 435 2D densities):

1. the fused path, ``triangle_densities``: count each kernel's launches in
   one run, time warm runs, profile one run (the top of the kernel-time
   table is printed), check its outputs, hold K1/K2/K3 against their plain
   PyTorch versions on its own inputs (timing both; f32 K2/K3 within 1e-5
   of the largest value at this production frame, two calls bitwise
   equal, both against an f64 chain; each beside the library call and its
   bytes and operations bounds), and compare the path on the card with the
   port on the CPU at 100k x 8;
2. device parity mode, ``MCSamples(...).fastParityDensities(device=True)``:
   one cold and one warm run (stage profile, peak memory, launch counts of
   one run), checks of its outputs, bin indices of all 30 columns against
   numpy's formula, K4 on this run's sheared stack (timed with the path's
   uint8 weights and with f32 weights) and f64 K2/K3 on its largest bucket
   against their plain versions (two calls bitwise equal),
   and parity on the card
   against the port on the CPU at 20k x 6 (a bounded parameter and a
   pair with |corr| > 0.87);
3. the sharded path (``getdist_tpu_torch.parallel``) in a one-rank NCCL
   group: ``sharded_triangle_densities`` (first call, warm runs, peak
   memory and launch counts of one run, beside ``triangle_densities`` on
   the same device tensors, and agreement with it), then
   ``sharded_pair_hists`` over all 435 pairs through K5 (both weight
   modes, bit-exact against K1 and the plain version; the f32-weight call
   bins raw 64-bit fixed-point sums on the group's scale, a row of its
   own) and without a pair plan through K4; then 4 gloo ranks on the CPU run the sharded path on
   a 40k x 6 chain and on a 40k x 6 bounded chain with like weights, held
   against the one-rank run on the card (the only run where the N_eff halo
   exchange and the card meet); last, on the 1M x 30 bounded chain (phase
   6's), ``sharded_triangle_densities`` with its limits, periodic axes and
   like weights beside ``triangle_densities`` on the same tensors (walls
   in turns, launches, outputs, agreement), the rows of its like
   histograms' group route (K1 binning raw sums on the group's scale, and
   ``fixed_to_f32``, the one conversion of the all-reduced sums: together
   one card's bits), and the public entry with ``mesh=group`` and
   meanlikes against the unsharded entry;
4. the public fused entry, ``MCSamples(...).fastTriangleDensities()``: on
   the bench chain (single dispatch: cold and warm walls, launches, the
   device idle share and stage split under the profiler, outputs held
   against ``triangle_densities``, bitwise where the shear subsets
   agree), then on a 1M x 8 hard chain (``hard_chain``: two programs, a
   960-bin regrid through K1's wide kernels, a sheared f64 assist), with
   the wide kernels and f32 K2/K3 at the run's larger DFT frames held
   against their plain versions, and the entry on the card against the
   port on the CPU at 100k x 8;
5. the wide kernels on a 1M x 14 degenerate chain (``degenerate_chain``:
   26 pairs binned past 256 bins, in fine groups of 960, 576 and 384
   bins): the public entry (cold and warm walls) and parity mode (one
   call), each with its wide-kernel launches, and a kernel row per fine
   group of each path (its rows, pairs and weights), bit-exact against
   the plain version, beside ``torch.bincount`` and the bound; then the
   entry on the same chain with importance weights, whose regrids bin
   fractional weights past 256 bins in 64-bit fixed point (a row at its
   widest fine group: bit-exact against the plain version, two calls
   bitwise equal, within one f32 rounding of the f64 sums);
6. hard limits, periodic axes and meanlikes on a 1M x 30 bounded chain
   (``bounded_chain``: lower, upper, two-sided and periodic columns,
   loglikes): the public entry cold and warm with meanlikes off and on
   (launches per kernel, the idle share and stage split of one profiled
   call, checks of its outputs: limits on the grid edges, wrap lines, like
   grids in [0, 1]), ``triangle_densities`` with the same arguments, K1
   with the f32 like weights (fixed point, bit-exact against the plain
   version, and against the f64 sums: each bin within 1e-6 of itself plus
   1e-9 of its pair's peak, the low tails within 1e-7 of their sum; two
   calls bitwise equal), K3 on the
   316-wide periodically extended grids and
   edge masks, and K2 and K3 at the clamped rescue's 768 frame (its
   kernels, 256-bin grids and 508-wide edge masks), each against its plain
   version, and the entry on the card against the port on the CPU at
   100k x 10;
7. parity mode on the bounded chain: device parity, one call (stage
   profile, buckets, launches per kernel; every bucket's f64 K3 on its
   periodically extended grids), f64 K3 on the largest bucket's extended
   grids against its plain version (within 1e-12 of the largest value,
   two calls bitwise equal, beside cuDNN's f64 conv2d and the bound); the
   same chain with fractional importance weights (``importance_weights``):
   device parity routed to the host variant and the host variant called
   directly (walls, stages, equal results); parity on the card against
   the port on the CPU at 20k x 6 with a periodic and a limited column
   (device parity, and the host variant on importance weights);
8. chain files: the bounded chain written as a 4-chain root (``root_1.txt``
   ... ``root_4.txt`` of 250k rows, ``.paramnames``, ``.ranges`` with ``N``
   bounds and periodic flags) in a temporary directory, deleted after;
   each file parsed by the port's native loader bitwise equal to
   ``np.loadtxt``; ``loadMCSamples`` cold and from its pickle cache (walls);
   ``fastTriangleDensities(meanlikes=True)`` on the loaded object cold and
   warm (walls, K1/K2/K3 launches), bitwise equal to the entry on the same
   arrays in memory and to the entry on the cache hit;
9. the host ``MCSamples`` analysis API on phase 8's root (``host_api_phase``):
   routed onto the card (the default on a CUDA object), ``getMargeStats()``
   cold and warm as one fused program launching K1, K2 and K3, then
   ``getLikeStats()``, ``getConvergeTests()`` (all six tests),
   ``getTable().tableTex()`` and ``getInlineLatex`` (walls); the same calls
   on the host path (``GETDIST_TPU_TORCH_FUSED=0``), held against the routed
   ones (means and sds bitwise, limit tags, limits within 0.02 sd,
   ``.likestats`` and ``.converge`` byte-identical, the 1D densities within
   6e-3 of the peak but at a one-sided limit (printed, ROADMAP C14) and 2D
   densities within 1.5e-2; a limited x periodic pair's difference
   printed), and routed meanlikes 2D queries (K1 with
   like weights) on a pair of the program and a rerun pair, their like
   grids within 1.5e-2 of the host's, none served by the host;
10. the batch command (``cli_phase``) on phase 8's root, on the card, into a
   temporary ``out_dir`` (PCA of 4 parameters, ``thin_factor`` 10, plot
   scripts written): cold with the default host statistics (the wall from
   root to every output, its stages, ``getConvergeTests``, K1/K2/K3
   launches, each non-zero) and again with
   ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` (both convergence-battery walls;
   ``.converge``, ``.covmat`` and ``.PCA`` within 1e-10 relative of the
   default run's, differing lines printed); then a 3-parameter N-D
   density through the card's ``weighted_bincount``, bitwise equal to the
   host's;
11. the plotter's data layer (``plot_data_phase``) on phase 8's root,
   with no matplotlib and no yaml: the root loaded through
   ``sample_analysis.MCSampleAnalysis`` as a grid job item (cold, then
   cached) and as a loose root (cached), each bitwise phase 8's samples;
   the requests ``GetDistPlotter.triangle_plot`` makes for all 30
   parameters (30 ``get_density``, 435 ``get_density_grid``) cold, warm
   and repeated (walls; K1, K2 and K3 launched by one fused program cold,
   none on the analyser's cache), every grid bitwise equal to the routed
   analysis API's on a separately loaded object, ten pairs within 1.5e-2
   of the host path's peak (a limited x periodic and a periodic x periodic
   pair's differences and the one-sided 1D departures printed: the JAX
   method's, ROADMAP C11, C18, C14), the ``shade_meanlikes`` gather of 20
   pairs (K1 with like weights, none served by the host, like grids within
   1.5e-2 of the host's but the reruns with a two-sided parameter, C18),
   and the gather beside the host path's per-pair time x 435;
12. interop and the GUI session (``interop_gui_phase``) on phase 8's root
   and chain, with no matplotlib: the chain as four Cobaya
   collections (numpy-backed, with the ``minuslogprior`` / ``chi2``
   columns) and its priors as a Cobaya info dict through
   ``MCSamplesFromCobaya(..., device="cuda")``, whose samples, weights,
   loglikes and ranges of the 30 parameters and whose
   ``fastTriangleDensities`` equal phase 8's loaded object's bit for bit;
   the chain as a duck-typed ArviZ InferenceData (posterior arrays (4,
   250k), weights and log-likelihood variables) through
   ``arviz_to_mcsamples(..., device="cuda")``, equal bit for bit to an
   ``MCSamples`` built from the same arrays, with the same routed
   ``getMargeStats`` text; and ``GuiSession(device="cuda")`` on phase 8's
   directory: the 30-parameter triangle's 465 densities through the
   session's data layer cold and warm, bitwise phase 11's, and its
   marginalized, likelihood and parameter-table texts equal to the
   analysis API's on an object loaded with the session's settings; all
   that with no yaml imported; then the chain written as a Cobaya root
   (``run.updated.yaml`` and ``run.1.txt`` ... ``run.4.txt``, written by
   four processes while the parts above run) and loaded by
   ``loadMCSamples`` (PyYAML), bitwise phase 8's object (K1/K2/K3
   launches and walls of each part, and the phase's wall).

K1, K4, K5 and the wide kernels are timed with the weights their paths
pass (integer weights as uint8, ``pair_hist.narrow_weights``), each beside
one ``torch.bincount`` over flat pair keys, the yardstick no path calls.
The build's ptxas lines of the uint8 pair-histogram kernel (K1, K4 and K5)
and of the wide kernels are printed.

Prints one JSON line of kernel results (with each kernel's bound on the
card and, where one exists, a single PyTorch call's time), the card line
again, then ``{"ok": true, "device": {...}}`` as the last line. Any
failure exits non-zero without the ok line. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FP32
# outside the tensor cores; f32-accurate products on the tensor cores as
# three TF32 passes (495 / 3); FP64 on the tensor cores (DMMA; 34 TFLOP/s
# outside)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
FP64_FLOPS = 67e12


def hard_chain(n, seed=23):
    """A chain that takes every rescue of the public fused entry: four
    columns of ``bench.make_chain(n, 4, seed)`` (its integer weights), a
    pair correlated at 0.99 (corr-adaptive fine grid of 960 bins), and a
    non-Gaussian correlated pair drawn like the zoo's "hammer" (two
    Gaussians, |corr| ~0.66: the sheared f64 host assist). Made with numpy
    from ``seed``; (samples (n, 8), weights (n,))."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from bench import make_chain

    base, weights = make_chain(n, 4, seed=seed)
    rng = np.random.RandomState(seed + 1)
    z = rng.standard_normal(n)
    tight = np.column_stack([z, 0.99 * z + np.sqrt(1 - 0.99**2) * rng.standard_normal(n)])
    comp = rng.rand(n) < 0.5
    hammer = np.empty((n, 2))
    for pick, mean, (sx, sy, c) in ((comp, (0.0, 0.0), (np.sqrt(0.5), 1.0, 0.9)),
                                    (~comp, (1.0, 1.8), (0.3, 1.0, -0.7))):
        cov = [[sx * sx, c * sx * sy], [c * sx * sy, sy * sy]]
        hammer[pick] = rng.multivariate_normal(mean, cov, int(pick.sum()))
    return np.column_stack([base, tight, hammer]), weights


# the degenerate chain's blocks: (columns, pair correlation c^2), each
# column c z + sqrt(1 - c^2) e on its block's own latent z
DEGENERATE_BLOCKS = ((5, 0.995), (5, 0.95), (4, 0.90))


def degenerate_chain(n, seed=29):
    """A chain of near-degenerate parameter blocks, as the H0 / Omega_m /
    sigma_8 / age / theta blocks of a cosmology chain: 14 columns in three
    blocks (``DEGENERATE_BLOCKS``: pair correlations 0.995, clipped to
    max_corr_2D = 0.99, 0.95 and 0.90, whose corr-adaptive fine grids are
    960, 576 and 384 bins), uncorrelated across blocks (those 65 pairs stay
    at 256 bins), with the integer weights (1..4) of ``bench.make_chain(n,
    1, seed)``. Unbounded. Made with numpy from ``seed``; (samples (n, 14),
    weights (n,))."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from bench import make_chain

    _, weights = make_chain(n, 1, seed=seed)
    rng = np.random.RandomState(seed + 1)
    cols = []
    for size, c2 in DEGENERATE_BLOCKS:
        z = rng.standard_normal(n)
        cols += [np.sqrt(c2) * z + np.sqrt(1 - c2) * rng.standard_normal(n) for _ in range(size)]
    return np.column_stack(cols), weights


# the bounded chain's columns by kind: (lower limit at 0, upper limit at 1,
# two-sided flat prior on [-1, 1.5], periodic on [0, 2 pi)); the rest of
# the columns stay unbounded
BOUNDED_KINDS = (4, 2, 2, 2)


def bounded_chain(n, p=30, seed=31, kinds=BOUNDED_KINDS):
    """A cosmology-like chain with hard priors: the columns of
    ``bench.make_chain(n, p, seed)`` (its integer weights), standardized to
    z, then by kind (``kinds``: counts of each kind, first columns first):
    |z| (half-normal, lower limit 0, as tau or mnu), 1 - |z| / 2 (upper
    limit 1), z reflected into the flat prior [-1, 1.5], and 1.5 z + pi
    wrapped into the periodic [0, 2 pi) (an angle); the rest unbounded.
    loglikes = 0.5 sum z^2. Made with numpy from ``seed``; returns
    (samples (n, p), weights (n,), loglikes (n,), names, ranges)."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from bench import make_chain

    x, weights = make_chain(n, p, seed=seed)
    z = (x - x.mean(0)) / x.std(0)
    names = [f"b{i}" for i in range(p)]
    samples = x.copy()
    ranges = {}
    col = 0
    for kind, count in enumerate(kinds):
        for _ in range(count):
            v = z[:, col]
            if kind == 0:
                samples[:, col], ranges[names[col]] = np.abs(v), [0.0, None]
            elif kind == 1:
                samples[:, col], ranges[names[col]] = 1 - 0.5 * np.abs(v), [None, 1.0]
            elif kind == 2:
                lo, span = -1.0, 2.5
                y = np.mod(v - lo, 2 * span)
                samples[:, col], ranges[names[col]] = lo + np.where(y > span, 2 * span - y, y), [lo, lo + span]
            else:
                samples[:, col], ranges[names[col]] = np.mod(1.5 * v + np.pi, 2 * np.pi), [0.0, 2 * np.pi, True]
            col += 1
    return samples, weights, 0.5 * np.sum(z * z, axis=1), names, ranges


def limit_arrays(names, ranges):
    """(limits_lo, limits_hi, periodic) of a ranges dict: (P,) f32 bounds
    (NaN: none) and bools."""
    import numpy as np

    lo = np.array([ranges.get(n, [None, None])[0] for n in names], dtype=float).astype(np.float32)
    hi = np.array([ranges.get(n, [None, None])[1] for n in names], dtype=float).astype(np.float32)
    return lo, hi, np.array([len(ranges.get(n, ())) == 3 for n in names])


def like_weights_of(weights, loglikes):
    """The mean-likelihood grids' per-sample f32 weights w exp(<-log L> -
    (-log L)), as ``MCSamples`` makes them."""
    import numpy as np

    return (weights * np.exp(np.sum(weights * loglikes) / np.sum(weights) - loglikes)).astype(np.float32)


def importance_weights(weights, seed):
    """Fractional weights of an importance-reweighted chain: each weight
    times exp(-chi2 / 2) of a chi2(1) draw from ``seed``, so in (0, w]."""
    import numpy as np

    return weights * np.exp(-0.5 * np.random.RandomState(seed).chisquare(1, len(weights)))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bound_terms(nbytes, ops, rate):
    """(bytes ms, operations ms): bytes over the HBM rate, operations over
    the peak rate for their type."""
    return nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of the two bound_terms."""
    t_bytes, t_ops = bound_terms(nbytes, ops, rate)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_bound(ix, weights, k, nbins):
    """K1/K4/K5: index rows and weights read once, f32 histograms written
    once; one add per sample and pair, at the FP32 rate (the published
    table has no integer scalar rate)."""
    n = ix.shape[1]
    nbytes = ix.numel() * ix.element_size() + weights.numel() * weights.element_size() + 4 * k * nbins * nbins
    return bound(nbytes, k * n, FP32_FLOPS)


def library_hist_ms(ix, weights, pa, pb, nbins, reps):
    """One PyTorch call computing K1/K4/K5's function: ``torch.bincount`` of
    flat keys k * nbins^2 + b * nbins + a with the weights repeated per pair
    (the keys and weights are built outside the timed window; ~5 GB at 30 x
    1M, 435 pairs, freed before returning). No index lies outside [0, nbins)
    on the paths' rows."""
    import torch

    k = pa.shape[0]
    pair = torch.arange(k, device=ix.device)[:, None] * (nbins * nbins)
    keys = (pair + ix[pb.long()].long() * nbins + ix[pa.long()].long()).reshape(-1)
    repeated = weights.repeat(k)
    ms = cuda_ms(lambda: torch.bincount(keys, weights=repeated, minlength=k * nbins * nbins), reps)
    del pair, keys, repeated
    torch.cuda.empty_cache()
    return ms


def exact_pair_sums(ix, weights, pa, pb, nbins, chunk=32):
    """(K, nbins, nbins) f64 sums of ``weights`` by (b, a) bin per pair, by
    ``torch.bincount`` in f64 over chunks of pairs: the exact sums that
    fixed-point histograms are held against."""
    import torch

    w64 = weights.to(torch.float64)
    out = []
    for c0 in range(0, pa.shape[0], chunk):
        a, b = pa[c0 : c0 + chunk].long(), pb[c0 : c0 + chunk].long()
        keys = (torch.arange(a.shape[0], device=ix.device)[:, None] * (nbins * nbins) + ix[b].long() * nbins
                + ix[a].long()).reshape(-1)
        out.append(torch.bincount(keys, weights=w64.repeat(a.shape[0]), minlength=a.shape[0] * nbins * nbins)
                   .view(-1, nbins, nbins))
    return torch.cat(out)


def fixed_point_error(got, ix, weights, pa, pb, nbins):
    """The largest ratio, over every bin, of |got - exact sum| to what
    64-bit fixed point allows: half an ulp of the f32 of the exact sum (the
    one conversion, after the sum's rounding to f64: 2^-53 of it) plus the
    weights' own rounding, at most 2^-62 * max |w| * N a sample in the bin.
    At most 1 when the bins are right (sums of two f32 weights of one
    magnitude sit on f32 midpoints: the ratio then comes near 1)."""
    import numpy as np
    import torch

    exact = exact_pair_sums(ix, weights, pa, pb, nbins)
    counts = exact_pair_sums(ix, torch.ones_like(weights), pa, pb, nbins)
    ulp = torch.from_numpy(np.spacing(exact.abs().float().cpu().numpy())).to(exact.device).double()
    allowed = 0.5 * ulp + 2.0**-53 * exact.abs() + counts * 2.0**-62 * float(weights.abs().max()) * ix.shape[1]
    return float(((got.double() - exact).abs() / allowed.clamp_min(1e-300)).max())


def ptxas_lines(log, name):
    """ptxas's register and spill report of each kernel whose (mangled) name
    holds ``name``, from a fresh build's ``-Xptxas -v`` log."""
    lines, kernel, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel, spill = line.split("'")[1], ""
        elif kernel and "spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            if name in kernel:
                lines.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None
    return lines


def _dft_rate(e):
    """K2/K3 operations: f32 at the 3xTF32 tensor-core rate (the fastest
    f32-accurate products), f64 at the DMMA rate."""
    return FP64_FLOPS if e == 8 else TF32X3_FLOPS


def spectrum_work(kernels, pad):
    """K2's (bytes, flops): kernels and two DFT matrices read, two spectra
    written. Flops per pair of U = F K F contract over the m x m kernel
    support only (the frame's zero padding needs none), and U of a real
    kernel is Hermitian, so rows 0..P/2 (h of them) determine it: (h x m)
    real x complex, then (h x m) x (m x P) complex x complex."""
    k, m, _ = kernels.shape
    e = kernels.element_size()
    h = pad // 2 + 1
    return e * (k * m * m + 2 * pad * pad + 2 * k * pad * pad), k * (4 * h * m * m + 8 * h * pad * m)


def conv_work(grids, pad, out_size):
    """K3's (bytes, flops): grids, two spectra and four DFT matrices read,
    the slice written. Flops per pair, with h = P/2 + 1 rows of the
    Hermitian spectrum of real grids: the forward transform contracts over
    the I x I grid (h rows), the spectrum product is 6 per point of those
    rows, and the inverse computes only the out_size rows and, of the real
    part, the out_size columns of the slice; the rows of the first inverse
    product are Hermitian too, so it needs h of their columns and the
    second product a depth of h."""
    k, size, _ = grids.shape
    e = grids.element_size()
    h = pad // 2 + 1
    nbytes = e * (k * size * size + 2 * k * pad * pad + 4 * pad * pad + k * out_size * out_size)
    forward = 4 * h * size * size + 8 * h * pad * size
    inverse = 8 * out_size * pad * h + 4 * out_size * out_size * h
    return nbytes, k * (forward + 6 * h * pad + inverse)


def spectrum_bound(kernels, pad):
    nbytes, flops = spectrum_work(kernels, pad)
    return bound(nbytes, flops, _dft_rate(kernels.element_size()))


def conv_bound(grids, pad, out_size):
    nbytes, flops = conv_work(grids, pad, out_size)
    return bound(nbytes, flops, _dft_rate(grids.element_size()))


def dft_report(name, r, work, rate):
    """One line: K2/K3 beside the full-frame plain chain, the library call
    and both bounds."""
    t_bytes, t_ops = bound_terms(*work, rate)
    print(
        f"{name}: kernel {r['ms']:.3f} ms, plain full-frame matmul chain {r['plain_ms']:.3f} ms, library "
        f"{r['library_ms']:.3f} ms; bounds: bytes {t_bytes:.3f} ms ({work[0] / 1e9:.3f} GB), operations "
        f"{t_ops:.3f} ms ({work[1] / 1e9:.1f} GFLOP at {rate / 1e12:.0f} TFLOP/s); kernel at "
        f"{max(t_bytes, t_ops) / r['ms']:.1%} of the bound, {r['library_ms'] / r['ms']:.2f}x the library's speed"
    )


def dft_checks(kernels, grids, ur, ui, conv, out_size, offset, pad, label):
    """Two calls give bitwise-equal K2/K3 results; the f32 error against the
    plain chain, and both against an f64 chain, are printed."""
    import torch

    from getdist_tpu_torch.ops import dft_conv

    ur2, ui2 = dft_conv.dft_conv_spectrum(kernels, pad)
    conv2 = dft_conv.dft_conv2d(grids, ur2, ui2, out_size, offset, pad)
    check(torch.equal(ur, ur2) and torch.equal(ui, ui2) and torch.equal(conv, conv2), f"{label}: two calls bitwise equal")
    if kernels.dtype == torch.float32:
        u64 = dft_conv.dft_conv_spectrum_plain(kernels.double(), pad)
        ref = dft_conv.dft_conv2d_plain(grids.double(), *u64, out_size, offset, pad)
        plain = dft_conv.dft_conv2d_plain(grids, *dft_conv.dft_conv_spectrum_plain(kernels, pad), out_size, offset, pad)
        scale = float(ref.abs().max())
        print(f"{label}: two calls bitwise equal; K3 against an f64 chain (of max|ref|): kernel "
              f"{float((conv.double() - ref).abs().max()) / scale:.3g}, plain f32 chain "
              f"{float((plain.double() - ref).abs().max()) / scale:.3g}")
    else:
        print(f"{label}: two calls bitwise equal")


def library_conv_ms(grids, kernels, out_size, offset, reps):
    """One PyTorch call computing K3's function: a grouped cuDNN convolution
    (TF32 off) of each grid with its own kernel, full size, then the slice."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    k, m, _ = kernels.shape
    weight = torch.flip(kernels, dims=(1, 2))[:, None]

    def run():
        full = F.conv2d(grids[None], weight, padding=m - 1, groups=k)[0]
        return full[:, offset : offset + out_size, offset : offset + out_size]

    return cuda_ms(run, reps)


def library_spectrum_ms(kernels, pad, reps):
    """One PyTorch call computing K2's function: the 2D FFT of the
    zero-padded kernels (U = F K F)."""
    import torch

    return cuda_ms(lambda: torch.fft.fft2(kernels, s=(pad, pad)), reps)


def check_outputs(d1, d2, p, k):
    import torch

    check(tuple(d1["P"].shape) == (p, 1024) and tuple(d2["P"].shape) == (k, 256, 256), "output shapes")
    check(tuple(d2["contours"].shape) == (k, 2), "contour shape")
    for name, grid in (("1D", d1["P"]), ("2D", d2["P"])):
        check(bool(torch.isfinite(grid).all()), f"{name} grids finite")
        peaks = grid.flatten(1).amax(1)
        check(bool(((peaks - 1).abs() < 1e-6).all()), f"{name} grids peak at 1")
    levels = d2["contours"]
    check(bool(((levels > 0) & (levels <= 1)).all()), "contour levels in (0, 1]")
    check(bool((levels[:, 0] > levels[:, 1]).all()), "68% level above the 95% level")
    for key in ("neff", "bandwidth", "host_pack"):
        check(bool(torch.isfinite(d1[key]).all()), f"1D {key} finite")
    for key in ("rx", "ry", "corr", "diag"):
        check(bool(torch.isfinite(d2[key]).all()), f"2D {key} finite")


def check_parity_outputs(dens1, dens2, p, k):
    import numpy as np

    check(len(dens1) == p and len(dens2) == k, f"parity returns {len(dens1)} 1D and {len(dens2)} 2D densities")
    for name, d in list(dens1.items()) + list(dens2.items()):
        check(bool(np.isfinite(d.P).all()), f"parity grid {name} finite")
        check(abs(float(d.P.max()) - 1) < 1e-12, f"parity grid {name} peaks at 1")
    for name, d in dens2.items():
        levels = np.asarray(d.contours)
        check(bool(np.all((levels > 0) & (levels <= 1))), f"parity contour levels of {name} in (0, 1]")


def cross_device(make_chain, triangle_densities):
    """The fused path on the card against the port on the CPU (plain
    versions), at the tolerances of tests/test_torch_batched.py."""
    import numpy as np

    samples, weights = make_chain(100_000, 8)
    g1, g2 = triangle_densities(samples, weights, device="cuda")
    c1, c2 = triangle_densities(samples, weights, device="cpu")
    g1 = {k: v for k, v in g1.items() if v is not None}
    report = {}

    def close(name, got, want, rtol=0.0, atol=0.0):
        got, want = got.cpu().numpy(), want.cpu().numpy()
        err = np.abs(got - want)
        report[name] = float(err.max())
        check(bool(np.all(err <= atol + rtol * np.abs(want))), f"cross-device {name}: max abs diff {err.max()}")

    for key in ("neff", "bandwidth"):
        close(f"1D {key}", g1[key], c1[key], rtol=1e-4)
    for i in range(2):
        close(f"1D range[{i}]", g1["range"][i], c1["range"][i], rtol=1e-4)
    close("1D P", g1["P"], c1["P"], atol=1e-4)
    for key in ("rx", "ry", "corr"):
        close(f"2D {key}", g2[key], c2[key], rtol=1e-3)
    close("2D P", g2["P"], c2["P"], atol=5e-4)
    close("2D contours", g2["contours"], c2["contours"], rtol=0.02)
    return report


def parity_cross_device(MCSamples):
    """Parity mode on the card against the port on the CPU, at the slice
    tests' tolerances, on a 20k x 6 chain with a bounded parameter and one
    pair with |corr| > 0.87 (a 384-bin fine group)."""
    import numpy as np

    rng = np.random.RandomState(17)
    n = 20_000
    base = rng.standard_normal((n, 6))
    samples = base.copy()
    samples[:, 1] = 0.9 * base[:, 0] + np.sqrt(1 - 0.81) * base[:, 1]
    samples[:, 2] = 0.4 * base[:, 0] + base[:, 2]
    samples[:, 5] = np.abs(base[:, 5])
    kwargs = dict(samples=samples, weights=rng.randint(1, 5, n).astype(np.float64),
                  names=[f"q{i}" for i in range(6)], ranges={"q5": [0, None]})
    g1, g2 = MCSamples(device="cuda", **kwargs).fastParityDensities(device=True)
    c1, c2 = MCSamples(device="cpu", **kwargs).fastParityDensities(device=True)
    check(set(g2) == set(c2) and set(g1) == set(c1), "parity cross-device keys")
    d1 = max(float(np.abs(g1[key].P - c1[key].P).max()) for key in c1)
    d2 = max(float(np.abs(g2[key].P / g2[key].P.max() - c2[key].P / c2[key].P.max()).max()) for key in c2)
    dc = max(float(np.abs(np.asarray(g2[key].contours) - np.asarray(c2[key].contours)).max()) for key in c2)
    fines = sorted({d.P.shape[0] for d in c2.values()})
    check(d1 <= 1e-10, f"parity cross-device 1D P {d1}")
    check(d2 <= 1e-5 and dc <= 1e-5, f"parity cross-device 2D P {d2}, contours {dc}")
    check(len(fines) > 1, f"a stretched fine group ({fines})")
    return {"1D P": d1, "2D P / peak": d2, "2D contours": dc, "fine grids": fines}


def profile_slice(run):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def profile_device_busy(run):
    """(device busy ms, wall ms) of one call under torch.profiler: the sum
    of CUDA kernel, memcpy and memset times, printed with the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer")
    ]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    return busy_ms, wall_ms


def fused_path(samples, weights, batched, dft_conv, pair_hist, make_chain):
    """Phase 1: the fused triangle-densities path (PR 1's phases)."""
    import torch

    p = samples.shape[1]
    k = p * (p - 1) // 2

    def run():
        return batched.triangle_densities(samples, weights, device="cuda")

    cold_s, _ = wall_s(run)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    for fn in counters:
        fn.launches = 0
    _, (d1, d2) = wall_s(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in one main-path run: {launches}")
    check(launches == {"pair_histograms": 1, "dft_conv_spectrum": 1, "dft_conv2d": 2}, "kernel launch counts")
    check_outputs(d1, d2, p, k)
    warm = min(wall_s(run)[0] for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    wall_s(run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def run_1d():
        return batched.all_1d_densities(*batched.prepare_chain(samples, weights, "cuda"))

    t1d = min(wall_s(run_1d)[0] for _ in range(2))
    print(
        f"slice 30 x 1M: first call {cold_s * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms (min of 2; 1D stage "
        f"{t1d * 1e3:.1f} ms incl. upload), peak device memory {peak_gb:.2f} GB"
    )
    profile_slice(run)

    # each kernel against its plain version on the main path's inputs
    s_dev, w_dev = batched.prepare_chain(samples, weights, "cuda")
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pairs = torch.tensor([(i, j) for i in range(p) for j in range(i + 1, p)], dtype=torch.int32, device="cuda")
    pa, pb = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    # the weights as the path passes them: integer weights narrowed to uint8
    w_path = pair_hist.narrow_weights(w_dev)
    check(w_path.dtype == torch.uint8, "the path's integer weights go to K1 as uint8")
    hists = pair_hist.pair_histograms(ix, w_path, pa, pb, integer_weights=True)
    ref_h = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    err_h = float((hists - ref_h).abs().max())
    check(err_h == 0.0, f"K1 bit-exact (max abs diff {err_h})")
    check(float(hists.double().sum()) == float(weights.sum()) * k, "K1 total mass")
    b_h, by_h = hist_bound(ix, w_path, k, 256)
    results = [
        {
            "name": "pair_histograms",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:309",
            "launches": launches["pair_histograms"],
            "max_abs_err": err_h,
            "ms": cuda_ms(lambda: pair_hist.pair_histograms(ix, w_path, pa, pb, integer_weights=True), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True), 2),
            "bound_ms": b_h,
            "bound_by": by_h,
            "library_ms": library_hist_ms(ix, w_dev, pa, pb, 256, 3),
        }
    ]
    kernels = batched._gauss_kernel_2d(d2["rx"], d2["ry"], d2["corr"], 30)
    ur, ui = dft_conv.dft_conv_spectrum(kernels)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    # the production frame (384, m 61, 256 grids, offset 30): 1e-5, which one TF32 pass would miss
    check(err_s <= 1e-5 * scale, f"K2 within 1e-5 max|ref| ({err_s} vs {scale})")
    conv = dft_conv.dft_conv2d(hists, ur, ui, 256, 30)
    conv0 = dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, 30)
    err_c = float((conv - conv0).abs().max())
    check(err_c <= 1e-5 * float(conv0.abs().max()), f"K3 within 1e-5 max|ref| ({err_c} vs {float(conv0.abs().max())})")
    dft_checks(kernels, hists, ur, ui, conv, 256, 30, 384, "K2/K3 f32, fused path")
    b_s, by_s = spectrum_bound(kernels, 384)
    b_c, by_c = conv_bound(hists, 384, 256)
    results += [
        {
            "name": "dft_conv_spectrum",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:155",
            "launches": launches["dft_conv_spectrum"],
            "max_abs_err": err_s,
            "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels), 5),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels), 5),
            "bound_ms": b_s,
            "bound_by": by_s,
            "library_ms": library_spectrum_ms(kernels, 384, 5),
        },
        {
            "name": "dft_conv2d",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:190",
            "launches": launches["dft_conv2d"],
            "max_abs_err": err_c,
            "ms": cuda_ms(lambda: dft_conv.dft_conv2d(hists, ur, ui, 256, 30), 5),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, 30), 5),
            "bound_ms": b_c,
            "bound_by": by_c,
            "library_ms": library_conv_ms(hists, kernels, 256, 30, 3),
        },
    ]
    dft_report("K2 f32", results[1], spectrum_work(kernels, 384), TF32X3_FLOPS)
    dft_report("K3 f32", results[2], conv_work(hists, 384, 256), TF32X3_FLOPS)
    report = cross_device(make_chain, batched.triangle_densities)
    print(f"cross-device 100k x 8 (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return results


def parity_path(samples, weights, batched, dft_conv, pair_hist):
    """Phase 2: device parity mode at full size."""
    import numpy as np
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.ops import parity_device as pdev

    p = samples.shape[1]
    k = p * (p - 1) // 2
    names = [f"p{i}" for i in range(p)]

    def fresh():
        t0 = time.perf_counter()
        mc = MCSamples(samples=samples, weights=weights, names=names, device="cuda")
        return mc, time.perf_counter() - t0

    mc, build_s = fresh()
    cold_s, _ = wall_s(lambda: mc.fastParityDensities(device=True))
    counters = (pair_hist.pair_histograms, pair_hist.pair_histograms_dynamic, dft_conv.dft_conv_spectrum,
                dft_conv.dft_conv2d)
    mc, _ = fresh()
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm_s, (dens1, dens2) = wall_s(lambda: mc.fastParityDensities(device=True))
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"launches in one parity run: {launches}")
    check(all(v >= 1 for v in launches.values()), "parity run launched K1, K4, K2 and K3")
    check_parity_outputs(dens1, dens2, p, k)
    profile = ", ".join(f"{key} {sec:.3f}" for key, sec in mc.parity_profile.items())
    print(
        f"parity 30 x 1M: MCSamples built in {build_s:.2f} s; fastParityDensities first call {cold_s:.2f} s, "
        f"warm {warm_s:.2f} s; peak device memory {peak_gb:.2f} GB"
    )
    print(f"parity stages (s, warm run): {profile}")
    print(f"parity buckets: {json.dumps(mc.parity_buckets)}")
    mc, _ = fresh()
    busy_ms, wall_ms = profile_device_busy(lambda: mc.fastParityDensities(device=True))
    print(f"parity device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall under the profiler "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")

    # bin indices of all columns at 1M, against numpy's formula
    idx = list(range(p))
    infos = [mc._initParamRanges(j) for j in idx]
    binmin = np.array([min(i.param_min, i.range_min) - (0 if i.has_limits_bot else (i.range_max - i.range_min) * 0.1)
                       for i in infos])
    binmax = np.array([max(i.param_max, i.range_max) + (0 if i.has_limits_top else (i.range_max - i.range_min) * 0.1)
                       for i in infos])
    fw = (binmax - binmin) / 255
    st = mc._parity_chain()
    got = pdev.bin_indices(st["samples"], binmin, fw).cpu().numpy()
    want = ((samples - binmin) / fw + 0.5).astype(np.int64).T
    flips = int(np.count_nonzero(got != want))
    check(flips == 0, f"bin indices bit-exact against numpy ({flips} of {want.size} differ)")
    print(f"bin indices 30 x 1M on the card: 0 of {want.size} differ from numpy's formula")

    # K4 on this run's sheared stack
    _, sheared_jobs = mc._parity_pairs(idx, infos)
    stack = mc._sheared_stack(idx, infos, sheared_jobs, st["samples"])
    ix = pair_hist.narrow_rows(stack["ix"], 256)
    check(ix.dtype == torch.uint8, "the sheared stack's rows narrow to uint8")
    sa = torch.tensor(stack["pair_a"], dtype=torch.int32, device="cuda")
    sb = torch.tensor(stack["pair_b"], dtype=torch.int32, device="cuda")
    check(not pdev.static_route(ix.shape[0], len(sheared_jobs)), "the sheared stack takes K4's route")
    # the weights as the path passes them: integer weights narrowed to uint8
    w_path = st["hist_weights"]
    check(w_path.dtype == torch.uint8, "the path's integer weights go to K1 and K4 as uint8")
    w32 = st["weights"].to(torch.float32)
    ref4 = pair_hist.pair_histograms_plain(ix, w32, sa, sb, integer_weights=True)
    err4 = 0.0
    for w_in in (w_path, w32):
        h4 = pair_hist.pair_histograms_dynamic(ix, w_in, sa, sb, integer_weights=True)
        err4 = max(err4, float((h4 - ref4).abs().max()))
    check(err4 == 0.0, f"K4 bit-exact in both weight types (max abs diff {err4})")
    del h4
    t4 = cuda_ms(lambda: pair_hist.pair_histograms_dynamic(ix, w_path, sa, sb, integer_weights=True), 10)
    t4_f32 = cuda_ms(lambda: pair_hist.pair_histograms_dynamic(ix, w32, sa, sb, integer_weights=True), 10)
    print(f"K4 on the sheared stack ({ix.shape[0]} index rows, {len(sheared_jobs)} pairs): {t4:.3f} ms with the "
          f"path's uint8 weights, {t4_f32:.3f} ms with f32 weights")
    b4, by4 = hist_bound(ix, w_path, len(sheared_jobs), 256)
    results = [
        {
            "name": "pair_histograms_dynamic",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:65",
            "launches": launches["pair_histograms_dynamic"],
            "max_abs_err": err4,
            "ms": t4,
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w32, sa, sb, integer_weights=True), 2),
            "bound_ms": b4,
            "bound_by": by4,
            "library_ms": library_hist_ms(ix, w32, sa, sb, 256, 3),
        }
    ]

    # f64 K2/K3 on the run's largest bucket (at fine 256): K1 histograms of
    # the bucket's pair count, kernels at the bucket's window
    bucket = max((b for b in mc.parity_buckets if b["fine"] == 256), key=lambda b: b["pairs"])
    kb, winw = bucket["pairs"], bucket["winw"]
    pad = dft_conv.frame_for(256 + 4 * winw + 1)
    ix256 = np.ascontiguousarray(got, dtype=np.uint8)
    pairs = np.array([(i, j) for i in range(p) for j in range(i + 1, p)][:kb], np.int32)
    hists = pair_hist.pair_histograms(
        torch.from_numpy(ix256).cuda(), w_path, torch.from_numpy(pairs[:, 0].copy()).cuda(),
        torch.from_numpy(pairs[:, 1].copy()).cuda(), integer_weights=True,
    ).double()
    widths = torch.linspace(0.8, winw / 2.5, kb, dtype=torch.float64, device="cuda")
    kernels = batched._gauss_kernel_2d(widths, widths.flip(0), torch.full_like(widths, 0.3), winw)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    check(err_s <= 1e-12 * scale, f"K2 f64 within 1e-12 max|ref| ({err_s} vs {scale})")
    conv = dft_conv.dft_conv2d(hists, ur, ui, 256, winw, pad)
    conv0 = dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, winw, pad)
    err_c = float((conv - conv0).abs().max())
    check(err_c <= 1e-12 * float(conv0.abs().max()), f"K3 f64 within 1e-12 max|ref| ({err_c})")
    print(f"f64 K2/K3 on the largest bucket: {kb} pairs, winw {winw}, frame {pad}")
    dft_checks(kernels, hists, ur, ui, conv, 256, winw, pad, "K2/K3 f64, parity bucket")
    b_s, by_s = spectrum_bound(kernels, pad)
    b_c, by_c = conv_bound(hists, pad, 256)
    results += [
        {
            "name": "dft_conv_spectrum_f64",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:155",
            "launches": launches["dft_conv_spectrum"],
            "max_abs_err": err_s,
            "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad), 3),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels, pad), 3),
            "bound_ms": b_s,
            "bound_by": by_s,
            "library_ms": library_spectrum_ms(kernels, pad, 3),
        },
        {
            "name": "dft_conv2d_f64",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/dft_conv.cu",
            "replaces": "getdist_tpu/ops/dft_conv.py:190",
            "launches": launches["dft_conv2d"],
            "max_abs_err": err_c,
            "ms": cuda_ms(lambda: dft_conv.dft_conv2d(hists, ur, ui, 256, winw, pad), 3),
            "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(hists, ur0, ui0, 256, winw, pad), 3),
            "bound_ms": b_c,
            "bound_by": by_c,
            "library_ms": library_conv_ms(hists, kernels, 256, winw, 1),
        },
    ]
    dft_report("K2 f64", results[1], spectrum_work(kernels, pad), FP64_FLOPS)
    dft_report("K3 f64", results[2], conv_work(hists, pad, 256), FP64_FLOPS)
    report = parity_cross_device(MCSamples)
    print(f"parity cross-device 20k x 6 (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return results


SHARDED_TOL = {"neff": ("rtol", 1e-3), "1D P": ("atol", 1e-5), "2D P": ("atol", 3e-5), "contours": ("rtol", 1e-3)}


def sharded_diffs(got, want, label):
    """Max differences of (d1, d2) against (d1, d2) at the tolerances of
    tests/test_parallel.py (SHARDED_TOL); fails past them."""
    import numpy as np

    (g1, g2), (w1, w2) = got, want
    pairs = {"neff": (g1["neff"], w1["neff"]), "1D P": (g1["P"], w1["P"]), "2D P": (g2["P"], w2["P"]),
             "contours": (g2["contours"], w2["contours"])}
    report = {}
    for name, (g, w) in pairs.items():
        g, w = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64) for x in (g, w))
        kind, tol = SHARDED_TOL[name]
        err = np.abs(g - w)
        report[name] = float(err.max())
        limit = tol * np.abs(w) if kind == "rtol" else tol
        check(bool(np.all(err <= limit)), f"{label} {name}: max abs diff {err.max()} ({kind} {tol})")
    return report


def cross_rank_worker(group, samples, weights, bounded=None):
    """One gloo rank of the cross-check: its block through the sharded path
    on the CPU; with ``bounded`` ((samples, weights, limits_lo, limits_hi,
    periodic, like weights) of a bounded chain) that chain's run too."""
    from getdist_tpu_torch.parallel import shard_samples, shard_values, sharded_triangle_densities

    def pick(d1, d2):
        return ({k: d1[k].numpy() for k in ("neff", "P", "likes") if d1.get(k) is not None},
                {k: d2[k].numpy() for k in ("P", "contours", "likes") if d2.get(k) is not None})

    out = [pick(*sharded_triangle_densities(group, *shard_samples(group, samples, weights, device="cpu"),
                                            n_samples=len(samples)))]
    if bounded is not None:
        bs, bw, lo, hi, per, like = bounded
        out.append(pick(*sharded_triangle_densities(
            group, *shard_samples(group, bs, bw, device="cpu"), limits_lo=lo, limits_hi=hi, periodic=per,
            like_weights=shard_values(group, like, device="cpu"), n_samples=len(bs), int8_weights=True,
        )))
    return out


def sharded_path(samples, weights, batched, dft_conv, pair_hist, make_chain, bounded):
    """Phase 3: the sharded path, one NCCL rank on the card (``bounded``:
    the bounded chain's arrays)."""
    import torch.distributed as dist

    from getdist_tpu_torch.ops._cuda import BUILD_DIR
    from getdist_tpu_torch.parallel import init_group

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = BUILD_DIR / f"nccl_store_{os.getpid()}"
    store.unlink(missing_ok=True)
    group = init_group("nccl", rank=0, world_size=1, init_method=f"file://{store}")
    try:
        rows = sharded_runs(group, samples, weights, batched, dft_conv, pair_hist, make_chain)
        rows += sharded_bounded(group, bounded, batched, dft_conv, pair_hist)
        return rows
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def sharded_runs(group, samples, weights, batched, dft_conv, pair_hist, make_chain):
    import numpy as np
    import torch

    from getdist_tpu_torch.parallel import (
        shard_samples,
        shard_values,
        sharded_pair_hists,
        sharded_triangle_densities,
        spawn_ranks,
    )

    p = samples.shape[1]
    k = p * (p - 1) // 2
    local = shard_samples(group, samples, weights, device="cuda")

    def run():
        return sharded_triangle_densities(group, *local, n_samples=len(samples))

    def run_fused():
        return batched.triangle_densities(*local, int8_weights=False, enable_shear=True)

    cold_s, _ = wall_s(run)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    for fn in counters:
        fn.launches = 0
    _, (d1, d2) = wall_s(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in one sharded run: {launches}")
    check(launches == {"pair_histograms": 1, "dft_conv_spectrum": 1, "dft_conv2d": 2}, "sharded launch counts")
    check_outputs(d1, d2, p, k)
    # warm walls in turns (S, T, T, S, S, T), then each peak with no other run's output alive
    fns = {"sharded": run, "triangle_densities": run_fused}
    walls = {name: [] for name in fns}
    for name in ("sharded", "triangle_densities", "triangle_densities", "sharded", "sharded", "triangle_densities"):
        walls[name].append(wall_s(fns[name])[0])
    peaks = {}
    for name, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        _, out = wall_s(fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        if name == "triangle_densities":
            fused = out
        del out
    warm = {name: min(ws) for name, ws in walls.items()}
    print(
        f"sharded 30 x 1M (one-rank NCCL group): first call {cold_s * 1e3:.1f} ms, warm {warm['sharded'] * 1e3:.1f}"
        f" ms (min of 3), peak device memory {peaks['sharded']:.2f} GB; triangle_densities on the same device "
        f"tensors: warm {warm['triangle_densities'] * 1e3:.1f} ms, peak {peaks['triangle_densities']:.2f} GB; "
        f"walls in turns (ms): {json.dumps({k: [round(x * 1e3, 1) for x in v] for k, v in walls.items()})}"
    )
    report = sharded_diffs((d1, d2), fused, "sharded vs triangle_densities")
    print(f"sharded vs triangle_densities on the card, max abs diffs: {json.dumps(report)}")

    # K5 through sharded_pair_hists over all pairs, both weight modes; K4 without a pair plan
    s_dev, w_dev = local
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    counters = (pair_hist.pair_histograms_grouped, pair_hist.pair_histograms_dynamic, pair_hist.fixed_to_f32)
    grouped, k5_launches = {}, {}
    for mode in (True, False):  # the int32 call, then the f32 one (raw fixed point on the group's scale)
        for fn in counters:
            fn.launches = 0
        grouped[mode] = sharded_pair_hists(group, ix, w_dev, pa, pb, static_pairs=pairs, int8_weights=mode)
        torch.cuda.synchronize()
        k5_launches[mode] = {fn.__name__: fn.launches for fn in counters}
    for fn in counters:
        fn.launches = 0
    dynamic = sharded_pair_hists(group, ix, w_dev, pa, pb)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"launches in the sharded pair-histogram calls: K5 int32 {k5_launches[True]}, K5 f32 {k5_launches[False]}, "
          f"K4 {launches}")
    check(k5_launches[True] == {"pair_histograms_grouped": 1, "pair_histograms_dynamic": 0, "fixed_to_f32": 0}
          and k5_launches[False] == {"pair_histograms_grouped": 1, "pair_histograms_dynamic": 0, "fixed_to_f32": 1}
          and launches == {"pair_histograms_grouped": 0, "pair_histograms_dynamic": 1, "fixed_to_f32": 1},
          "K5/K4 launch counts")
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    err5 = 0.0
    for mode, hists in grouped.items():
        ref = pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, int8_weights=mode)
        k1 = pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=mode)
        err5 = max(err5, float((hists - ref).abs().max()))
        check(torch.equal(hists, ref) and torch.equal(hists, k1), f"K5 (int8_weights={mode}) bit-exact vs plain and K1")
    check(float(grouped[True].double().sum()) == float(weights.sum()) * k, "K5 total mass")
    check(torch.equal(dynamic, grouped[True]), "K4 route of sharded_pair_hists equals K5's")
    # the weights as sharded_pair_hists passes them: uint8 for integer weights
    w_in = {True: pair_hist.narrow_weights(w_dev), False: w_dev}
    t5 = {mode: cuda_ms(lambda m=mode: pair_hist.pair_histograms_grouped(ix, w_in[m], *plan, int8_weights=m), 10)
          for mode in (True, False)}
    t1 = cuda_ms(lambda: pair_hist.pair_histograms(ix, w_in[True], pa, pb, integer_weights=True), 10)
    print(f"K5 on 30 x 1M, 435 pairs in {plan[0].shape[0]} groups of {plan[0].shape[1]}: int32 {t5[True]:.3f} ms, "
          f"f32 {t5[False]:.3f} ms; K1 on the same rows, int32 {t1:.3f} ms (K5 / K1 {t5[True] / t1:.3f})")
    b5, by5 = hist_bound(ix, w_in[True], k, 256)
    library5 = library_hist_ms(ix, w_dev, pa, pb, 256, 3)
    result = {
        "name": "pair_histograms_grouped",
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/pair_hist.cu",
        "replaces": "getdist_tpu/ops/pallas_kernels.py:170",
        "launches": k5_launches[True]["pair_histograms_grouped"],
        "max_abs_err": err5,
        "ms": t5[True],
        "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, int8_weights=True), 2),
        "bound_ms": b5,
        "bound_by": by5,
        "library_ms": library5,
    }
    # K5's f32-weight call as sharded_pair_hists makes it: raw 64-bit sums on
    # the group's scale (ROADMAP C13 (a)), 8-byte bins written
    scale = pair_hist.group_scale(w_dev, len(samples), group)
    raw5 = pair_hist.pair_histograms_grouped(ix, w_dev, *plan, False, scale=scale, raw=True)
    ref5 = pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, False, scale=scale, raw=True)
    check(raw5.dtype == torch.int64 and torch.equal(raw5, ref5), "K5 f32 raw sums bit-exact vs plain")
    check(torch.equal(pair_hist.fixed_to_f32(raw5, scale), grouped[False]), "K5 f32 raw sums convert to the call's")
    del raw5, ref5
    b5f, by5f = bound(ix.numel() + 4 * w_dev.numel() + 8 * k * 256 * 256, k * ix.shape[1], FP32_FLOPS)
    t5f = cuda_ms(lambda: pair_hist.pair_histograms_grouped(ix, w_dev, *plan, False, scale=scale, raw=True), 10)
    result_f32 = dict(
        result, name="pair_histograms_grouped_f32", launches=k5_launches[False]["pair_histograms_grouped"],
        max_abs_err=0.0, ms=t5f, bound_ms=b5f, bound_by=by5f,
        plain_ms=cuda_ms(lambda: pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, False, scale=scale,
                                                                         raw=True), 2),
    )
    print(f"K5 f32-weight call (raw fixed point, group scale): {t5f:.3f} ms, {b5f / t5f:.1%} of its bound "
          f"{b5f:.4f} ms ({by5f}); plain {result_f32['plain_ms']:.3f} ms; torch.bincount {library5:.3f} ms")

    # 4 gloo ranks on the CPU against the one-rank run on the card
    base, cw = make_chain(40_000, 6, seed=19)
    cs = base.copy()
    cs[:, 1] = 0.8 * base[:, 0] + 0.6 * base[:, 1]
    corr = np.corrcoef(cs.T)[0, 1]
    check(abs(corr) > 0.5, f"cross-rank chain has a correlated pair ({corr})")
    # and a 40k x 6 bounded chain: lower, upper, two-sided and periodic
    # columns, like weights
    bs, bw, bll, bnames, branges = bounded_chain(40_000, p=6, kinds=(1, 1, 1, 1))
    blo, bhi, bper = limit_arrays(bnames, branges)
    blike = like_weights_of(bw, bll)
    t0 = time.perf_counter()
    ranks = spawn_ranks(cross_rank_worker, 4, "gloo", args=(cs, cw, (bs, bw, blo, bhi, bper, blike)), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    for rank, got in enumerate(ranks[1:], start=1):
        for run, first_run in zip(got, ranks[0]):
            for mine, first in zip(run, first_run):
                check(all(np.array_equal(mine[key], first[key]) for key in first),
                      f"rank {rank} bitwise equal to rank 0")
    card = sharded_triangle_densities(group, *shard_samples(group, cs, cw, device="cuda"), n_samples=len(cs))
    report = sharded_diffs(ranks[0][0], card, "4 gloo ranks vs one NCCL rank")
    card_b = sharded_triangle_densities(group, *shard_samples(group, bs, bw, device="cuda"), limits_lo=blo,
                                        limits_hi=bhi, periodic=bper, like_weights=shard_values(group, blike, "cuda"),
                                        n_samples=len(bs), int8_weights=True)
    report_b = sharded_diffs(ranks[0][1], card_b, "4 gloo ranks vs one NCCL rank, bounded")
    likes_b, bad = like_diffs(ranks[0][1], card_b, "4 gloo ranks vs one NCCL rank, bounded",
                              tol_2d=LIKES_TOL_CROSS_DEVICE_2D)
    check(not bad, "; ".join(bad))
    report_b.update(likes_b)
    print(f"cross-rank 40k x 6 (|corr| {abs(corr):.2f}): 4 gloo ranks on the CPU ({spawn_s:.1f} s for both chains, "
          f"bitwise equal across ranks) vs one NCCL rank on the card, max abs diffs: {json.dumps(report)}; bounded "
          f"40k x 6 (limits, periodic, like weights): {json.dumps(report_b)}")
    return [result, result_f32]


# like grids of one device against another order of the same sums (f32
# like weights over many decades), and of the card against the CPU (2D: f32
# round-off of the convolutions over the density floor, the zoo's 5e-3, as
# bounded_cross_device holds them)
LIKES_TOL = 1e-4
LIKES_TOL_CROSS_DEVICE_2D = 5e-3
# K1 adds fractional (like) weights in fixed point, order independent: on
# one device the same program gives the same like grids bit for bit, so a
# call against itself and a one-rank group against no group are held equal
# (LIKES_SAME = 0) over the whole grid (ROADMAP C13).
LIKES_SAME = 0.0


def like_diffs(got, want, label, tol_1d=LIKES_TOL, tol_2d=LIKES_TOL):
    """(report, failures) of the 1D and 2D like grids of (d1, d2) against
    (d1, d2), over the whole grids: max differences, and those past
    ``tol_1d`` in 1D and ``tol_2d`` in 2D."""
    import numpy as np

    def host(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)

    report, failures = {}, []
    for name, g, w, tol in (("1D likes", got[0]["likes"], want[0]["likes"], tol_1d),
                            ("2D likes", got[1]["likes"], want[1]["likes"], tol_2d)):
        report[name] = float(np.abs(host(g) - host(w)).max())
        if report[name] > tol:
            failures.append(f"{label} {name}: max abs diff {report[name]} (tolerance {tol})")
    return report, failures


def bitwise(got, want):
    """Whether two (d1, d2) results are equal bit for bit on every tensor
    both hold."""
    import torch

    return all(
        torch.equal(a[key], b[key])
        for a, b in zip(got, want)
        for key in a
        if isinstance(a[key], torch.Tensor) and isinstance(b.get(key), torch.Tensor)
    )


def sharded_bounded(group, bounded, batched, dft_conv, pair_hist):
    """Phase 3 on the bounded chain (30 x 1M: limits, periodic axes, like
    weights), in the one-rank NCCL group: ``sharded_triangle_densities``
    beside ``triangle_densities`` with the same arguments on the same device
    tensors (walls in turns, launches, outputs; equal within
    tests/test_parallel.py's tolerances, the like curves and grids equal
    over the whole grids; and whether bitwise), and the latter against
    itself (like grids equal), then
    ``MCSamples.fastTriangleDensities(mesh=group)`` with meanlikes against
    the unsharded entry (the same regrid keys, served grids within 2e-5,
    tests/test_parallel.py's public-path tolerance; like grids equal)."""
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.parallel import shard_samples, shard_values, sharded_triangle_densities

    samples, weights, loglikes, names, ranges = bounded
    lo, hi, per = limit_arrays(names, ranges)
    local = shard_samples(group, samples, weights, device="cuda")
    like = shard_values(group, like_weights_of(weights, loglikes), device="cuda")
    kw = dict(limits_lo=lo, limits_hi=hi, periodic=per, like_weights=like, int8_weights=True, enable_shear=True)

    def run():
        return sharded_triangle_densities(group, *local, n_samples=len(samples), **kw)

    def run_fused():
        return batched.triangle_densities(*local, device="cuda", **kw)

    label = "sharded, bounded chain 30 x 1M (one-rank NCCL group)"
    cold_s, _ = wall_s(run)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d, pair_hist.fixed_to_f32)
    for fn in counters:
        fn.launches = 0
    pair_hist.pair_histograms.float_launches = 0
    _, (d1, d2) = wall_s(run)
    launches = {fn.__name__: fn.launches for fn in counters}
    launches["float"] = pair_hist.pair_histograms.float_launches
    check(launches["pair_histograms"] == 2 and launches["float"] == 1 and launches["dft_conv_spectrum"] >= 1
          and launches["dft_conv2d"] >= 2 and launches["fixed_to_f32"] == 1,
          f"{label}: K1 (integer and like weights, the latter raw on the group's scale, converted once), K2 and K3 "
          f"launched ({launches})")
    rows = group_like_rows(group, local[0], like, d1["range"], len(samples), launches, batched, pair_hist)
    pairs = [(a, b) for a in range(len(names)) for b in range(a + 1, len(names))]
    check_bounded_outputs(d1, dict(d2, regrid={}), pairs, BOUNDED_KINDS, label)
    walls = {"sharded": [], "triangle_densities": []}
    fns = {"sharded": run, "triangle_densities": run_fused}
    for name in ("sharded", "triangle_densities", "triangle_densities", "sharded"):
        walls[name].append(wall_s(fns[name])[0])
    fused = run_fused()
    report = sharded_diffs((d1, d2), fused, f"{label} vs triangle_densities")
    likes, bad = like_diffs((d1, d2), fused, f"{label} vs triangle_densities", LIKES_SAME, LIKES_SAME)
    report.update(likes)
    repeat, bad_repeat = like_diffs(fused, run_fused(), "triangle_densities against itself", LIKES_SAME, LIKES_SAME)
    bad += bad_repeat
    print(f"{label}: first call {cold_s * 1e3:.1f} ms, warm {min(walls['sharded']) * 1e3:.1f} ms (min of 2), "
          f"triangle_densities on the same tensors warm {min(walls['triangle_densities']) * 1e3:.1f} ms; walls in "
          f"turns (ms): {json.dumps({k: [round(x * 1e3, 1) for x in v] for k, v in walls.items()})}; launches of one "
          f"run: {json.dumps(launches)}; vs triangle_densities: bitwise {bitwise((d1, d2), fused)}, max abs diffs "
          f"{json.dumps(report)}; triangle_densities against itself, like grids: {json.dumps(repeat)}")
    check(not bad, "; ".join(bad))
    del d1, d2, fused

    mc = MCSamples(samples=samples, weights=weights, loglikes=loglikes, names=names, ranges=ranges, device="cuda")
    entry = lambda **k: mc.fastTriangleDensities(meanlikes=True, **k)  # noqa: E731
    cold_s, _ = wall_s(lambda: entry(mesh=group))
    for fn in counters:
        fn.launches = 0
    warm_s, (g1, g2, pairs) = wall_s(lambda: entry(mesh=group))
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v >= 1 for v in launches.values()), f"mesh entry: K1, K2 and K3 launched ({launches})")
    stages = dict(mc.fast_profile)
    groups = [(g["fine"], len(g["pairs"]), g["bandwidths"]) for g in mc.fast_regrid_groups]
    u_warm = [wall_s(entry)[0] for _ in range(2)]
    u1, u2, _ = entry()
    u_groups = [(g["fine"], len(g["pairs"]), g["bandwidths"]) for g in mc.fast_regrid_groups]
    check(set(g2["regrid"]) == set(u2["regrid"]) and groups == u_groups, "mesh entry: the unsharded regrid keys")
    err2 = 0.0
    for k, key in enumerate(pairs):
        got = g2["regrid"][key]["P"] if key in g2["regrid"] else g2["P"][k]
        want = u2["regrid"][key]["P"] if key in u2["regrid"] else u2["P"][k]
        err2 = max(err2, float((got - want).abs().max()))
    err1 = float((g1["P"] - u1["P"]).abs().max())
    neff = float(((g1["neff"] - u1["neff"]).abs() / u1["neff"]).max())
    check(err1 <= 2e-5 and err2 <= 2e-5 and neff <= 1e-3,
          f"mesh entry vs unsharded: 1D {err1}, served 2D {err2}, neff {neff}")
    likes, bad = like_diffs((g1, g2), (u1, u2), "mesh entry vs unsharded", LIKES_SAME, LIKES_SAME)
    print(f"public entry, bounded chain, mesh=group (one NCCL rank), meanlikes: first call {cold_s * 1e3:.1f} ms, "
          f"warm {warm_s * 1e3:.1f} ms; unsharded warm {min(u_warm) * 1e3:.1f} ms (min of 2); launches "
          f"{json.dumps(launches)}; stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; regrid groups {groups}; vs unsharded: 1D {err1:.3g}, served 2D {err2:.3g}, neff (rel) {neff:.3g}, "
          f"{json.dumps(likes)}, {len(u2['regrid'])} regrid keys equal")
    check(not bad, "; ".join(bad))
    del mc, g1, g2, u1, u2
    torch.cuda.empty_cache()
    return rows


def group_like_rows(group, s_dev, like, ranges, n, launches, batched, pair_hist):
    """Kernel rows of the sharded like histograms (ROADMAP C13 (a)), on the
    bounded chain's rows and like weights in the group: K1 binning raw
    64-bit sums on the group's scale (max |w| over the ranks, the chain's
    length), and the one conversion of the all-reduced sums to f32
    (``fixed_to_f32``). Each bit-exact against its plain version; together
    they give one card's like histograms bit for bit."""
    import torch

    binmin, binmax = ranges
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    p = ix.shape[0]
    pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    k = len(pairs)
    scale = pair_hist.group_scale(like, n, group)
    raw = pair_hist.pair_histograms(ix, like, pa, pb, scale=scale, raw=True)
    check(raw.dtype == torch.int64 and torch.equal(raw, pair_hist.pair_histograms_plain(ix, like, pa, pb, scale=scale,
                                                                                        raw=True)),
          "K1 like, raw sums on the group's scale: bit-exact vs plain")
    converted = pair_hist.fixed_to_f32(raw, scale)
    check(torch.equal(converted, pair_hist._fixed_to_f32_plain(raw, scale)), "fixed_to_f32: bit-exact vs its twin")
    check(torch.equal(converted, pair_hist.pair_histograms(ix, like, pa, pb)),
          "K1 like: the group route's histograms are one card's bits")
    library = library_hist_ms(ix, like, pa, pb, 256, 3)
    b_raw, by_raw = bound(ix.numel() + 4 * like.numel() + 8 * k * 256 * 256, k * ix.shape[1], FP32_FLOPS)
    b_cvt, by_cvt = bound(12 * raw.numel(), raw.numel(), FP64_FLOPS)
    rows = [
        {
            "name": "pair_histograms_like_group",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:309",
            "launches": launches["float"],
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: pair_hist.pair_histograms(ix, like, pa, pb, scale=scale, raw=True), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, like, pa, pb, scale=scale, raw=True), 2),
            "bound_ms": b_raw,
            "bound_by": by_raw,
            "library_ms": library,
        },
        {
            "name": "fixed_to_f32",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            # an auxiliary kernel of K1's fixed point: no Pallas counterpart
            "replaces": None,
            "launches": launches["fixed_to_f32"],
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: pair_hist.fixed_to_f32(raw, scale), 10),
            "plain_ms": cuda_ms(lambda: pair_hist._fixed_to_f32_plain(raw, scale), 10),
            "bound_ms": b_cvt,
            "bound_by": by_cvt,
            "library_ms": None,
        },
    ]
    for r in rows:
        print(f"{r['name']} (sharded like histograms, 30 x 1M, {k} pairs): kernel {r['ms']:.3f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of its bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, launches {r['launches']}")
    del raw, converted
    return rows


STAGE_PREFIXES = ("fast:", "1d:", "2d:")


def fused_stage_rows(prof):
    """(stage, host ms, device ms) of the stage ranges of one profiled
    ``fastTriangleDensities`` call: its own ``fast:<stage>`` ranges and
    the ``1d:`` / ``2d:`` ranges of ``ops.batched`` inside them."""
    import torch

    rows = []
    for e in prof.key_averages():
        # the host-side range (the profiler also lists each range's span on the device timeline)
        if e.key.startswith(STAGE_PREFIXES) and e.device_type == torch.autograd.DeviceType.CPU:
            device_us = getattr(e, "device_time_total", None)
            if device_us is None:
                device_us = e.cuda_time_total
            rows.append((e.key, e.cpu_time_total / 1e3, device_us / 1e3, e.count))
    return rows


def entry_call(mc, **kwargs):
    """One profiled public-entry call: (device busy ms, wall ms, stage rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mc.fastTriangleDensities(**kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(("Activity Buffer",) + STAGE_PREFIXES)  # not the stage ranges' device spans
    ]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return busy_ms, wall_ms, fused_stage_rows(prof)


def print_entry_profile(label, mc, busy_ms, wall_ms, rows):
    print(f"{label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall under the profiler "
          f"(idle share {1 - busy_ms / wall_ms:.3f}); stages (host ms, device ms of the kernels they queued, "
          "calls): " + ", ".join(f"{name} {cpu:.1f}/{dev:.1f} x{n}" for name, cpu, dev, n in rows))
    print(f"{label}: stage split of the last unprofiled call (host clock, s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in mc.fast_profile.items()))
    groups = [dict(g, pairs=len(g["pairs"])) for g in mc.fast_regrid_groups]
    print(f"{label}: regrid groups (pair counts) {json.dumps(groups)}")


def check_entry_outputs(d1, d2, pairs, p, label):
    import torch

    check(len(pairs) == p * (p - 1) // 2, f"{label}: pair list")
    check_outputs(d1, d2, p, len(pairs))
    for key, entry in d2["regrid"].items():
        grid, levels = entry["P"], entry["contours"]
        check(bool(torch.isfinite(grid).all()) and abs(float(grid.max()) - 1) < 1e-6, f"{label}: regrid {key} peaks at 1")
        check(bool(((levels > 0) & (levels <= 1)).all()), f"{label}: regrid {key} contour levels in (0, 1]")


def entry_vs_program(mc, d1, d2, samples, weights, batched):
    """The public entry against ``triangle_densities`` on the same chain,
    given the entry's shear subset (from the exact correlations): bitwise
    equal on every output the program served. Also reports whether the
    program's own subsampled sniff picks the same subset."""
    import numpy as np
    import torch

    p = samples.shape[1]
    pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
    corr = mc.getCorrelationMatrix()
    exact = tuple(k for k, (a, b) in enumerate(pairs) if abs(corr[a, b]) > 0.15)
    sniffed = batched._sniff_shear(samples, 0.99, pairs=np.array(pairs), weights=weights)
    subset = tuple(range(len(pairs))) if sniffed is True else () if sniffed is False else tuple(sniffed)
    t1, t2 = batched.triangle_densities(samples, weights, max_corr=float(mc.max_corr_2D), enable_shear=exact,
                                        device="cuda")
    served = [k for k, key in enumerate(pairs) if key not in d2["regrid"]]
    same = all(torch.equal(d1[key], t1[key]) for key in ("P", "neff", "bandwidth"))
    same = same and all(torch.equal(d2[key][served], t2[key][served]) for key in ("P", "contours", "rx", "ry", "corr"))
    check(same, "public entry bitwise equal to triangle_densities on the pairs it served from the program")
    print(f"public entry vs triangle_densities (the entry's shear subset, {len(exact)} pairs): bitwise equal on the "
          f"{len(served)} of {len(pairs)} pairs served from the program; the subsampled sniff picks "
          f"{len(subset)} pairs, {len(set(subset) ^ set(exact))} of them different")


def entry_cross_device(MCSamples):
    """The public entry on the card against the port on the CPU at 100k x 8
    of the hard chain: the same regrid keys and sizes, grids within the
    zoo's 5e-3, 1D within 1e-4."""
    samples, weights = hard_chain(100_000)
    kw = dict(samples=samples, weights=weights, names=[f"h{i}" for i in range(8)])
    g1, g2, pairs = MCSamples(device="cuda", **kw).fastTriangleDensities()
    c1, c2, _ = MCSamples(device="cpu", **kw).fastTriangleDensities()
    check(set(g2["regrid"]) == set(c2["regrid"]), f"cross-device regrid keys {sorted(g2['regrid'])} {sorted(c2['regrid'])}")
    err2 = 0.0
    for k, key in enumerate(pairs):
        got = g2["regrid"][key]["P"] if key in g2["regrid"] else g2["P"][k]
        want = c2["regrid"][key]["P"] if key in c2["regrid"] else c2["P"][k]
        check(got.shape == want.shape, f"cross-device grid size of {key}")
        err2 = max(err2, float((got.cpu() - want).abs().max()))
    err1 = float((g1["P"].cpu() - c1["P"]).abs().max())
    check(err1 <= 1e-4 and err2 <= 5e-3, f"public entry cross-device 1D {err1}, 2D {err2}")
    sizes = sorted({int(e["P"].shape[0]) for e in g2["regrid"].values()})
    return {"1D P": err1, "2D P (served)": err2, "regrid keys": len(g2["regrid"]), "regrid sizes": sizes}


def wide_row(name, entry, ix, w, pa, pb, fine, integer, launches, pair_hist):
    """A kernel row of the wide kernels on one fine group's rows, pairs and
    weights, as its path passes them (``entry``: K1's or K4's): bit-exact
    against the plain version (integer weights), timed beside the plain
    version and one ``torch.bincount``, with its bound and the route
    ``pair_hist.wide_plan`` takes."""
    import torch

    k, n = pa.shape[0], ix.shape[1]
    check(ix.dtype == torch.int16, f"{name}: rows at {fine} bins narrow to int16")
    got = entry(ix, w, pa, pb, integer_weights=integer, nbins=fine)
    ref = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=integer, nbins=fine)
    err = float((got - ref).abs().max())
    check(err == 0.0, f"{name}: bit-exact against the plain version ({err})")
    if not integer:  # fractional weights: 64-bit fixed point (ROADMAP C13 (b))
        check(torch.equal(got, entry(ix, w, pa, pb, nbins=fine)), f"{name}: two calls bitwise equal")
        worst = fixed_point_error(got, ix, w, pa, pb, fine)
        check(worst <= 1.0, f"{name}: within one f32 rounding of the f64 sums ({worst})")
        print(f"{name}: fractional weights, two calls bitwise equal, at most {worst:.3g} of one f32 rounding of "
              "the f64 sums")
    del got, ref
    b, by = hist_bound(ix, w, k, fine)
    row = {
        "name": name,
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/pair_hist.cu",
        "replaces": "getdist_tpu/ops/batched.py:125",
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: entry(ix, w, pa, pb, integer_weights=integer, nbins=fine), 10),
        "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w, pa, pb, integer, fine), 2),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": library_hist_ms(ix, w, pa, pb, fine, 3),
    }
    plan = pair_hist.wide_plan(k, n, fine, torch.cuda.get_device_properties(0).multi_processor_count,
                               4 if integer or w.dtype == torch.uint8 else 8)
    verdict = "faster" if row["ms"] <= row["library_ms"] else "SLOWER"
    print(f"{name}: {k} pair(s) of {ix.shape[0]} int16 rows x {n} at {fine} bins, {w.dtype} weights, {plan.route} "
          f"route: kernel {row['ms']:.3f} ms, {b / row['ms']:.1%} of its bound {b:.4f} ms ({by}); plain "
          f"{row['plain_ms']:.3f} ms; torch.bincount {row['library_ms']:.3f} ms ({verdict} than it); launches {launches}")
    return row


def entry_group_rows(s_dev, ranges, group, pair_hist, batched):
    """(index rows, pair_a, pair_b, pair keys) of a public-entry regrid group,
    as ``all_2d_densities`` bins it: the group's columns at its fine grid
    over the 1D stage's ranges, narrowed by ``pair_hist.narrow_rows``."""
    import torch

    binmin, binmax = ranges
    fine, keys = group["fine"], [tuple(key) for key in group["pairs"]]
    cols = sorted({c for key in keys for c in key})
    pos = {c: i for i, c in enumerate(cols)}
    sel = torch.as_tensor(cols, device="cuda")
    ix = pair_hist.narrow_rows(batched._fine_indices(
        s_dev[:, sel].T.contiguous(), binmin[sel], (binmax - binmin)[sel] / (fine - 1), fine), fine)
    pa = torch.tensor([pos[a] for a, _ in keys], dtype=torch.int32, device="cuda")
    pb = torch.tensor([pos[b] for _, b in keys], dtype=torch.int32, device="cuda")
    return ix, pa, pb, keys


def conv_frames(dft_conv):
    """K3's launches by DFT frame, summed over its (frame, input size) counts."""
    frames = {}
    for (pad, _), n in dft_conv.dft_conv2d.inputs.items():
        frames[pad] = frames.get(pad, 0) + n
    return frames


def new_shape_rows(mc, d1, d2, launches, pair_hist, dft_conv, batched):
    """Kernel rows of the shapes the public entry adds, on the inputs of
    the run's own reruns: K1's wide kernels on the rows of its first fine >
    256 regrid group, and f32 K2/K3 at each DFT frame past 384 that the run
    launched (the first group there: its histograms and its pairs'
    kernels); each against its plain version, the library call and its
    bound."""
    import torch

    st = mc._fast_chain_state()
    s_dev, w_dev = st["samples"], st["weights"]

    def group_hists(group):
        return entry_group_rows(s_dev, d1["range"], group, pair_hist, batched)

    wide = next((g for g in mc.fast_regrid_groups if g["fine"] > 256), None)
    check(wide is not None, "the run regridded a pair past 256 bins")
    fine = wide["fine"]
    ix, pa, pb, keys = group_hists(wide)
    # the weights as all_2d_densities passes them: integer weights narrowed to uint8
    w_path = pair_hist.narrow_weights(w_dev) if st["int8"] else w_dev
    rows = [wide_row(f"pair_histograms_wide_{fine}bins", pair_hist.pair_histograms, ix, w_path, pa, pb, fine,
                     st["int8"], launches["wide_bins"].get(fine, 0), pair_hist)]
    done = set()
    for group in mc.fast_regrid_groups:
        size, off = group["fine"], group["winw"]
        pad = dft_conv.frame_for(size + 4 * off + 1)
        if pad <= 384 or pad in done:
            continue
        done.add(pad)
        ix, pa, pb, keys = group_hists(group)
        grids = pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=st["int8"], nbins=size)
        entries = [d2["regrid"][key] for key in keys]
        kernels = batched._gauss_kernel_2d(*(torch.stack([e[n] for e in entries]) for n in ("rx", "ry", "corr")), off)
        ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
        ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
        scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
        err_s = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
        check(err_s <= 1e-5 * scale, f"K2 f32 at frame {pad} within 1e-5 max|ref| ({err_s} vs {scale})")
        conv = dft_conv.dft_conv2d(grids, ur, ui, size, off, pad)
        conv0 = dft_conv.dft_conv2d_plain(grids, ur0, ui0, size, off, pad)
        err_c = float((conv - conv0).abs().max())
        check(err_c <= 1e-5 * float(conv0.abs().max()), f"K3 f32 at frame {pad} within 1e-5 max|ref| ({err_c})")
        b_s, by_s = spectrum_bound(kernels, pad)
        b_c, by_c = conv_bound(grids, pad, size)
        rows += [
            {
                "name": f"dft_conv_spectrum_frame{pad}",
                "route": "cuda",
                "source": "getdist_tpu_torch/csrc/dft_conv.cu",
                "replaces": "getdist_tpu/ops/dft_conv.py:155",
                "launches": launches["spectrum_frames"].get(pad, 0),
                "max_abs_err": err_s,
                "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad), 5),
                "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels, pad), 5),
                "bound_ms": b_s,
                "bound_by": by_s,
                "library_ms": library_spectrum_ms(kernels, pad, 5),
            },
            {
                "name": f"dft_conv2d_frame{pad}",
                "route": "cuda",
                "source": "getdist_tpu_torch/csrc/dft_conv.cu",
                "replaces": "getdist_tpu/ops/dft_conv.py:190",
                "launches": launches["conv_frames"].get(pad, 0),
                "max_abs_err": err_c,
                "ms": cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, size, off, pad), 5),
                "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(grids, ur0, ui0, size, off, pad), 5),
                "bound_ms": b_c,
                "bound_by": by_c,
                "library_ms": library_conv_ms(grids, kernels, size, off, 3),
            },
        ]
        print(f"K2/K3 f32 at frame {pad} ({group['bandwidths']} group): {len(keys)} pair(s) of {size}^2, window {off}")
        dft_checks(kernels, grids, ur, ui, conv, size, off, pad, f"K2/K3 f32, frame {pad}")
        dft_report(f"K2 f32 frame {pad}", rows[-2], spectrum_work(kernels, pad), TF32X3_FLOPS)
        dft_report(f"K3 f32 frame {pad}", rows[-1], conv_work(grids, pad, size), TF32X3_FLOPS)
    return rows


def public_entry(samples, weights, batched, dft_conv, pair_hist):
    """Phase 4: the public fused entry, ``MCSamples.fastTriangleDensities``,
    on the bench chain and on the 1M x 8 hard chain."""
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples

    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)

    def reset():
        for fn in counters:
            fn.launches = 0
        pair_hist.pair_histograms.wide_launches = 0
        pair_hist.pair_histograms.wide_bins.clear()
        dft_conv.dft_conv_spectrum.frames.clear()
        dft_conv.dft_conv2d.inputs.clear()

    def read():
        out = {fn.__name__: fn.launches for fn in counters}
        out.update(wide=pair_hist.pair_histograms.wide_launches, wide_bins=dict(pair_hist.pair_histograms.wide_bins),
                   spectrum_frames=dict(dft_conv.dft_conv_spectrum.frames), conv_frames=conv_frames(dft_conv))
        return out

    def timed_runs(label, s, w, names):
        t0 = time.perf_counter()
        mc = MCSamples(samples=s, weights=w, names=names, device="cuda")
        build_s = time.perf_counter() - t0
        cold_s, _ = wall_s(lambda: mc.fastTriangleDensities())
        reset()
        _, (d1, d2, pairs) = wall_s(lambda: mc.fastTriangleDensities())
        launches = read()
        walls = [wall_s(lambda: mc.fastTriangleDensities())[0] for _ in range(2)]
        profile = dict(mc.fast_profile)
        route = "single dispatch" if "program" in profile else "two programs"
        print(f"{label}: MCSamples built in {build_s:.2f} s; fastTriangleDensities first call {cold_s * 1e3:.1f} ms "
              f"(chain upload included), warm {min(walls) * 1e3:.1f} ms (min of 2: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in walls)}); route: {route}; launches of one run: {json.dumps(launches)}")
        check(launches["pair_histograms"] >= 1 and launches["dft_conv_spectrum"] >= 1 and launches["dft_conv2d"] >= 2,
              f"{label}: the run launched K1, K2 and K3")
        check_entry_outputs(d1, d2, pairs, s.shape[1], label)
        busy_ms, wall_ms, rows = entry_call(mc)
        mc.fast_profile = profile
        print_entry_profile(label, mc, busy_ms, wall_ms, rows)
        return mc, d1, d2, launches, route

    p = samples.shape[1]
    mc, d1, d2, _, route = timed_runs("public entry, bench chain 30 x 1M", samples, weights, [f"p{i}" for i in range(p)])
    check(route == "single dispatch", "the bench chain takes the single-dispatch route")
    entry_vs_program(mc, d1, d2, samples, weights, batched)
    del mc, d1, d2
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hs, hw = hard_chain(1_000_000)
    print(f"hard chain 1,000,000 x 8 made in {time.perf_counter() - t0:.1f} s")
    mc, d1, d2, launches, route = timed_runs("public entry, hard chain 8 x 1M", hs, hw, [f"h{i}" for i in range(8)])
    kinds = {g["bandwidths"] for g in mc.fast_regrid_groups}
    check(route == "two programs", "the hard chain takes the two-program route")
    check(launches["wide"] >= 1, "a fine > 256 regrid ran K1's wide kernels")
    check("assist" in kinds, "a sheared f64 assist ran")
    print(f"hard chain rescues: {sorted(kinds)}; clamped or fragile rescue "
          f"{'present' if kinds & {'clamped', 'fragile'} else 'absent on this chain'}")
    rows = new_shape_rows(mc, d1, d2, launches, pair_hist, dft_conv, batched)
    report = entry_cross_device(MCSamples)
    print(f"public entry cross-device 100k x 8 hard chain (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return rows


def degenerate_phase(pair_hist, batched):
    """Phase 5: the wide kernels on ``degenerate_chain(1M)`` through the
    public entry (cold and warm) and parity mode (one call): walls, wide
    launches, and a kernel row per fine group past 256 bins of each path."""
    import numpy as np
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.ops import parity_device as pdev

    t0 = time.perf_counter()
    samples, weights = degenerate_chain(1_000_000)
    p = samples.shape[1]
    kw = dict(samples=samples, weights=weights, names=[f"d{i}" for i in range(p)], device="cuda")
    print(f"degenerate chain 1,000,000 x {p} made in {time.perf_counter() - t0:.1f} s")
    entries = (pair_hist.pair_histograms, pair_hist.pair_histograms_dynamic)

    def reset():
        for fn in entries:
            fn.launches = fn.wide_launches = 0
            fn.wide_bins.clear()

    def read():
        return {fn.__name__: {"launches": fn.launches, "wide": fn.wide_launches, "wide_bins": dict(fn.wide_bins)}
                for fn in entries}

    def wide_groups(label, fines):
        """{fine: pairs} past 256 bins; at least 20 pairs in at least three
        groups, 960 among them."""
        wide = {fine: n for fine, n in fines.items() if fine > 256}
        check(sum(wide.values()) >= 20 and len(wide) >= 3 and 960 in wide, f"{label}: fine groups {fines}")
        return wide

    # the public entry
    mc = MCSamples(**kw)
    cold_s, _ = wall_s(lambda: mc.fastTriangleDensities())
    reset()
    warm_s, (d1, d2, pairs) = wall_s(lambda: mc.fastTriangleDensities())
    launches = read()
    label = "degenerate chain, public entry"
    check_entry_outputs(d1, d2, pairs, p, label)
    fines = {}
    for g in mc.fast_regrid_groups:
        fines[g["fine"]] = fines.get(g["fine"], 0) + len(g["pairs"])
    wide = wide_groups(label, fines)
    check(launches["pair_histograms"]["wide_bins"] == {fine: 1 for fine in wide}, f"{label}: wide launches {launches}")
    print(f"{label}: fastTriangleDensities first call {cold_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms; pairs per "
          f"fine grid {json.dumps(fines)}; launches of the warm call {json.dumps(launches)}; stage split (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in mc.fast_profile.items()))
    st = mc._fast_chain_state()
    w_path = pair_hist.narrow_weights(st["weights"]) if st["int8"] else st["weights"]
    check(w_path.dtype == torch.uint8, f"{label}: integer weights go to the wide kernels as uint8")
    rows = []
    for g in sorted((g for g in mc.fast_regrid_groups if g["fine"] > 256), key=lambda g: -g["fine"]):
        ix, pa, pb, _ = entry_group_rows(st["samples"], d1["range"], g, pair_hist, batched)
        rows.append(wide_row(f"pair_histograms_wide_entry_{g['fine']}bins", pair_hist.pair_histograms, ix, w_path,
                             pa, pb, g["fine"], st["int8"], launches["pair_histograms"]["wide_bins"].get(g["fine"], 0),
                             pair_hist))
    del mc, d1, d2, st, w_path
    torch.cuda.empty_cache()

    # fractional weights past 256 bins (ROADMAP C13 (b)): a meanlikes run
    # bins like weights there only where it reruns past 256 bins (the bounded
    # chain reruns none), but an importance-weighted chain's regrids bin its
    # fractional weights with the wide kernels
    label = "degenerate chain, importance weights, public entry"
    mc = MCSamples(**dict(kw, weights=importance_weights(weights, seed=30)))
    wall_s(lambda: mc.fastTriangleDensities())
    reset()
    pair_hist.pair_histograms.float_launches = 0
    warm_s, (d1, d2, pairs) = wall_s(lambda: mc.fastTriangleDensities())
    launches = read()
    floats = pair_hist.pair_histograms.float_launches
    check_entry_outputs(d1, d2, pairs, p, label)
    st = mc._fast_chain_state()
    groups = sorted((g for g in mc.fast_regrid_groups if g["fine"] > 256), key=lambda g: -g["fine"])
    check(not st["int8"] and groups and launches["pair_histograms"]["wide"] >= 1 and floats >= 1,
          f"{label}: fractional weights through the wide kernels ({launches}, f32 launches {floats})")
    print(f"{label}: warm {warm_s * 1e3:.1f} ms; launches {json.dumps(launches)}, with f32 weights {floats}")
    g = groups[0]
    ix, pa, pb, _ = entry_group_rows(st["samples"], d1["range"], g, pair_hist, batched)
    rows.append(wide_row(f"pair_histograms_wide_fractional_{g['fine']}bins", pair_hist.pair_histograms, ix,
                         st["weights"], pa, pb, g["fine"], False,
                         launches["pair_histograms"]["wide_bins"].get(g["fine"], 0), pair_hist))
    del mc, d1, d2, st, ix
    torch.cuda.empty_cache()

    # parity mode
    mc = MCSamples(**kw)
    reset()
    par_s, (dens1, dens2) = wall_s(lambda: mc.fastParityDensities(device=True))
    launches = read()
    label = "degenerate chain, parity"
    check_parity_outputs(dens1, dens2, p, p * (p - 1) // 2)
    idx = list(range(p))
    infos = [mc._initParamRanges(j) for j in idx]
    pair_fine, _ = mc._parity_pairs(idx, infos)
    wide = wide_groups(label, {fine: len(members) for fine, members in pair_fine.items()})
    wide_bins = {}
    for fn in entries:
        for fine, count in launches[fn.__name__]["wide_bins"].items():
            wide_bins[fine] = wide_bins.get(fine, 0) + count
    check(wide_bins == {fine: 1 for fine in wide}, f"{label}: wide launches {launches}")
    print(f"{label}: fastParityDensities {par_s:.2f} s (one call, fresh MCSamples); pairs per fine grid "
          f"{json.dumps({f: len(m) for f, m in pair_fine.items()})}; launches {json.dumps(launches)}; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in mc.parity_profile.items()))
    # the groups' rows as fastParityDensities bins them (the reference _binSamples ranges)
    pad = np.array([(i.range_max - i.range_min) * 0.1 for i in infos])
    binmin = np.array([min(i.param_min, i.range_min) for i in infos]) - np.where([i.has_limits_bot for i in infos], 0, pad)
    binmax = np.array([max(i.param_max, i.range_max) for i in infos]) + np.where([i.has_limits_top for i in infos], 0, pad)
    st = mc._parity_chain()
    check(st["hist_weights"].dtype == torch.uint8, f"{label}: integer weights go to the wide kernels as uint8")
    for fine in sorted(wide, reverse=True):
        members = pair_fine[fine]
        params_in = sorted({c for a, b, _ in members for c in (a, b)})
        local = {c: i for i, c in enumerate(params_in)}
        sel = st["samples"][:, torch.as_tensor(params_in, device="cuda")]
        ix = pair_hist.narrow_rows(pdev.bin_indices(sel, binmin[params_in], (binmax - binmin)[params_in] / (fine - 1)),
                                   fine)
        pa = torch.tensor([local[a] for a, _, _ in members], dtype=torch.int32, device="cuda")
        pb = torch.tensor([local[b] for _, b, _ in members], dtype=torch.int32, device="cuda")
        entry = entries[0] if pdev.static_route(len(params_in), len(members)) else entries[1]
        rows.append(wide_row(f"{entry.__name__}_wide_parity_{fine}bins", entry, ix, st["hist_weights"], pa, pb, fine,
                             st["integer"], launches[entry.__name__]["wide_bins"].get(fine, 0), pair_hist))
    return rows


def check_bounded_outputs(d1, d2, pairs, kinds, label):
    """The bounded chain's outputs: every served grid finite, peak 1 and
    non-negative (no value below -1e-6 of the peak: f32 round-off of the
    convolutions in empty tails); the grid starts at the limit on each
    lower-limited column and ends at it on each upper-limited one; a
    periodic parameter's 1D density, and a pair's grid along a periodic
    axis whose other parameter has no active limit, equal at both ends (the
    wrap line). Like curves and grids lie in [-1e-6, 1]. Returns the
    largest wrap-line difference on pairs of a periodic and an actively
    limited parameter (the JAX package's boundary correction there is not
    periodic, ROADMAP C11)."""
    import torch

    p = d1["P"].shape[0]
    check_entry_outputs(d1, d2, pairs, p, label)
    per = d1["periodic"].cpu()
    act_lo, act_hi = d1["active_lo"].cpu(), d1["active_hi"].cpu()
    x = d1["x"].cpu()
    col = 0
    for kind, count in enumerate(kinds):
        for i in range(col, col + count):
            if kind in (0, 2):
                lim = 0.0 if kind == 0 else -1.0
                check(bool(act_lo[i]) and float(x[i, 0]) == lim,
                      f"{label}: x[0] at the lower limit of column {i}")
            if kind in (1, 2):
                # x[-1] = binmin + 1023 (binmax - binmin) / 1023, within f32 rounding of the limit
                lim = 1.0 if kind == 1 else 1.5
                check(bool(act_hi[i]) and abs(float(x[i, -1]) - lim) <= 1e-6,
                      f"{label}: x[-1] at the upper limit of column {i}")
            if kind == 3:
                check(bool(per[i]) and not act_lo[i] and not act_hi[i], f"{label}: column {i} periodic")
        col += count
    check(not bool(per[col:].any() | act_lo[col:].any() | act_hi[col:].any()), f"{label}: unbounded columns unflagged")
    check(float(d1["P"].min()) >= -1e-6, f"{label}: 1D grids non-negative")
    for i in torch.nonzero(per).flatten().tolist():
        check(abs(float(d1["P"][i, 0]) - float(d1["P"][i, -1])) <= 1e-6, f"{label}: 1D wrap of column {i}")
    limited = act_lo | act_hi
    wrap_limited = 0.0
    for k, (a, b) in enumerate(pairs):
        grid = (d2["regrid"][(a, b)]["P"] if (a, b) in d2["regrid"] else d2["P"][k]).cpu()
        check(float(grid.min()) >= -1e-6, f"{label}: 2D grid {(a, b)} non-negative ({float(grid.min())})")
        for axis, periodic, other in ((1, per[a], b), (0, per[b], a)):
            if periodic:
                diff = float((grid.select(axis, 0) - grid.select(axis, -1)).abs().max())
                if limited[other]:
                    wrap_limited = max(wrap_limited, diff)
                else:
                    check(diff == 0.0, f"{label}: wrap line of {(a, b)} on its periodic axis ({diff})")
    for name, likes in (("1D", d1["likes"]), ("2D", d2["likes"])):
        if likes is not None:
            check(bool(torch.isfinite(likes).all()) and float(likes.min()) >= -1e-6 and float(likes.max()) <= 1.0,
                  f"{label}: {name} like grids in [0, 1]")
    return wrap_limited


def bounded_cross_device(MCSamples):
    """The public entry with meanlikes on the card against the port on the
    CPU at 100k x 10 of a bounded chain (every 10th sample of
    ``bounded_chain(1M, 10)``: one column of each limit kind and one
    periodic): the same regrid keys, grids within the zoo's 5e-3, 1D and
    its like curves within 1e-4, the program's like grids within 5e-3."""
    samples, weights, loglikes, names, ranges = bounded_chain(1_000_000, p=10, kinds=(1, 1, 1, 1))
    kw = dict(samples=samples[::10].copy(), weights=weights[::10].copy(), loglikes=loglikes[::10].copy(),
              names=names, ranges=ranges)
    g1, g2, pairs = MCSamples(device="cuda", **kw).fastTriangleDensities(meanlikes=True)
    c1, c2, _ = MCSamples(device="cpu", **kw).fastTriangleDensities(meanlikes=True)
    check(set(g2["regrid"]) == set(c2["regrid"]), f"cross-device regrid keys {sorted(g2['regrid'])} {sorted(c2['regrid'])}")
    err2 = 0.0
    for k, key in enumerate(pairs):
        got = g2["regrid"][key]["P"] if key in g2["regrid"] else g2["P"][k]
        want = c2["regrid"][key]["P"] if key in c2["regrid"] else c2["P"][k]
        check(got.shape == want.shape, f"cross-device grid size of {key}")
        err2 = max(err2, float((got.cpu() - want).abs().max()))
    err1 = float((g1["P"].cpu() - c1["P"]).abs().max())
    like1 = float((g1["likes"].cpu() - c1["likes"]).abs().max())
    like2 = float((g2["likes"].cpu() - c2["likes"]).abs().max())
    check(err1 <= 1e-4 and like1 <= 1e-4 and err2 <= 5e-3 and like2 <= 5e-3,
          f"bounded entry cross-device 1D {err1}, 1D likes {like1}, 2D {err2}, 2D likes {like2}")
    return {"1D P": err1, "1D likes": like1, "2D P (served)": err2, "2D likes": like2, "regrid keys": len(g2["regrid"])}


def spectrum_row(name, kernels, pad, launches):
    """A K2 row at ``pad`` on ``kernels``, held within 1e-5 of max|ref| of
    its plain version in f32, 1e-12 in f64 (two f64 calls bitwise equal)."""
    import torch

    from getdist_tpu_torch.ops import dft_conv

    f64 = kernels.dtype == torch.float64
    tol = 1e-12 if f64 else 1e-5
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    scale = float(torch.maximum(ur0.abs().max(), ui0.abs().max()))
    err = max(float((ur - ur0).abs().max()), float((ui - ui0).abs().max()))
    check(err <= tol * scale, f"{name}: K2 within {tol} max|ref| ({err} vs {scale})")
    if f64:
        again = dft_conv.dft_conv_spectrum(kernels, pad)
        check(torch.equal(again[0], ur) and torch.equal(again[1], ui), f"{name}: two f64 K2 calls bitwise equal")
    b, by = spectrum_bound(kernels, pad)
    row = {
        "name": name,
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/dft_conv.cu",
        "replaces": "getdist_tpu/ops/dft_conv.py:155",
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum(kernels, pad), 5),
        "plain_ms": cuda_ms(lambda: dft_conv.dft_conv_spectrum_plain(kernels, pad), 5),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": library_spectrum_ms(kernels, pad, 5),
    }
    dft_report(f"K2 {'f64' if f64 else 'f32'} {name}", row, spectrum_work(kernels, pad),
               _dft_rate(kernels.element_size()))
    return row


def conv_row(name, kernels, grids, out_size, offset, pad, launches):
    """A K3 row at ``pad`` on ``grids`` with the spectra of ``kernels``,
    held within 1e-5 of max|ref| of its plain version (on the plain
    spectra), with the repeat-call and f64 checks of :func:`dft_checks`."""
    from getdist_tpu_torch.ops import dft_conv

    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    conv = dft_conv.dft_conv2d(grids, ur, ui, out_size, offset, pad)
    conv0 = dft_conv.dft_conv2d_plain(grids, ur0, ui0, out_size, offset, pad)
    err = float((conv - conv0).abs().max())
    check(err <= 1e-5 * float(conv0.abs().max()), f"{name}: K3 within 1e-5 max|ref| ({err})")
    b, by = conv_bound(grids, pad, out_size)
    row = {
        "name": name,
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/dft_conv.cu",
        "replaces": "getdist_tpu/ops/dft_conv.py:190",
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, out_size, offset, pad), 5),
        "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(grids, ur0, ui0, out_size, offset, pad), 5),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": library_conv_ms(grids, kernels, out_size, offset, 3),
    }
    dft_checks(kernels, grids, ur, ui, conv, out_size, offset, pad, f"K2/K3 f32, {name}")
    dft_report(f"K3 f32 {name}", row, conv_work(grids, pad, out_size), TF32X3_FLOPS)
    return row


def bounded_phase(bounded, batched, dft_conv, pair_hist):
    """Phase 6: the public entry on ``bounded_chain(1M)`` (30 x 1M with
    lower, upper and two-sided limits and periodic columns, loglikes):
    cold and warm walls with meanlikes off and on, launches per kernel, the
    idle share and stage split of one profiled call, checks of the outputs,
    ``triangle_densities`` with the same limits, periodic flags and like
    weights; kernel rows of K1 with the f32 like weights, of K3 on the
    periodically extended grids and on the edge-mask stack (the input
    fine + 2 winw wide), and of K2 and K3 at the clamped rescue's frame on
    its own pairs; the entry on the card against the CPU at 100k x 10.
    ``bounded``: the chain's arrays."""
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples

    samples, weights, loglikes, names, ranges = bounded
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    hist = pair_hist.pair_histograms

    def reset():
        for fn in counters:
            fn.launches = 0
        hist.float_launches = hist.wide_launches = 0
        hist.wide_bins.clear()
        dft_conv.dft_conv_spectrum.frames.clear()
        dft_conv.dft_conv2d.inputs.clear()

    def read():
        out = {fn.__name__: fn.launches for fn in counters}
        out.update(float=hist.float_launches, wide=hist.wide_launches, wide_bins=dict(hist.wide_bins),
                   spectrum_frames=dict(dft_conv.dft_conv_spectrum.frames),
                   conv_inputs={f"{pad}:{size}": n for (pad, size), n in dft_conv.dft_conv2d.inputs.items()})
        return out

    t0 = time.perf_counter()
    mc = MCSamples(samples=samples, weights=weights, loglikes=loglikes, names=names, ranges=ranges, device="cuda")
    print(f"bounded chain: MCSamples built in {time.perf_counter() - t0:.2f} s")
    label = "public entry, bounded chain 30 x 1M"
    for meanlikes in (False, True):
        run = lambda: mc.fastTriangleDensities(meanlikes=meanlikes)  # noqa: E731
        cold_s, _ = wall_s(run)
        reset()
        warm_s, (d1, d2, pairs) = wall_s(run)
        launches = read()
        walls = [warm_s] + [wall_s(run)[0] for _ in range(1)]
        tag = f"{label}, meanlikes={meanlikes}"
        print(f"{tag}: first call {cold_s * 1e3:.1f} ms, warm {min(walls) * 1e3:.1f} ms (min of 2: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in walls)}); launches of one run: {json.dumps(launches)}; stage "
              "split (s): " + ", ".join(f"{k} {v:.4f}" for k, v in mc.fast_profile.items()))
        check("program_b" in mc.fast_profile, f"{tag}: two programs")
        check(launches["pair_histograms"] >= 1 + meanlikes and launches["dft_conv_spectrum"] >= 1
              and launches["dft_conv2d"] >= 2, f"{tag}: the run launched K1, K2 and K3")
        like_runs = int(meanlikes) * (1 + len(mc.fast_regrid_groups))
        check(launches["float"] == like_runs,
              f"{tag}: K1 with f32 like weights with meanlikes, once in program B and once in each rerun "
              f"({launches['float']} of {like_runs})")
        check(launches["conv_inputs"].get("384:316", 0) >= 6, f"{tag}: K3 on the extended grids")
        wrap = check_bounded_outputs(d1, d2, pairs, BOUNDED_KINDS, tag)
        check((d1["likes"] is not None) == meanlikes and (d2["likes"] is not None) == meanlikes, f"{tag}: like grids")
        print(f"{tag}: outputs checked; wrap-line difference on pairs of a periodic and a limited parameter "
              f"{wrap:.4g} (the JAX package's non-periodic boundary correction, ROADMAP C11); regrid groups "
              + json.dumps([dict(g, pairs=len(g["pairs"])) for g in mc.fast_regrid_groups]))
    busy_ms, wall_ms, rows = entry_call(mc, meanlikes=True)
    mc.fast_profile = dict(mc.fast_profile)
    print_entry_profile(f"{label}, meanlikes=True", mc, busy_ms, wall_ms, rows)

    # the fused program alone, with the same limits, periodic flags and like weights
    st = mc._fast_chain_state()
    lo, hi, per = limit_arrays(names, ranges)

    def program():
        return batched.triangle_densities(st["samples"], st["weights"], limits_lo=lo, limits_hi=hi, periodic=per,
                                          like_weights=st["like_weights"], int8_weights=True, device="cuda")

    cold_s, _ = wall_s(program)
    warm_s, (t1, t2) = wall_s(program)
    check_bounded_outputs(t1, dict(t2, regrid={}), pairs, BOUNDED_KINDS, "triangle_densities, bounded chain")
    print(f"triangle_densities, bounded chain 30 x 1M (limits, periodic, like weights): first call "
          f"{cold_s * 1e3:.1f} ms, warm {warm_s * 1e3:.1f} ms")

    # kernel rows on this run's inputs
    s_dev, w_dev, lw = st["samples"], st["weights"], st["like_weights"]
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    k = len(pairs)
    got = hist(ix, lw, pa, pb, integer_weights=False)
    plain = pair_hist.pair_histograms_plain(ix, lw, pa, pb, integer_weights=False)
    err_l = float((got - plain).abs().max())
    check(err_l == 0.0, f"K1 with f32 like weights: bit-exact against the plain version (fixed point too): {err_l}")
    del plain
    # fixed point (each weight rounded to a multiple of 2^-62 of max |w| *
    # N) against the f64 sums, each rounded to f32 once: each bin within
    # 1e-6 of itself plus 1e-9 of its pair's peak bin, and the bins below
    # 1e-3 of the peak (the low-likelihood tails, where the like weights are
    # smallest) within 1e-7 of their pair's tail sum
    ref = exact_pair_sums(ix, lw, pa, pb, 256).float()
    peak = ref.amax(dim=(1, 2), keepdim=True)
    diff = (got - ref).abs()
    worst = float((diff / (1e-6 * ref.abs() + 1e-9 * peak)).max())
    check(worst <= 1.0, f"K1 with f32 like weights per bin within 1e-6 (+1e-9 of the pair's peak): {worst}")
    tail = ref < 1e-3 * peak
    tail_sum = torch.where(tail, ref, 0.0).double().sum(dim=(1, 2))
    tail_err = torch.where(tail, diff, 0.0).double().sum(dim=(1, 2))
    tail_rel = float((tail_err / tail_sum.clamp_min(1e-30)).max())
    check(tail_rel <= 1e-7, f"K1 with f32 like weights: tail bins within 1e-7 of each pair's tail sum ({tail_rel})")
    same = torch.equal(got, hist(ix, lw, pa, pb, integer_weights=False))
    check(same, "K1 with f32 like weights: two calls bitwise equal")
    print(f"K1, f32 like weights: max abs diff to plain {err_l:.3g}, to the f64 sums at most {worst:.3g} of the "
          f"per-bin tolerance, tails "
          f"{tail_rel:.3g} of their sum ({int(tail.sum())} tail bins), two calls bitwise equal: {same}")
    del got, ref, diff, tail
    b_l, by_l = hist_bound(ix, lw, k, 256)
    rows = [
        {
            "name": "pair_histograms_like_f32",
            "route": "cuda",
            "source": "getdist_tpu_torch/csrc/pair_hist.cu",
            "replaces": "getdist_tpu/ops/pallas_kernels.py:309",
            "launches": launches["float"],
            "max_abs_err": err_l,
            "ms": cuda_ms(lambda: hist(ix, lw, pa, pb, integer_weights=False), 10),
            "plain_ms": cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, lw, pa, pb, integer_weights=False), 2),
            "bound_ms": b_l,
            "bound_by": by_l,
            "library_ms": library_hist_ms(ix, lw, pa, pb, 256, 3),
        }
    ]
    hists = hist(ix, pair_hist.narrow_weights(w_dev), pa, pb, integer_weights=True)
    kernels = batched._gauss_kernel_2d(d2["rx"], d2["ry"], d2["corr"], 30)
    per_t = d1["periodic"]
    ext_grids = batched._extend_periodic(hists, per_t[pa.long()], per_t[pb.long()], 30)
    act_lo, act_hi = d1["active_lo"], d1["active_hi"]
    masks = batched._edge_masks(act_lo[pa.long()], act_hi[pa.long()], act_lo[pb.long()], act_hi[pb.long()], 256, 30,
                                torch.float32)
    n_ext = launches["conv_inputs"].get("384:316", 0)
    for name, grids in (("dft_conv2d_periodic_ext316", ext_grids), ("dft_conv2d_edge_masks_ext316", masks)):
        check(tuple(grids.shape) == (k, 316, 316), f"{name}: the extended input")
        rows.append(conv_row(name, kernels, grids, 256, 60, 384, n_ext))
    print(f"K3 launches on 316-wide inputs in the meanlikes run: {n_ext} (both rows: one kernel at one shape, "
          "counted by (frame, input size); the program's periodic grids and its edge masks)")
    del hists, ext_grids, masks

    # the clamped rescue's rerun: K2 and K3 at its 768 frame (winw 126), on
    # its pairs' kernels, 256-bin histograms and 508-wide edge masks
    group = next((g for g in mc.fast_regrid_groups if g["bandwidths"] == "clamped"), None)
    check(group is not None, "the bounded chain's run took the clamped rescue")
    winw = group["winw"]
    pad = dft_conv.frame_for(256 + 4 * winw + 1)
    ixg, pag, pbg, keys = entry_group_rows(s_dev, d1["range"], group, pair_hist, batched)
    grids = hist(ixg, pair_hist.narrow_weights(w_dev), pag, pbg, integer_weights=True)
    entries = [d2["regrid"][key] for key in keys]
    kernels = batched._gauss_kernel_2d(*(torch.stack([e[n] for e in entries]) for n in ("rx", "ry", "corr")), winw)
    ka = torch.tensor([a for a, _ in keys], device="cuda")
    kb = torch.tensor([b for _, b in keys], device="cuda")
    masks = batched._edge_masks(act_lo[ka], act_hi[ka], act_lo[kb], act_hi[kb], 256, winw, torch.float32)
    ext = 256 + 2 * winw
    print(f"clamped rescue: {len(keys)} pairs, window {winw}, frame {pad}; K2 launches at frame {pad}: "
          f"{launches['spectrum_frames'].get(pad, 0)}, K3 launches by input size: "
          f"{ {key: n for key, n in launches['conv_inputs'].items() if key.startswith(f'{pad}:')} }")
    rows.append(spectrum_row(f"dft_conv_spectrum_clamped_frame{pad}", kernels, pad,
                             launches["spectrum_frames"].get(pad, 0)))
    rows.append(conv_row(f"dft_conv2d_clamped_frame{pad}", kernels, grids, 256, winw, pad,
                         launches["conv_inputs"].get(f"{pad}:256", 0)))
    rows.append(conv_row(f"dft_conv2d_edge_masks_ext{ext}", kernels, masks, 256, 2 * winw, pad,
                         launches["conv_inputs"].get(f"{pad}:{ext}", 0)))
    del grids, masks, kernels, ixg
    del mc, st, d1, d2, t1, t2
    torch.cuda.empty_cache()
    report = bounded_cross_device(MCSamples)
    print(f"bounded entry cross-device 100k x 10 (cuda vs cpu), max abs diffs: {json.dumps(report)}")
    return rows


def parity_periodic_cross_device(MCSamples):
    """Parity on the card against the port on the CPU at 20k x 6 (a
    periodic, a limited and an unbounded column, a pair at corr 0.9):
    device parity with the chain's integer weights, and the host variant
    with importance weights; 2D within 1e-5 of the peak, 1D within 1e-10."""
    import numpy as np

    rng = np.random.RandomState(37)
    n = 20_000
    z = rng.standard_normal((n, 6))
    samples = z.copy()
    samples[:, 1] = 0.9 * z[:, 0] + np.sqrt(1 - 0.81) * z[:, 1]
    samples[:, 2] = np.abs(z[:, 2])
    samples[:, 3] = np.mod(1.5 * z[:, 3] + np.pi, 2 * np.pi)
    samples[:, 4] = 0.4 * z[:, 0] + z[:, 4]
    weights = rng.randint(1, 5, n).astype(np.float64)
    base = dict(samples=samples, names=[f"q{i}" for i in range(6)], ranges={"q2": [0, None], "q3": [0, 2 * np.pi, True]})
    report = {}
    for label, w, device_mode in (("device parity", weights, True),
                                  ("host variant", importance_weights(weights, 38), False)):
        g1, g2 = MCSamples(device="cuda", weights=w, **base).fastParityDensities(device=device_mode)
        c1, c2 = MCSamples(device="cpu", weights=w, **base).fastParityDensities(device=device_mode)
        check(set(g2) == set(c2) and set(g1) == set(c1), f"{label} cross-device keys")
        d1 = max(float(np.abs(g1[key].P - c1[key].P).max()) for key in c1)
        d2 = max(float(np.abs(g2[key].P / g2[key].P.max() - c2[key].P / c2[key].P.max()).max()) for key in c2)
        dc = max(float(np.abs(np.asarray(g2[key].contours) - np.asarray(c2[key].contours)).max()) for key in c2)
        check(d1 <= 1e-10 and d2 <= 1e-5 and dc <= 1e-5, f"{label} cross-device 1D {d1}, 2D {d2}, contours {dc}")
        report[label] = {"1D P": d1, "2D P / peak": d2, "2D contours": dc,
                         "fine grids": sorted({d.P.shape[0] for d in c2.values()})}
    return report


def periodic_conv_row(name, mc, bucket, launches, pair_hist, dft_conv, batched):
    """A row of f64 K3 on ``bucket``'s periodically extended grids: the
    bucket's pair count of K1 histograms at parity's grid edges, periodic
    pairs first, extended by ``_extend_periodic`` to (fine + 2 winw)^2,
    with kernels at its window; within 1e-12 of the largest value of its
    plain version, two calls bitwise equal, beside cuDNN's f64 conv2d."""
    import torch

    from getdist_tpu_torch.ops import parity_device as pdev

    p = mc.n
    kb, winw, fine = bucket["pairs"], bucket["winw"], bucket["fine"]
    infos = [mc._initParamRanges(j) for j in range(p)]
    binmin, binmax = mc._parity_grid_edges(infos)
    st = mc._parity_chain()
    ix = pdev.bin_indices(st["samples"], binmin, (binmax - binmin) / (fine - 1))
    ix = pair_hist.narrow_rows(ix, fine)
    per = [bool(info.periodic) for info in infos]
    pairs = sorted(((a, b) for a in range(p) for b in range(a + 1, p)), key=lambda ab: not (per[ab[0]] or per[ab[1]]))
    pa = torch.tensor([a for a, _ in pairs[:kb]], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs[:kb]], dtype=torch.int32, device="cuda")
    w_hist = st["hist_weights"] if st["integer"] else st["weights"].to(torch.float32)
    hists = pair_hist.pair_histograms(ix, w_hist, pa, pb, integer_weights=st["integer"], nbins=fine).double()
    per_t = torch.tensor(per, device="cuda")
    grids = batched._extend_periodic(hists, per_t[pa.long()], per_t[pb.long()], winw)
    ext = fine + 2 * winw
    check(tuple(grids.shape) == (kb, ext, ext), f"{name}: the extended input")
    widths = torch.linspace(0.8, winw / 2.5, kb, dtype=torch.float64, device="cuda")
    kernels = batched._gauss_kernel_2d(widths, widths.flip(0), torch.full_like(widths, 0.3), winw)
    pad = dft_conv.frame_for(fine + 4 * winw + 1)
    ur, ui = dft_conv.dft_conv_spectrum(kernels, pad)
    ur0, ui0 = dft_conv.dft_conv_spectrum_plain(kernels, pad)
    conv = dft_conv.dft_conv2d(grids, ur, ui, fine, 2 * winw, pad)
    conv0 = dft_conv.dft_conv2d_plain(grids, ur0, ui0, fine, 2 * winw, pad)
    err = float((conv - conv0).abs().max())
    check(err <= 1e-12 * float(conv0.abs().max()), f"{name}: f64 K3 within 1e-12 max|ref| ({err})")
    dft_checks(kernels, grids, ur, ui, conv, fine, 2 * winw, pad, f"K3 f64, {name}")
    b, by = conv_bound(grids, pad, fine)
    row = {
        "name": name,
        "route": "cuda",
        "source": "getdist_tpu_torch/csrc/dft_conv.cu",
        "replaces": "getdist_tpu/ops/dft_conv.py:190",
        "launches": launches["conv_inputs"].get(f"{pad}:{ext}", 0),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: dft_conv.dft_conv2d(grids, ur, ui, fine, 2 * winw, pad), 3),
        "plain_ms": cuda_ms(lambda: dft_conv.dft_conv2d_plain(grids, ur0, ui0, fine, 2 * winw, pad), 3),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": library_conv_ms(grids, kernels, fine, 2 * winw, 1),
    }
    print(f"{name}: {kb} pairs ({sum(per[a] or per[b] for a, b in pairs[:kb])} with a periodic axis), window "
          f"{winw}, input {ext}^2, frame {pad}; K3 launches on {ext}-wide inputs in the run: {row['launches']}")
    dft_report(f"K3 f64 {name}", row, conv_work(grids, pad, fine), FP64_FLOPS)
    return row


def parity_bounded_phase(bounded, batched, dft_conv, pair_hist):
    """Phase 7: parity mode on ``bounded_chain(1M)`` (30 x 1M, two periodic
    columns): device parity, one call (stage profile, buckets, launches
    per kernel, outputs), a row of f64 K3 on its largest bucket's
    periodically extended grids; the same chain with importance weights
    (``importance_weights``, fractional): device parity routed to the host
    variant and the host variant called directly (walls, stages, equal
    results), a row of f64 K3 on the host variant's largest bucket when its
    shape differs; parity card against CPU at 20k x 6."""
    import logging

    import numpy as np
    import torch

    from getdist_tpu_torch.mcsamples import MCSamples

    samples, weights, loglikes, names, ranges = bounded
    p = samples.shape[1]
    k = p * (p - 1) // 2
    counters = (pair_hist.pair_histograms, pair_hist.pair_histograms_dynamic, dft_conv.dft_conv_spectrum,
                dft_conv.dft_conv2d)

    def reset():
        for fn in counters:
            fn.launches = 0
        dft_conv.dft_conv2d.inputs.clear()
        dft_conv.dft_conv_spectrum.kernels.clear()

    def read():
        out = {fn.__name__: fn.launches for fn in counters}
        out["conv_inputs"] = {f"{pad}:{size}": n for (pad, size), n in dft_conv.dft_conv2d.inputs.items()}
        out["spectrum_kernels"] = {f"{pad}:{m}": n for (pad, m), n in dft_conv.dft_conv_spectrum.kernels.items()}
        return out

    def fresh(w):
        return MCSamples(samples=samples, weights=w, names=names, ranges=ranges, device="cuda")

    label = "parity, bounded chain 30 x 1M"
    mc = fresh(weights)
    reset()
    cold_s, (dens1, dens2) = wall_s(lambda: mc.fastParityDensities(device=True))
    launches = read()
    check(all(launches[fn.__name__] >= 1 for fn in counters), f"{label}: K1, K4, K2 and K3 launched ({launches})")
    check_parity_outputs(dens1, dens2, p, k)
    buckets = list(mc.parity_buckets)
    ext_ran = [b for b in buckets if any(key.endswith(f":{b['fine'] + 2 * b['winw']}") for key in launches["conv_inputs"])]
    check(len(ext_ran) == len(buckets), f"{label}: every bucket's K3 ran on its periodically extended grids")
    print(f"{label}: first call {cold_s:.2f} s; launches of the run: {json.dumps(launches)}; "
          "stages (s): " + ", ".join(f"{key} {sec:.3f}" for key, sec in mc.parity_profile.items())
          + f"; buckets {json.dumps(buckets)}")
    bucket = max((b for b in buckets if b["fine"] == 256), key=lambda b: b["pairs"])
    rows = [periodic_conv_row(f"dft_conv2d_f64_periodic_ext{256 + 2 * bucket['winw']}", mc, bucket, launches,
                              pair_hist, dft_conv, batched)]
    # f64 K2 at each bucket's shape: its pairs' kernels, (2 winw + 1)^2, at
    # the bucket's frame, with the run's launches at that (frame, size)
    for b in sorted(buckets, key=lambda b: (b["winw"], b["fine"])):
        winw, m = b["winw"], 2 * b["winw"] + 1
        pad = dft_conv.frame_for(b["fine"] + 4 * winw + 1)
        widths = torch.linspace(0.8, winw / 2.5, b["pairs"], dtype=torch.float64, device="cuda")
        kernels = batched._gauss_kernel_2d(widths, widths.flip(0), torch.full_like(widths, 0.3), winw)
        check(tuple(kernels.shape) == (b["pairs"], m, m), f"bounded parity K2 rows: bucket {b}'s kernels")
        rows.append(spectrum_row(f"dft_conv_spectrum_f64_w{winw}_frame{pad}", kernels, pad,
                                 launches["spectrum_kernels"].get(f"{pad}:{m}", 0)))
        print(f"K2 f64, bounded parity bucket fine {b['fine']} winw {winw} ({b['pairs']} pairs, {m}^2 kernels, "
              f"frame {pad}): launches at this shape in the run {rows[-1]['launches']}")
    check(sum(launches["spectrum_kernels"].values()) == launches["dft_conv_spectrum"],
          f"bounded parity: K2 launches by shape add up ({launches['spectrum_kernels']})")
    del mc, dens1, dens2
    torch.cuda.empty_cache()

    frac = importance_weights(weights, 32)
    h_label = "host variant, bounded chain with importance weights, 30 x 1M"
    check(not np.all(frac == np.round(frac)), "the importance weights are fractional")
    mc = fresh(frac)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger().addHandler(handler)
    reset()
    try:
        routed_s, (r1, r2) = wall_s(lambda: mc.fastParityDensities(device=True))
    finally:
        logging.getLogger().removeHandler(handler)
    launches_h = read()
    check(any("host parity variant" in rec.getMessage() for rec in records), f"{h_label}: device mode warned")
    check("hists_bandwidths" in mc.parity_profile, f"{h_label}: device mode routed to the host variant")
    check(launches_h["dft_conv_spectrum"] >= 1 and launches_h["dft_conv2d"] >= 1
          and launches_h["pair_histograms"] == launches_h["pair_histograms_dynamic"] == 0,
          f"{h_label}: K2 and K3 launched, no device histogram ({launches_h})")
    check_parity_outputs(r1, r2, p, k)
    routed_profile, h_buckets = dict(mc.parity_profile), list(mc.parity_buckets)
    mc = fresh(frac)
    direct_s, (h1, h2) = wall_s(lambda: mc.fastParityDensities(device=False))
    same = all(np.array_equal(r1[key].P, h1[key].P) for key in h1) and all(
        np.array_equal(r2[key].P, h2[key].P) for key in h2)
    check(same, f"{h_label}: the routed call equals the direct one")
    print(f"{h_label}: fastParityDensities(device=True) routed {routed_s:.2f} s, device=False {direct_s:.2f} s "
          "(equal results); launches of the routed run: " + json.dumps(launches_h) + "; stages of the routed run "
          "(s): " + ", ".join(f"{key} {sec:.3f}" for key, sec in routed_profile.items()) + "; of the direct run: "
          + ", ".join(f"{key} {sec:.3f}" for key, sec in mc.parity_profile.items()) + f"; buckets {json.dumps(h_buckets)}")
    h_bucket = max((b for b in h_buckets if b["fine"] == 256), key=lambda b: b["pairs"])
    if (h_bucket["winw"], h_bucket["pairs"]) != (bucket["winw"], bucket["pairs"]):
        rows.append(periodic_conv_row(f"dft_conv2d_f64_host_periodic_ext{256 + 2 * h_bucket['winw']}", mc, h_bucket,
                                      launches_h, pair_hist, dft_conv, batched))
    del mc, r1, r2, h1, h2
    torch.cuda.empty_cache()
    report = parity_periodic_cross_device(MCSamples)
    print(f"parity cross-device 20k x 6 with a periodic and a limited column (cuda vs cpu), max abs diffs: "
          f"{json.dumps(report)}")
    return rows


def write_chain_text(path, table):
    """One chain file: rows of weight, -log(like) and the parameters, every
    f64 in full (%.17g). Module level: the files phase writes its four
    files in four processes."""
    import numpy as np

    np.savetxt(path, table, fmt="%.17g")


def entries_bitwise(got, want):
    """Whether two results of the public entry ((d1, d2, pairs)) are equal
    bit for bit: every tensor of d1 and d2, the pairs, and every rerun's
    grid, contours and kernel."""
    import torch

    if got[2] != want[2] or set(got[1]["regrid"]) != set(want[1]["regrid"]):
        return False
    reruns = all(torch.equal(torch.as_tensor(got[1]["regrid"][key][name]), torch.as_tensor(value))
                 for key, entry in want[1]["regrid"].items() for name, value in entry.items())
    return reruns and bitwise(got[:2], want[:2])


def files_phase(bounded, card, pair_hist, dft_conv):
    """Phase 8: a chain root on disk through ``loadMCSamples`` into the
    public entry. ``bounded_chain(1M)`` (``bounded``) is written as a
    4-chain root of 250k rows each (``weight -loglike p1 ... p30``, with
    ``.paramnames`` and a ``.ranges`` of ``N`` bounds and periodic flags) in
    a temporary directory, deleted after. Each file parsed by the port's
    native loader is held bitwise against ``np.loadtxt``; the root loads
    cold (the loader) and warm (the pickle cache, in the same directory);
    ``fastTriangleDensities(meanlikes=True)`` runs cold and warm on the
    loaded object, with K1, K2 and K3 launched, its grids bitwise equal to
    the entry on an ``MCSamples`` built in memory from the loaded arrays and
    to the entry on the cache hit. Walls (host clock to
    ``torch.cuda.synchronize()``) beside ``card``."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    import getdist_tpu_torch
    from getdist_tpu_torch import _native
    from getdist_tpu_torch import mcsamples as tmc

    samples, weights, loglikes, names, ranges = bounded
    folder = tempfile.mkdtemp(prefix="chip_smoke_files_")
    saved_cache, saved_read = getdist_tpu_torch.cache_dir, tmc.MCSamples.readChains
    try:
        root = os.path.join(folder, "bounded")
        t0 = time.perf_counter()
        blocks = np.array_split(np.column_stack([weights, loglikes, samples]), 4)
        paths = [f"{root}_{i + 1}.txt" for i in range(4)]
        with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(write_chain_text, paths, blocks))
        with open(root + ".paramnames", "w", encoding="utf-8") as handle:
            handle.writelines(f"{name}\tb_{{{i}}}\n" for i, name in enumerate(names))
        with open(root + ".ranges", "w", encoding="utf-8") as handle:
            for name, window in ranges.items():
                lo, hi = ("N" if v is None else repr(float(v)) for v in window[:2])
                handle.write(f"{name} {lo} {hi}" + (" periodic" if len(window) > 2 and window[2] else "") + "\n")
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(path) for path in paths)
        print(f"files: bounded chain {len(samples):,} x {samples.shape[1]} written as a 4-chain root "
              f"({size / 1e9:.2f} GB of text) in {write_s:.1f} s (set-up, not a metric)")

        t0 = time.perf_counter()
        for path, block in zip(paths, blocks):
            got = _native.load_chain_text(path)
            check(got.shape == block.shape and np.array_equal(got, np.loadtxt(path)),
                  f"{os.path.basename(path)}: the port's loader bitwise equal to np.loadtxt")
            check(np.array_equal(got, block), f"{os.path.basename(path)}: the written values come back exactly")
        print(f"files: 4 files x ~{len(samples) // 4:,} rows parsed by the native loader bitwise equal to np.loadtxt "
              f"({time.perf_counter() - t0:.1f} s with np.loadtxt)")
        del got, blocks

        getdist_tpu_torch.cache_dir = os.path.join(folder, "cache")
        reads = []

        def counted(self, *a, **k):
            reads.append(1)
            return saved_read(self, *a, **k)

        tmc.MCSamples.readChains = counted
        load = lambda: getdist_tpu_torch.loadMCSamples(root, settings={"ignore_rows": 0}, no_cache=False,  # noqa: E731
                                                       device="cuda")
        cold_load_s, mc = wall_s(load)
        hit_load_s, mc_hit = wall_s(load)
        check(len(reads) == 1 and mc_hit is not mc and os.path.exists(tmc._cache_path(root)),
              f"files: the second load is a cache hit ({len(reads)} chain reads)")
        for obj, tag in ((mc, "cold load"), (mc_hit, "cache hit")):
            check(np.array_equal(obj.samples, samples) and np.array_equal(obj.weights, weights)
                  and np.array_equal(obj.loglikes, loglikes) and obj.paramNames.list() == list(names)
                  and obj.device == torch.device("cuda"), f"files: {tag} holds the chain's arrays and names")
            check(obj.ranges.periodic == {n for n, w in ranges.items() if len(w) > 2 and w[2]}
                  and all(obj.ranges.getLower(n) == w[0] and obj.ranges.getUpper(n) == w[1]
                          for n, w in ranges.items()), f"files: {tag} holds the chain's ranges")

        counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
        entry = lambda obj: obj.fastTriangleDensities(meanlikes=True)  # noqa: E731
        cold_entry_s, _ = wall_s(lambda: entry(mc))
        for fn in counters:
            fn.launches = 0
        pair_hist.pair_histograms.float_launches = 0
        first_s, got = wall_s(lambda: entry(mc))
        launches = {fn.__name__: fn.launches for fn in counters}
        launches["float"] = pair_hist.pair_histograms.float_launches
        like_runs = 1 + len(mc.fast_regrid_groups)
        check(launches["pair_histograms"] >= 2 and launches["float"] == like_runs
              and launches["dft_conv_spectrum"] >= 1 and launches["dft_conv2d"] >= 2,
              f"files: the entry on the loaded root launched K1 (with like weights once in program B and once "
              f"in each of its {like_runs - 1} reruns), K2 and K3 ({launches})")
        warm_entry_s = min([first_s] + [wall_s(lambda: entry(mc))[0] for _ in range(1)])
        pairs = [(a, b) for a in range(len(names)) for b in range(a + 1, len(names))]
        check_bounded_outputs(got[0], got[1], pairs, BOUNDED_KINDS, "files: entry on the loaded root")
        memory = tmc.MCSamples(samples=mc.samples, weights=mc.weights, loglikes=mc.loglikes,
                               names=mc.paramNames.list(), ranges=mc.ranges, device="cuda")
        same_memory = entries_bitwise(got, entry(memory))
        del memory
        hit_cold_s, hit = wall_s(lambda: entry(mc_hit))
        same_hit = entries_bitwise(got, hit)
        check(same_memory, "files: the entry on the loaded root bitwise equals the entry on the same arrays in memory")
        check(same_hit, "files: the entry on the cache hit bitwise equals the cold load's")
        print(f"files, bounded chain {len(samples):,} x {samples.shape[1]} as a 4-file root ({card}): "
              f"loadMCSamples cold (native loader) {cold_load_s * 1e3:.1f} ms, cache hit {hit_load_s * 1e3:.1f} ms; "
              f"fastTriangleDensities(meanlikes=True) on the loaded object cold {cold_entry_s * 1e3:.1f} ms, warm "
              f"{warm_entry_s * 1e3:.1f} ms (min of 2), on the cache hit's first call {hit_cold_s * 1e3:.1f} ms; "
              f"launches {json.dumps(launches)}; bitwise equal to the in-memory entry {same_memory} and the cache "
              f"hit's {same_hit}; regrid groups "
              + json.dumps([dict(g, pairs=len(g["pairs"])) for g in mc.fast_regrid_groups]))
        del mc, mc_hit, got, hit
        torch.cuda.empty_cache()
        tmc.MCSamples.readChains = saved_read
        host_pair_walls = host_api_phase(root, names, ranges, card, pair_hist, dft_conv)
        cli_phase(root, names, ranges, card, pair_hist, dft_conv)
        plot_grids = plot_data_phase(root, names, ranges, samples, card, pair_hist, dft_conv, host_pair_walls)
        interop_gui_phase(root, bounded, card, pair_hist, dft_conv, plot_grids)
    finally:
        getdist_tpu_torch.cache_dir = saved_cache
        tmc.MCSamples.readChains = saved_read
        shutil.rmtree(folder, ignore_errors=True)


def triangle_requests(names, conts=2, shade_meanlikes=False):
    """The data-layer requests of ``GetDistPlotter.triangle_plot`` on one
    root of ``names`` at default settings but ``shade_meanlikes``, in order:
    ``("1d", name, likes)`` for each parameter (the diagonal), then
    ``("2d", x, y, conts, likes)`` for each pair below it, column before
    row (``tests/test_torch_plots.py`` pins them against the port's
    plotter and the JAX package's)."""
    from itertools import combinations

    return ([("1d", name, False) for name in names]
            + [("2d", x, y, conts, shade_meanlikes) for x, y in combinations(names, 2)])


CONVERGE_TESTS = ("MeanVar", "GelmanRubin", "SplitTest", "RafteryLewis", "CorrLengths", "CorrSteps")
# the host-API phase's bars, routed against host: limits within this
# fraction of the parameter's sd; 2D densities within this fraction of the
# peak where the host density is above 0.05 of it (tests/test_fused_routing.py's)
ROUTED_LIMIT_SD = 0.02
ROUTED_2D_PEAK = 1.5e-2
# routed 1D densities against the host's, of the peak (tests/test_fused_routing.py)
ROUTED_1D_PEAK = 6e-3
# a limit's tag may differ where the 1D density at the prior edge lies this
# close to the two-tail threshold (max_frac_twotail)
TAG_EDGE_BAND = 1e-3


def routed_1d_diff(got, want):
    """Max difference of the peak-normalized 1D densities on 300 points of
    their common range (tests/test_fused_routing.py's measure)."""
    import numpy as np

    grid = np.linspace(max(got.x[0], want.x[0]), min(got.x[-1], want.x[-1]), 300)
    return float(np.max(np.abs(got.Prob(grid) / got.P.max() - want.Prob(grid) / want.P.max())))


def routed_2d_diff(got, want, likes=False):
    """Max difference of the peak-normalized 2D densities (with ``likes``,
    of the like grids, interpolated) on 80^2 points of their common range
    where ``want``'s density is above 0.05 of its peak."""
    import numpy as np
    from scipy.interpolate import RectBivariateSpline

    gx = np.linspace(max(got.x[0], want.x[0]), min(got.x[-1], want.x[-1]), 80)
    gy = np.linspace(max(got.y[0], want.y[0]), min(got.y[-1], want.y[-1]), 80)
    x, y = (a.ravel() for a in np.meshgrid(gx, gy))
    sel = want(x, y, grid=False) / want.P.max() > 0.05
    if likes:
        fg, fw = (RectBivariateSpline(d.x, d.y, d.likes.T)(gx, gy).T.ravel() for d in (got, want))
    else:
        fg, fw = got(x, y, grid=False) / got.P.max(), want(x, y, grid=False) / want.P.max()
    return float(np.max(np.abs(fg[sel] - fw[sel])))


def host_api_phase(root, names, ranges, card, pair_hist, dft_conv):
    """Phase 9: the host ``MCSamples`` analysis API on the files phase's
    root (loaded from its pickle cache, on the card). Routed (the default
    on a CUDA object): ``getMargeStats()`` cold (the first object) and warm
    (a fresh object), each one fused program (one
    ``_fused_cache`` entry) that launches K1, K2 and K3; ``getLikeStats()``,
    ``getConvergeTests()`` with all six tests (integer weights 1-4),
    ``getTable().tableTex()`` and ``getInlineLatex``, with walls. Then the
    same calls with ``GETDIST_TPU_TORCH_FUSED=0`` on a fresh object (the
    host path: 30 host 1D KDEs with N_eff), and routed against host: means
    and sds bitwise, limit tags equal (except where the 1D density at a
    prior edge lies within TAG_EDGE_BAND of ``max_frac_twotail``: listed),
    limits within ROUTED_LIMIT_SD of the sd, ``.likestats`` and
    ``.converge`` byte-identical, the 1D densities of the free, two-sided
    and periodic parameters within ROUTED_1D_PEAK of the peak (those of the
    one-sided limited ones printed with no bar: at the limit the fused
    boundary correction departs from the host's, the JAX package's alike,
    ROADMAP C14), ``get2DDensity`` on a free x free,
    limited x free and periodic x free pair within ROUTED_2D_PEAK of the
    peak; a limited x periodic pair's difference printed with no bar
    (ROADMAP C11). Routed meanlikes ``get2DDensityGridData`` (K1 with like
    weights) on a pair of the program and on a pair the fused run reran
    (the rerun bins the like weights at its grid): both carry like grids,
    no query is served by the host, and their like grids are within
    ROUTED_2D_PEAK of the host's where its density is above 0.05 of the
    peak."""
    import numpy as np
    import torch

    import getdist_tpu_torch

    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    load = lambda: getdist_tpu_torch.loadMCSamples(root, device="cuda")  # noqa: E731
    saved_flag = os.environ.pop("GETDIST_TPU_TORCH_FUSED", None)
    try:
        mc = load()
        check(mc._fused_route_enabled(), "host API: a CUDA MCSamples routes its density queries")
        for fn in counters:
            fn.launches = 0
        cold_s, marge = wall_s(mc.getMargeStats)
        launches = {fn.__name__: fn.launches for fn in counters}
        check(all(launches.values()), f"host API: the routed getMargeStats launched K1, K2 and K3 ({launches})")
        check(list(mc._fused_cache) == [False], f"host API: one fused program ({list(mc._fused_cache)})")
        warm, fused = [], []
        for _ in range(1):
            fresh = load()
            warm.append(wall_s(fresh.getMargeStats)[0])
            check(list(fresh._fused_cache) == [False], "host API: one fused program (warm)")
            fused.append(sum(v for k, v in fresh.fast_profile.items() if k != "host_served"))
        del fresh
        walls = {"getMargeStats cold": cold_s, "getMargeStats warm": min(warm),
                 "of which the fused run (fast_profile)": fused[warm.index(min(warm))]}
        walls["getLikeStats"], likestats = wall_s(mc.getLikeStats)
        walls["getConvergeTests"], converge = wall_s(lambda: mc.getConvergeTests(what=CONVERGE_TESTS))
        walls["tableTex"], table = wall_s(lambda: mc.getTable().tableTex())
        walls["getInlineLatex"], inline = wall_s(lambda: [mc.getInlineLatex(n) for n in names])
        check(converge and "Raftery&Lewis" in converge and "auto-correlations" in converge,
              "host API: the convergence report holds all six tests")
        print(f"host API, routed, {card}: " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in walls.items())
              + f"; launches of the cold getMargeStats {json.dumps(launches)}; {names[0]}: {inline[0]}")

        free, limited, periodic = (next(n for n in names if n not in ranges),
                                   next(n for n, w in ranges.items() if len(w) == 2),
                                   next(n for n, w in ranges.items() if len(w) == 3))
        other = [n for n in names if n not in ranges][1]
        pairs = {"free x free": (free, other), "limited x free": (limited, free),
                 "periodic x free": (periodic, free), "limited x periodic": (limited, periodic)}
        routed_2d = {key: mc.get2DDensity(*pair) for key, pair in pairs.items()}
        # meanlikes queries: the first pair the fused run served from its
        # program's grids and the first it reran, and the first of each whose
        # like grid is held against the host's (no parameter at a one-sided
        # limit, ROADMAP C14, and no periodic x limited pair, C11)
        one_sided = {n for n, w in ranges.items() if len(w) == 2 and (w[0] is None) != (w[1] is None)}
        bounded_names = {n for n, w in ranges.items() if len(w) == 2}
        angles = {n for n, w in ranges.items() if len(w) == 3}

        def held(key):
            return not set(key) & one_sided and not (set(key) & bounded_names and set(key) & angles)

        rerun = {pair for group in mc.fast_regrid_groups for pair in group["pairs"]}
        check(bool(rerun), "host API: the fused run reran pairs (the clamped rescue)")
        index_pairs = [(a, b) for a in range(len(names)) for b in range(a + 1, len(names))]
        in_program = [(names[a], names[b]) for a, b in index_pairs if (a, b) not in rerun]
        reran = [(names[a], names[b]) for a, b in sorted(rerun)]
        queries = list(dict.fromkeys([in_program[0], next(key for key in in_program if held(key)), reran[0],
                                      next(key for key in reran if held(key))]))
        for fn in counters:
            fn.launches = 0
        pair_hist.pair_histograms.float_launches = 0
        served = mc.fast_profile.get("host_served", 0)
        walls_ml, _ = wall_s(lambda: mc.get2DDensityGridData(*queries[0], meanlikes=True))
        like_launches = pair_hist.pair_histograms.float_launches
        routed_likes = {key: mc.get2DDensityGridData(*key, meanlikes=True) for key in queries}
        for key, grid in routed_likes.items():
            check(grid.likes is not None and np.isfinite(grid.likes).all() and grid.likes.max() == 1.0,
                  f"host API: the routed meanlikes query {key} carries its like grid")
        check(mc.fast_profile.get("host_served", 0) == served and like_launches >= 2,
              f"host API: the routed meanlikes run ran K1 with like weights for the program and its reruns "
              f"({like_launches} like launches) and the host served no query "
              f"({mc.fast_profile.get('host_served', 0) - served})")
        print(f"host API, routed meanlikes get2DDensityGridData{queries[0]} {walls_ml * 1e3:.1f} ms (its own fused "
              f"run, like launches {like_launches}); queries {queries} (reruns among them "
              f"{[key for key in queries if key in reran]}) served from the run; fused cache "
              f"{sorted(mc._fused_cache)}; host_served {mc.fast_profile.get('host_served', 0)} (rerun pairs "
              f"{len(rerun)})")

        os.environ["GETDIST_TPU_TORCH_FUSED"] = "0"
        host = load()
        check(not host._fused_route_enabled(), "host API: GETDIST_TPU_TORCH_FUSED=0 forces the host path")
        host_walls = {}
        host_walls["getMargeStats"], host_marge = wall_s(host.getMargeStats)
        host_walls["getLikeStats"], host_like = wall_s(host.getLikeStats)
        host_walls["getConvergeTests"], host_converge = wall_s(lambda: host.getConvergeTests(what=CONVERGE_TESTS))
        host_walls["tableTex"], _ = wall_s(lambda: host.getTable().tableTex())
        host_2d = {}
        for key, pair in pairs.items():
            host_walls[f"get2DDensity {key}"], host_2d[key] = wall_s(lambda pair=pair: host.get2DDensity(*pair))
        host_likes = {}
        for key in routed_likes:
            host_walls[f"meanlikes get2DDensityGridData {key}"], host_likes[key] = wall_s(
                lambda key=key: host.get2DDensityGridData(*key, meanlikes=True))
        print(f"host API, host path (GETDIST_TPU_TORCH_FUSED=0), {card}: "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in host_walls.items()))

        check(str(likestats) == str(host_like), "host API: .likestats routed and host byte-identical")
        check(converge == host_converge, "host API: .converge routed and host byte-identical")
        edge_cases, worst_limit = [], 0.0
        for got, want in zip(marge.names, host_marge.names):
            check(got.name == want.name and got.mean == want.mean and got.err == want.err,
                  f"host API: {got.name} mean and sd bitwise routed and host")
            for level, (lg, lw) in enumerate(zip(got.limits, want.limits)):
                if lg.limitTag() != lw.limitTag():
                    density = mc.density1D[got.name], host.density1D[want.name]
                    edges = [d.P[i] for d in density for i in (0, -1)]
                    near = any(abs(e - mc.max_frac_twotail[level]) < TAG_EDGE_BAND for e in edges)
                    check(near, f"host API: {got.name} limit {level + 1} tag {lg.limitTag()} routed against "
                                f"{lw.limitTag()} host, edge densities {edges} not near the two-tail threshold")
                    edge_cases.append((got.name, level + 1, lg.limitTag(), lw.limitTag()))
                    continue
                diff = max(abs(lg.lower - lw.lower), abs(lg.upper - lw.upper)) / want.err
                worst_limit = max(worst_limit, diff)
                check(diff < ROUTED_LIMIT_SD, f"host API: {got.name} limit {level + 1} routed within "
                                              f"{ROUTED_LIMIT_SD} sd of host ({diff:.4f})")
        diffs_1d = {name: routed_1d_diff(mc.density1D[name], host.density1D[name]) for name in names}
        # a one-sided hard limit where the density peaks: the fused path's
        # boundary correction, the JAX package's too, departs from the host's
        # at the limit (ROADMAP C14): printed with no bar
        held_1d = {n: d for n, d in diffs_1d.items() if n not in one_sided}
        worst_1d = max(held_1d, key=held_1d.get)
        check(held_1d[worst_1d] < ROUTED_1D_PEAK, f"host API: every routed 1D density but the one-sided limited "
                                                  f"ones within {ROUTED_1D_PEAK} of the peak of host (worst "
                                                  f"{worst_1d} {held_1d[worst_1d]:.4g})")
        c14 = {n: round(diffs_1d[n], 6) for n in names if n in one_sided}
        diffs = {key: routed_2d_diff(routed_2d[key], host_2d[key]) for key in pairs}
        for key, diff in diffs.items():
            if key != "limited x periodic":
                check(diff < ROUTED_2D_PEAK, f"host API: routed get2DDensity {key} {pairs[key]} within "
                                             f"{ROUTED_2D_PEAK} of the peak of host ({diff:.4g})")
        like_diffs = {key: routed_2d_diff(routed_likes[key], host_likes[key], likes=True) for key in routed_likes}
        for key, diff in like_diffs.items():
            if held(key):
                check(diff < ROUTED_2D_PEAK, f"host API: routed like grid {key} within {ROUTED_2D_PEAK} of host "
                                             f"({diff:.4g})")
        print(f"host API, routed against host: means and sds bitwise; limits within {worst_limit:.3g} sd "
              f"(bar {ROUTED_LIMIT_SD}); limit tags differing at the two-tail threshold {edge_cases}; "
              f".likestats and .converge byte-identical; 1D densities of the free, two-sided and periodic "
              f"parameters within {held_1d[worst_1d]:.4g} of the peak (worst {worst_1d}; bar {ROUTED_1D_PEAK}), of "
              f"the one-sided limited ones {json.dumps(c14)} (no bar, ROADMAP C14); get2DDensity max diff of the peak "
              + json.dumps({f"{k} {pairs[k]}": round(v, 6) for k, v in diffs.items()})
              + " (limited x periodic: no bar, ROADMAP C11); meanlikes like grids max diff "
              + json.dumps({f"{k}": round(v, 6) for k, v in like_diffs.items()}) + f" (bar {ROUTED_2D_PEAK} on "
              f"{[k for k in like_diffs if held(k)]}; the others at a one-sided limit, ROADMAP C14, printed)")
        del mc, host, routed_2d, host_2d, routed_likes, host_likes
        torch.cuda.empty_cache()
        return [wall for key, wall in host_walls.items() if key.startswith("get2DDensity ")]
    finally:
        os.environ.pop("GETDIST_TPU_TORCH_FUSED", None)
        if saved_flag is not None:
            os.environ["GETDIST_TPU_TORCH_FUSED"] = saved_flag


# the CLI phase's bar: the device-ops run's numbers against the default
# run's, relative (or one unit of the last printed digit, where only the
# printing's rounding moves them)
CLI_REL = 1e-10
# the MCSamples methods whose walls the CLI phase prints inside its stages
CLI_TIMED = ("getConvergeTests", "writeCovMatrix", "writeCorrelationMatrix", "writeThinData", "PCA",
             "_setDensitiesandMarge1D", "getMargeStats", "getLikeStats")


_NUMBER = r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"


def _number_lines_differ(a, b):
    """None if two output lines agree: the same words, and every pair of
    numbers within CLI_REL relative or one unit of its last printed digit;
    else the largest relative difference of a pair that is not (inf where
    the words differ)."""
    import re

    if " ".join(re.sub(_NUMBER, "#", a).split()) != " ".join(re.sub(_NUMBER, "#", b).split()):
        return float("inf")
    worst = None
    for x, y in zip(re.findall(_NUMBER, a), re.findall(_NUMBER, b)):
        fx, fy = float(x), float(y)
        rel = abs(fx - fy) / max(abs(fx), abs(fy), 1e-300)
        mantissa, _, exponent = y.lower().partition("e")
        decimals = len(mantissa.split(".")[1]) if "." in mantissa else 0
        unit = 10.0 ** (int(exponent or 0) - decimals)
        if rel > CLI_REL and abs(fx - fy) > 1.01 * unit:
            worst = max(worst or 0.0, rel)
    return worst


def _read_bytes(path):
    with open(path, "rb") as handle:
        return handle.read()


def cli_phase(root, names, ranges, card, pair_hist, dft_conv):
    """Phase 10: the port's batch command (``getdist_tpu_torch.command_line``)
    on the files phase's root, on the card, into a temporary ``out_dir``:
    an ini from ``make_param_file`` with PCA of four free parameters,
    ``thin_factor`` 10 and plot scripts written (not run; 1D and one 3D
    plot). Run cold (the chains parsed from the root's text files) with
    the default host statistics: its wall, the walls of its stages and of
    ``getConvergeTests``, and its K1/K2/K3 launches (the routed 1D
    densities' fused program), each non-zero; every text output present.
    Then again with ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` (the chain
    statistics, autocorrelations, N_eff lag sums and sorts on the card):
    both ``getConvergeTests`` walls, and ``.converge``, ``.covmat`` and
    ``.PCA`` held against the default run's (CLI_REL; every differing line
    printed), with the covariance and the Gelman-Rubin R-1 of the two runs'
    objects within CLI_REL. The walls of the methods in CLI_TIMED are
    printed inside the stages'. Last, ``getRawNDDensityGridData`` of three
    parameters (one hard-limited, with mean likelihoods) on the default
    run's object with its histograms on the host and through the card's
    ``weighted_bincount``: the density and contours (integer weights)
    bitwise equal, the mean likelihoods (fractional weights) within
    CLI_REL of the peak."""
    import tempfile
    import types as pytypes

    import numpy as np
    import torch

    from getdist_tpu_torch import command_line as tcl
    from getdist_tpu_torch import mcsamples as tmc
    from getdist_tpu_torch.inifile import IniFile

    free = [n for n in names if n not in ranges]
    limited = next(n for n, w in ranges.items() if len(w) == 2 and w[0] is not None)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)
    saved_ops = os.environ.pop("GETDIST_TPU_TORCH_DEVICE_OPS", None)
    saved_bincount = tmc.weighted_bincount
    saved_methods = {name: getattr(tmc.MCSamples, name) for name in CLI_TIMED}
    method_s, binned_on = {}, []

    def timed(name):
        def method(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = saved_methods[name](self, *args, **kwargs)
            torch.cuda.synchronize()
            method_s[name] = method_s.get(name, 0.0) + time.perf_counter() - t0
            return out

        return method

    def seen_bincount(indices, weights, length):
        binned_on.append(indices.device.type)
        return saved_bincount(indices, weights, length)

    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.dirname(root))
    for name in CLI_TIMED:
        setattr(tmc.MCSamples, name, timed(name))
    try:
        runs = {}
        for label, ops in (("default", None), ("device ops", "1")):
            out_dir = os.path.join(folder, label.replace(" ", "_"))
            os.mkdir(out_dir)
            ini_file = os.path.join(out_dir, "pars.ini")
            tcl.make_param_file(ini_file, feedback=False)
            ini = IniFile(ini_file)
            ini.params.update({"file_root": root, "out_dir": out_dir, "PCA_num": "4", "PCA_params": " ".join(free[:4]),
                               "PCA_func": "NNNN", "thin_factor": "10", "no_plots": "F", "num_3D_plots": "1",
                               "3D_plot1": " ".join(free[:3])})
            ini.saveFile(ini_file)
            if ops:
                os.environ["GETDIST_TPU_TORCH_DEVICE_OPS"] = ops
            for fn in counters:
                fn.launches = 0
            method_s.clear()
            run = tcl._BatchRun(pytypes.SimpleNamespace(ini_file=ini_file, chain_root=root, ignore_rows=None,
                                                        make_plots=False), False, "cuda")
            wall, _ = wall_s(run.execute)
            launches = {fn.__name__: fn.launches for fn in counters}
            os.environ.pop("GETDIST_TPU_TORCH_DEVICE_OPS", None)
            stem = os.path.join(out_dir, os.path.basename(root))
            outputs = {ext: stem + ext for ext in (".margestats", ".likestats", ".converge", ".covmat", ".corr",
                                                   ".PCA", "_thin.txt", ".py", "_3D.py")}
            missing = [ext for ext, path in outputs.items() if not os.path.exists(path)]
            check(not missing, f"CLI ({label}): every output written (missing {missing})")
            check(all(launches.values()), f"CLI ({label}): the run launched K1, K2 and K3 ({launches})")
            check(run.samples.device == torch.device("cuda"), f"CLI ({label}): the MCSamples is on the card")
            check(set(method_s) == set(CLI_TIMED), f"CLI ({label}): every timed method ran ({sorted(method_s)})")
            runs[label] = dict(wall=wall, stages=dict(run.stage_seconds), launches=launches,
                               battery=method_s["getConvergeTests"], outputs=outputs, samples=run.samples)
            print(f"CLI ({label}), bounded chain {run.samples.numrows:,} x {run.samples.n} from its 4-file root, "
                  f"{card}: wall {wall:.3f} s (root to every output); stages "
                  + json.dumps({k: round(v, 3) for k, v in run.stage_seconds.items()})
                  + "; inside them " + json.dumps({k: round(v, 3) for k, v in method_s.items()})
                  + f"; launches {json.dumps(launches)}")
        print(f"CLI getConvergeTests, {card}: host numpy {runs['default']['battery']:.3f} s, "
              f"GETDIST_TPU_TORCH_DEVICE_OPS=1 {runs['device ops']['battery']:.3f} s "
              f"({runs['default']['battery'] / runs['device ops']['battery']:.2f}x)")

        base, dev = runs["default"], runs["device ops"]
        for ext in (".converge", ".covmat", ".PCA"):
            with open(base["outputs"][ext], encoding="utf-8") as handle:
                want = handle.read().splitlines()
            with open(dev["outputs"][ext], encoding="utf-8") as handle:
                got = handle.read().splitlines()
            check(len(got) == len(want), f"CLI: {ext} has as many lines with device ops as without")
            differing = [(g, w, _number_lines_differ(g, w)) for g, w in zip(got, want) if g != w]
            for g, w, rel in differing:
                print(f"CLI {ext} line differs: device ops {g!r} default {w!r} (largest relative difference {rel})")
            bad = [(g, w) for g, w, rel in differing if rel is not None]
            check(not bad, f"CLI: {ext} with device ops within {CLI_REL} relative of the default run ({bad[:3]})")
            print(f"CLI {ext}: {len(differing)} of {len(want)} lines differ in their text, all within {CLI_REL} "
                  f"relative or the last printed digit")
        cov_b, cov_d = base["samples"].getCov(), dev["samples"].getCov()
        cov_rel = float(np.max(np.abs(cov_d - cov_b)) / np.max(np.abs(cov_b)))
        gr_b, gr_d = base["samples"].getGelmanRubin(), dev["samples"].getGelmanRubin()
        check(cov_rel <= CLI_REL and abs(gr_d - gr_b) <= CLI_REL * abs(gr_b),
              f"CLI: covariance ({cov_rel:.3g}) and R-1 ({gr_d} against {gr_b}) within {CLI_REL}")
        same_marge = _read_bytes(base["outputs"][".margestats"]) == _read_bytes(dev["outputs"][".margestats"])
        print(f"CLI device ops against default: covariance max diff {cov_rel:.3g} of the largest, R-1 "
              f"{float(gr_d)!r} against {float(gr_b)!r}; .margestats byte-identical {same_marge}")

        mc = base["samples"]
        nd_params = [free[0], limited, free[1]]
        for name in nd_params:  # the parameters' ranges (argsorts) outside both walls
            mc._initParamRanges(name)
        host_s, host_nd = wall_s(lambda: mc.getRawNDDensityGridData(nd_params, meanlikes=True))
        tmc.weighted_bincount = seen_bincount
        os.environ["GETDIST_TPU_TORCH_DEVICE_OPS"] = "1"
        try:
            card_s, card_nd = wall_s(lambda: mc.getRawNDDensityGridData(nd_params, meanlikes=True))
        finally:
            os.environ.pop("GETDIST_TPU_TORCH_DEVICE_OPS", None)
            tmc.weighted_bincount = saved_bincount
        check(binned_on == ["cuda", "cuda"], f"CLI: the N-D histograms binned on the card ({binned_on})")
        same = all(np.array_equal(getattr(card_nd, k), getattr(host_nd, k)) for k in ("P", "contours"))
        check(same, "CLI: the N-D density (integer weights) through the card's weighted_bincount bitwise equals "
                    "the host path's")
        likes_diff = float(np.max(np.abs(card_nd.likes - host_nd.likes)))
        check(likes_diff <= CLI_REL, f"CLI: the N-D mean likelihoods (fractional weights, summed in another order "
                                     f"on the card) within {CLI_REL} of the peak ({likes_diff:.3g})")
        print(f"CLI N-D density {nd_params} ({card_nd.P.shape} bins, meanlikes), {card}: host np.bincount "
              f"{host_s * 1e3:.1f} ms, card weighted_bincount {card_s * 1e3:.1f} ms; density and contours bitwise "
              f"equal {same}; mean likelihoods max diff {likes_diff:.3g} of the peak")
        del runs, mc, base, dev
        torch.cuda.empty_cache()
    finally:
        for name, method in saved_methods.items():
            setattr(tmc.MCSamples, name, method)
        tmc.weighted_bincount = saved_bincount
        os.environ.pop("GETDIST_TPU_TORCH_DEVICE_OPS", None)
        if saved_ops is not None:
            os.environ["GETDIST_TPU_TORCH_DEVICE_OPS"] = saved_ops


# the plot-data phase's pairs, held against the host path at the host-API
# phase's ROUTED_2D_PEAK but for PLOT_PAIRS_UNHELD, whose differences are
# the JAX method's and are printed: a limited x periodic pair's wrap line
# (ROADMAP C11), and the mult-bias rounds the fused path runs on a pair of
# two periodic parameters, which the host path skips (C18)
PLOT_PAIRS = {"free x free": ("b10", "b11"), "free x free, far": ("b20", "b29"),
              "limited x limited": ("b6", "b7"), "lower x upper": ("b1", "b5"), "lower x free": ("b0", "b12"),
              "upper x free": ("b4", "b13"), "two-sided x free": ("b7", "b15"), "periodic x free": ("b9", "b14"),
              "periodic x periodic": ("b8", "b9"), "limited x periodic": ("b6", "b8")}
PLOT_PAIRS_UNHELD = {"limited x periodic": "C11", "periodic x periodic": "C18"}
# the meanlikes gather's parameters: its 20 pairs are theirs but the
# limited x periodic one (ROADMAP C11); none at a one-sided limit (C14).
# The like grids of the pairs the fused run reran with a two-sided
# parameter are printed, not held: the JAX method's rerun bandwidths there
# depart from the host path's (C18)
PLOT_LIKE_PARAMS = ("b6", "b8", "b10", "b11", "b12", "b13", "b14")


def gather_plot_data(analyser, root, requests, params):
    """Make ``requests`` (``triangle_requests``' tuples) of the plotter's
    data layer ``analyser`` on ``root``, as ``triangle_plot`` makes them;
    returns {request: density}."""
    out = {}
    for request in requests:
        if request[0] == "1d":
            out[request] = analyser.get_density(root, params[request[1]], likes=request[2])
        else:
            _, x, y, conts, likes = request
            out[request] = analyser.get_density_grid(root, params[x], params[y], conts=conts, likes=likes)
    return out


def plot_data_phase(root, names, ranges, samples, card, pair_hist, dft_conv, host_pair_walls):
    """Phase 11: the plotter's data layer (``sample_analysis.MCSampleAnalysis``,
    which the port's ``plots.GetDistPlotter`` draws from on the host) on
    the files phase's root, on the card, with no matplotlib and no yaml.
    The root loads through the analyser as a grid job item (its files
    linked into a subfolder of a ``ChainDirGrid``: cold from the text,
    then from its pickle cache) and as a loose root (phase 8's pickle
    cache), each holding phase 8's samples bitwise. Then the requests of
    ``triangle_plot`` on all 30 parameters at default settings
    (``triangle_requests``: 30 ``get_density``, 435 ``get_density_grid``):
    cold (a fresh analyser on a fresh load: one fused program and its
    reruns, K1, K2 and K3 launched), warm (a second fresh analyser on the
    same object) and repeated on the first analyser (0 launches, its
    cache); the wide kernels' launches printed. Every grid bitwise equal
    to the routed ``get1DDensityGridData`` / ``get2DDensityGridData`` of a
    separately loaded object; PLOT_PAIRS' densities within
    ROUTED_2D_PEAK of the host path's (``GETDIST_TPU_TORCH_FUSED=0``, on
    that object) but
    PLOT_PAIRS_UNHELD's (printed, ROADMAP C11 and C18); the one-sided
    limited parameters' 1D departures from the host printed (C14). Then
    the meanlikes gather (``shade_meanlikes``) on PLOT_LIKE_PARAMS' 20
    pairs: K1 with like weights launched, no query served by the host, the
    like grids within ROUTED_2D_PEAK of the host's but those of the pairs
    the fused run reran with a two-sided parameter (printed, ROADMAP C18).
    Last, the cold gather
    beside the host path's per-pair ``get2DDensity`` walls (phase 9's and
    this phase's) times 435, printed only."""
    import numpy as np
    import torch

    import getdist_tpu_torch
    from getdist_tpu_torch.chain_grid import ChainItem
    from getdist_tpu_torch.mcsamples import MCSamples
    from getdist_tpu_torch.sample_analysis import MCSampleAnalysis

    phase_t0 = time.perf_counter()
    folder, name = os.path.split(root)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)

    def zero():
        for fn in counters:
            fn.launches = 0
        pair_hist.pair_histograms.float_launches = 0
        pair_hist.pair_histograms.wide_launches = 0

    def counts():
        out = {fn.__name__: fn.launches for fn in counters}
        out["float"] = pair_hist.pair_histograms.float_launches
        out["wide"] = pair_hist.pair_histograms.wide_launches
        return out

    reads = []
    saved_read = MCSamples.readChains

    def counted(self, *a, **k):
        reads.append(1)
        return saved_read(self, *a, **k)

    saved_flag = os.environ.pop("GETDIST_TPU_TORCH_FUSED", None)
    MCSamples.readChains = counted
    try:
        grid_dir = os.path.join(folder, "grid", "tag")
        os.makedirs(grid_dir)
        for entry in os.listdir(folder):
            if entry.startswith(name + "_") or entry.startswith(name + "."):
                os.symlink(os.path.join(folder, entry), os.path.join(grid_dir, entry))
        loads = {}
        for tag, location in (("grid item cold", os.path.dirname(grid_dir)), ("grid item cached",
                                                                             os.path.dirname(grid_dir)),
                              ("loose root cached", folder)):
            before = len(reads)
            loads[tag], mc = wall_s(lambda loc=location: MCSampleAnalysis(loc, device="cuda").samples_for_root(name))
            check(np.array_equal(mc.samples, samples) and mc.device == torch.device("cuda"),
                  f"plot data: the {tag} load holds phase 8's samples bitwise on the card")
            check((len(reads) > before) == (tag == "grid item cold"),
                  f"plot data: the {tag} load {'parsed the files' if tag.endswith('cold') else 'hit its cache'}")
            if tag.startswith("grid"):
                check(isinstance(mc.jobItem, ChainItem) and mc.jobItem.chainRoot == os.path.join(grid_dir, name)
                      and mc.batch_path == os.path.dirname(grid_dir), f"plot data: the {tag} load is a job item")
            else:
                check(mc.jobItem is None, "plot data: the loose root has no job item")
        del mc

        requests = triangle_requests(names)
        check(len(requests) == 30 + 435, "plot data: the triangle's 465 requests")
        analyser = MCSampleAnalysis(folder, device="cuda")
        zero()
        load_s, mc = wall_s(lambda: analyser.samples_for_root(name))
        params = {n: mc.paramNames.parWithName(n) for n in names}
        cold_s, grids = wall_s(lambda: gather_plot_data(analyser, name, requests, params))
        cold = counts()
        check(cold["pair_histograms"] > 0 and cold["dft_conv_spectrum"] > 0 and cold["dft_conv2d"] > 0,
              f"plot data: the cold gather launched K1, K2 and K3 ({cold})")
        check(list(mc._fused_cache) == [False] and mc.fast_profile.get("host_served", 0) == 0,
              f"plot data: one fused program served every request ({list(mc._fused_cache)}, host served "
              f"{mc.fast_profile.get('host_served', 0)})")
        check(all(g is not None for g in grids.values()), "plot data: every request has a density")
        reruns = len(mc.fast_regrid_groups)
        fused_s = sum(v for k, v in mc.fast_profile.items() if k != "host_served")
        warm_analyser = MCSampleAnalysis(folder, device="cuda")
        warm_analyser.mcsamples[name] = mc
        zero()
        warm_s, warm = wall_s(lambda: gather_plot_data(warm_analyser, name, requests, params))
        warm_counts = counts()
        zero()
        repeat_s, repeat = wall_s(lambda: gather_plot_data(analyser, name, requests, params))
        repeat_counts = counts()
        check(not any(repeat_counts.values()) and all(repeat[k] is grids[k] for k in requests),
              f"plot data: the repeat gather is served from the analyser's cache ({repeat_counts})")
        print(f"plot data, 30-parameter triangle on the {len(samples):,}-row file root ({card}): loads "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in loads.items())
              + f"; the analyser's load {load_s * 1e3:.1f} ms; 30 get_density + 435 get_density_grid cold "
              f"{cold_s * 1e3:.1f} ms (of which the fused run, fast_profile, {fused_s * 1e3:.1f} ms; launches "
              f"{json.dumps(cold)}, fused regrid groups {reruns}), warm "
              f"{warm_s * 1e3:.1f} ms (launches {json.dumps(warm_counts)}), repeated on the same analyser "
              f"{repeat_s * 1e3:.1f} ms (launches {json.dumps(repeat_counts)})")

        # the analysis API's routed queries on a separately loaded object
        api = getdist_tpu_torch.loadMCSamples(root, ini=analyser.ini, device="cuda")
        differing = []
        for request, got in grids.items():
            if request[0] == "1d":
                want = api.get1DDensityGridData(request[1])
                same = np.array_equal(got.x, want.x) and np.array_equal(got.P, want.P)
            else:
                want = api.get2DDensityGridData(request[1], request[2], num_plot_contours=request[3])
                same = (np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
                        and np.array_equal(got.P, want.P) and np.array_equal(got.contours, want.contours))
            if not same or not (np.array_equal(warm[request].P, got.P)):
                differing.append(request)
        check(not differing, f"plot data: every grid (and the warm gather's) bitwise equal to the routed "
                             f"analysis API's on a separately loaded object (differing {differing[:5]})")

        # the host path on that object (its parameter ranges already set up,
        # as phase 9's host object has them when it times get2DDensity)
        os.environ["GETDIST_TPU_TORCH_FUSED"] = "0"
        host = api
        check(not host._fused_route_enabled(), "plot data: GETDIST_TPU_TORCH_FUSED=0 forces the host path")
        pair_walls, diffs = [], {}
        for key, (x, y) in PLOT_PAIRS.items():
            wall, want = wall_s(lambda x=x, y=y: host.get2DDensityGridData(x, y, num_plot_contours=2))
            pair_walls.append(wall)
            diffs[key] = routed_2d_diff(grids[("2d", x, y, 2, False)], want)
            if key not in PLOT_PAIRS_UNHELD:
                check(diffs[key] < ROUTED_2D_PEAK, f"plot data: {key} {(x, y)} within {ROUTED_2D_PEAK} of the "
                                                   f"peak of the host's ({diffs[key]:.4g})")
        one_sided = [n for n, w in ranges.items() if len(w) == 2 and (w[0] is None) != (w[1] is None)]
        c14 = {n: round(routed_1d_diff(grids[("1d", n, False)], host.get1DDensityGridData(n)), 6) for n in one_sided}
        print(f"plot data, routed against the host path ({card}): 2D max diff of the peak "
              + json.dumps({f"{k} {PLOT_PAIRS[k]}": round(v, 6) for k, v in diffs.items()})
              + f" (bar {ROUTED_2D_PEAK}; no bar, ROADMAP {json.dumps(PLOT_PAIRS_UNHELD)}); one-sided limited 1D "
              f"{json.dumps(c14)} (no bar, ROADMAP C14)")

        like_pairs = [(x, y) for i, x in enumerate(PLOT_LIKE_PARAMS) for y in PLOT_LIKE_PARAMS[i + 1:]
                      if (x, y) != ("b6", "b8")]
        check(len(like_pairs) == 20, "plot data: 20 meanlikes pairs")
        like_requests = [("2d", x, y, 2, True) for x, y in like_pairs]
        os.environ.pop("GETDIST_TPU_TORCH_FUSED", None)
        like_analyser = MCSampleAnalysis(folder, device="cuda")
        like_analyser.mcsamples[name] = mc
        served = mc.fast_profile.get("host_served", 0)
        zero()
        like_s, like_grids = wall_s(lambda: gather_plot_data(like_analyser, name, like_requests, params))
        like_counts = counts()
        check(like_counts["float"] > 0 and mc.fast_profile.get("host_served", 0) == served
              and all(g.likes is not None for g in like_grids.values()),
              f"plot data: the meanlikes gather ran K1 with like weights ({like_counts}) and the host served no "
              f"query ({mc.fast_profile.get('host_served', 0) - served})")
        os.environ["GETDIST_TPU_TORCH_FUSED"] = "0"
        like_diffs, like_dens_diffs = {}, {}
        for request, got in like_grids.items():
            want = host.get2DDensityGridData(request[1], request[2], num_plot_contours=2, meanlikes=True)
            like_diffs[request[1:3]] = routed_2d_diff(got, want, likes=True)
            like_dens_diffs[request[1:3]] = routed_2d_diff(got, want)
        rerun = {(names[a], names[b]) for group in mc.fast_regrid_groups for a, b in group["pairs"]}
        two_sided = {n for n, w in ranges.items() if len(w) == 2 and None not in w}
        unheld = {k for k in like_diffs if k in rerun and set(k) & two_sided}
        held_likes = {k: v for k, v in like_diffs.items() if k not in unheld}
        worst = max(held_likes, key=held_likes.get)
        check(held_likes[worst] < ROUTED_2D_PEAK, f"plot data: the routed like grids within {ROUTED_2D_PEAK} of the "
                                                  f"host's (worst {worst} {held_likes[worst]:.4g})")
        print(f"plot data, meanlikes gather of 20 pairs {like_s * 1e3:.1f} ms ({card}; its own fused run, launches "
              f"{json.dumps(like_counts)}); like grids of {len(held_likes)} pairs within {held_likes[worst]:.4g} "
              f"of the host's (worst {worst}; bar {ROUTED_2D_PEAK}); like grid / density max diff of the peak, "
              f"rerun, of every pair: " + json.dumps({f"{k}": [round(like_diffs[k], 6), round(like_dens_diffs[k], 6),
                                                               k in rerun] for k in like_diffs})
              + f"; no bar on the reruns with a two-sided parameter {sorted(unheld)} (ROADMAP C18)")
        print(f"plot data, scale ({card}; printed, not held): the cold gather of 465 densities {cold_s:.3f} s "
              f"against the host path's get2DDensity per pair x 435: phase 9's mean "
              f"{np.mean(host_pair_walls) * 1e3:.1f} ms x 435 = {np.mean(host_pair_walls) * 435:.1f} s, this "
              f"phase's mean {np.mean(pair_walls) * 1e3:.1f} ms x 435 = {np.mean(pair_walls) * 435:.1f} s; the "
              f"phase's wall {time.perf_counter() - phase_t0:.1f} s")
        bad = [m for m in ("matplotlib", "yaml") if m in sys.modules]
        check(not bad, f"plot data: the phase imported neither matplotlib nor yaml ({bad})")
        del mc, api, host, warm, repeat, like_grids, analyser, warm_analyser, like_analyser
        torch.cuda.empty_cache()
        return grids
    finally:
        MCSamples.readChains = saved_read
        os.environ.pop("GETDIST_TPU_TORCH_FUSED", None)
        if saved_flag is not None:
            os.environ["GETDIST_TPU_TORCH_FUSED"] = saved_flag


def _cobaya_info(names, ranges):
    """A Cobaya ``updated`` info dict for the bounded chain: each parameter
    with a prior giving its range (``{min, max}``, a one-sided ``{min}`` or
    ``{max}``, ``periodic: true``, or an unbounded normal), its label as
    phase 8's ``.paramnames`` has it, one likelihood."""
    params = {}
    for i, name in enumerate(names):
        window = ranges.get(name)
        if window is None:
            prior = {"dist": "norm", "loc": 0.0, "scale": 10.0}
        else:
            prior = {edge: value for edge, value in zip(("min", "max"), window[:2]) if value is not None}
        params[name] = {"prior": prior, "latex": f"b_{{{i}}}"}
        if window is not None and len(window) > 2 and window[2]:
            params[name]["periodic"] = True
    return {"params": params, "likelihood": {"like": None}, "sampler": {"mcmc": {"temperature": 1}}}


class _Collection:
    """A Cobaya SampleCollection's surface on numpy columns (``data.columns``,
    ``c[name].values``, ``c[[names]].values``), as ``MCSamplesFromCobaya``
    reads it."""

    class _Frame:
        def __init__(self, columns):
            self.columns = columns

        def __iter__(self):
            return iter(self.columns)

    class _Values:
        def __init__(self, values):
            self.values = values

    def __init__(self, columns):
        self._columns = columns
        self.data = self._Frame(list(columns))

    def __getitem__(self, key):
        import numpy as np

        if isinstance(key, list):
            return self._Values(np.column_stack([self._columns[k] for k in key]))
        return self._Values(self._columns[key])


class _InferenceData:
    """A duck-typed ArviZ InferenceData: groups of (chain, draw) arrays."""

    class _Array:
        def __init__(self, values):
            self.values, self.shape, self.dims, self.coords = values, values.shape, ("chain", "draw"), {}

    class _Group(dict):
        @property
        def data_vars(self):
            return list(self)

        @property
        def sizes(self):
            shape = next(iter(self.values())).shape
            return {"chain": shape[0], "draw": shape[1]}

    def __init__(self, **groups):
        for name, arrays in groups.items():
            setattr(self, name, self._Group({k: self._Array(v) for k, v in arrays.items()}))

    def __contains__(self, name):
        return name in self.__dict__


def interop_gui_phase(root, bounded, card, pair_hist, dft_conv, plot_grids):
    """Phase 12: what a Cobaya, PyMC or GUI user's session sends to the card,
    on the files phase's root and chain, with no matplotlib.
    (a) The chain's four files as four numpy-backed Cobaya collections
    (weight, minuslogpost, the 30 parameters, the minuslogprior and chi2
    columns) with a Cobaya info dict whose priors give the root's
    ``.ranges`` (``_cobaya_info``), through
    ``MCSamplesFromCobaya(..., device="cuda")``: the 30 parameters'
    samples, weights, loglikes and ranges bitwise phase 8's loaded object's
    (its pickle cache), and ``fastTriangleDensities(params=<the 30>)`` on
    both bitwise equal. (b) The chain as a duck-typed InferenceData
    (posterior arrays (4, 250k) per parameter, weights in ``sample_stats``,
    log-likelihoods in ``log_likelihood``) through
    ``arviz_to_mcsamples(..., custom_ranges=<the root's>, device="cuda")``:
    its arrays bitwise an ``MCSamples`` built from the same per-chain arrays
    and ranges, its routed ``getMargeStats()`` text that object's.
    (c) ``GuiSession(device="cuda")`` on the root's directory: the
    465 densities a 30-parameter triangle ``PlotSpec`` draws, gathered
    through the session's data layer cold (the root's load and one fused
    program) and warm (the loaded object's fused run, empty density
    caches), bitwise phase 11's (``plot_grids``); its ``marge_stats``,
    ``like_stats`` and ``param_table_tabs`` equal to the text of
    ``loadMCSamples`` with the session's settings on the card. No yaml is
    imported up to here. (d) The chain as a Cobaya root on disk
    (``cobaya/run.updated.yaml``, dumped from (a)'s info, and
    ``run.1.txt`` ... ``run.4.txt`` with (a)'s columns, written by four
    processes from the phase's start, a set-up that overlaps (a)-(c)),
    loaded by ``loadMCSamples`` (its yaml through PyYAML): its 30
    parameters' samples, weights, loglikes, labels and ranges bitwise
    phase 8's object's. Each part's K1/K2/K3 launches (each non-zero, for
    (a)-(c)) and walls, and the phase's wall, are printed beside
    ``card``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    import getdist_tpu_torch
    from getdist_tpu_torch.arviz_wrapper import arviz_to_mcsamples
    from getdist_tpu_torch.cobaya_interface import MCSamplesFromCobaya
    from getdist_tpu_torch.gui import app_logic
    from getdist_tpu_torch.mcsamples import MCSamples

    phase_t0 = time.perf_counter()
    samples, weights, loglikes, names, ranges = bounded
    folder, name = os.path.split(root)
    counters = (pair_hist.pair_histograms, dft_conv.dft_conv_spectrum, dft_conv.dft_conv2d)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts(part):
        out = {fn.__name__: fn.launches for fn in counters}
        check(all(out.values()), f"interop, {part}: K1, K2 and K3 launched ({out})")
        return out

    walls, launches = {}, {}
    saved_recent = app_logic.RECENT_FILE
    app_logic.RECENT_FILE = os.path.join(folder, "recent_dirs")
    # (d)'s chain files, written from now on by four processes
    cobaya_root = os.path.join(folder, "cobaya", "run")
    os.makedirs(os.path.dirname(cobaya_root))
    zeros = np.zeros(len(samples))
    table = np.column_stack([weights, loglikes, samples, zeros, zeros, 2 * loglikes, 2 * loglikes])
    writers = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"))
    written = [writers.submit(write_chain_text, f"{cobaya_root}.{i + 1}.txt", block)
               for i, block in enumerate(np.array_split(table, 4))]
    del table
    try:
        loaded = getdist_tpu_torch.loadMCSamples(root, settings={"ignore_rows": 0}, device="cuda")
        p = len(names)

        # (a) Cobaya collections: one per chain file of phase 8
        t0 = time.perf_counter()
        info = _cobaya_info(names, ranges)
        collections = []
        for rows in np.array_split(np.arange(len(samples)), 4):
            columns = {"weight": weights[rows], "minuslogpost": loglikes[rows]}
            columns.update({n: samples[rows, j] for j, n in enumerate(names)})
            zeros = np.zeros(len(rows))
            columns.update(minuslogprior=zeros, minuslogprior__0=zeros, chi2=2 * loglikes[rows],
                           chi2__like=2 * loglikes[rows])
            collections.append(_Collection(columns))
        setup_s = time.perf_counter() - t0
        walls["cobaya build"], cobaya = wall_s(lambda: MCSamplesFromCobaya(info, collections, device="cuda"))
        check(cobaya.device == torch.device("cuda") and cobaya.paramNames.list()[:p] == list(names),
              f"interop, Cobaya: the 30 parameters first, on the card ({cobaya.paramNames.list()}, {cobaya.device})")
        check(np.array_equal(cobaya.samples[:, :p], loaded.samples) and np.array_equal(cobaya.weights, loaded.weights)
              and np.array_equal(cobaya.loglikes, loaded.loglikes),
              "interop, Cobaya: samples, weights and loglikes bitwise phase 8's loaded object's")
        check(all(cobaya.ranges.getLower(n) == loaded.ranges.getLower(n)
                  and cobaya.ranges.getUpper(n) == loaded.ranges.getUpper(n) for n in names)
              and cobaya.ranges.periodic & set(names) == loaded.ranges.periodic
              and [cobaya.paramNames.parWithName(n).label for n in names]
              == [loaded.paramNames.parWithName(n).label for n in names],
              "interop, Cobaya: the 30 parameters' ranges, periodic flags and labels phase 8's")
        zero()
        walls["cobaya fastTriangleDensities"], got = wall_s(lambda: cobaya.fastTriangleDensities(params=list(names)))
        launches["cobaya"] = counts("Cobaya fastTriangleDensities")
        walls["loaded fastTriangleDensities"], want = wall_s(lambda: loaded.fastTriangleDensities(params=list(names)))
        same_cobaya = entries_bitwise(got, want)
        check(same_cobaya, "interop, Cobaya: fastTriangleDensities bitwise equal to phase 8's loaded object's")
        del cobaya, collections, got, want
        print(f"interop, Cobaya ({card}): 4 numpy collections of {len(samples) // 4:,} rows x {p + 6} columns "
              f"(set-up {setup_s:.1f} s); MCSamplesFromCobaya {walls['cobaya build'] * 1e3:.1f} ms; "
              f"fastTriangleDensities(params=<{p}>) {walls['cobaya fastTriangleDensities'] * 1e3:.1f} ms (phase 8's "
              f"object {walls['loaded fastTriangleDensities'] * 1e3:.1f} ms), launches {json.dumps(launches['cobaya'])}; "
              f"samples, weights, loglikes, ranges and densities bitwise phase 8's: {same_cobaya}")

        # (b) ArviZ InferenceData: posterior (chain, draw) arrays per parameter
        t0 = time.perf_counter()
        chains = np.array_split(np.arange(len(samples)), 4)
        check(len({len(c) for c in chains}) == 1, "interop, ArviZ: four chains of equal length")
        draws = len(chains[0])
        idata = _InferenceData(
            posterior={n: samples[:, j].reshape(4, draws) for j, n in enumerate(names)},
            sample_stats={"w": weights.reshape(4, draws)},
            log_likelihood={"ll": (-loglikes).reshape(4, draws)},
        )
        labels = {n: f"b_{{{i}}}" for i, n in enumerate(names)}
        setup_s = time.perf_counter() - t0
        walls["arviz build"], az = wall_s(lambda: arviz_to_mcsamples(
            idata, custom_labels=labels, custom_ranges=ranges, weights_var="w", loglikes_var="ll", device="cuda"))
        walls["direct build"], direct = wall_s(lambda: MCSamples(
            samples=[samples[c] for c in chains], weights=[weights[c] for c in chains],
            loglikes=[loglikes[c] for c in chains], names=list(names), labels=[labels[n] for n in names],
            ranges=ranges, label="MCSamples from InferenceData", device="cuda"))
        check(az.device == torch.device("cuda") and az.paramNames.list() == list(names)
              and all(np.array_equal(getattr(az, a), getattr(direct, a))
                      for a in ("samples", "weights", "loglikes", "chain_offsets"))
              and (az.ranges.lower, az.ranges.upper, az.ranges.periodic)
              == (direct.ranges.lower, direct.ranges.upper, direct.ranges.periodic),
              "interop, ArviZ: names, arrays, chain offsets and ranges bitwise the directly built MCSamples'")
        zero()
        walls["arviz getMargeStats"], az_marge = wall_s(lambda: str(az.getMargeStats()))
        launches["arviz"] = counts("ArviZ getMargeStats")
        walls["direct getMargeStats"], direct_marge = wall_s(lambda: str(direct.getMargeStats()))
        check(az_marge == direct_marge, "interop, ArviZ: the routed getMargeStats text equals the direct object's")
        del az, direct, idata
        print(f"interop, ArviZ ({card}): InferenceData of {p} posterior arrays (4, {draws:,}) with weights and "
              f"log-likelihoods (set-up {setup_s:.1f} s); arviz_to_mcsamples {walls['arviz build'] * 1e3:.1f} ms "
              f"(MCSamples from the same arrays {walls['direct build'] * 1e3:.1f} ms); "
              f"routed getMargeStats {walls['arviz getMargeStats'] * 1e3:.1f} ms (direct object "
              f"{walls['direct getMargeStats'] * 1e3:.1f} ms), launches {json.dumps(launches['arviz'])}; arrays "
              f"bitwise and marge text equal")

        # (c) the GUI session on the root's directory
        session = app_logic.GuiSession(device="cuda")
        roots = session.open_directory(folder)
        check(name in roots and not session.is_grid(), f"interop, GUI: the session finds the root ({roots})")
        session.add_root(name)
        check(session.param_list() == list(names), "interop, GUI: the session lists the 30 parameters")
        spec = app_logic.PlotSpec(plot_type="triangle", x_params=list(names))
        check(not spec.problems() and "device='cuda'" in session.script_for(spec),
              "interop, GUI: a triangle PlotSpec of the 30 parameters, its script on the card")
        requests = triangle_requests(list(spec.x_params))
        analysis = session.analysis()
        zero()

        def gather():
            mc = analysis.samples_for_root(name)
            params = {n: mc.paramNames.parWithName(n) for n in names}
            return gather_plot_data(analysis, name, requests, params)

        walls["gui triangle cold"], grids = wall_s(gather)
        launches["gui"] = counts("GUI triangle data")
        analysis.densities_1D.clear()
        analysis.densities_2D.clear()
        walls["gui triangle warm"], warm = wall_s(gather)
        differing = [k for k in requests if not all(
            np.array_equal(getattr(g[k], a), getattr(plot_grids[k], a))
            for g in (grids, warm) for a in ("x", "P") + (("y", "contours") if k[0] == "2d" else ()))]
        check(not differing, f"interop, GUI: the triangle's 465 densities bitwise phase 11's (differing "
                             f"{differing[:5]})")
        walls["gui marge_stats"], marge = wall_s(lambda: session.marge_stats(name))
        walls["gui like_stats"], like = wall_s(lambda: session.like_stats(name))
        walls["gui param_table_tabs"], tabs = wall_s(lambda: session.param_table_tabs(name))
        walls["api load + stats"], api_texts = wall_s(lambda: _api_texts(root, analysis.ini, len(tabs)))
        check(marge == api_texts[0] and like == api_texts[1] and [t for _, t in tabs] == api_texts[2],
              "interop, GUI: marge_stats, like_stats and param_table_tabs equal the analysis API's text on the card")
        bad = [m for m in ("matplotlib", "yaml") if m in sys.modules]
        check(not bad, f"interop: parts (a)-(c) imported neither matplotlib nor yaml ({bad})")
        del session, analysis, grids, warm
        torch.cuda.empty_cache()
        print(f"interop, GUI session ({card}): triangle PlotSpec data ({p} get_density + {len(requests) - p} "
              f"get_density_grid) cold "
              f"{walls['gui triangle cold'] * 1e3:.1f} ms (launches {json.dumps(launches['gui'])}), warm "
              f"{walls['gui triangle warm'] * 1e3:.1f} ms, bitwise phase 11's; marge_stats "
              f"{walls['gui marge_stats'] * 1e3:.1f} ms, like_stats {walls['gui like_stats'] * 1e3:.1f} ms, "
              f"param_table_tabs {walls['gui param_table_tabs'] * 1e3:.1f} ms, equal to the analysis API's "
              f"(its load and stats {walls['api load + stats'] * 1e3:.1f} ms)")

        # (d) the chain as a Cobaya root on disk, loaded through its yaml
        t0 = time.perf_counter()
        for future in written:
            future.result()
        walls["cobaya root files (wait)"] = time.perf_counter() - t0
        import yaml

        with open(cobaya_root + ".updated.yaml", "w", encoding="utf-8") as handle:
            yaml.safe_dump(info, handle, sort_keys=False)
        zero()
        walls["cobaya root load"], from_yaml = wall_s(lambda: getdist_tpu_torch.loadMCSamples(
            cobaya_root, settings={"ignore_rows": 0}, device="cuda", no_cache=True))
        check(from_yaml.device == torch.device("cuda") and from_yaml.paramNames.list()[:p] == list(names)
              and np.array_equal(from_yaml.samples[:, :p], loaded.samples)
              and np.array_equal(from_yaml.weights, loaded.weights)
              and np.array_equal(from_yaml.loglikes, loaded.loglikes)
              and [from_yaml.paramNames.parWithName(n).label for n in names]
              == [loaded.paramNames.parWithName(n).label for n in names]
              and all(from_yaml.ranges.getLower(n) == loaded.ranges.getLower(n)
                      and from_yaml.ranges.getUpper(n) == loaded.ranges.getUpper(n) for n in names)
              and from_yaml.ranges.periodic & set(names) == loaded.ranges.periodic
              and from_yaml.sampler == "mcmc" and from_yaml.properties.params.get("sampler") == "mcmc",
              "interop, Cobaya root: loadMCSamples of run.updated.yaml and its 4 chain files holds phase 8's "
              "samples, weights, loglikes, labels and ranges bitwise")
        print(f"interop, Cobaya root on disk ({card}): {len(samples):,} rows x {from_yaml.samples.shape[1]} "
              f"parameters in 4 files (written during (a)-(c); waited {walls['cobaya root files (wait)']:.1f} s "
              f"more); loadMCSamples through the yaml {walls['cobaya root load'] * 1e3:.1f} ms; bitwise phase 8's "
              f"object; parameters after the {p}: {from_yaml.paramNames.list()[p:]}")
        del from_yaml, loaded
        bad = [m for m in ("matplotlib",) if m in sys.modules]
        check(not bad, f"interop: the phase imported no matplotlib ({bad})")
        print(f"interop and GUI phase ({card}): walls (ms) "
              + json.dumps({k: round(v * 1e3, 1) for k, v in walls.items()})
              + f"; launches {json.dumps(launches)}; the phase's wall {time.perf_counter() - phase_t0:.1f} s")
    finally:
        writers.shutdown(cancel_futures=True)
        app_logic.RECENT_FILE = saved_recent


def _api_texts(root, ini, n_tabs):
    """(marge stats, like stats, the parameter tables by limit) of the
    analysis API on ``root`` loaded on the card with ``ini``."""
    import getdist_tpu_torch

    mc = getdist_tpu_torch.loadMCSamples(root, ini=ini, device="cuda")
    return (str(mc.getMargeStats()), str(mc.getLikeStats()),
            [mc.getTable(columns=1, limit=i + 1).tableTex() for i in range(n_tabs)])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi failed"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    sys.path.insert(0, ROOT)
    from bench import make_chain
    from getdist_tpu_torch.ops import _cuda, batched, dft_conv, pair_hist

    lib = _cuda.library()
    print(f"build: {lib.build_seconds:.2f} s with nvcc -> {os.path.relpath(lib.path, ROOT)}")
    usage = [line.strip() for line in lib.log.splitlines() if "registers" in line or "spill" in line]
    print("ptxas: " + " | ".join(usage))
    for line in ptxas_lines(lib.log, "pair_hist_uint8_kernel"):
        print(f"ptxas, K1/K4/K5 uint8 kernel: {line}")
    for line in ptxas_lines(lib.log, "pair_hist_wide"):
        print(f"ptxas, wide kernels: {line}")

    t0 = time.perf_counter()
    samples, weights = make_chain(1_000_000, 30)
    print(f"chain 1,000,000 x 30 made in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bounded = bounded_chain(1_000_000)
    print(f"bounded chain 1,000,000 x {bounded[0].shape[1]} made in {time.perf_counter() - t0:.1f} s "
          f"(kinds lower/upper/two-sided/periodic {BOUNDED_KINDS}, the rest unbounded)")

    results = fused_path(samples, weights, batched, dft_conv, pair_hist, make_chain)
    results += parity_path(samples, weights, batched, dft_conv, pair_hist)
    results += sharded_path(samples, weights, batched, dft_conv, pair_hist, make_chain, bounded)
    results += public_entry(samples, weights, batched, dft_conv, pair_hist)
    results += degenerate_phase(pair_hist, batched)
    results += bounded_phase(bounded, batched, dft_conv, pair_hist)
    results += parity_bounded_phase(bounded, batched, dft_conv, pair_hist)
    files_phase(bounded, card, pair_hist, dft_conv)
    for r in results:
        # a bound is a least time: no measured way of computing the function may beat it
        measured = [t for t in (r["ms"], r["plain_ms"], r["library_ms"]) if t is not None]
        check(r["bound_ms"] <= min(measured), f"{r['name']}: bound {r['bound_ms']} ms above a measured {min(measured)} ms")
        print(
            f"{r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), library {r['library_ms']}, max abs err {r['max_abs_err']:.3g}, "
            f"launches {r['launches']}"
        )

    print(card)
    print(json.dumps({"kernels": results}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 - the smoke run reports every failure and exits non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
