"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 and the
least time of the work the analyses need, counted from the problem.

The histogram and convolution counts are those the port's kernel rows have
used (each input byte read once and each output written once; the DFT
products as the convolutions need them, the paired products of a real
transform's conjugate columns counted once). The DFT frame is a frozen
copy of the program's rule at the time the benchmark was defined
(:func:`frame_for`), so a later change of frame or algorithm in the
program leaves the work counted here as it is.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W power
# limit): HBM3 bytes/s; FP32 outside the tensor cores; float32-accurate
# products on the tensor cores as three TF32 passes (495 / 3); FP64 on the
# tensor cores (DMMA)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
FP64_FLOPS = 67e12


def frame_for(size):
    """The DFT frame for a linear convolution of ``size`` samples: at least
    384, rounded up to a multiple of 128."""
    return max(384, -(-int(size) // 128) * 128)


def bound_terms(nbytes, ops, rate):
    """(bytes ms, operations ms): bytes over the HBM rate, operations over
    the peak rate for their type."""
    return nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of the two bound_terms."""
    t_bytes, t_ops = bound_terms(nbytes, ops, rate)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hist_work(n, rows, index_bytes, weight_bytes, k, nbins):
    """(bytes, adds) of one set of pair histograms: ``rows`` index rows of
    ``n`` samples (``index_bytes`` each) and the weights read once, ``k``
    f32 histograms of nbins^2 written once; one add per sample and pair."""
    return rows * n * index_bytes + n * weight_bytes + 4 * k * nbins * nbins, k * n


def hist_bound(n, rows, index_bytes, weight_bytes, k, nbins):
    """K1/K4/K5's least time, with the adds at the FP32 rate (the published
    table has no integer scalar rate)."""
    return bound(*hist_work(n, rows, index_bytes, weight_bytes, k, nbins), FP32_FLOPS)


def dft_rate(elem_bytes):
    """K2/K3 operations: f32 at the 3xTF32 tensor-core rate, f64 at DMMA's."""
    return FP64_FLOPS if elem_bytes == 8 else TF32X3_FLOPS


def spectrum_work(k, m, pad, elem_bytes=4, unpaired=False):
    """K2's (bytes, flops) for ``k`` kernels of m x m at frame ``pad``: the
    kernels and two DFT matrices read, two spectra written. Per kernel U =
    F K F contracts over the m x m support only, and U of a real kernel is
    Hermitian, so rows 0..P/2 (h of them) determine it: (h x m) real x
    complex, then (h x m) x (m x P) complex x complex, whose columns c and P
    - c come from one set of four real products, 4 flops a term.
    ``unpaired``: that product at 8 flops a term."""
    h = pad // 2 + 1
    cross = 8 if unpaired else 4
    nbytes = elem_bytes * (k * m * m + 2 * pad * pad + 2 * k * pad * pad)
    return nbytes, k * (4 * h * m * m + cross * h * pad * m)


def conv_work(k, size, pad, out_size, elem_bytes=4, unpaired=False):
    """K3's (bytes, flops) for ``k`` grids of size x size at frame ``pad``:
    the grids, two spectra and four DFT matrices read, the out_size slice
    written. Per grid, with h = P/2 + 1 rows of the Hermitian spectrum: the
    forward transform contracts over the grid (h rows), then over its
    columns for all P output columns, c and P - c sharing one set of four
    real products; the spectrum product is 6 flops per point of those rows;
    the inverse computes only the out_size rows and columns of the slice,
    its first product over h Hermitian columns pairing rows k and P - k (4
    flops a term), its second of depth h. ``unpaired``: the paired products
    at 8 flops a term."""
    h = pad // 2 + 1
    cross = 8 if unpaired else 4
    nbytes = elem_bytes * (k * size * size + 2 * k * pad * pad + 4 * pad * pad + k * out_size * out_size)
    forward = 4 * h * size * size + cross * h * pad * size
    inverse = cross * out_size * pad * h + 4 * out_size * out_size * h
    return nbytes, k * (forward + 6 * h * pad + inverse)


def spectrum_bound(k, m, pad, elem_bytes=4):
    nbytes, flops = spectrum_work(k, m, pad, elem_bytes)
    return bound(nbytes, flops, dft_rate(elem_bytes))


def conv_bound(k, size, pad, out_size, elem_bytes=4):
    nbytes, flops = conv_work(k, size, pad, out_size, elem_bytes)
    return bound(nbytes, flops, dft_rate(elem_bytes))


def analysis_hist_ms(info):
    """The least time of one triangle analysis' pair histograms: for each
    grid size that serves a pair, the parameters' index rows (one byte up to
    256 bins, two past that) and the weights read once, each served pair's
    histogram written once, and again with the f32 like weights for the
    mean-likelihood grids; all bytes at the HBM rate or all adds at the FP32
    rate, whichever takes longer."""
    by_grid = {}
    for a, b, fine, _winw in info["pairs"]:
        cols, k = by_grid.get(fine, (set(), 0))
        by_grid[fine] = (cols | {a, b}, k + 1)
    n = info["samples"]
    weight_bytes = 1 if info["integer_weights"] else 4
    nbytes = adds = 0
    for fine, (cols, k) in by_grid.items():
        index_bytes = 1 if fine <= 256 else 2
        parts = [hist_work(n, len(cols), index_bytes, weight_bytes, k, fine)]
        if info["meanlikes"]:
            parts.append(hist_work(n, 0, index_bytes, 4, k, fine))
        nbytes += sum(b for b, _ in parts)
        adds += sum(o for _, o in parts)
    return max(bound_terms(nbytes, adds, FP32_FLOPS))


def analysis_conv_ms(info):
    """The least time of one triangle analysis' convolutions, each pair at
    the grid and window that serve it (kernel support m = 2 winw + 1, frame
    ``frame_for(fine + 4 winw + 1)``): one kernel spectrum, the smoothing
    and the multiplicative bias round (on the periodically extended grid of
    fine + 2 winw where an axis is periodic); for a pair with a hard-limited
    axis five more spectra of the kernel's moments and eight more
    convolutions of the boundary correction (six of the extended edge
    masks, two of the grid); with mean-likelihood grids an f64 spectrum and
    smoothing and one more f32 round. Like shapes are counted as one batch
    (its DFT matrices read once); all bytes at the HBM rate or the f32 and
    f64 flops at their peaks, whichever takes longer."""
    spectra, convs = {}, {}
    params = info["params"]
    for a, b, fine, winw in info["pairs"]:
        m = 2 * winw + 1
        pad = frame_for(fine + 4 * winw + 1)
        ext = fine + 2 * winw
        periodic = params[a]["periodic"] or params[b]["periodic"]
        limited = params[a]["limited"] or params[b]["limited"]
        main = ext if periodic else fine
        wanted_s = [(m, pad, 4)] * (6 if limited else 1)
        wanted_c = [(main, pad, fine, 4)] * 2 + ([(ext, pad, fine, 4)] * 6 + [(fine, pad, fine, 4)] * 2 if limited
                                                  else [])
        if info["meanlikes"]:
            wanted_s.append((m, pad, 8))
            wanted_c += [(main, pad, fine, 8), (main, pad, fine, 4)]
        for key in wanted_s:
            spectra[key] = spectra.get(key, 0) + 1
        for key in wanted_c:
            convs[key] = convs.get(key, 0) + 1
    nbytes, seconds_ops = 0, 0.0
    parts = [(spectrum_work(k, m, pad, e), e) for (m, pad, e), k in spectra.items()]
    parts += [(conv_work(k, size, pad, out, e), e) for (size, pad, out, e), k in convs.items()]
    for (b, flops), e in parts:
        nbytes += b
        seconds_ops += flops / dft_rate(e)
    return max(nbytes / HBM_BYTES_S, seconds_ops) * 1e3
