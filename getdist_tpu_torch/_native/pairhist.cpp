// Multi-threaded exact pair histograms for the host parity variant.
//
// The reference computes each pair's 2D histogram with np.bincount over
// flattened indices (getdist mcsamples.py:1821-1827); at 435 pairs x 1M
// samples that is ~9 s of single-threaded numpy. This computes the same
// f64 scatter adds, bit-identical (the f64 addition order per pair is the
// sample order np.bincount uses), with the pairs fanned out across
// threads.
//
// Built with g++ at first use and called through ctypes by
// getdist_tpu_torch._native.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// ixs: (p, n) int32 row-major bin indices per parameter (in [0, nbins));
// w: (n,) f64 weights; pair_a/pair_b: (k,) parameter rows; out: (k,
// nbins*nbins) f64, zero-initialized by the caller. Returns 0, or 1 for a
// bad shape and 2 for a pair row outside [0, p).
int gdt_pair_hists(const int32_t* ixs, int64_t n, int64_t p, const double* w,
                   const int64_t* pair_a, const int64_t* pair_b, int64_t k,
                   int64_t nbins, double* out, int n_threads) {
    if (n < 0 || p <= 0 || k <= 0 || nbins <= 0) return 1;
    for (int64_t j = 0; j < k; ++j) {
        if (pair_a[j] < 0 || pair_a[j] >= p || pair_b[j] < 0 || pair_b[j] >= p) return 2;
    }
    if (n_threads < 1) n_threads = 1;
    int64_t cells = nbins * nbins;

    auto work = [&](int64_t k_lo, int64_t k_hi) {
        for (int64_t j = k_lo; j < k_hi; ++j) {
            const int32_t* ia = ixs + pair_a[j] * n;
            const int32_t* ib = ixs + pair_b[j] * n;
            double* h = out + j * cells;
            // rows = b, cols = a (the _make2Dhist layout); an index outside
            // the grid is clamped onto its edge, never written out of bounds
            for (int64_t i = 0; i < n; ++i) {
                int64_t a = ia[i];
                int64_t b = ib[i];
                a = a < 0 ? 0 : (a >= nbins ? nbins - 1 : a);
                b = b < 0 ? 0 : (b >= nbins ? nbins - 1 : b);
                h[b * nbins + a] += w[i];
            }
        }
    };

    if (n_threads == 1 || k == 1) {
        work(0, k);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t per = (k + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < k ? lo + per : k;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
