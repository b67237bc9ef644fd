#!/usr/bin/env python
"""Time the port's pair-histogram kernels K1, K4 and K5, and the wide
kernels past 256 bins, on one CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/time_pair_hist_torch.py          # all of it
    python3 scripts/time_pair_hist_torch.py --wide   # the wide kernels only
    python3 scripts/time_pair_hist_torch.py --fixed  # the fixed-point route only

Two stacks of uint8 index rows from ``bench.make_chain(1_000_000, 30)``:

* K1's and K5's: the fused path's fine indices at 256 bins over the 1D
  stage's ranges, 30 rows (30 MB, inside the 50 MB L2), all 435 pairs;
* K4's: parity mode's sheared stack (lead rows and one Cholesky-residual
  row per sheared pair, as ``MCSamples.fastParityDensities(device=True)``
  builds it): 139 rows (139 MB, beyond L2), 112 pairs whose a rows repeat.

Checks every timed route bit-exact against the plain version (integer
weights as uint8, as the paths pass them, and as f32), then prints CUDA-event
times (mean of 10 calls after a warm-up, taken in two turns of opposite
order) of the wrappers: K1 and K5 in each weight mode; K4 in each weight
mode, at N = 1,000,003 (columns off 16-byte boundaries), with its pairs
shuffled, and with its samples split over 2 and 4 chunks a pair (the split
route's global-atomic flush). Then the uint8 kernel alone
(launches on prepared buffers, without the wrapper's checks) on both
stacks, the device time per K4 call under torch.profiler by kernel, and
the ``torch.bincount`` yardstick of ``chip_smoke.py`` beside each stack's
bound. Prints the pair-histogram kernels' ptxas lines of a fresh build.

The wide kernels (int16 rows past 256 bins) on the shapes their paths
give them: the three fine groups of ``chip_smoke.degenerate_chain(1M)``'s
blocks and ``chip_smoke.hard_chain(1M)``'s 0.99 pair, binned over each
column's range widened by a tenth on both sides (parity's convention), with
uint8 integer weights as the paths pass them. Each is checked bit-exact
against the plain version and timed (CUDA events, mean of 10 calls, two
turns of opposite order) by the route rule, by each design alone (the
direct and bucket routes of ``pair_hist.wide_plan``) and with f32 weights,
beside ``torch.bincount`` and the bound; then each design's device time per
call by kernel under torch.profiler, also for the bucket route with the most
rows a slab's tile holds and with half and twice the rule's entries per bin
block, and the host time per call of the rule's route. Copied with ``chip_smoke.py`` into an
older tree whose ``pair_hist`` has no ``wide_plan``, ``--wide`` times that
tree's kernel for int16 rows (f32 weights) on the same rows instead, so that
two trees compare in one call.

``--fixed`` times the route of fractional weights (64-bit fixed point) on
the shapes its paths give it, from one meanlikes run of the public entry on
``chip_smoke.bounded_chain(1M)``: the like histograms of all 435 pairs, the
clamped rescue's 110 pairs, K5's grouped plan raw on the group's scale, the
sharded K1 like route raw, and an 8-pair split-route call. Each is checked
bit-exact against the plain version and twice against itself, then timed
(CUDA events in two turns, and the profiler's device time) beside scratch
builds of ``csrc/pair_hist.cu`` that replace its adds (timing only: no adds,
the low words' adds alone, every vector's a and w read); it prints the
atomic instructions of each build's fixed-point kernels (``cuobjdump
-sass``). Copied into an older tree, it times that tree's kernel and its
own split (reads only, convert without add, 32-bit adds, the two-word adds
in that kernel) in the same way, so that two trees compare in one call.
Imports nothing of JAX.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from bench import make_chain  # noqa: E402
from chip_smoke import (  # noqa: E402
    DEGENERATE_BLOCKS, cuda_ms, degenerate_chain, hard_chain, hist_bound, library_hist_ms, ptxas_lines,
)
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from getdist_tpu_torch.ops import _cuda, batched, pair_hist  # noqa: E402


def sheared_stack(samples, weights):
    """Parity's sheared stack of the chain: (ix (R, N) uint8, pair_a, pair_b)."""
    p = samples.shape[1]
    mc = MCSamples(samples=samples, weights=weights, names=[f"p{i}" for i in range(p)], device="cuda")
    idx = list(range(p))
    infos = [mc._initParamRanges(j) for j in idx]
    _, jobs = mc._parity_pairs(idx, infos)
    stack = mc._sheared_stack(idx, infos, jobs, mc._parity_chain()["samples"])
    ix = pair_hist.narrow_rows(stack["ix"], 256)
    pa, pb = (torch.tensor(stack[key], dtype=torch.int32, device="cuda") for key in ("pair_a", "pair_b"))
    return ix, pa, pb


def forced_split(n_split, fn):
    """``fn`` with ``pair_hist.split_plan`` fixed at ``n_split`` chunks a pair."""

    def run():
        saved = pair_hist.split_plan
        pair_hist.split_plan = lambda k, n, sms, parts=2: n_split
        try:
            return fn()
        finally:
            pair_hist.split_plan = saved

    return run


def kernel_alone(ix, w, pa, pb):
    """Launches of the uint8 kernel on prepared buffers (one chunk a pair,
    integer weights, pairs already checked): the kernel without its
    wrapper."""
    out = torch.empty((pa.shape[0], 256, 256), dtype=torch.float32, device="cuda")

    def run():
        _cuda.call(
            "pair_hist_uint8_launch", ix.device, ix.data_ptr(), ix.shape[0], w.data_ptr(), w.element_size(),
            pa.data_ptr(), pb.data_ptr(), 0, 0, ix.shape[1], pa.shape[0], 256, 1, 1, 0, 0, 0, 0, out.data_ptr(),
        )
        return out

    return run


def device_breakdown(fn, reps=10):
    """{kernel name: mean device us per call} of ``reps`` calls of ``fn`` under
    torch.profiler, with the total device time per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name[:100]] = per.get(e.name[:100], 0.0) + e.time_range.elapsed_us() / reps
    per = {k: round(v, 2) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}
    per["total device us per call"] = round(sum(per.values()), 2)
    return per


def in_turns(runs):
    """{name: [ms, ms]}: each run timed twice, in two turns of opposite order."""
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times[name].append(cuda_ms(runs[name], 10))
    return times


def wide_shapes():
    """{name: (int16 rows (P, N), nbins, f32 weights)} of the wide kernels' shapes,
    the rows at each group's fine grid (see the module's docstring)."""
    import numpy as np

    samples, weights = degenerate_chain(1_000_000)
    hard, hard_w = hard_chain(1_000_000)
    shapes, start = {}, 0
    for (size, _), (label, fine) in zip(DEGENERATE_BLOCKS, (("A", 960), ("B", 576), ("C", 384))):
        shapes[f"{label}: degenerate block, {fine} bins x {size * (size - 1) // 2} pairs"] = (
            samples[:, start : start + size], fine, weights)
        start += size
    shapes["hard chain's 0.99 pair, 960 bins x 1 pair"] = (hard[:, 4:6], 960, hard_w)
    rows = {}
    for name, (cols, fine, w) in shapes.items():
        lo, hi = cols.min(0), cols.max(0)
        lo, hi = lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo)
        ix = ((cols - lo) / ((hi - lo) / (fine - 1)) + 0.5).astype(np.int16).T.copy()
        rows[name] = (torch.from_numpy(ix).cuda(), fine, torch.from_numpy(w.astype(np.float32)).cuda())
    return rows


def device_by_kernel(fn, reps=10):
    """{kernel: mean device us per call} under torch.profiler, with the total."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("pair_hist_wide_")[-1].split("(")[0].split("<")[0][:40]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / reps
    per = {k: round(v, 1) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}
    per["total"] = round(sum(per.values()), 1)
    return per


def time_wide(card):
    """The wide kernels (or an older tree's kernel for int16 rows) on
    :func:`wide_shapes`; True when every route is bit-exact."""
    older = not hasattr(pair_hist, "wide_plan")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True
    for name, (ix, fine, w) in wide_shapes().items():
        p = ix.shape[0]
        pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
        pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
        pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
        k, n = len(pairs), ix.shape[1]
        w8 = pair_hist.narrow_weights(w)
        ref = pair_hist.pair_histograms_plain(ix, w, pa, pb, integer_weights=True, nbins=fine)

        def entry(weights, **forced):
            def run():
                if not forced:
                    return pair_hist.pair_histograms(ix, weights, pa, pb, integer_weights=True, nbins=fine)
                plan = pair_hist.wide_plan
                pair_hist.wide_plan = lambda *args: plan(*args)._replace(**forced)
                try:
                    return pair_hist.pair_histograms(ix, weights, pa, pb, integer_weights=True, nbins=fine)
                finally:
                    pair_hist.wide_plan = plan

            return run

        if older:
            runs = {"older tree's kernel, f32 weights": entry(w)}
        else:
            runs = {
                "rule, uint8 weights": entry(w8),
                "direct alone, uint8 weights": entry(w8, route="direct"),
                "bucket alone, uint8 weights": entry(w8, route="bucket"),
                "rule, f32 weights": entry(w),
            }
        checks = {key: torch.equal(fn(), ref) for key, fn in runs.items()}
        ok = ok and all(checks.values())
        times = in_turns(runs)
        times["library bincount"] = [round(library_hist_ms(ix, w, pa, pb, fine, 10), 4)]
        times["plain"] = [round(cuda_ms(lambda: pair_hist.pair_histograms_plain(ix, w, pa, pb, True, fine), 2), 4)]
        bound, by = hist_bound(ix, w8, k, fine)
        route = "" if older else f", rule's plan {pair_hist.wide_plan(k, n, fine, sms)}"
        print(f"{card}: wide, {name} (int16 rows x {n}{route}); bit-exact {json.dumps(checks)}; ms per call: "
              f"{json.dumps({key: [round(x, 4) for x in v] for key, v in times.items()})}; bound {bound:.4f} ms ({by}, "
              "uint8 weights)")
        designs = {key: fn for key, fn in runs.items() if "alone" in key or older}
        if not older:
            # the bucket route beside the rule's choices of rows and part: the most rows a
            # slab's tile holds, and half and twice the entries a bin block takes
            plan = pair_hist.wide_plan(k, n, fine, sms)
            rows = min(fine, pair_hist.TILE_WORDS // fine)
            slabs = -(-fine // rows)
            designs[f"bucket, {rows} rows a slab"] = entry(
                w8, route="bucket", rows=rows, slabs=slabs, split_slots=min(k * slabs, k * n // plan.part))
            for scale in (0.5, 2):
                part = int(plan.part * scale)
                designs[f"bucket, part {part}"] = entry(
                    w8, route="bucket", part=part, split_slots=min(k * plan.slabs, k * n // part))
        for key, fn in designs.items():
            ok = ok and torch.equal(fn(), ref)
            print(f"  device us per call by kernel, {key}: {json.dumps(device_by_kernel(fn))}")
        fn = runs["older tree's kernel, f32 weights" if older else "rule, uint8 weights"]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        print(f"  host us per call (100 calls, each reading its pair indices back): "
              f"{(time.perf_counter() - t0) * 1e4:.1f}")
    return ok


# Scratch builds of csrc/pair_hist.cu for --fixed, timing only (never in
# the package): the fixed-point adds replaced, in whichever form the tree
# holds them (add_fixed's two 32-bit adds, or an older tree's inline 64-bit
# atomicAdd in its Adder).
_OLD_ADD = "atomicAdd(&tile[row * bins + a], acc_of<Acc>(w, scale));"
_OLD_TARGET = "&tile[row * bins + a]"
FIXED_VARIANTS = {
    # no conversion and no add: the reads, the index arithmetic and the row test
    "reads only": "if (__float_as_uint(static_cast<float>(w)) == 0xffffffffu) *({target}) = Acc(1);",
    # the conversion of the weight without its add
    "convert, no add": "{{ const Acc v_ = acc_of<Acc>(w, scale); if (v_ == static_cast<Acc>(-7)) *({target}) = v_; }}",
    # one native 32-bit add of the addend's low word (wrong sums)
    "32-bit adds": "atomicAdd(reinterpret_cast<unsigned*>({target}), static_cast<unsigned>(acc_of<Acc>(w, scale)));",
    # exact: the 64-bit add as two native 32-bit adds, the low word's carry into the high one
    "carry split": "{{ const Acc v_ = acc_of<Acc>(w, scale); if constexpr (sizeof(Acc) == 8) {{ "
                   "unsigned* p_ = reinterpret_cast<unsigned*>({target}); const unsigned lo_ = static_cast<unsigned>(v_); "
                   "const unsigned old_ = atomicAdd(p_, lo_); atomicAdd(p_ + 1, static_cast<unsigned>("
                   "static_cast<unsigned long long>(v_) >> 32) + (old_ + lo_ < old_ ? 1u : 0u)); }} "
                   "else {{ atomicAdd({target}, v_); }} }}",
}
_ADD_LO = "  const unsigned old = atomicAdd(word, lo);"
_ADD_HI = "  atomicAdd(word + 1, static_cast<unsigned>(v >> 32) + (old + lo < old ? 1u : 0u));"
_NO_HI = "  if (old == 0x7fffffffu && lo == 3u) *bin = 0;"
NEW_VARIANTS = {
    # the reads, the row tests and the conversions, without the adds
    "no adds": [(_ADD_LO, "  const unsigned old = lo ^ static_cast<unsigned>(reinterpret_cast<uintptr_t>(word));"),
                (_ADD_HI, _NO_HI)],
    # the low words' native 32-bit adds alone (wrong sums)
    "low words only": [(_ADD_HI, _NO_HI)],
    # a and w read for every vector, as the parent did
    "no skip": [("      if (!any_row(bv, add.row0 * 0x01010101u, add.rows * 0x01010101u)) continue;\n", "")],
}


def _variant_source(text, variant):
    """The source with the fixed-point adds replaced for ``variant``, or None
    when the tree has no such adds."""
    if _ADD_LO not in text:
        if _OLD_ADD in text and variant in FIXED_VARIANTS:
            return text.replace(_OLD_ADD, FIXED_VARIANTS[variant].format(target=_OLD_TARGET))
        return None
    out = text
    for old, new in NEW_VARIANTS.get(variant, [(None, None)]):
        if old is None or old not in out:
            return None
        out = out.replace(old, new)
    return out


def variant_libraries():
    """{variant: KernelLibrary} of the scratch builds (under the ignored
    build directory, one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from getdist_tpu_torch._compile import build_once

    text = (_cuda.CSRC / "pair_hist.cu").read_text()
    names = dict.fromkeys([*FIXED_VARIANTS, *NEW_VARIANTS])
    sources = {}
    for name in names:
        src = _variant_source(text, name)
        if src is not None:
            path = _cuda.BUILD_DIR / "variants" / f"pair_hist_{name.replace(' ', '_').replace(',', '')}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(src)
            sources[name] = path

    def build(item):
        name, src = item

        def steps(out, tag):
            return [[[_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]]], []

        path, _, _ = build_once(f"variant_{src.stem}", [src], _cuda.NVCC_FLAGS, _cuda.BUILD_DIR / "variants", steps)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _cuda._SIGNATURES.items():
            if fn.startswith("pair_hist"):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        return name, _cuda.KernelLibrary(lib, path, 0.0, "")

    with ThreadPoolExecutor(len(sources) or 1) as pool:
        return dict(pool.map(build, sources.items()))


def with_library(lib, fn):
    """``fn`` run with the wrappers launching from ``lib``."""

    def run():
        saved = _cuda.library
        _cuda.library = lambda: lib
        try:
            return fn()
        finally:
            _cuda.library = saved

    return run


def atomic_sass(path, mangled):
    """{opcode: count} of the shared and global atomic instructions (ATOMS,
    ATOM, RED and their compare-and-swap forms) in the SASS of each kernel
    of the library at ``path`` whose mangled name holds ``mangled``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=300).stdout
    except (OSError, subprocess.TimeoutExpired) as err:
        return {"cuobjdump failed": str(err)}
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernel = name if mangled in name else None
            if kernel:
                found[kernel] = {}
        elif kernel:
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?((?:ATOMS|ATOMG|ATOM|RED|REDG|REDS|CAS)\S*)", line)
            if m:
                found[kernel][m.group(1)] = found[kernel].get(m.group(1), 0) + 1
    return found


def fixed_shapes():
    """The fixed-point route's calls on their paths' inputs, from one
    meanlikes run of the public entry on ``bounded_chain(1M)``: {name:
    (call(), plain())}, each returning (K, nbins, nbins) f32 or raw int64."""
    from chip_smoke import bounded_chain, entry_group_rows

    samples, weights, loglikes, names, ranges = bounded_chain(1_000_000)
    mc = MCSamples(samples=samples, weights=weights, loglikes=loglikes, names=names, ranges=ranges, device="cuda")
    d1, _, pairs = mc.fastTriangleDensities(meanlikes=True)
    st = mc._fast_chain_state()
    s_dev, w_dev, lw = st["samples"], st["weights"], st["like_weights"]
    binmin, binmax = d1["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    group = next(g for g in mc.fast_regrid_groups if g["bandwidths"] == "clamped")
    ixg, pag, pbg, _ = entry_group_rows(s_dev, d1["range"], group, pair_hist, batched)
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    n = ix.shape[1]
    like_scale = pair_hist.group_scale(lw, n)
    w_scale = pair_hist.group_scale(w_dev, n)
    hist, plain = pair_hist.pair_histograms, pair_hist.pair_histograms_plain
    return {
        f"K1 like f32, {len(pairs)} pairs": (lambda: hist(ix, lw, pa, pb), lambda: plain(ix, lw, pa, pb)),
        f"K1 like f32, clamped rescue's {pag.shape[0]} pairs": (
            lambda: hist(ixg, lw, pag, pbg), lambda: plain(ixg, lw, pag, pbg)),
        "K5 f32, raw on the group's scale": (
            lambda: pair_hist.pair_histograms_grouped(ix, w_dev, *plan, False, scale=w_scale, raw=True),
            lambda: pair_hist.pair_histograms_grouped_plain(ix, w_dev, *plan, False, scale=w_scale, raw=True)),
        "K1 like, group route (raw)": (
            lambda: hist(ix, lw, pa, pb, scale=like_scale, raw=True),
            lambda: plain(ix, lw, pa, pb, scale=like_scale, raw=True)),
        "K1 like f32, 8 pairs (split route)": (
            lambda: hist(ix, lw, pa[:8], pb[:8]), lambda: plain(ix, lw, pa[:8], pb[:8])),
    }, (ix, lw, len(pairs))


def device_ms_of(fn, reps=10):
    """Mean device ms per call of ``fn`` under torch.profiler (every kernel,
    memcpy and memset of the call)."""
    return device_by_kernel(fn, reps)["total"] / 1e3


def time_fixed(card):
    """The fixed-point route on each of its paths' shapes (see
    :func:`fixed_shapes`): bit-exact
    against the plain version and two calls bitwise equal, then CUDA-event
    times in turns of the tree's kernel and of the scratch builds
    (:data:`NEW_VARIANTS`, or :data:`FIXED_VARIANTS` in an older tree), the
    profiler's device time, and the atomic SASS of each build's fixed-point
    kernels. True when every exact call is bit-exact."""
    variants = variant_libraries()
    for name, lib in [("tree", _cuda.library()), *variants.items()]:
        print(f"SASS atomics, {name}: {json.dumps(atomic_sass(lib.path, 'pair_hist_uint8_kernelIy'))}")
    shapes, (ix, lw, k) = fixed_shapes()
    ok = True
    for name, (call, plain) in shapes.items():
        want = plain()
        got = call()
        exact = {"tree's kernel": torch.equal(got, want) and torch.equal(got, call())}
        if "carry split" in variants:
            exact["carry split"] = torch.equal(with_library(variants["carry split"], call)(), want)
        ok = ok and all(exact.values())
        runs = {"tree's kernel": call, **{v: with_library(lib, call) for v, lib in variants.items()}}
        times = in_turns(runs)
        dev = {key: round(device_ms_of(fn), 4) for key, fn in runs.items()}
        print(f"{card}: fixed point, {name}: bit-exact and repeatable {json.dumps(exact)}; ms per call (CUDA "
              f"events, two turns): {json.dumps({key: [round(x, 4) for x in v] for key, v in times.items()})}; "
              f"device ms (profiler): {json.dumps(dev)}")
        del want, got
    b, by = hist_bound(ix, lw, k, 256)
    print(f"bound of the {k}-pair call {b:.4f} ms ({by})")
    return ok


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
    if "--wide" in sys.argv[1:]:
        return 0 if time_wide(card) else 1
    if "--fixed" in sys.argv[1:]:
        return 0 if time_fixed(card) else 1

    samples, weights = make_chain(1_000_000, 30)
    s_dev, w_dev = batched.prepare_chain(samples, weights, "cuda")
    w8 = pair_hist.narrow_weights(w_dev)
    w_frac = w_dev * 0.37
    checks = {}

    # K1 / K5: the fused path's rows
    binmin, binmax = batched.all_1d_densities(s_dev, w_dev)["range"]
    ix = batched._fine_indices(s_dev.T.contiguous(), binmin, (binmax - binmin) / 255, 256).to(torch.uint8)
    p = ix.shape[0]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device="cuda")
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device="cuda")
    plan = [torch.from_numpy(x).cuda() for x in pair_hist.group_pairs(pairs)]
    k1_ref = pair_hist.pair_histograms_plain(ix, w_dev, pa, pb, integer_weights=True)
    for name, w, mode in (("uint8", w8, True), ("f32 integer", w_dev, True), ("f32", w_dev, False)):
        checks[f"K1 {name} weights"] = torch.equal(pair_hist.pair_histograms(ix, w, pa, pb, mode), k1_ref)
        checks[f"K5 {name} weights"] = torch.equal(
            pair_hist.pair_histograms_grouped(ix, w, *plan, int8_weights=mode), k1_ref
        )
    k1_runs = {
        "K1 uint8 weights": lambda: pair_hist.pair_histograms(ix, w8, pa, pb, integer_weights=True),
        "K1 f32 integer weights": lambda: pair_hist.pair_histograms(ix, w_dev, pa, pb, integer_weights=True),
        "K1 f32 fractional weights": lambda: pair_hist.pair_histograms(ix, w_frac, pa, pb, integer_weights=False),
        "K5 uint8 weights": lambda: pair_hist.pair_histograms_grouped(ix, w8, *plan, int8_weights=True),
        "K5 f32 weights": lambda: pair_hist.pair_histograms_grouped(ix, w_dev, *plan, int8_weights=False),
    }

    # K4: parity's sheared stack
    sx, sa, sb = sheared_stack(samples, weights)
    print(f"sheared stack: {tuple(sx.shape)} {sx.dtype}, {sa.shape[0]} pairs over {len(set(sa.tolist()))} a rows")
    sx_odd = torch.cat([sx, sx[:, :3]], dim=1).contiguous()  # columns off 16-byte boundaries
    w_odd = torch.cat([w8, w8[:3]]).contiguous()
    shuffle = torch.randperm(sa.shape[0], generator=torch.Generator().manual_seed(5)).cuda()
    sa_mixed, sb_mixed = sa[shuffle].contiguous(), sb[shuffle].contiguous()
    ref4 = pair_hist.pair_histograms_plain(sx, w_dev, sa, sb, integer_weights=True)
    k4 = {
        "K4 uint8 weights": lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, integer_weights=True),
        "K4 f32 integer weights": lambda: pair_hist.pair_histograms_dynamic(sx, w_dev, sa, sb, integer_weights=True),
        "K4 split 2, uint8 weights": forced_split(2, lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True)),
        "K4 split 4, uint8 weights": forced_split(4, lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True)),
        "K4 uint8 kernel alone": kernel_alone(sx, w8, sa, sb),
    }
    for name, fn in k4.items():
        checks[name] = torch.equal(fn(), ref4)
    checks["K4 pairs shuffled"] = torch.equal(
        pair_hist.pair_histograms_dynamic(sx, w8, sa_mixed, sb_mixed, True), ref4[shuffle]
    )
    checks["K4 N=1000003"] = torch.equal(
        pair_hist.pair_histograms_dynamic(sx_odd, w_odd, sa, sb, True),
        pair_hist.pair_histograms_plain(sx_odd, w_odd, sa, sb, integer_weights=True),
    )
    checks["K1 uint8 kernel alone"] = torch.equal(kernel_alone(ix, w8, pa, pb)(), k1_ref)
    got = pair_hist.pair_histograms_dynamic(sx, w_frac, sa, sb)
    want = pair_hist.pair_histograms_plain(sx, w_frac, sa, sb)
    frac_err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    del ref4, got, want, k1_ref
    print(f"bit-exact against the plain version: {json.dumps(checks)}; K4 fractional weights: max error "
          f"{frac_err:.3g} of max(1, |plain|)")
    breakdown = device_breakdown(lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa, sb, True))
    print(f"K4 (uint8 weights) device time per call under torch.profiler (us): {json.dumps(breakdown)}")

    k4_runs = {
        **k4,
        "K4 fractional weights": lambda: pair_hist.pair_histograms_dynamic(sx, w_frac, sa, sb),
        "K4 uint8 weights, pairs shuffled":
            lambda: pair_hist.pair_histograms_dynamic(sx, w8, sa_mixed, sb_mixed, True),
        "K4 uint8 weights, N=1000003": lambda: pair_hist.pair_histograms_dynamic(sx_odd, w_odd, sa, sb, True),
        "K1 uint8 kernel alone": kernel_alone(ix, w8, pa, pb),
    }
    times = in_turns({**k1_runs, **k4_runs})
    times["library bincount, K1's stack"] = [library_hist_ms(ix, w_dev, pa, pb, 256, 3)]
    times["library bincount, K4's stack"] = [library_hist_ms(sx, w_dev, sa, sb, 256, 3)]
    bound1, by1 = hist_bound(ix, w8, len(pairs), 256)
    bound4, by4 = hist_bound(sx, w8, sa.shape[0], 256)
    print(f"{card}: ms per call, two turns each: {json.dumps(times)}")
    print(f"bounds: K1's stack {bound1:.4f} ms ({by1}), K4's stack {bound4:.4f} ms ({by4}), uint8 weights")
    wide_ok = time_wide(card)
    return 0 if all(checks.values()) and wide_ok else 1


if __name__ == "__main__":
    sys.exit(main())
