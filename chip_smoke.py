#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch or exception exits
non-zero:

  1. card    nvidia-smi name and power limit, torch and CUDA versions
  2. build   nvcc builds every CUDA source of the main path from the
             checkout (build seconds, -Xptxas -v registers/shared memory)
  3. parity  each kernel against its plain torch version on the card, bit
             for bit, on seeded random rows at the main path's shapes (the
             k-reference kernel over INTER/SUB polarities, excludes and
             bound-0 rows), with both timed by CUDA events
  4. main    repro_torch.Miner counts triangles, cliques, three-chains and
             the 4-motifs on mico, youtube, wiki-vote and email-eu-core at
             the sizes below, and 4-cycle once more with fused_level=False;
             each count must equal the JAX package's (mico's three-chains
             also the closed form); every kernel's launch counter, zeroed
             just before this phase, must be > 0 after it
  5. profile mico's queries once more under torch.profiler: device busy
             time against the untraced wall time, and the top device kernels
  6. lines   the kernels JSON line, then the final {"ok": true, ...} line

Imports nothing of JAX or of the JAX package. Needs one card; exits non-zero,
printing no result, when torch sees no CUDA device or when the repository's
``src/repro_torch`` is not beside this file.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# The JAX package's counts on the same graphs, from
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "from repro.graph import \
#     get_dataset; from repro.mining.session import Miner; \
#     print(Miner(get_dataset(NAME, SCALE), backend='xla').count(QUERY))"
# (mico's and wiki-vote's 4-star, 4-cycle and 4-path build wedge-sized
# worklists, about 1.1e8 items on mico, too many for the JAX package on a CPU;
# they run on wiki-vote, the other Table IV graph the paper mines.)
MAIN_PATH = (
    ("mico", 1.0, (("triangle", 71459), ("4-clique", 4682), ("5-clique", 674),
                   ("three-chain-induced", 108741980), ("diamond", 505337),
                   ("paw", 96666391))),
    ("youtube", 1.0, (("triangle", 10152197),)),
    ("wiki-vote", 1.0, (("three-chain-induced", 9905212), ("diamond", 749669),
                        ("4-star", 626676141), ("4-cycle", 2759009),
                        ("paw", 33374526), ("4-path", 654442501))),
    ("email-eu-core", 0.25, (("triangle", 11502), ("4-clique", 10622),
                             ("three-chain", 138732), ("tailed-triangle", 1769583),
                             ("diamond", 151646), ("4-star", 1652486),
                             ("4-cycle", 161630), ("paw", 1035535),
                             ("4-path", 3252244))),
)
# run again with fused_level=False: one mark launch per reference; 4-cycle's
# count level has k = 2 references (one INTER, one SUB)
UNFUSED = ("email-eu-core", 0.25, "4-cycle", 161630, 2)
PROFILED = ("triangle", "4-clique", "5-clique", "three-chain-induced", "paw")

# (B, cap_a, cap_b): mico's level-1 chunk at the smallest and the largest
# degree bucket, and youtube's 128-row chunk at its 32768-key bucket
PARITY_SHAPES = ((2048, 128, 128), (2048, 2048, 2048), (128, 128, 32768))
TIMED_SHAPE = (2048, 2048, 2048)
# (B, cap_a, k, cap_b) of the k-reference kernel; the last stack (3 x 32768
# keys) is past shared memory and takes the global-memory search. Each shape
# runs every polarity of MULTI_POLS (k = len(pol)) bit for bit, and is timed
# with k - 1 INTER references then one SUB (4-cycle's count level: k = 2).
MULTI_SHAPES = ((2048, 128, 2, 128), (2048, 2048, 2, 2048), (128, 128, 3, 32768))
MULTI_POLS = ((1,), (0,), (1, 0), (0, 0), (1, 1, 0))
MULTI_TIMED = (2048, 2048, 2, 2048)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor fp32 rate, as the int rate
SENTINEL = 2**31 - 1
DEVICE = "cuda"

KERNELS = {
    "intersect_count": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/intersect.cu",
                            replaces="src/repro/kernels/intersect.py:187"),
    "intersect_expand": dict(route="cuda",
                             source="src/repro_torch/kernels/csrc/intersect.cu",
                             replaces="src/repro/kernels/intersect.py:214"),
    "intersect_mark": dict(route="cuda",
                           source="src/repro_torch/kernels/csrc/intersect.cu",
                           replaces="src/repro/kernels/intersect.py:250"),
    "intersect_multi": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/intersect.cu",
                            replaces="src/repro/kernels/intersect.py:326"),
}


def sorted_rows(gen, rows: int, cap: int, span: int, empty_frac: float = 0.05):
    """(rows, cap) int32 sorted sets over [0, ~span), random lengths, some
    empty, SENTINEL-padded, made on the card from ``gen``."""
    dev = gen.device
    step = max(2, (2 * span) // cap)
    gaps = torch.randint(1, step, (rows, cap), generator=gen, device=dev)
    keys = torch.cumsum(gaps, dim=1) - 1
    lens = torch.randint(0, cap + 1, (rows,), generator=gen, device=dev)
    lens[torch.rand(rows, generator=gen, device=dev) < empty_frac] = 0
    col = torch.arange(cap, device=dev)
    return torch.where(col[None] < lens[:, None], keys, SENTINEL).to(torch.int32)


def bound_vectors(gen, rows: int, span: int):
    """bounds from {SENTINEL, random, 0}; lbounds -1 or random below."""
    dev = gen.device
    pick = torch.randint(0, 3, (rows,), generator=gen, device=dev)
    rnd = torch.randint(0, span, (rows,), generator=gen, device=dev)
    bounds = torch.where(pick == 0, SENTINEL, torch.where(pick == 1, rnd, 0))
    low = torch.randint(0, 2, (rows,), generator=gen, device=dev) == 1
    lbounds = torch.where(low, rnd // 3, -1)
    return bounds.to(torch.int32), lbounds.to(torch.int32)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, warmed up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    print(f"[card] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.load("intersect")
    print(f"[build] intersect.cu: {time.perf_counter() - t0:.2f}s "
          f"(nvcc {lib.build_seconds:.2f}s) -> {lib.path.name}", flush=True)
    for ln in lib.ptxas_report.splitlines():
        print(f"[build]   {ln.strip()}", flush=True)


def _window_keys(x, bounds, lbounds) -> int:
    """Keys of the rows ``x`` (B, cap) or stack (k, B, cap) inside each
    row's (lbound, bound) window: what any implementation must read."""
    return int(((x > lbounds[:, None]) & (x < bounds[:, None])).sum())


def _bound(B: int, cap_b: int, live: int, a_live: int, k: int, out_bytes: int,
           extra_in: int = 0) -> tuple[float, str]:
    """(bound ms, what bounds it): the window keys and the per-row operands
    read once, the outputs written once, at 3.35 TB/s; or k binary searches
    of log2(cap_b) integer compares per A window key at the int rate."""
    bytes_ms = ((live + 2 * B + extra_in) * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = a_live * k * max(1, (cap_b - 1).bit_length()) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _record(report: dict, name: str, err: int) -> None:
    report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)


def _parity_pair(K, report, gen, B, cap_a, cap_b):
    """count, expand and mark at one shape: bit for bit, then timed."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    b = sorted_rows(gen, B, cap_b, span)
    bounds, lbounds = bound_vectors(gen, B, span)
    for bd, lbd in ((bounds, lbounds), (None, None)):
        got_c = K.intersect_count(a, b, bd, lbd)
        want_c = K.intersect_count_ref(a, b, bd, lbd)
        got_m, got_mc = K.intersect_expand(a, b, bd, lbd)
        want_m, want_mc = K.intersect_expand_ref(a, b, bd, lbd)
        got_k = K.intersect_mark(a, b, bd, lbd)
        want_k = K.intersect_mark_ref(a, b, bd, lbd)
        torch.cuda.synchronize()
        errs = {"intersect_count": (got_c - want_c).abs().max().item(),
                "intersect_expand": max((got_m - want_m).abs().max().item(),
                                        (got_mc - want_mc).abs().max().item()),
                "intersect_mark": (got_k - want_k).abs().max().item()}
        for name, err in errs.items():
            _record(report, name, err)
        if not (torch.equal(got_c, want_c) and torch.equal(got_m, want_m)
                and torch.equal(got_mc, want_mc) and torch.equal(got_k, want_k)):
            raise SystemExit(f"[parity] MISMATCH at B={B} caps=({cap_a},{cap_b}) "
                             f"bounds={'set' if bd is not None else 'None'}: {errs}")
    hits = int(K.intersect_count_ref(a, b, bounds, lbounds).sum())
    args = (a, b, bounds, lbounds)
    t = {name: (cuda_ms(lambda f=getattr(K, name): f(*args)),
                cuda_ms(lambda f=getattr(K, name + "_ref"): f(*args)))
         for name in ("intersect_count", "intersect_expand", "intersect_mark")}
    a_live = _window_keys(a, bounds, lbounds)
    live = a_live + _window_keys(b, bounds, lbounds)
    for name, (ms, plain_ms) in t.items():
        out_bytes = (B * 4 if name != "intersect_mark" else 0) \
            + (B * cap_a * 4 if name != "intersect_count" else 0)
        bound_ms, by = _bound(B, cap_b, live, a_live, 1, out_bytes)
        print(f"[parity] {name} B={B} caps=({cap_a},{cap_b}) equal bit for bit; "
              f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
              f"{bound_ms:.4f} ms ({live} window keys); hits {hits}", flush=True)
        if (B, cap_a, cap_b) == TIMED_SHAPE:
            report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=by, library_ms=None)


def _excludes(gen, a, E: int = 2):
    """(B, E) injectivity keys: keys of A at random slots (-1, the no-op,
    where a slot is padding)."""
    B, cap_a = a.shape
    col = torch.randint(0, cap_a, (B, E), generator=gen, device=a.device)
    ex = a.gather(1, col)
    return torch.where(ex == SENTINEL, -1, ex).contiguous()


def _parity_multi(K, report, gen, B, cap_a, k, cap_b):
    """The k-reference kernel at one shape, over every polarity, with and
    without bounds and excludes: bit for bit; timed at MULTI_TIMED."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    bs_all = torch.stack([sorted_rows(gen, B, cap_b, span) for _ in range(3)])
    bounds, lbounds = bound_vectors(gen, B, span)
    excl = _excludes(gen, a)
    kept = {}
    for pol in MULTI_POLS:
        bs = bs_all[: len(pol)].contiguous()
        for bd, lbd, ex in ((bounds, lbounds, excl), (None, None, excl),
                            (bounds, lbounds, None), (None, None, None)):
            got_m, got_c = K.intersect_multi(a, bs, pol, bd, lbd, ex)
            want_m, want_c = K.intersect_multi_ref(a, bs, pol, bd, lbd, ex)
            torch.cuda.synchronize()
            err = max((got_m - want_m).abs().max().item(),
                      (got_c - want_c).abs().max().item())
            _record(report, "intersect_multi", err)
            if not (torch.equal(got_m, want_m) and torch.equal(got_c, want_c)):
                raise SystemExit(f"[parity] MISMATCH intersect_multi B={B} "
                                 f"cap_a={cap_a} cap_b={cap_b} pol={pol} "
                                 f"bounds={'set' if bd is not None else 'None'} "
                                 f"excludes={'set' if ex is not None else 'None'}: {err}")
        kept[pol] = int(K.intersect_multi_ref(a, bs, pol, bounds, lbounds, excl)[1].sum())
    print(f"[parity] intersect_multi B={B} cap_a={cap_a} cap_b={cap_b} pols "
          f"{list(MULTI_POLS)} equal bit for bit; kept with bounds and excludes "
          f"{kept}", flush=True)
    pol = (1,) * (k - 1) + (0,)
    bs = bs_all[:k].contiguous()
    args = (a, bs, pol, bounds, lbounds, excl)
    ms = cuda_ms(lambda: K.intersect_multi(*args))
    plain_ms = cuda_ms(lambda: K.intersect_multi_ref(*args))
    a_live = _window_keys(a, bounds, lbounds)
    live = a_live + _window_keys(bs, bounds, lbounds)
    bound_ms, by = _bound(B, cap_b, live, a_live, k, B * 4 + B * cap_a * 4,
                          extra_in=excl.numel())
    print(f"[parity] intersect_multi B={B} cap_a={cap_a} k={k} cap_b={cap_b} "
          f"pol={pol}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
          f"{bound_ms:.4f} ms ({live} window keys)", flush=True)
    if (B, cap_a, k, cap_b) == MULTI_TIMED:
        report["intersect_multi"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=by, library_ms=None)


def phase_parity() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import intersect as K
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    report = {name: {"max_abs_err": 0} for name in KERNELS}
    for B, cap_a, cap_b in PARITY_SHAPES:
        _parity_pair(K, report, gen, B, cap_a, cap_b)
    for shape in MULTI_SHAPES:
        _parity_multi(K, report, gen, *shape)
    return report


def build_graphs() -> dict:
    """The main path's graphs, built on the host (set-up, not timed)."""
    from repro_torch.graph.datasets import dataset_stats, get_dataset
    graphs = {}
    for name, scale, _ in MAIN_PATH:
        t0 = time.perf_counter()
        graphs[name, scale] = get_dataset(name, scale)
        print(f"[main] {name} x{scale}: {dataset_stats(graphs[name, scale])} "
              f"built on the host in {time.perf_counter() - t0:.2f}s", flush=True)
    return graphs


def _mine(miner, kernels, label: str, query: str, want: int):
    """One counted query: (count, launches per kernel, the runner counters it
    added); exits on a count that differs from the JAX package's."""
    before = [k.launches for k in kernels]
    st0 = dict(miner.stats["runner"])
    chunks0 = miner.metrics.counter("feed_chunks").value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = miner.count(query)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = [k.launches - n for k, n in zip(kernels, before)]
    st = {k: v - st0[k] for k, v in miner.stats["runner"].items()}
    print(f"[main] {label} {query} = {got} (JAX package: {want}) {dt:.3f}s wall; "
          "launches " + " ".join(f"{k.__name__.removeprefix('intersect_')} {n}"
                                 for k, n in zip(kernels, launched))
          + f"; feed_chunks {miner.metrics.counter('feed_chunks').value - chunks0} "
          f"exec_misses {st['exec_misses']} items {st['items']} dispatches "
          f"{st['level_kernel_dispatches']} compactions {st['device_compactions']}",
          flush=True)
    if got != want:
        raise SystemExit(f"[main] MISMATCH {label} {query}: {got} != {want}")
    return got, launched, st


def phase_main_path(graphs: dict) -> dict:
    """Drive the port's Miner; every count must equal the JAX package's."""
    from repro_torch import Miner
    from repro_torch.kernels import intersect as K

    kernels = tuple(getattr(K, name) for name in KERNELS)
    for k in kernels:
        k.launches = 0
    counts = {}
    for name, scale, queries in MAIN_PATH:
        miner = Miner(graphs[name, scale], device=DEVICE)
        for query, want in queries:
            counts[name, scale, query] = _mine(miner, kernels, f"{name} x{scale}",
                                               query, want)
    # mico's induced three-chains, independently: Σ_v C(d_v, 2) − 3·triangles
    d = graphs["mico", 1.0].degrees.cpu().numpy().astype("int64")
    wedges = int((d * (d - 1) // 2).sum())
    closed = wedges - 3 * counts["mico", 1.0, "triangle"][0]
    print(f"[main] mico x1.0 three-chain-induced closed form {wedges} - 3 x "
          f"{counts['mico', 1.0, 'triangle'][0]} = {closed}", flush=True)
    if closed != counts["mico", 1.0, "three-chain-induced"][0]:
        raise SystemExit(f"[main] MISMATCH mico three-chain closed form {closed}")
    # fused_level=False: each call of a general level launches one mark per
    # reference instead of one k-reference kernel
    name, scale, query, want, k = UNFUSED
    miner = Miner(graphs[name, scale], device=DEVICE, fused_level=False)
    _, launched, st = _mine(miner, kernels, f"{name} x{scale} fused_level=False",
                            query, want)
    _, f_launched, f_st = counts[name, scale, query]
    mark, multi = list(KERNELS).index("intersect_mark"), list(KERNELS).index("intersect_multi")
    calls = f_launched[multi]
    rise = st["level_kernel_dispatches"] - f_st["level_kernel_dispatches"]
    print(f"[main] fused_level=False {query}: dispatches {st['level_kernel_dispatches']} "
          f"vs {f_st['level_kernel_dispatches']} fused, +{rise} over {calls} "
          f"general-level calls of k = {k} references; mark launches "
          f"{launched[mark]} vs {f_launched[mark]} fused", flush=True)
    if calls <= 0 or rise != (k - 1) * calls or launched[multi] \
            or launched[mark] != f_launched[mark] + k * calls:
        raise SystemExit("[main] fused_level=False did not trade each k-reference "
                         "launch for k mark launches")
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"[main] {name} was never launched on the main path")
    return launches


def phase_profile(graphs: dict) -> None:
    """Where mico's queries spend the card's time: a warm untraced run, then
    one run under torch.profiler; device busy = summed device self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Miner
    miner = Miner(graphs["mico", 1.0], device=DEVICE)
    for query in PROFILED:
        miner.count(query)                      # executables built
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miner.count(query)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            miner.count(query)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
        print(f"[profile] mico x1.0 {query}: {wall:.1f} ms wall untraced, device "
              f"busy {busy:.1f} ms = {100 * busy / wall:.1f}% of it; top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms "
                          f"x{e.count}" for e in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    report = phase_parity()
    graphs = build_graphs()
    launches = phase_main_path(graphs)
    phase_profile(graphs)
    rows = [{"name": name, **KERNELS[name], "launches": launches[name],
             "parity": True, **report[name]} for name in KERNELS]
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
