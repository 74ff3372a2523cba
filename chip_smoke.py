#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch or exception exits
non-zero:

  1. card    nvidia-smi name and power limit, torch and CUDA versions
  2. build   nvcc builds every CUDA source of the main path from the
             checkout (build seconds, -Xptxas -v registers/shared memory)
  3. parity  each kernel against its plain torch version on the card, bit
             for bit, on seeded random rows at the main path's shapes, with
             both timed by CUDA events
  4. main    repro_torch.Miner counts triangles and cliques on mico,
             youtube and email-eu-core at the sizes below; each count must
             equal the JAX package's; every kernel's launch counter, zeroed
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
MAIN_PATH = (
    ("mico", 1.0, (("triangle", 71459), ("4-clique", 4682), ("5-clique", 674))),
    ("youtube", 1.0, (("triangle", 10152197),)),
    ("email-eu-core", 0.25, (("triangle", 11502), ("4-clique", 10622))),
)

# (B, cap_a, cap_b): mico's level-1 chunk at the smallest and the largest
# degree bucket, and youtube's 128-row chunk at its 32768-key bucket
PARITY_SHAPES = ((2048, 128, 128), (2048, 2048, 2048), (128, 128, 32768))
TIMED_SHAPE = (2048, 2048, 2048)
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


def phase_parity() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import intersect as K
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    report = {name: {"max_abs_err": 0} for name in KERNELS}
    for B, cap_a, cap_b in PARITY_SHAPES:
        span = 2 * cap_b
        a = sorted_rows(gen, B, cap_a, span)
        b = sorted_rows(gen, B, cap_b, span)
        bounds, lbounds = bound_vectors(gen, B, span)
        for bd, lbd in ((bounds, lbounds), (None, None)):
            got_c = K.intersect_count(a, b, bd, lbd)
            want_c = K.intersect_count_ref(a, b, bd, lbd)
            got_m, got_mc = K.intersect_expand(a, b, bd, lbd)
            want_m, want_mc = K.intersect_expand_ref(a, b, bd, lbd)
            torch.cuda.synchronize()
            errs = {"intersect_count": (got_c - want_c).abs().max().item(),
                    "intersect_expand": max((got_m - want_m).abs().max().item(),
                                            (got_mc - want_mc).abs().max().item())}
            for name, err in errs.items():
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            if not (torch.equal(got_c, want_c) and torch.equal(got_m, want_m)
                    and torch.equal(got_mc, want_mc)):
                raise SystemExit(f"[parity] MISMATCH at B={B} caps=({cap_a},{cap_b}) "
                                 f"bounds={'set' if bd is not None else 'None'}: {errs}")
        hits = int(K.intersect_count_ref(a, b, bounds, lbounds).sum())
        t = {"intersect_count": (cuda_ms(lambda: K.intersect_count(a, b, bounds, lbounds)),
                                 cuda_ms(lambda: K.intersect_count_ref(a, b, bounds, lbounds))),
             "intersect_expand": (cuda_ms(lambda: K.intersect_expand(a, b, bounds, lbounds)),
                                  cuda_ms(lambda: K.intersect_expand_ref(a, b, bounds, lbounds)))}
        # the least any implementation must read: the keys of A and of B
        # inside each row's (lbound, bound) window, and the two bounds
        live = sum(int(((x > lbounds[:, None]) & (x < bounds[:, None])).sum())
                   for x in (a, b))
        for name, (ms, plain_ms) in t.items():
            out_bytes = B * 4 + (B * cap_a * 4 if name == "intersect_expand" else 0)
            bytes_ms = ((live + 2 * B) * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
            ops_ms = live * max(1, (cap_b - 1).bit_length()) / INT_OPS_PER_S * 1e3
            print(f"[parity] {name} B={B} caps=({cap_a},{cap_b}) equal bit for bit; "
                  f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms ({live} window keys); hits {hits}",
                  flush=True)
            if (B, cap_a, cap_b) == TIMED_SHAPE:
                report[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)
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


def phase_main_path(graphs: dict) -> dict:
    """Drive the port's Miner; every count must equal the JAX package's."""
    from repro_torch import Miner
    from repro_torch.kernels import intersect as K

    kernels = (K.intersect_count, K.intersect_expand)
    for k in kernels:
        k.launches = 0
    for name, scale, queries in MAIN_PATH:
        miner = Miner(graphs[name, scale], device=DEVICE)
        for query, want in queries:
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = miner.count(query)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = [k.launches - n for k, n in zip(kernels, before)]
            st = miner.stats["runner"]
            print(f"[main] {name} x{scale} {query} = {got} (JAX package: {want}) "
                  f"{dt:.3f}s wall; launches count {launched[0]} expand "
                  f"{launched[1]}; feed_chunks "
                  f"{miner.metrics.counter('feed_chunks').value} exec_misses "
                  f"{st['exec_misses']} items {st['items']}", flush=True)
            if got != want:
                raise SystemExit(f"[main] MISMATCH {name} x{scale} {query}: "
                                 f"{got} != {want}")
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
    for query in ("triangle", "4-clique", "5-clique"):
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
