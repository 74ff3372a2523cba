#!/usr/bin/env python3
"""Time the S_VINTER designs that the port does not use beside its kernels.

    python3 scripts/bench_vinter_variants.py          # on one NVIDIA GPU

``scripts/vinter_variants.cu`` holds the designs measured and dropped (teams
of 8, 16 or 32 lanes a pair with B staged in shared memory; B staged with
its values, its keys alone or not at all under four keys a lane in
lockstep; a grid tile of 2 A rows x 4 B rows, read where they lie or
staged). This script builds it with the port's nvcc flags into
``build/exp/``, runs each design and the port's wrapper (``vinter``,
``vinter_grid``) on the same inputs, holds every result against the plain
version (within rtol 1e-5 and atol 1e-6, the sparse path's tolerance: the
data's normal values cancel, and the plain version sums in f32), and
prints each one's device ms per launch (the profiler's, as
``chip_smoke.py:kernel_times``) beside the bound. Shapes:

  spmm pairs  the first 64 x 64 block of email-core's spmm, as 4096 row
              pairs (repeat_interleave / repeat rows: the paired form)
  spmm grid   the same block as a (64, 64) grid
  ttv         the first 512 fibres of chicago-s against the 240-key vector
              at row stride 0 (the paired form, as sparse.ttv calls it)
  long        2048 pairs of caps 2048 (chip_smoke.py's VINTER_LONG)
  grid long   a (32, 64) grid of caps 2048 (chip_smoke.py's GRID_LONG)

The last line is the JSON of every time; ``--out`` also writes it to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "vinter_variants.cu"
HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rows.cuh"
# exp_vinter's variants (teams at short rows only) and exp_vinter_grid's
PAIR_VARIANTS = {8: "team 8, B staged", 16: "team 16, B staged", 32: "team 32, B staged",
                 1: "warp, B keys+values staged", 2: "warp, B keys staged",
                 3: "warp, B in device memory"}
GRID_VARIANTS = {0: "2x4 tile, rows in device memory", 1: "2x4 tile staged (halved to fit)"}


def build_variants():
    """nvcc scripts/vinter_variants.cu (keyed by its and rows.cuh's hash)."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    digest = hashlib.sha256(SOURCE.read_bytes() + HEADER.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "exp" / f"vinter_variants-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, n_ints in ((lib.exp_vinter, 6), (lib.exp_vinter_grid, 6)):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class Refused(Exception):
    """A design that does not take the shape (its staging overflows shared
    memory): cudaErrorInvalidValue before any launch."""


def call(fn, tensors, ints) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if rc == 1:
        raise Refused
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} {ints}: CUDA error {rc}")


def pair_cases(cs):
    """(name, (ak, av, bk, bv), bound ms, bound_by) of the paired shapes."""
    import numpy as np

    from repro_torch.sparse import from_dense, random_csf
    a_d, b_d = cs.dense_matrix(1005, 0.025, 1), cs.dense_matrix(1005, 0.025, 2)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    rows = np.nonzero(np.diff(a.indptr) > 0)[0][:64]
    cols = np.nonzero(np.diff(b.indptr) > 0)[0][:64]
    ak, av, bk, bv = (torch.from_numpy(x).to("cuda")
                      for x in (*a.padded_rows(rows), *b.padded_rows(cols)))
    nr, nc = len(rows), len(cols)
    spmm = (ak.repeat_interleave(nc, 0), av.repeat_interleave(nc, 0), bk.repeat(nr, 1),
            bv.repeat(nr, 1))
    yield ("spmm pairs", spmm, *cs._vinter_bound(spmm[0], spmm[2], nr * nc))
    name, shape, nnz = cs.SPARSE_TENSORS[0]
    fk, fv, vk, vv = cs.ttv_block(random_csf(shape, nnz, seed=3), shape[2])
    n = fk.shape[0]
    yield ("ttv", (fk, fv, vk.expand(n, -1), vv.expand(n, -1)),
           *cs._vinter_bound(fk, vk, n))
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, cap_a, cap_b = cs.VINTER_LONG
    lk, lb = cs.sorted_rows(gen, B, cap_a, cap_a + cap_b), cs.sorted_rows(gen, B, cap_b,
                                                                         cap_a + cap_b)
    args = (lk, cs.values_like(gen, lk, dyadic=False), lb,
            cs.values_like(gen, lb, dyadic=False))
    yield ("long", args, *cs._vinter_bound(lk, lb, B))


def grid_cases(cs):
    """The same for the grid shapes."""
    import numpy as np

    from repro_torch.sparse import from_dense
    a_d, b_d = cs.dense_matrix(1005, 0.025, 1), cs.dense_matrix(1005, 0.025, 2)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    rows = np.nonzero(np.diff(a.indptr) > 0)[0][:64]
    cols = np.nonzero(np.diff(b.indptr) > 0)[0][:64]
    ak, av, bk, bv = (torch.from_numpy(x).to("cuda")
                      for x in (*a.padded_rows(rows), *b.padded_rows(cols)))
    yield ("spmm grid", (ak, av, bk, bv), *cs._vinter_grid_bound(ak, bk))
    gen = torch.Generator(device="cuda").manual_seed(1)
    nr, nc, cap_a, cap_b = cs.GRID_LONG
    lk, lb = cs.sorted_rows(gen, nr, cap_a, cap_a + cap_b), cs.sorted_rows(gen, nc, cap_b,
                                                                          cap_a + cap_b)
    args = (lk, cs.values_like(gen, lk, dyadic=False), lb,
            cs.values_like(gen, lb, dyadic=False))
    yield ("grid long", args, *cs._vinter_grid_bound(lk, lb))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_vinter_variants: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import svinter as SV
    lib = build_variants()
    results = {}

    def timed(shape, design, run, want, bound_ms, by):
        try:
            got = run()
        except Refused:
            print(f"[variants] {shape}: {design}: does not take this shape", flush=True)
            return
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[variants] MISMATCH {shape} {design}: "
                             f"{(got - want).abs().max().item()}")
        t = cs.kernel_times(run, reps=50, host_calls=10)
        results.setdefault(shape, {})[design] = t["device_ms"]
        print(f"[variants] {shape}: {design}: {t['device_ms']:.4f} ms device "
              f"({100 * bound_ms / t['device_ms']:.1f}% of the {bound_ms:.3g} ms {by} "
              f"bound)", flush=True)

    for shape, (ak, av, bk, bv), bound_ms, by in pair_cases(cs):
        want = SV.vinter_ref(ak, av, bk, bv)
        timed(shape, "port", lambda: SV.vinter(ak, av, bk, bv), want, bound_ms, by)
        for variant, design in PAIR_VARIANTS.items():
            if variant in (8, 16, 32) and ak.shape[1] > 128:
                continue
            out = torch.empty(ak.shape[0], dtype=torch.float32, device="cuda")

            def run(v=variant, o=out):
                call(lib.exp_vinter, (ak, av, bk, bv, o),
                     (ak.shape[0], ak.shape[1], bk.shape[1], bk.stride(0), 0, v))
                return o
            timed(shape, design, run, want, bound_ms, by)
    for shape, (ak, av, bk, bv), bound_ms, by in grid_cases(cs):
        want = SV.vinter_grid_ref(ak, av, bk, bv)
        timed(shape, "port", lambda: SV.vinter_grid(ak, av, bk, bv), want, bound_ms, by)
        for variant, design in GRID_VARIANTS.items():
            out = torch.empty((ak.shape[0], bk.shape[0]), dtype=torch.float32, device="cuda")

            def run(v=variant, o=out):
                call(lib.exp_vinter_grid, (ak, av, bk, bv, o),
                     (ak.shape[0], bk.shape[0], ak.shape[1], bk.shape[1], 0, v))
                return o
            timed(shape, design, run, want, bound_ms, by)
    line = json.dumps({"device_ms": results})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
