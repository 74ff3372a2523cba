"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries land in ``build/kernels/`` at the repository root,
named by the SHA-256 of the source, the headers beside it (``*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded as
it is. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills)
is kept beside each library. ``launch`` calls one kernel's C entry point on
a device's current stream; the entry point's ctypes function is resolved and
typed once, and the stream is read without a device switch when the device
is already current (the host cost of a call is most of a small launch).
Inside a session's query (``repro_torch.obs.active()``) each launch counts
in the session's ``kernel_launches{symbol=...}`` and, with its tracer on,
sits in a ``launch`` span (category ``host``, attribute ``symbol``) that
holds the ctypes call, the stream lookup included.

Nothing here runs at import: the tests import every module on machines
with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.obs import active

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


class KernelLibrary:
    """One built source: the loaded ``ctypes.CDLL`` plus its build record."""

    def __init__(self, source: Path):
        self.source = source
        text = source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        self.path = BUILD_DIR / f"{source.stem}-{digest}.so"
        self.log_path = self.path.with_suffix(".log")
        self.build_seconds = 0.0      # 0.0: loaded from an earlier build
        t0 = time.perf_counter()
        if not self.path.exists():
            self._compile()
            self.build_seconds = time.perf_counter() - t0
        self.lib = ctypes.CDLL(str(self.path))

    def _compile(self) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        self.log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, self.path)   # atomic: a concurrent build sees all or nothing

    @property
    def ptxas_report(self) -> str:
        """``-Xptxas -v`` lines: registers and shared memory per kernel."""
        if not self.log_path.exists():
            return ""
        return "\n".join(ln for ln in self.log_path.read_text().splitlines()
                         if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln))


_LOADED: dict[str, KernelLibrary] = {}


def load(name: str) -> KernelLibrary:
    """Build (when the source changed) and load ``csrc/<name>.cu``."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = KernelLibrary(CSRC / f"{name}.cu")
    return lib


_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _function(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """``symbol`` of ``csrc/<name>.cu``, its argument types set: resolved
    once per process, so a launch looks it up in a dict."""
    fn = getattr(load(name).lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _FUNCTIONS[name, symbol] = fn
    return fn


def launch(name: str, symbol: str, device: torch.device, tensors, ints) -> None:
    """Launch ``symbol`` of ``csrc/<name>.cu`` on ``device``'s current stream:
    ``symbol(*tensor pointers (None -> NULL), *ints, stream)``; raise on the
    CUDA error code it returns. A device other than the current one is made
    current for the launch (the kernel launches on the current device).
    Counted, and spanned when tracing, on the active session's telemetry."""
    tel = active()
    if tel is not None:
        tel.launched(symbol)
        if tel.tracer.enabled:
            with tel.tracer.span("launch", cat="host", symbol=symbol):
                _launch(name, symbol, device, tensors, ints)
            return
    _launch(name, symbol, device, tensors, ints)


def _launch(name: str, symbol: str, device: torch.device, tensors, ints) -> None:
    fn = _FUNCTIONS.get((name, symbol)) or _function(name, symbol, len(tensors),
                                                     len(ints))
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        rc = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*ptrs, *ints, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
