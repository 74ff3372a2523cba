"""Stream: the paper's first-class sparse-vector data type, on torch tensors.

The counterpart of ``repro.core.stream``. A stream is a sorted int32 key
row of *static capacity*, padded with ``SENTINEL`` (2^31-1), plus a live
length (a 0-d int32 tensor, so a stream built on the card stays there).
(key,value) streams carry an f32 values row aligned with the keys. Every
ISA op (``repro_torch.core.isa``) keeps the invariants the property tests
hold:

  I1  keys[:length] strictly increasing (edge lists / sparse indices are sets)
  I2  keys[length:] == SENTINEL
  I3  0 <= length <= capacity
  I4  capacity % LANE == 0 (the CUDA kernels take any such multiple)

The paper's Stream Mapping Table (SMT) tracked stream-ID -> stream-register
mappings at decode time; on the card that bookkeeping is the allocator's.
``StreamTable`` keeps the *programming model* (Table II handles with
define/active bits) for the API layer.

Constructors take ``device=``, ``cuda`` unless the caller passes ``cpu``;
``stream_from_slice`` builds on the device of the memory it reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)  # 2147483647, "End Of Stream"
LANE = 128  # minimum stream capacity granule


def round_capacity(n: int) -> int:
    """Smallest multiple of LANE >= max(n, 1)."""
    return max(LANE, ((int(n) + LANE - 1) // LANE) * LANE)


@dataclasses.dataclass(frozen=True)
class Stream:
    """A key stream or (key,value) stream (values is None for key streams)."""

    keys: torch.Tensor                   # (capacity,) int32, sorted, SENTINEL-padded
    length: torch.Tensor                 # ()          int32
    values: torch.Tensor | None = None   # (capacity,) f32, aligned with keys

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    @property
    def has_values(self) -> bool:
        return self.values is not None

    @property
    def device(self) -> torch.device:
        return self.keys.device


def make_stream(keys, values=None, capacity: int | None = None,
                device="cuda") -> Stream:
    """Build a stream from a host/np array of sorted unique keys."""
    keys = np.asarray(keys, dtype=np.int32)
    assert keys.ndim == 1
    n = int(keys.shape[0])
    cap = round_capacity(capacity if capacity is not None else n)
    out = np.full((cap,), SENTINEL, dtype=np.int32)
    out[:n] = keys
    vals = None
    if values is not None:
        v = np.zeros((cap,), dtype=np.float32)
        v[:n] = np.asarray(values, dtype=np.float32)
        vals = torch.from_numpy(v).to(device)
    return Stream(keys=torch.from_numpy(out).to(device),
                  length=torch.tensor(n, dtype=torch.int32, device=device), values=vals)


def empty_stream(capacity: int, with_values: bool = False, device="cuda") -> Stream:
    cap = round_capacity(capacity)
    return Stream(
        keys=torch.full((cap,), SENTINEL, dtype=torch.int32, device=device),
        length=torch.tensor(0, dtype=torch.int32, device=device),
        values=torch.zeros((cap,), dtype=torch.float32, device=device)
        if with_values else None,
    )


def stream_from_slice(memory: torch.Tensor, start, length, capacity: int) -> Stream:
    """S_READ: initialize a key stream from ``memory[start : start+length]``.

    ``capacity`` is the stream-register slot size; ``start``/``length`` are
    ints or 0-d tensors on ``memory``'s device (read there, never synced to
    the host). Elements past ``length`` are SENTINEL-padded.
    """
    cap = round_capacity(capacity)
    dev, n = memory.device, memory.shape[0]
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    length = torch.as_tensor(length, dtype=torch.int32, device=dev)
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    # the memory reads as if padded by cap SENTINELs: a window starting near
    # its end reads SENTINEL past it, never shifts back onto a neighbour's
    # keys (the start clamps into the padded array, as a dynamic slice's does)
    pos = start.clamp(0, n) + idx
    window = torch.where(pos < n, memory[pos.clamp(max=n - 1)], SENTINEL) if n \
        else torch.full_like(pos, SENTINEL)
    keys = torch.where(idx < length, window, SENTINEL).to(torch.int32)
    return Stream(keys=keys, length=length)


def to_host(s: Stream) -> np.ndarray:
    """Return the live keys as a host numpy array (test/debug helper)."""
    n = int(s.length)
    return s.keys.cpu().numpy()[:n]


class StreamTable:
    """Programming-model SMT: named handles with define/active bits.

    Mirrors §IV-B semantics at the API level: registering a handle sets
    V_D=V_A=1; releasing clears V_D immediately (later references raise) and
    V_A at "retire" (here: immediately, since execution is eager).
    ``max_active`` models the paper's 16 stream registers; exceeding it is an
    error, mirroring the stall-on-full behaviour.
    """

    def __init__(self, max_active: int = 16):
        self.max_active = max_active
        self._streams: dict[int, Stream] = {}
        self._next = 0

    def register(self, s: Stream) -> int:
        if len(self._streams) >= self.max_active:
            raise RuntimeError(
                f"stream table full ({self.max_active} active); "
                "S_FREE (release) a stream first")
        sid = self._next
        self._next += 1
        self._streams[sid] = s
        return sid

    def get(self, sid: int) -> Stream:
        if sid not in self._streams:
            raise KeyError(f"stream id {sid} is not defined (S_FREE'd or never read)")
        return self._streams[sid]

    def release(self, sid: int) -> None:
        if sid not in self._streams:
            raise KeyError(f"stream id {sid} is not defined")
        del self._streams[sid]

    def __len__(self) -> int:
        return len(self._streams)
