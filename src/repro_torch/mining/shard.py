"""Mesh-sharded mining: data-parallel wavefronts over a list of devices.

The counterpart of ``repro.mining.shard``. The wavefront interpreter
(``engine.WaveRunner``) is parallel over the level-1 edge feed: every
edge's pattern-tree descent is independent. ``ShardedWaveRunner`` keeps
the interpreter's host loop and its level bodies as they are, and runs
each level body once per shard, each shard a ``torch.device`` of the
mesh (``distributed.sharding.make_mining_mesh``). One Python process
drives every shard, as one host drives the JAX package's ``shard_map``:

  * the CSR graph is replicated once per distinct device (eight shards on
    one card share one copy), and every shard intersects against its own;
  * wave buffers (prefix columns, carries, compacted (src, verts)
    worklists) are ``Shards``: one tensor a shard, on the shard's device,
    all of one shape, so the interpreter's batch arithmetic reads a
    shard's sizes;
  * a count leaf's per-shard int64 partials move to shard 0's device and
    are summed there (the JAX package's ``psum``; int64 needs no limbs),
    one reduction per leaf call (``stats["psum_reductions"]``); an
    aggregate leaf's values reduce with the leaf's op (a dead shard holds
    the op's identity) and its live counts are summed;
  * an expand level's per-shard meta rows are stacked on shard 0's device
    and read in one host sync: the per-shard live totals drive lockstep
    chunking (every shard walks ``ceil(max totals / chunk)`` steps over
    the same window of its own worklist; past its own total a shard's
    items carry bound 0), and next-level capacities take the max over
    shards (upper bounds, so lossless);
  * an emit level's per-shard totals are read at once, then each live
    shard's rows are copied, shard after shard (row order differs from the
    unsharded run's; the row multiset does not).

The host orchestration (plan descent, forest fan-out, residual packs) is
the unsharded runner's: the per-shard state it tracks is the live-total
vector (``_pack_total``, ``_chunk_steps``). Counts are bit-identical to
the unsharded session's, the same integer summands grouped otherwise.
A level step is one dispatch (one traced ``dispatch`` span, ending in a
synchronize of every distinct card) whatever the number of shards; each
shard's kernels launch asynchronously on its own device.

The level-1 feed is dealt by ``shard_edge_steps``: per degree bucket,
edges are dealt round robin across shards (CSR order groups a hub's edges,
which a contiguous split would pin on one shard; dealing bounds the
per-step imbalance at one item). ``stats["shard_feed_items"]`` holds the
per-shard feed items (a labelled counter series, ``shard=s``);
``feed_partition="contiguous"`` keeps the contiguous split as the foil.

Use it through the session (``Miner(g, mesh=8)``, or
``Miner(g, mesh=8, mesh_devices=("cuda:0",) * 8)`` on one card); the
runner prefixes every executable key with ``("mesh", axis, shards)`` and
the session's cache with ``session.mesh_signature``, so sharded and
unsharded executables never collide and a repeated sharded query builds
nothing.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.stream import round_capacity
from repro_torch.graph.csr import CSRGraph

from .engine import (WaveRunner, _host, _one_ahead, _pow2cap, _pow2caps, directed_edges,
                     half_edges)

__all__ = ["FEED_PARTITIONS", "ShardedWaveRunner", "Shards", "shard_edge_steps"]

FEED_PARTITIONS = ("round_robin", "contiguous")


def shard_edge_steps(g: CSRGraph, chunk: int, shards: int, symmetric: bool = True,
                     mode: str = "round_robin"):
    """Level-1 feed for an ``shards``-way mesh: yields lockstep steps
    ``(cap, v0, v1, n)`` where ``v0``/``v1`` are (shards * nb,) int32
    arrays holding one nb-item block per shard back to back, and ``n`` is
    the (shards,) per-shard live count.

    Per degree bucket of E edges the block width is
    ``nb = min(chunk, pow2cap(ceil(E / shards)))``: the bucket's work
    divided across the mesh, so a sharded pass takes about ``1/shards``
    the steps of the unsharded feed. Each step spans ``shards * nb``
    consecutive bucket edges:

    * ``round_robin`` (default): shard s takes ``step_edges[s::shards]``,
      so every hub's run of edges spreads across the mesh; per-step
      imbalance is at most one item.
    * ``contiguous``: shard s takes the s-th contiguous nb-slice, the
      hub-pinning foil (a partial step loads the low shards).

    Both modes enumerate the same edge multiset; only the edge -> shard
    assignment differs, so counts are unaffected.
    """
    if mode not in FEED_PARTITIONS:
        raise ValueError(f"feed_partition must be one of {FEED_PARTITIONS}, got {mode!r}")
    edges = half_edges(g) if symmetric else directed_edges(g)
    if edges.shape[0] == 0:
        return
    caps = _pow2caps(g.degrees.cpu().numpy()[edges[:, 0]])
    for cap in np.unique(caps):
        sel = edges[caps == cap]
        e = sel.shape[0]
        nb = min(chunk, _pow2cap(max(-(-e // shards), 1)))
        span = shards * nb
        for lo in range(0, e, span):
            blk = sel[lo: lo + span]
            v0 = np.zeros((shards, nb), np.int32)
            v1 = np.zeros((shards, nb), np.int32)
            n = np.zeros((shards,), np.int32)
            for s in range(shards):
                part = blk[s::shards] if mode == "round_robin" \
                    else blk[s * nb: (s + 1) * nb]
                k = part.shape[0]
                n[s] = k
                v0[s, :k] = part[:, 0]
                v1[s, :k] = part[:, 1]
            yield int(cap), v0.reshape(-1), v1.reshape(-1), n


class Shards(tuple):
    """A sharded wave buffer: one tensor a shard, each on its shard's
    device, all of one shape. ``shape`` is a shard's."""

    @property
    def shape(self) -> torch.Size:
        return self[0].shape


def _at(x, s: int):
    """Shard ``s``'s part of one executable argument: its tensor of a
    ``Shards``, its entry of a per-shard count vector, the same of each
    member of a tuple; anything else (a window start, None) as it is."""
    if isinstance(x, Shards):
        return x[s]
    if isinstance(x, tuple):
        return tuple(_at(v, s) for v in x)
    if isinstance(x, np.ndarray):
        return int(x[s])
    return x


class ShardedWaveRunner(WaveRunner):
    """``WaveRunner`` with every level body run once per shard of ``mesh``.

    See the module docstring for the contract. Only the executable hook
    (``_wrap``), the feed, the meta and emit reads, the chunk steps and the
    synchronize differ from the base interpreter; the level bodies are
    shared, so the two runners cannot drift apart.
    """

    def __init__(self, g: CSRGraph, mesh, exec_cache, *, axis: str = "mine",
                 feed_partition: str = "round_robin", chunk: int | None = None,
                 device_compact: bool = True, record: bool = False,
                 fused_level: bool = True, telemetry=None):
        if not device_compact:
            raise ValueError("ShardedWaveRunner requires device_compact=True: the host "
                             "compaction oracle is single-device")
        if record:
            raise ValueError("ShardedWaveRunner does not support record=True (waves are "
                             "per shard; record on the unsharded runner)")
        if axis not in dict(mesh.shape):
            raise ValueError(f"axis {axis!r} not in mesh axes {tuple(dict(mesh.shape))}")
        if feed_partition not in FEED_PARTITIONS:
            raise ValueError(f"feed_partition must be one of {FEED_PARTITIONS}, "
                             f"got {feed_partition!r}")
        # the CSR once per distinct device: shards on one card share it
        copies = {d: g.to(d) for d in dict.fromkeys(mesh.devices)}
        super().__init__(copies[mesh.devices[0]], exec_cache, chunk=chunk, telemetry=telemetry,
                         fused_level=fused_level)
        self.g = Shards(copies[d] for d in mesh.devices)
        self.mesh = mesh
        self.axis = axis
        self.feed_partition = feed_partition
        self._shards = len(mesh.devices)
        self._cards = tuple(d for d in copies if d.type == "cuda")
        self._exec_prefix = ("mesh", axis, self._shards)
        # the cross-shard reduction counter joins the legacy view; the
        # per-shard feed items are a labelled series whose legacy key is
        # the list of its values
        self._ct["psum_reductions"] = self.stats.expose_counter("psum_reductions",
                                                                self.metrics)
        self._shard_feed = [self.metrics.counter("shard_feed_items", shard=s)
                            for s in range(self._shards)]
        self.stats.expose("shard_feed_items", lambda: [c.value for c in self._shard_feed])

    # ------------------------------------------------------------ dispatch
    def _gather(self, xs) -> torch.Tensor:
        """Per-shard tensors stacked on shard 0's device: (shards, ...)."""
        return torch.stack([x.to(self.device) for x in xs])

    def _wrap(self, key: tuple, build: Callable) -> Callable:
        """Run the body under ``key`` once per shard. A count leaf returns
        the sum of the shards' partials, an aggregate leaf its op over the
        shards' values and the sum of their live counts (one f32 pair), a
        chunk slice ``Shards`` of each output; an expand, emit or residual
        pack returns ``Shards`` of its blocks and its last output (meta
        row or total) stacked a shard a row on shard 0's device."""
        kind = key[0]

        def built():
            body = build()

            def each(*args):
                return [body(*(_at(a, s) for a in args)) for s in range(self._shards)]
            if kind == "pcount":
                return lambda *args: self._gather(each(*args)).sum()
            if kind == "pagg":
                reduce = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[key[1].agg]

                def agg(*args):
                    pairs = self._gather(each(*args))
                    return torch.stack([reduce(pairs[:, 0]), pairs[:, 1].sum()])
                return agg
            if kind == "pchunk":
                def chunk(*args):
                    fwd, vch, carry = zip(*each(*args))
                    return (tuple(Shards(c) for c in zip(*fwd)), Shards(vch),
                            None if carry[0] is None else Shards(carry))
                return chunk

            def blocks(*args):
                *outs, last = zip(*each(*args))
                return (*(Shards(o) for o in outs), self._gather(last))
            return blocks
        return built

    def _sync(self) -> None:
        for d in self._cards:
            torch.cuda.synchronize(d)

    def _bump(self, op, host: bool = False) -> None:
        super()._bump(op, host)
        if op.kind == "count":
            self._ct["psum_reductions"].inc()

    # ------------------------------------------------------------ feed
    def _edge_feed(self, symmetric: bool = True):
        """Sharded level-1 feed, double-buffered: each step's per-shard
        blocks go from pinned memory to their shards' devices one step
        ahead of compute; ``n`` is the per-shard live-count vector."""
        def steps():
            for cap, v0, v1, n in shard_edge_steps(self.host_g, self.chunk, self._shards,
                                                   symmetric, self.feed_partition):
                for c, k in zip(self._shard_feed, n):
                    c.inc(int(k))
                blk = np.stack([v0, v1]).reshape(2, self._shards, -1)
                dv = [self._upload(blk[:, s], d) for s, d in enumerate(self.mesh.devices)]
                yield cap, Shards(x[0] for x in dv), Shards(x[1] for x in dv), v1, n
        return _one_ahead(steps())

    # ------------------------------------------------------------ per-shard totals
    def _pack_total(self, tot):
        tot = np.array(tot.tolist(), dtype=np.int64)
        return tot, bool(tot.max() > 0)

    def _chunk_steps(self, totals):
        """Lockstep chunking: every shard slices the same [lo, lo + chunk)
        window of its own worklist, ``m`` the live width of each (0 past a
        shard's own total); the shard with the most survivors sets the
        number of steps."""
        for lo in range(0, int(totals.max()), self.chunk):
            yield lo, np.clip(totals - lo, 0, self.chunk)

    def _expand_device(self, op, caps_sig, cap_base, out_cap, out_items, vals, carry, n):
        """The level's meta rows, a shard a row, read in one host sync:
        per-shard live totals (lockstep chunking), capacities the max over
        shards, the ride the sum of the totals."""
        self._bump(op)
        fn = self._plan_expand_fn(op, caps_sig, cap_base, out_cap, out_items)
        rows2, src, verts2, meta = self._dispatch(op, fn, (self.g, vals, carry, n),
                                                  items=n, caps_sig=caps_sig)
        meta = np.array(meta.tolist(), dtype=np.int64)      # (shards, m)
        totals = meta[:, 0]
        total = int(totals.sum())
        self._ct["host_syncs"].inc()
        self._ct["device_compactions"].inc()
        self._ct["items"].inc(total)
        self._h_wave_items.observe(total)
        if total == 0:
            return None
        caps2 = {c: _pow2cap(max(int(d), 1))
                 for c, d in zip(op.gather_refs, meta[:, 2:].max(axis=0))}
        cap2 = round_capacity(int(meta[:, 1].max())) if op.carry_out else 0
        return rows2, src, verts2, totals, caps2, cap2, total

    def _plan_emit(self, op, caps_sig, cap_base, out_cap, out_items, cols, vals, carry,
                   n) -> list:
        """One emit-level step: one read of the shards' totals, then one
        copy of each live shard's rows, concatenated shard after shard."""
        self._bump(op)
        fn = self._plan_emit_fn(op, caps_sig, cap_base, out_cap, out_items)
        emb, totals = self._dispatch(op, fn, (self.g, vals, carry, n), items=n,
                                     caps_sig=caps_sig)
        totals = totals.tolist()
        total = sum(totals)
        self._ct["device_compactions"].inc()
        self._ct["items"].inc(total)
        self._h_wave_items.observe(total)
        if total == 0:
            return []
        return [np.concatenate([_host(e[:t]) for e, t in zip(emb, totals) if t])]
