"""Wavefront pattern-enumeration engine on torch tensors: device-resident,
host-orchestrated.

The counterpart of ``repro.mining.engine``. A compiled ``WavePlan`` runs in
level-synchronous waves:

  level 1: the edge list (half edges v1 < v0 when the plan's restrictions
           break that symmetry, straight from the CSR offset register),
           bucketed by the degree of v0 and fed in fixed-width chunks
  level l: each surviving work item's base stream is intersected with one
           neighbour stream under its bounds (the clique case is
           S_l = S_{l-1} ∩ N(v) ∩ [0, v)), then counted or compacted

Between levels the survivors are compacted on the device into the next
wave's (rows, verts) buffers: an INTER level's by ``ops.xinter_compact_csr``
(the expand kernel packs each row's survivors, the items kernel writes the
worklist), a SUB or general level's by a keep mark and the prefix-sum
scatter ``batch_compact_scan``. Per level only one
small meta vector (total, max survivor count, max degree of each gathered
column) crosses to the host, to size the next level's capacities; count
levels leave one int64 partial per chunk on the device, summed and read
once per run. Padded tail items carry bound 0, so they contribute nothing.

A count leaf under a device-compacted expand reads the parent's compacted
worklist in place, with no chunk sliced and no torch op around its launch:
one launch a chunk adds the chunk's count into one int64 accumulator a leaf
a run. A carried leaf whose one INTER or SUB reference and one upper bound
are the parent's new vertex (a clique's last level, diamond's SUB leaf)
takes ``ops.xcount_worklist`` (the form ``carried``); any other leaf with
at least one reference and one launch a call (paw's, 4-cycle's) the
k-reference kernel's ``ops.xlevel_count_worklist`` (the form ``csr``),
which reads the parent's new vertex and the columns it forwards through
``src`` where the expand left them. Aggregate and tail leaves, residual
branches, leaves with no reference, every other leaf under
``fused_level=False``, the host path, ``record`` and the sharded runner
read sliced chunks.

A level runs in one of three shapes, as in the reference engine:

  'inter'  one INTER reference: the count / expand kernels, which read a
           fresh base from the CSR too and write no mark
  'sub'    one SUB reference (an induced non-edge): the count kernel's SUB
           form on a count leaf, the mark kernel (the window inside it) on
           an expand level
  general  k INTER/SUB references and injectivity excludes: the
           k-reference kernel (``fused_level``), or with
           ``fused_level=False`` one mark launch per reference ANDed into
           the keep mask; a window-only level (k = 0) launches nothing

Every kernel reads a level's reference rows straight from the CSR (vertex
ids and caps), as it reads a count leaf's and an INTER expand level's fresh
base. Padded rows are gathered (``graph.csr.padded_rows``) only for what
still takes them: a SUB or general expand level's fresh base, which the
compaction packs, and the base of a window-only or ``fused_level=False``
level.

An aggregate leaf (a weighted query, ``plan.compile_pattern(aggregate=)``)
replaces the count leaf: one launch of the value-lane kernel
(``ops.xlevel_agg``) per call whatever the level's shape (none for a
window-only leaf), leaving one f32 (value, live) pair per chunk on the
device; the pairs are read once per run and reduced on the host in
float64, in chunk order.

``run_set`` runs a ``forest.PlanForest`` (a batch of plans merged on their
shared prefixes) in one feed pass per orientation: a shared expand node is
dispatched once per chunk and fanned out to its child branches; a child
whose branch deferred constraints into residuals first gets its own packed
worklist (``compact_indices_scan``); a count leaf equal to a sibling
expand's op rides it (its count is the expand's survivor total, read in the
same meta sync). Results equal per-plan ``run`` calls.

``device_compact=False`` takes the host path instead, the oracle the
device path is held against: a level's keep mask (one mark launch per
reference), one compact-rows kernel launch front-packing the survivors,
one read of (rows, counts) to the host, the ``compact`` oracle
(``np.nonzero``), and the next wave's chunks uploaded to the device.
``record=True`` keeps each wave's live rows and vertices in ``trace``, so
the two paths can be compared wave for wave.

An emit level (``plan.compile_pattern(emit=True)``, ``Miner.embeddings``)
ends a plan in its embeddings instead of a count: the level's survivors
are compacted as an expand level's are (the same kernels), the output
columns are gathered through the worklist's ``src`` on the device, and one
read per call brings the live (total, k) rows to the host, where
``_finalize`` concatenates them into one (N, k) int32 matrix. On the host
path the level's keep mask, one compact-rows launch and the ``compact``
oracle give the same rows in the same order.

Every level call goes through ``WaveRunner._dispatch``. With the session's
tracer on it opens a ``dispatch`` span (op kind and level, items,
capacities, executable-cache hit) around the level body's torch ops and
launches; ``run`` and ``run_set`` open the ``execute``, ``feed``, per-level
``L{l}:{kind}`` and ``finalize`` spans around it, and the ``host`` spans
name the rest of the loop: ``launch`` (``kernels/build.py``), ``sync`` (a
host read that waits on the card: a level's meta, a residual pack's total,
an emit's rows, the partials), ``slice`` (the torch ops that cut the next
wave's chunk) and ``upload`` (``_upload``: pin and H2D copy). No span
synchronizes: every span is host time, the card's time is the device
trace's, and a level span's self time is the engine's own Python (cache
lookup, arguments, counters). With the tracer off (the default) no span is
opened and no span name or attribute is built. ``run`` and ``run_set`` make
the session's telemetry ``obs.active()`` for the kernels' launch counter
(``kernel_launches{symbol=...}``); ``_upload`` counts the bytes it sends to
a card in ``feed_h2d_bytes``.

The module-level waves (``edge_wave``, ``expand_count``, ``expand``,
``pair_wave``, ``wave_chunks``) are the one-shot forms the host oracle
``apps.triangle_list_host`` and the benches use; they run on the device of
the graph's tensors, through the same kernel wrappers. The runner's
``count_edges``, ``clique``, ``three_chain_induced`` and
``tailed_triangle`` are the JAX runner's one-shots: each compiles one plan
and runs it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.batch import batch_compact_scan, compact_indices_scan
from repro_torch.core.stream import LANE, SENTINEL, round_capacity
from repro_torch.graph.csr import CSRGraph, padded_rows, padded_value_rows
from repro_torch.kernels.compact import compact_rows
from repro_torch.kernels.intersect import MAX_COLS, MAX_REFS
from repro_torch.kernels.ops import (xcount_worklist, xinter, xinter_compact_csr,
                                     xinter_count, xinter_count_csr, xlevel_agg,
                                     xlevel_agg_csr, xlevel_compact, xlevel_compact_csr,
                                     xlevel_count, xlevel_count_csr, xlevel_count_worklist,
                                     xmark_csr, xsub_compact_csr, xsub_count_csr)
from repro_torch.obs import NO_SPAN, LegacyStatsView, Telemetry, activate
from repro_torch.values import edge_value_lookup, prefix_scale

from .plan import (TAILED_TRIANGLE, THREE_CHAIN_INDUCED, LevelOp, WavePlan, clique_pattern,
                   compile_pattern, pattern)


def half_edges(g: CSRGraph) -> np.ndarray:
    """(E/2, 2) array of (v0, v1) with v1 < v0 — the symmetry-breaking edge
    frontier, read directly via the CSR offset register (offsets[v0] = number
    of neighbours < v0)."""
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    counts = g.offsets.cpu().numpy().astype(np.int64)
    v0 = np.repeat(np.arange(g.num_vertices, dtype=np.int32), counts)
    # position of each kept slot within its row
    pos = np.arange(counts.sum(), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    v1 = indices[indptr[v0].astype(np.int64) + pos]
    return np.stack([v0, v1], axis=1)


def directed_edges(g: CSRGraph) -> np.ndarray:
    """(E, 2) all directed edges (v0, v1) in CSR order."""
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    v0 = np.repeat(np.arange(g.num_vertices, dtype=np.int32), np.diff(indptr))
    v1 = g.indices.cpu().numpy()[: g.num_edges]
    return np.stack([v0, v1], axis=1)


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


@dataclasses.dataclass
class Wave:
    """A compacted frontier on the host: prefix rows + the vertex that
    extends each."""

    rows: np.ndarray    # (N, cap) int32 sorted SENTINEL-padded prefix streams
                        # (``edge_wave``'s: a tensor on the graph's device)
    verts: np.ndarray   # (N,) int32 extension vertex (also the bound)

    def __len__(self) -> int:
        return int(self.verts.shape[0])


def compact(rows: np.ndarray, counts: np.ndarray, limit: int | None = None,
            return_src: bool = False):
    """Host compaction oracle: expand (rows, counts) into the next Wave.

    Every valid key rows[i, j] (j < counts[i]) becomes a work item whose
    prefix is rows[i] and whose extension vertex/bound is that key, in
    row-major (i, j) order — the order the device path's scan compaction
    gives. The prefix capacity shrinks to the padded max survivor length.
    ``return_src`` also returns each item's source row index."""
    counts = counts[: limit] if limit is not None else counts
    rows = rows[: counts.shape[0]]
    maxc = int(counts.max()) if counts.size else 0
    if maxc == 0:
        return (None, None) if return_src else None
    cap = round_capacity(maxc)
    col = np.arange(rows.shape[1])
    ii, jj = np.nonzero(col[None, :] < counts[:, None])
    verts = rows[ii, jj].astype(np.int32)
    wave = Wave(rows=rows[ii, :cap], verts=verts)
    return (wave, ii) if return_src else wave


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _live(n) -> int:
    """A chunk's live items: ``n``, or the sum of a sharded chunk's
    per-shard counts (``mining.shard``)."""
    return n if isinstance(n, int) else int(np.sum(n))


@functools.cache
def _level_name(level: int, kind: str) -> str:
    """A level span's name, ``L{level}:{kind}``: one string a level."""
    return f"L{level}:{kind}"


@functools.cache
def _caps_name(caps_sig: tuple) -> str:
    """A dispatch span's ``caps`` attribute: formatted once a signature."""
    return str(tuple(caps_sig))


def _one_ahead(items):
    """Yield ``items`` one behind their production: item N+1 (its uploads
    issued) is made before item N is handed to the consumer."""
    pending = None
    for item in items:
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


def _pow2cap(n: int) -> int:
    """Smallest power-of-two LANE multiple >= n (degree bucket capacity)."""
    c = LANE
    while c < n:
        c *= 2
    return c


def _pow2caps(d: np.ndarray) -> np.ndarray:
    """``_pow2cap`` over an array of degrees."""
    caps = np.full(d.shape, LANE, dtype=np.int64)
    while (small := caps < d).any():
        caps[small] *= 2
    return caps


def edge_chunks(g: CSRGraph, chunk: int, symmetric: bool = True):
    """Host half of the level-1 feed: yields (cap, v0, v1, n) degree-bucketed
    chunk-padded int32 vertex arrays *without* materialising neighbour rows —
    row gathers happen on the device so the feed can be double-buffered."""
    edges = half_edges(g) if symmetric else directed_edges(g)
    if edges.shape[0] == 0:
        return
    caps = _pow2caps(g.degrees.cpu().numpy()[edges[:, 0]])
    for cap in np.unique(caps):
        sel = edges[caps == cap]
        # fixed chunk width: one executable shape per degree bucket
        nb = min(chunk, _pow2cap(sel.shape[0]))
        for lo in range(0, sel.shape[0], nb):
            sl = sel[lo: lo + nb]
            n = sl.shape[0]
            v0 = _pad_to(sl[:, 0].astype(np.int32), nb, 0)
            v1 = _pad_to(sl[:, 1].astype(np.int32), nb, 0)
            yield int(cap), v0, v1, n


def _on(g: CSRGraph, x) -> torch.Tensor:
    """``x`` (a host array or a tensor) as a tensor on ``g``'s device."""
    if isinstance(x, torch.Tensor):
        return x.to(g.device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(g.device)


def edge_wave(g: CSRGraph, chunk: int, symmetric: bool = True):
    """Yield level-1 waves: (v0 rows are N(v0) on ``g``'s device, vert =
    v1), bucketed by the prefix vertex's degree so per-edge work is
    O(bucket), not O(max degree)."""
    for cap, v0, v1, n in edge_chunks(g, chunk, symmetric):
        rows, _ = padded_rows(g, _on(g, v0), cap)
        yield Wave(rows=rows, verts=v1), n


def _neighbor_cap(g: CSRGraph, verts) -> int:
    """Degree-bucket capacity of the largest neighbour list of ``verts``."""
    deg = _host(g.degrees)
    mx = int(deg[_host(verts)].max()) if len(verts) else 1
    return _pow2cap(max(mx, 1))


def expand_count(g: CSRGraph, wave: Wave, bounded: bool = True) -> torch.Tensor:
    """counts[i] = |rows_i ∩ N(verts_i) ∩ [0, verts_i)| (bound dropped when
    ``bounded`` is False): one count-kernel launch on a card. Neighbour
    capacity = the chunk's degree bucket."""
    capn = _neighbor_cap(g, wave.verts)
    verts = _on(g, wave.verts)
    nbr, _ = padded_rows(g, verts, capn)
    return xinter_count(_on(g, wave.rows), nbr, verts if bounded else None)


def expand(g: CSRGraph, wave: Wave, out_cap: int | None = None):
    """Materialise S_l rows on the host: (rows (N, out_cap), counts (N,)),
    from the mark kernel and one compact-rows launch on a card."""
    capn = _neighbor_cap(g, wave.verts)
    rows_a = _on(g, wave.rows)
    cap = out_cap or min(rows_a.shape[1], capn)
    verts = _on(g, wave.verts)
    nbr, _ = padded_rows(g, verts, capn)
    rows, counts = xinter(rows_a, nbr, verts, out_cap=cap)
    return _host(rows), _host(counts)


def pair_chunks(g: CSRGraph, edges: np.ndarray, chunk: int):
    """Host half of the pair feed: yields (cap_a, cap_b, v0, v1, n) without
    materialising rows (the device gathers them)."""
    if edges.shape[0] == 0:
        return
    deg = _host(g.degrees)
    cap_a = _pow2caps(deg[edges[:, 0]])
    cap_b = _pow2caps(deg[edges[:, 1]])
    keys = cap_a << 32 | cap_b
    for key in np.unique(keys):
        ca, cb = int(key >> 32), int(key & 0xFFFFFFFF)
        sel = edges[keys == key]
        nb = min(chunk, _pow2cap(sel.shape[0]))
        for lo in range(0, sel.shape[0], nb):
            sl = sel[lo: lo + nb]
            n = sl.shape[0]
            v0 = _pad_to(sl[:, 0].astype(np.int32), nb, 0)
            v1 = _pad_to(sl[:, 1].astype(np.int32), nb, 0)
            yield ca, cb, v0, v1, n


def pair_wave(g: CSRGraph, edges: np.ndarray, chunk: int):
    """Yield degree-bucketed padded row pairs for an (N, 2) vertex-pair list:
    (rows_a, rows_b on ``g``'s device, v0, v1, n_valid)."""
    for ca, cb, v0, v1, n in pair_chunks(g, edges, chunk):
        rows_a, _ = padded_rows(g, _on(g, v0), ca)
        rows_b, _ = padded_rows(g, _on(g, v1), cb)
        yield rows_a, rows_b, v0, v1, n


def wave_chunks(wave: Wave, chunk: int):
    """Split a host wave into padded chunks; yields (Wave, n_valid).

    Padding uses vertex 0 with bound 0 => zero contribution."""
    n = len(wave)
    for lo in range(0, max(n, 1), chunk):
        r = wave.rows[lo: lo + chunk]
        v = wave.verts[lo: lo + chunk]
        if r.shape[0] == 0:
            continue
        k = r.shape[0]
        yield Wave(rows=_pad_to(r, chunk, SENTINEL), verts=_pad_to(v, chunk, 0)), k


DEFAULT_CHUNK = 4096


def choose_chunk(cap: int, budget_bytes: int = 64 << 20) -> int:
    """Chunk size so one wave's buffers stay within ``budget_bytes``."""
    per_row = cap * 4 * 4  # rows + neighbour rows + output + slack
    c = max(LANE, budget_bytes // max(per_row, 1))
    return int(min(DEFAULT_CHUNK * 4, (c // LANE) * LANE))


# count_edges back-compat surface: the four (symmetric, bounded) triangle
# stream shapes as one-level plans
_EDGE_COUNT_PATTERNS = {
    (True, True): pattern("edges-sym-bounded", 3, [(0, 1), (0, 2), (1, 2)],
                          restrictions=[(1, 0), (2, 1)]),
    (True, False): pattern("edges-sym", 3, [(0, 1), (0, 2), (1, 2)],
                           restrictions=[(1, 0)]),
    (False, True): pattern("edges-bounded", 3, [(0, 1), (0, 2), (1, 2)],
                           restrictions=[(2, 1)]),
    (False, False): pattern("edges", 3, [(0, 1), (0, 2), (1, 2)]),
}


class WaveRunner:
    """Stream-program interpreter: executes a compiled ``WavePlan`` (``run``)
    or a ``PlanForest`` (``run_set``) on the device-resident wavefront
    pipeline.

    * **executable cache** keyed by (chunk, device_compact, fused_level,
      kind, LevelOp, capacities, ...): an executable is a built level body;
      a miss is a rebuild (``stats['exec_misses']``);
    * **fused expand + compaction**: survivors are compacted on the
      device; the only per-level host traffic is the meta vector that sizes
      the next level's capacities (``device_compact=False``: the host path,
      see the module docstring);
    * **prefix-column forwarding**: the compiler's liveness fields
      (``out_cols``/``gather_refs``) say which matched vertices deeper
      levels reference; they are gathered through the compacted ``src``
      indices on the device;
    * **double-buffered feed**: level-1 edge chunks go to the device from
      pinned memory one chunk ahead of compute;
    * **per-chunk device partials**: count levels reduce to one int64 per
      chunk on the device, summed and read once at the end of ``run``;
      aggregate leaves to one f32 (value, live) pair per chunk, read once
      and reduced on the host;
    * **the sharded runner's seam**: ``mining.shard.ShardedWaveRunner``
      runs the same level bodies once per shard by overriding ``_wrap``
      (which makes each executable), the feed, the meta and emit
      reads (``_expand_device``, ``_plan_emit``), ``_pack_total`` and
      ``_chunk_steps``, under its own ``_exec_prefix``.

    ``stats['host_syncs']`` counts the reference engine's sync points: a
    level's meta read, a residual pack's total, a host-path compaction and
    one per leaf partial or emitted block (the port reads a plan's count
    partials in one transfer; the count stays the reference's so that the
    two engines compare). ``level_execs`` counts level calls per (kind,
    level); the registry's ``wave_items`` histogram holds each expand or
    emit call's survivor total.
    """

    # prepended to every executable key: the sharded runner's
    # ("mesh", axis, shards) keeps its executables apart from these
    _exec_prefix: tuple = ()
    # whether carried count leaves may read their worklist in place; the
    # sharded runner's leaves reduce shard partials and read sliced chunks
    _in_place_leaves: bool = True

    # ``stats`` keys, in the reference engine's order; each is a registry
    # counter the view derives from
    _STAT_KEYS = ("exec_hits", "exec_misses", "host_syncs",
                  "device_compactions", "host_compactions", "items",
                  "level_kernel_dispatches", "count_rides")

    def __init__(self, g: CSRGraph, exec_cache, chunk: int | None = None,
                 telemetry: Telemetry | None = None, fused_level: bool = True,
                 device_compact: bool = True, record: bool = False):
        self.g = g
        # general levels: one k-reference launch (True) or one mark launch
        # per reference (False)
        self.fused_level = fused_level
        # False: every expand takes the host path (compact oracle)
        self.device_compact = device_compact
        self.record = record
        self.trace: list[tuple[int, np.ndarray, np.ndarray]] = []
        self.device = g.device
        # host copy for the feed and capacity sizing (free when g is on the CPU)
        self.host_g = g.to("cpu")
        # chunk <= 2^15 keeps chunk sizes, and so every counter, equal to the
        # reference engine's (whose (hi, lo) int32 partials need the clamp)
        self.chunk = min(chunk or choose_chunk(g.padded_max_degree), 1 << 15)
        # session-lifetime executable cache (mining.session.ExecutableCache)
        self._exec_cache = exec_cache
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.metrics = self.telemetry.metrics
        self.stats = LegacyStatsView()
        self._ct = {k: self.stats.expose_counter(k, self.metrics)
                    for k in self._STAT_KEYS}
        self._h_wave_items = self.metrics.histogram("wave_items")
        self._ct_feed_chunks = self.metrics.counter("feed_chunks")
        # bytes ``_upload`` sent to a card (the feed's, and the host path's waves)
        self._ct_h2d_bytes = self.metrics.counter("feed_h2d_bytes")
        # aggregate-leaf calls: each rides the leaf's one membership launch,
        # so this counts value lanes, not extra launches
        self._ct_value_lanes = self.metrics.counter("value_lane_dispatches")
        # count-leaf calls that read their parent's worklist in place
        self._ct_in_place = self.metrics.counter("leaf_inplace_calls")
        # the run's in-place leaf accumulators, one int64 a leaf
        self._accs: dict[int, torch.Tensor] = {}
        self.level_execs: dict[tuple[str, int], int] = {}
        # whether the last ``_executable`` call built its executable (the
        # dispatch span's ``exec_cached`` attribute)
        self._exec_fresh = False

    # ------------------------------------------------------------ levels
    @staticmethod
    def _fused_shape(op: LevelOp) -> str | None:
        """'inter'/'sub' when one fused bounded kernel covers the level."""
        if op.exclude:
            return None
        if len(op.inter) == 1 and not op.sub:
            return "inter"
        if len(op.sub) == 1 and not op.inter:
            return "sub"
        return None

    def _level_dispatches(self, op: LevelOp, host: bool = False) -> int:
        """Membership-kernel launches one level call issues: 1 for a fused
        or a general level, k per general level with ``fused_level=False``
        and k per host-path level (one mark per reference), 0 for a
        window-only level. An aggregate leaf counts as its count twin does,
        as in the reference engine, though it always issues one value-lane
        launch (none when k = 0)."""
        k = len(op.inter) + len(op.sub)
        if host:
            return k
        if self._fused_shape(op) is not None:
            return 1
        if k == 0:
            return 0
        return 1 if self.fused_level else k

    def _bump(self, op: LevelOp, host: bool = False) -> None:
        key = (op.kind, op.level)
        self.level_execs[key] = self.level_execs.get(key, 0) + 1
        self._ct["level_kernel_dispatches"].inc(self._level_dispatches(op, host))

    # ------------------------------------------------------------ cache
    def _executable(self, key: tuple, build: Callable) -> Callable:
        fn, fresh = self._exec_cache.get_or_build(self._exec_key(key),
                                                  self._wrap(key, build))
        self._exec_fresh = fresh
        self._ct["exec_misses" if fresh else "exec_hits"].inc()
        return fn

    def _exec_key(self, key: tuple) -> tuple:
        return (self.chunk, self.device_compact, self.fused_level) + self._exec_prefix + key

    def _note_slice(self, op: LevelOp, b: int, out_cap: int, cap2: int) -> None:
        """Count the lookup of the chunk slice that ``_plan_chunk_fn`` would
        make, and build nothing: an in-place leaf slices no chunk, but the
        exec counters stay the JAX engine's, which slices."""
        fresh = self._exec_cache.note(self._exec_key(("pchunk", op, b, out_cap, cap2,
                                                      self.chunk)))
        self._ct["exec_misses" if fresh else "exec_hits"].inc()

    # ------------------------------------------------------------ traced dispatch
    def _dispatch(self, op: LevelOp, fn: Callable, args: tuple, items=None,
                  caps_sig: tuple = (), host: bool = False, form: str | None = None):
        """Run one level executable. With tracing on, the call sits in a
        ``dispatch`` span (op kind and level, membership launches, items,
        capacity signature, executable-cache hit; ``inplace`` and the
        leaf's ``form`` for a leaf read in place): the host's time to issue
        the level body's torch ops and launches, not the card's. With
        tracing off: the bare call."""
        tr = self.telemetry.tracer
        if not tr.enabled:
            return fn(*args)
        attrs = {"kind": op.kind, "level": op.level,
                 "dispatches": self._level_dispatches(op, host),
                 "exec_cached": not self._exec_fresh}
        if op.agg is not None:
            attrs["agg"] = op.agg
        if items is not None:
            attrs["items"] = _live(items)
        if caps_sig:
            attrs["caps"] = _caps_name(caps_sig)
        if host:
            attrs["host"] = True
        if form is not None:
            attrs["inplace"] = True
            attrs["form"] = form
        with tr.span("dispatch", cat="dispatch", **attrs):
            return fn(*args)

    def _wrap(self, key: tuple, build: Callable) -> Callable:
        """The build function of the executable under ``key`` (its kind first:
        "pcount", "pagg", "pexpand", "pemit", "pchunk", "rpack", ...). Here
        the body as it is; the sharded runner's runs the body once per
        shard and reduces or stacks what the shards return."""
        return build

    def _span(self, name: str, **attrs):
        """A span of the session's tracer; a no-op context with tracing off.
        For spans whose attributes cost nothing to build."""
        tr = self.telemetry.tracer
        return tr.span(name, **attrs) if tr.enabled else NO_SPAN

    def _host_span(self, name: str):
        """A ``host`` span (``sync``, ``slice``, ``upload``)."""
        tr = self.telemetry.tracer
        return tr.span(name, cat="host") if tr.enabled else NO_SPAN

    def _level_span(self, op: LevelOp, n: int):
        """The span of one op's processing of one wave chunk (its children's
        levels nest inside); name and attributes built only when tracing."""
        tr = self.telemetry.tracer
        if not tr.enabled:
            return NO_SPAN
        return tr.span(_level_name(op.level, op.kind), cat="level", level=op.level,
                       kind=op.kind, items=_live(n))

    def _feed_span(self, cap0: int, n):
        """The span of one level-1 feed chunk; built only when tracing."""
        tr = self.telemetry.tracer
        if not tr.enabled:
            return NO_SPAN
        return tr.span("feed", cat="level", cap=cap0, items=_live(n))

    # ------------------------------------------------------------ feed
    def _upload(self, x: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        """Host array -> ``device`` (the runner's by default), from pinned
        memory without blocking the host when the device is a card; the
        bytes sent to a card count in ``feed_h2d_bytes``."""
        device = device or self.device
        with self._host_span("upload"):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                self._ct_h2d_bytes.value += t.nbytes
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

    def _edge_feed(self, symmetric: bool = True):
        """Double-buffered level-1 feed: (cap, dv0, dv1, v1_host, n).

        Chunk N+1 is copied to the device before chunk N is handed to the
        consumer."""
        return _one_ahead((cap, *self._upload(np.stack([v0, v1])), v1, n)
                          for cap, v0, v1, n in edge_chunks(self.host_g, self.chunk, symmetric))

    # ------------------------------------------------------------ plan parts
    @staticmethod
    def _in_cols(op: LevelOp) -> tuple[int, ...]:
        """Prefix columns whose *values* the level executable consumes (an
        emit level's output columns too)."""
        cols = set(op.val_refs()) | {c for c in op.gather_refs if c < op.level}
        if op.kind == "emit":
            cols |= {c for c in op.out_cols if c < op.level}
        return tuple(sorted(cols))

    @staticmethod
    def _min_ub(op: LevelOp, get):
        ub = get[op.ub[0]]
        for u in op.ub[1:]:
            ub = torch.minimum(ub, get[u])
        return ub

    @staticmethod
    def _max_lb(op: LevelOp, get):
        lb = get[op.lb[0]]
        for w in op.lb[1:]:
            lb = torch.maximum(lb, get[w])
        return lb

    def _ub_vec(self, op: LevelOp, g, get, n: int, nrows: int) -> torch.Tensor:
        """Per-row effective upper bound for the kernels: min over the ``ub``
        columns (SENTINEL when unbounded), then zeroed for padding rows and
        residual-failing items — bound 0 kills the whole row in the kernel.
        Built on ``g``'s device (a sharded runner's shard's)."""
        if op.ub:
            ub = self._min_ub(op, get)
        else:
            ub = torch.full((nrows,), SENTINEL, dtype=torch.int32, device=g.device)
        ok = torch.arange(nrows, device=g.device) < n
        for kind, i, j in op.residual:
            ok = ok & ((get[i] < get[j]) if kind == "lt" else (get[i] != get[j]))
        return torch.where(ok, ub, 0)

    def _base(self, op: LevelOp, g, get, carry, caps: dict) -> torch.Tensor:
        return carry if op.use_carry else \
            padded_rows(g, get[op.base], caps[op.base])[0]

    @staticmethod
    def _csr_base(op: LevelOp, get, carry, caps: dict):
        """A kernel's base operand without a gather -> (keyword arguments,
        rows): the carried survivor stream as padded rows ``a``, else the
        base column's vertex ids ``va`` at their cap."""
        if op.use_carry:
            return dict(a=carry), carry.shape[0]
        return dict(va=get[op.base], cap_a=caps[op.base]), get[op.base].shape[0]

    def _mask_ops(self, op: LevelOp, caps: dict):
        """The ``fused_level=False`` general path: AND one membership mark
        per INTER/SUB reference (one mark launch each, the reference read
        from the CSR) with the bound, injectivity, residual and live masks."""

        def keep_of(g, base, get, n):
            keep = base != SENTINEL
            for j in op.inter:
                keep = keep & xmark_csr(g.indptr, g.indices, base, get[j], caps[j])
            for j in op.sub:
                keep = keep & ~xmark_csr(g.indptr, g.indices, base, get[j], caps[j])
            if op.ub:
                keep = keep & (base < self._min_ub(op, get)[:, None])
            if op.lb:
                keep = keep & (base > self._max_lb(op, get)[:, None])
            for e in op.exclude:
                keep = keep & (base != get[e][:, None])
            for kind, i, j in op.residual:
                ok = (get[i] < get[j]) if kind == "lt" else (get[i] != get[j])
                keep = keep & ok[:, None]
            live = torch.arange(base.shape[0], device=base.device) < n
            return keep & live[:, None]
        return keep_of

    @staticmethod
    def _excl_vals(op: LevelOp, get):
        """Per-row injectivity keys for the k-reference kernel's excludes
        operand, (B, E) int32 (None when the level declares none)."""
        if not op.exclude:
            return None
        return torch.stack([get[e] for e in op.exclude], dim=1)

    def _plan_count_fn(self, op: LevelOp, caps_sig: tuple, cap_base: int):
        """Terminal count level -> one int64 partial per chunk, on device."""
        return self._executable(("pcount", op, caps_sig, cap_base),
                                lambda: self._count_body(op, caps_sig))

    def _count_body(self, op: LevelOp, caps_sig: tuple):
        in_cols = self._in_cols(op)
        caps = dict(caps_sig)
        fused = self._fused_shape(op)
        keep_of = self._mask_ops(op, caps)
        refs = op.inter + op.sub
        pol = (1,) * len(op.inter) + (0,) * len(op.sub)
        use_xlevel = fused is None and self.fused_level

        def fn(g, vals, carry, n):
            get = dict(zip(in_cols, vals))
            if fused or (use_xlevel and refs):
                # rows straight from the CSR: the references always, the
                # base unless it is the carried survivor stream
                base_kw, nrows = self._csr_base(op, get, carry, caps)
                ub = self._ub_vec(op, g, get, n, nrows)
                lb = self._max_lb(op, get) if op.lb else None
                if fused:
                    ref = refs[0]
                    xcount = xinter_count_csr if fused == "inter" else xsub_count_csr
                    counts = xcount(g.indptr, g.indices, get[ref], caps[ref], **base_kw,
                                    bounds=ub, lbounds=lb)
                else:
                    counts = xlevel_count_csr(g.indptr, g.indices,
                                              torch.stack([get[j] for j in refs]),
                                              [caps[j] for j in refs], pol, **base_kw,
                                              bounds=ub, lbounds=lb,
                                              excludes=self._excl_vals(op, get))
                return self._count_total(op, g, get, counts)
            base = self._base(op, g, get, carry, caps)
            if use_xlevel:
                # a window-only level (k = 0): the plain form, no kernel
                ub = self._ub_vec(op, g, get, n, base.shape[0])
                lb = self._max_lb(op, get) if op.lb else None
                counts = xlevel_count(base, None, pol, ub, lbounds=lb,
                                      excludes=self._excl_vals(op, get))
            else:
                counts = keep_of(g, base, get, n).sum(dim=1, dtype=torch.int32)
            return self._count_total(op, g, get, counts)
        return fn

    @staticmethod
    def _count_total(op: LevelOp, g, get, counts):
        """A count leaf's int64 partial: the row counts, times the tail's
        degree factor when the plan folded its last level into one."""
        counts = counts.long()
        if op.tail is not None:
            col, c = op.tail
            counts = counts * (g.degrees[get[col].long()].long() - c)
        return counts.sum()

    def _plan_agg_fn(self, op: LevelOp, caps_sig: tuple, cap_base: int):
        """Terminal SVPU aggregate level (``op.agg``) -> one f32 (value,
        live) pair per chunk, on device. The cache key's prefix carries
        ``fused_level``, as the reference's key does."""
        return self._executable(("pagg", op, caps_sig, cap_base),
                                lambda: self._agg_body(op, caps_sig))

    def _agg_body(self, op: LevelOp, caps_sig: tuple):
        """The aggregate leaf. An embedding's value is the product over all
        pattern edges of the edge weight, from three sources: prefix-prefix
        edges fold into the per-row ``scale`` (``prefix_scale``); the
        leaf's own INTER references give theirs in the kernel's value lane,
        read beside their keys in the CSR; candidate edges covered at an
        ancestor level land in the base's values: a fresh base's own CSR
        values, or ``a_vals`` of a carried base (1.0) and of lookups
        (``agg_cand_cols``: ``edge_value_lookup`` against padded base rows).
        A leaf with references is one ``xlevel_agg_csr`` launch; a
        window-only leaf (k = 0) the plain form over padded rows. The pair
        is [op-reduced value, live embedding count]; ``live`` only gates
        the op identity out at ``_finalize``."""
        in_cols = self._in_cols(op)
        caps = dict(caps_sig)
        refs = op.inter + op.sub
        pol = (1,) * len(op.inter) + (0,) * len(op.sub)

        def fn(g, vals, carry, n):
            get = dict(zip(in_cols, vals))
            # the base: CSR rows when fresh and nothing multiplies into its
            # values; else padded rows with a_vals (None: 1.0)
            base = va = a_vals = None
            if op.use_carry:
                base = carry
            elif op.agg_cand_cols or not refs:
                base = padded_rows(g, get[op.base], caps[op.base])[0]
                a_vals = padded_value_rows(g, get[op.base], caps[op.base])
            else:
                va = get[op.base]
            for c in op.agg_cand_cols:
                look = edge_value_lookup(g, get[c], base)
                a_vals = look if a_vals is None else a_vals * look
            nrows = get[op.base].shape[0] if base is None else base.shape[0]
            scale = prefix_scale(g, get, op.agg_scale_edges) if op.agg_scale_edges \
                else torch.ones((nrows,), dtype=torch.float32, device=g.device)
            ub = self._ub_vec(op, g, get, n, nrows)
            lb = self._max_lb(op, get) if op.lb else None
            excl = self._excl_vals(op, get)
            if refs:
                counts, rvals = xlevel_agg_csr(
                    g.indptr, g.indices, g.edge_values,
                    torch.stack([get[j] for j in refs]), [caps[j] for j in refs],
                    pol, scale, op.agg, a=base, va=va,
                    cap_a=None if va is None else caps[op.base], a_vals=a_vals,
                    bounds=ub, lbounds=lb, excludes=excl)
            else:
                if a_vals is None:
                    a_vals = torch.ones(base.shape, dtype=torch.float32,
                                        device=base.device)
                counts, rvals = xlevel_agg(base, None, pol, a_vals, None, scale,
                                           op.agg, ub, lbounds=lb, excludes=excl)
            # a dead row carries the op identity, so the plain reduce is right
            if op.agg == "sum":
                value = rvals.sum(dtype=torch.float32)
            elif op.agg == "max":
                value = rvals.max()
            else:
                value = rvals.min()
            live = counts.sum(dtype=torch.int32).to(torch.float32)
            return torch.stack([value, live])
        return fn

    def _survivor_core(self, op: LevelOp, caps: dict, out_cap: int,
                       out_items: int):
        """Survivors -> compacted items in one ``x*_compact``: a fused
        'inter'/'sub' level or a general level through the k-reference
        kernel (references read from the CSR), where the per-row bound
        vector (``_ub_vec``) folds the upper bounds, the live mask and any
        residuals into the bound operand and lower bounds ride ``lbounds``;
        with ``fused_level=False`` a general level composes one mark per
        reference. An INTER level reads its base from the CSR too (or the
        carry) and its kernels pack the survivors and write the worklist;
        every other path ends in the ``batch_compact_scan`` prefix-sum
        scatter over a padded base."""
        fused = self._fused_shape(op)
        keep_of = self._mask_ops(op, caps)
        refs = op.inter + op.sub
        pol = (1,) * len(op.inter) + (0,) * len(op.sub)
        use_xlevel = fused is None and self.fused_level

        def core(g, get, carry, n):
            if fused == "inter":
                base_kw, nrows = self._csr_base(op, get, carry, caps)
                return xinter_compact_csr(g.indptr, g.indices, get[refs[0]], caps[refs[0]],
                                          **base_kw, bounds=self._ub_vec(op, g, get, n, nrows),
                                          out_cap=out_cap, out_items=out_items,
                                          lbounds=self._max_lb(op, get) if op.lb else None)
            base = self._base(op, g, get, carry, caps)
            if not (fused or use_xlevel):
                return batch_compact_scan(base, keep_of(g, base, get, n), out_cap,
                                          out_items)
            ub = self._ub_vec(op, g, get, n, base.shape[0])
            lb = self._max_lb(op, get) if op.lb else None
            if fused == "sub":
                return xsub_compact_csr(g.indptr, g.indices, base, get[refs[0]],
                                        caps[refs[0]], ub, out_cap=out_cap,
                                        out_items=out_items, lbounds=lb)
            if refs:
                return xlevel_compact_csr(g.indptr, g.indices, base,
                                          torch.stack([get[j] for j in refs]),
                                          [caps[j] for j in refs], pol, ub,
                                          out_cap=out_cap, out_items=out_items,
                                          lbounds=lb, excludes=self._excl_vals(op, get))
            return xlevel_compact(base, None, pol, ub, out_cap=out_cap,
                                  out_items=out_items, lbounds=lb,
                                  excludes=self._excl_vals(op, get))
        return core

    def _plan_expand_fn(self, op: LevelOp, caps_sig: tuple, cap_base: int,
                        out_cap: int, out_items: int):
        """Fused gather + intersect + on-device compaction + meta.

        meta = [total, max survivor count] + [max degree of column c over
        live items, for c in op.gather_refs] — the only host sync per level.
        """
        return self._executable(
            ("pexpand", op, caps_sig, cap_base, out_cap, out_items),
            lambda: self._expand_body(op, caps_sig, out_cap, out_items))

    def _expand_body(self, op: LevelOp, caps_sig: tuple, out_cap: int,
                     out_items: int):
        in_cols = self._in_cols(op)
        caps = dict(caps_sig)
        core = self._survivor_core(op, caps, out_cap, out_items)

        def fn(g, vals, carry, n):
            get = dict(zip(in_cols, vals))
            rows2, _, src, verts, total, maxc = core(g, get, carry, n)
            live = torch.arange(out_items, device=src.device) < total
            metas = [total, maxc]
            for c in op.gather_refs:
                cv = verts if c == op.level else get[c][src.long()]
                metas.append(torch.where(live, g.degrees[cv.long()], 0).max())
            return rows2, src, verts, torch.stack(metas)
        return fn

    def _plan_emit_fn(self, op: LevelOp, caps_sig: tuple, cap_base: int,
                      out_cap: int, out_items: int):
        """Terminal emit level: the compacted embeddings stay on the device
        until one read per call of their live rows."""
        return self._executable(
            ("pemit", op, caps_sig, cap_base, out_cap, out_items),
            lambda: self._emit_body(op, caps_sig, out_cap, out_items))

    def _emit_body(self, op: LevelOp, caps_sig: tuple, out_cap: int,
                   out_items: int):
        """The emit level -> (embeddings (out_items, k) int32, live total):
        the level's survivors compacted as an expand level's are, column c
        of an embedding ``verts`` where c is the level's own vertex, else
        the prefix column gathered through ``src`` (0 past the total)."""
        in_cols = self._in_cols(op)
        caps = dict(caps_sig)
        core = self._survivor_core(op, caps, out_cap, out_items)

        def fn(g, vals, carry, n):
            get = dict(zip(in_cols, vals))
            _, _, src, verts, total, _ = core(g, get, carry, n)
            live = torch.arange(out_items, device=src.device) < total
            s = src.long()
            cols = [verts if c == op.level else torch.where(live, get[c][s], 0)
                    for c in op.out_cols]
            return torch.stack(cols, dim=1), total
        return fn

    def _plan_chunk_fn(self, op: LevelOp, b: int, out_cap: int, cap2: int,
                       chunk: int):
        """Slice the compacted worklist into the next level's device wave:
        forwarded prefix columns gather through ``src`` (zeroed past the live
        count so padding items carry bound 0 everywhere), the new vertex
        column comes from ``verts``, and the survivor streams become the next
        carry when the compiler proved reuse."""
        return self._executable(("pchunk", op, b, out_cap, cap2, chunk),
                                lambda: self._chunk_body(op, cap2, chunk))

    @staticmethod
    def _chunk_body(op: LevelOp, cap2: int, chunk: int):
        carry_out = op.carry_out

        def fn(rows2, src, verts2, colvals, lo, m):
            s = src[lo: lo + chunk].long()
            valid = torch.arange(chunk, device=src.device) < m
            v = torch.where(valid, verts2[lo: lo + chunk], 0)
            outs = tuple(torch.where(valid, cv[s], 0) for cv in colvals)
            if carry_out:
                return outs, v, rows2[s, :cap2]
            return outs, v, None
        return fn

    @staticmethod
    def _worklist_body(op: LevelOp, caps_sig: tuple, cap_base: int, form: str):
        """An in-place count leaf: one launch over the chunk [lo, lo + m) of
        the parent's worklist, into ``acc``: ``xcount_worklist`` (form
        ``carried``) or ``xlevel_count_worklist`` (``csr``), which reads the
        parent's forwarded columns ``cols`` through ``src``."""
        caps = dict(caps_sig)
        refs = op.inter + op.sub
        caps_b = tuple(caps[j] for j in refs)
        if form == "carried":
            sub = bool(op.sub)

            def fn(g, rows2, src, verts2, cols, lo, m, acc):
                return xcount_worklist(g.indptr, g.indices, rows2, src, verts2, lo, m,
                                       cap_base, caps_b[0], acc, sub)
            return fn
        pol = (1,) * len(op.inter) + (0,) * len(op.sub)
        base = None if op.use_carry else op.base

        def fn(g, rows2, src, verts2, cols, lo, m, acc):
            return xlevel_count_worklist(g.indptr, g.indices, rows2, src, verts2, cols, lo,
                                         m, acc, base, cap_base, refs, caps_b, pol, op.ub,
                                         op.lb, op.exclude)
        return fn

    def _plan_expand_host_fn(self, op: LevelOp, caps_sig: tuple, cap_base: int,
                             out_cap: int):
        """Host-path twin of ``_plan_expand_fn``: the level's keep mask (one
        mark launch per reference), then one compact-rows launch ->
        (rows2 (B, out_cap), counts2 (B,)); compaction into items is the
        host's (``compact``). The rows and counts equal the reference
        engine's masked sort ``sort(where(keep, base, SENTINEL))[:, :out_cap]``."""
        return self._executable(("pexpandh", op, caps_sig, cap_base, out_cap),
                                lambda: self._expand_host_body(op, caps_sig, out_cap))

    def _expand_host_body(self, op: LevelOp, caps_sig: tuple, out_cap: int):
        in_cols = self._in_cols(op)
        caps = dict(caps_sig)
        keep_of = self._mask_ops(op, caps)

        def fn(g, vals, carry, n):
            get = dict(zip(in_cols, vals))
            base = self._base(op, g, get, carry, caps)
            return compact_rows(base, keep_of(g, base, get, n), out_cap)
        return fn

    def _residual_pack_fn(self, level: int, residual: tuple, out_items: int):
        """Per-branch worklist pack: drop the items that fail a child
        branch's residuals before chunking, so a branch that shares a
        relaxed ancestor runs exactly the items its own plan would, in the
        same order (``compact_indices_scan``). Returns (packing fn, the
        value columns it reads)."""
        refs = tuple(sorted({c for _, i, j in residual for c in (i, j) if c < level}))
        fn = self._executable(("rpack", level, residual, out_items),
                              lambda: self._rpack_body(level, residual, refs, out_items))
        return fn, refs

    @staticmethod
    def _rpack_body(level: int, residual: tuple, refs: tuple, out_items: int):
        def fn(rvals, src, verts, total):
            get = dict(zip(refs, rvals))
            s = src.long()

            def val(c):
                return verts if c == level else get[c][s]
            idx = torch.arange(out_items, device=src.device)
            ok = idx < total
            for kind, i, j in residual:
                ok = ok & ((val(i) < val(j)) if kind == "lt" else (val(i) != val(j)))
            order, tot = compact_indices_scan(ok)
            o = order.long()
            return src[o], torch.where(idx < tot, verts[o], 0), tot
        return fn

    def _rows_fn(self, cap: int):
        """The level-1 prefix rows of a feed chunk (``record`` only)."""
        return self._executable(("rows", cap),
                                lambda: lambda g, vs: padded_rows(g, vs, cap)[0])

    # ------------------------------------------------------- the interpreter
    def _record(self, level: int, rows, verts, n: int) -> None:
        if self.record:
            self.trace.append((level, _host(rows)[:n].copy(), _host(verts)[:n].copy()))

    def _record_feed(self, cap0: int, dv0, dv1, n: int) -> None:
        if self.record:
            self._record(1, self._rows_fn(cap0)(self.g, dv0), dv1, n)

    def _record_wave(self, op: LevelOp, cols2: dict, carry2, vch, m: int) -> None:
        """Record the wave chunk an expand level hands to level
        ``op.level + 1``: its carry, else its output columns stacked, else
        its vertices (``record`` only: nothing is stacked otherwise)."""
        if not self.record:
            return
        if carry2 is not None:
            rows = carry2
        elif op.out_cols:
            rows = torch.stack([cols2[c] for c in op.out_cols], dim=1)
        else:
            rows = vch
        self._record(op.level + 1, rows, vch, m)

    def _finalize(self, plan: WavePlan, parts: list):
        """Reduce one plan's partials — int64 device scalars and, for a count
        riding an expand, host ints — in one host read; an emit plan's host
        blocks into one (N, k) int32 matrix."""
        if plan.ops[-1].kind == "emit":
            if not parts:
                return np.zeros((0, plan.k), dtype=np.int32)
            return np.concatenate(parts, axis=0).astype(np.int32)
        agg = plan.ops[-1].agg
        if agg is not None:
            return self._finalize_agg(agg, parts)
        dev = [p for p in parts if isinstance(p, torch.Tensor)]
        total = sum(p for p in parts if not isinstance(p, torch.Tensor))
        if dev:
            with self._host_span("sync"):
                total += int(torch.stack(dev).sum())
        if total % plan.div:
            raise RuntimeError(f"{plan.pattern.name}: total {total} is not a "
                               f"multiple of div {plan.div}")
        return total // plan.div

    def _finalize_agg(self, agg: str, parts: list) -> float:
        """Reduce the f32 (value, live) pairs in float64 on the host, in
        chunk order, as the reference engine does; 0.0 when no embedding
        is live (a weighted query over zero embeddings aggregates to 0.0)."""
        if not parts:
            return 0.0
        with self._host_span("sync"):
            pairs = torch.stack(parts).cpu().numpy().astype(np.float64)
        value, live = None, 0.0
        for x, n in pairs.tolist():
            live += n
            if value is None:
                value = x
            elif agg == "sum":
                value += x
            elif agg == "max":
                value = max(value, x)
            else:
                value = min(value, x)
        return value if live > 0 else 0.0

    def _feed_caps(self, cap0: int, need1: bool, v1h) -> dict:
        caps = {0: cap0}
        if need1:
            caps[1] = _neighbor_cap(self.host_g, v1h)
        return caps

    def run(self, plan: WavePlan):
        """Execute a compiled ``WavePlan``: returns the count (divided by
        ``plan.div``), the aggregate (a float) or, for an emit plan, the
        (N, k) int32 embedding matrix."""
        need1 = 1 in plan.ops[0].row_refs()
        outs: list = []
        self._accs = {}
        with activate(self.telemetry), self._span("execute", plan=plan.pattern.name):
            for cap0, dv0, dv1, v1h, n in self._edge_feed(plan.symmetric):
                self._ct_feed_chunks.inc()
                with self._feed_span(cap0, n):
                    self._record_feed(cap0, dv0, dv1, n)
                    outs += self._plan_descend(plan, 0, {0: dv0, 1: dv1},
                                               self._feed_caps(cap0, need1, v1h), None, n)
            self._ct["host_syncs"].inc(len(outs))
            with self._span("finalize"):
                return self._finalize(plan, outs)

    def run_set(self, forest):
        """Execute a ``forest.PlanForest``: each feed orientation is iterated
        once, every trie root consumes the same device chunks, and shared
        interior nodes run their expand and compaction once before fanning
        out to their child branches. Returns per-plan results in
        ``forest.plans`` order, equal to running each plan through ``run``
        (ints, floats, or (N, k) int32 matrices for emit plans)."""
        acc: list[list] = [[] for _ in forest.plans]
        self._accs = {}
        with activate(self.telemetry), \
                self._span("execute", plans=len(forest.plans), forest=True):
            for symmetric, roots in ((True, forest.symmetric_roots),
                                     (False, forest.directed_roots)):
                if not roots:
                    continue
                need1 = any(1 in r.op.row_refs() for r in roots)
                for cap0, dv0, dv1, v1h, n in self._edge_feed(symmetric):
                    self._ct_feed_chunks.inc()
                    with self._feed_span(cap0, n):
                        self._record_feed(cap0, dv0, dv1, n)
                        caps = self._feed_caps(cap0, need1, v1h)
                        for root in roots:
                            self._forest_descend(root, {0: dv0, 1: dv1}, caps, None, n,
                                                 acc)
            self._ct["host_syncs"].inc(sum(len(a) for a in acc))
            with self._span("finalize"):
                return [self._finalize(plan, parts)
                        for plan, parts in zip(forest.plans, acc)]

    def _leaf(self, op: LevelOp, caps_sig: tuple, cap_base: int, vals, carry, n):
        """One count or aggregate leaf call -> its device partial."""
        self._bump(op)
        if op.agg is not None:
            self._ct_value_lanes.inc()
            fn = self._plan_agg_fn(op, caps_sig, cap_base)
        else:
            fn = self._plan_count_fn(op, caps_sig, cap_base)
        return self._dispatch(op, fn, (self.g, vals, carry, n), items=n, caps_sig=caps_sig)

    def _level_args(self, op: LevelOp, cols: dict, caps: dict, carry):
        """(caps_sig, cap_base, vals, b, out_cap, out_items) of one level call."""
        caps_sig = tuple(sorted((c, caps[c]) for c in op.row_refs()))
        cap_base = int(carry.shape[1]) if op.use_carry else caps[op.base]
        vals = tuple(cols[c] for c in self._in_cols(op))
        b = int(carry.shape[0]) if op.use_carry else int(cols[op.base].shape[0])
        out_cap = min([cap_base] + [caps[j] for j in op.inter])
        out_items = -(-b * out_cap // self.chunk) * self.chunk
        return caps_sig, cap_base, vals, b, out_cap, out_items

    def _forest_descend(self, node, cols: dict, caps: dict, carry, n: int,
                        acc: list) -> None:
        """Execute one forest node on a wave chunk; fan out over children.

        The per-op machinery of ``_plan_descend``, except that an expand's
        chunks feed every child branch, and a leaf's partial (an emit
        node's blocks) goes to each plan that owns it."""
        with self._level_span(node.op, n):
            self._forest_node(node, cols, caps, carry, n, acc)

    def _forest_node(self, node, cols: dict, caps: dict, carry, n: int, acc: list) -> None:
        op = node.op
        caps_sig, cap_base, vals, b, out_cap, out_items = \
            self._level_args(op, cols, caps, carry)
        if op.kind == "count":
            part = self._leaf(op, caps_sig, cap_base, vals, carry, n)
            for i in node.plans:
                acc[i].append(part)
            return
        if op.kind == "emit":
            parts = self._plan_emit(op, caps_sig, cap_base, out_cap, out_items, cols,
                                    vals, carry, n)
            for i in node.plans:
                acc[i].extend(parts)
            return
        if node.ride_plans:
            self._ct["count_rides"].inc(len(node.ride_plans))
        if not self.device_compact:
            # the host path packs no residuals: every child reads the wave
            ride_out: dict = {}
            for cols2, caps2, carry2, vch, m in self._expand_chunks_host(
                    op, caps_sig, cap_base, out_cap, cols, vals, carry, n, ride_out):
                self._record_wave(op, cols2, carry2, vch, m)
                for child in node.children:
                    self._forest_descend(child, cols2, caps2, carry2, m, acc)
            if "count_part" in ride_out:
                for i in node.ride_plans:
                    acc[i].append(ride_out["count_part"])
                # read with the compaction: no sync of its own at the end
                self._ct["host_syncs"].dec(len(node.ride_plans))
            return
        exp = self._expand_device(op, caps_sig, cap_base, out_cap, out_items, vals,
                                  carry, n)
        if exp is None:
            return
        rows2, src, verts2, total, caps2, cap2, ride = exp
        if node.ride_plans:
            # the riding leaf's count is the expand's survivor total, read in
            # the level's meta sync: no sync of its own at the end
            for i in node.ride_plans:
                acc[i].append(ride)
            self._ct["host_syncs"].dec(len(node.ride_plans))
        # children that kept every constraint of the shared node read the
        # compacted worklist as it is; a child whose branch deferred
        # constraints into residuals gets its own packed worklist first
        feeds = []
        shared = [ch for ch in node.children if not ch.op.residual]
        if shared:
            feeds.append((shared, src, verts2, total))
        for ch in node.children:
            if not ch.op.residual:
                continue
            pfn, refs = self._residual_pack_fn(op.level, ch.op.residual,
                                               int(src.shape[0]))
            src_b, verts_b, tot_b = pfn(tuple(cols[c] for c in refs), src, verts2, total)
            with self._host_span("sync"):
                tot_b, has_b = self._pack_total(tot_b)
            self._ct["host_syncs"].inc()
            if has_b:
                feeds.append(([ch], src_b, verts_b, tot_b))
        for children, s_, v_, t_ in feeds:
            in_place, sliced = [], []
            for ch in children:
                (in_place if self._reads_in_place(op, ch.op) else sliced).append(ch)
            if sliced:
                for cols2, carry2, vch, m in self._expand_chunks(
                        op, b, out_cap, cap2, rows2, s_, v_, cols, t_):
                    self._record_wave(op, cols2, carry2, vch, m)
                    for child in sliced:
                        self._forest_descend(child, cols2, caps2, carry2, m, acc)
            elif in_place:
                self._note_slice(op, b, out_cap, cap2)
            for ch in in_place:
                part = self._leaf_in_place(op, ch.op, id(ch), len(ch.plans), cols, rows2,
                                           s_, v_, t_, caps2, cap2)
                if part is not None:
                    for i in ch.plans:
                        acc[i].append(part)

    def _plan_descend(self, plan: WavePlan, oi: int, cols: dict, caps: dict,
                      carry, n: int) -> list:
        """Execute plan.ops[oi] on one wave chunk; recurse over survivors."""
        op = plan.ops[oi]
        with self._level_span(op, n):
            caps_sig, cap_base, vals, b, out_cap, out_items = \
                self._level_args(op, cols, caps, carry)
            if op.kind == "count":
                return [self._leaf(op, caps_sig, cap_base, vals, carry, n)]
            if op.kind == "emit":
                return self._plan_emit(op, caps_sig, cap_base, out_cap, out_items, cols,
                                       vals, carry, n)
            child = plan.ops[oi + 1]
            if self._reads_in_place(op, child):
                exp = self._expand_device(op, caps_sig, cap_base, out_cap, out_items, vals,
                                          carry, n)
                if exp is None:
                    return []
                rows2, src, verts2, total, caps2, cap2, _ = exp
                self._note_slice(op, b, out_cap, cap2)
                part = self._leaf_in_place(op, child, id(child), 1, cols, rows2, src,
                                           verts2, total, caps2, cap2)
                return [] if part is None else [part]
            if self.device_compact:
                chunks = self._expand_chunks_device(op, caps_sig, cap_base, out_cap,
                                                    out_items, b, cols, vals, carry, n)
            else:
                chunks = self._expand_chunks_host(op, caps_sig, cap_base, out_cap, cols,
                                                  vals, carry, n)
            parts: list = []
            for cols2, caps2, carry2, vch, m in chunks:
                self._record_wave(op, cols2, carry2, vch, m)
                parts += self._plan_descend(plan, oi + 1, cols2, caps2, carry2, m)
            return parts

    def _plan_emit(self, op, caps_sig, cap_base, out_cap, out_items, cols, vals,
                   carry, n) -> list:
        """One emit-level call -> its host block of embeddings ([] when none
        survive). Device path: the emit executable, one read of the total,
        then one copy of the live rows. Host path: the keep mask and one
        compact-rows launch, one read of (rows, counts), the ``compact``
        oracle, and the output columns gathered on the host."""
        self._bump(op, host=not self.device_compact)
        if self.device_compact:
            fn = self._plan_emit_fn(op, caps_sig, cap_base, out_cap, out_items)
            emb, total = self._dispatch(op, fn, (self.g, vals, carry, n), items=n,
                                        caps_sig=caps_sig)
            with self._host_span("sync"):
                total = int(total)
            self._ct["device_compactions"].inc()
            self._ct["items"].inc(total)
            self._h_wave_items.observe(total)
            if total == 0:
                return []
            with self._host_span("sync"):
                return [_host(emb[:total])]
        hfn = self._plan_expand_host_fn(op, caps_sig, cap_base, out_cap)
        rows2, counts2 = self._dispatch(op, hfn, (self.g, vals, carry, n), items=n,
                                        caps_sig=caps_sig, host=True)
        with self._host_span("sync"):
            rows_h, counts_h = _host(rows2), _host(counts2)
        wave, ii = compact(rows_h, counts_h, return_src=True)
        self._ct["host_compactions"].inc()
        if wave is None:
            return []
        self._ct["items"].inc(len(wave))
        return [np.stack([wave.verts if c == op.level else _host(cols[c])[ii]
                          for c in op.out_cols], axis=1)]

    def _pack_total(self, tot):
        """A residual pack's live total, read to the host -> (what chunking
        takes, whether any item survived). The sharded runner's is the
        per-shard total vector."""
        tot = int(tot)
        return tot, tot > 0

    def _expand_device(self, op, caps_sig, cap_base, out_cap, out_items,
                       vals, carry, n):
        """Run one expand executable + meta sync. Returns ``None`` when no
        survivors, else (rows2, src, verts2, total, caps2, cap2, ride):
        ``ride`` is the survivor count a riding count leaf takes."""
        self._bump(op)
        fn = self._plan_expand_fn(op, caps_sig, cap_base, out_cap, out_items)
        rows2, src, verts2, meta = self._dispatch(op, fn, (self.g, vals, carry, n),
                                                  items=n, caps_sig=caps_sig)
        with self._host_span("sync"):
            total, maxc, *dmaxs = meta.tolist()       # the level's one host sync
        self._ct["host_syncs"].inc()
        self._ct["device_compactions"].inc()
        self._ct["items"].inc(total)
        self._h_wave_items.observe(total)
        if total == 0:
            return None
        caps2 = {c: _pow2cap(max(d, 1)) for c, d in zip(op.gather_refs, dmaxs)}
        cap2 = round_capacity(maxc) if op.carry_out else 0
        return rows2, src, verts2, total, caps2, cap2, total

    @staticmethod
    def _carried_leaf(parent: LevelOp, op: LevelOp) -> bool:
        """Whether count leaf ``op`` takes ``xcount_worklist`` (the form
        ``carried``): its base is ``parent``'s carried survivors, its one
        INTER or SUB reference and its one upper bound are the parent's new
        vertex, and it has no lower bound or exclude."""
        return (op.use_carry and not (op.lb or op.exclude)
                and op.inter + op.sub == (parent.level,) and op.ub == (parent.level,))

    def _reads_in_place(self, parent: LevelOp, op: LevelOp) -> bool:
        """Whether count leaf ``op`` reads ``parent``'s compacted worklist in
        place (``_leaf_in_place``) instead of sliced chunks: no aggregate,
        tail or residual shapes it, and it is a carried leaf
        (``_carried_leaf``) or, with ``fused_level``, a leaf of at least one
        reference whose base, references, bounds and excludes are the
        parent's carried survivors, its new vertex or columns it forwards
        (one k-reference launch a call, whatever its shape). The host
        path, ``record`` (its trace keeps the sliced waves) and the sharded
        runner slice."""
        if not (self._in_place_leaves and self.device_compact and not self.record
                and op.kind == "count" and op.agg is None and op.tail is None
                and not op.residual):
            return False
        if self._carried_leaf(parent, op):
            return True
        refs = op.inter + op.sub
        return (self.fused_level and 0 < len(refs) <= MAX_REFS and parent.level < MAX_COLS
                and set(op.val_refs()) <= set(parent.out_cols))

    def _leaf_in_place(self, parent: LevelOp, op: LevelOp, key: int, owners: int,
                       cols: dict, rows2, src, verts2, total: int, caps2: dict, cap2: int):
        """Count leaf ``op`` over every chunk of ``parent``'s compacted
        worklist ``(rows2, src, verts2)`` of ``total`` items, read in place,
        the parent's forwarded columns taken from its wave's ``cols``: one
        launch a chunk into the run's int64 accumulator under ``key``,
        zeroed once a run. Returns the accumulator when this call made it
        (the caller hands it to its ``owners`` plans' partials, once), else
        None. The counters are the sliced path's: each chunk is a level call
        with its cache lookup and a partial a plan to read."""
        acc = self._accs.get(key)
        fresh = acc is None
        if fresh:
            acc = self._accs[key] = torch.zeros((), dtype=torch.int64, device=self.device)
        form = "carried" if self._carried_leaf(parent, op) else "csr"
        caps_sig = tuple(sorted((c, caps2[c]) for c in op.row_refs()))
        cap_base = cap2 if op.use_carry else caps2[op.base]
        fwd = tuple(cols.get(c) for c in range(parent.level))
        calls = 0
        for lo, m in self._chunk_steps(total):
            with self._level_span(op, m):
                self._bump(op)
                fn = self._executable(
                    ("pleaf", op, caps_sig, cap_base),
                    lambda: self._worklist_body(op, caps_sig, cap_base, form))
                self._dispatch(op, fn, (self.g, rows2, src, verts2, fwd, lo, m, acc),
                               items=m, caps_sig=caps_sig, form=form)
            calls += 1
        self._ct_in_place.inc(calls)
        # the JAX engine reads one partial a chunk a plan; ``run`` counts a
        # sync for the accumulator once, so the other chunks count theirs here
        self._ct["host_syncs"].inc(owners * (calls - fresh))
        return acc if fresh else None

    def _chunk_steps(self, total):
        """(lo, live items) of each chunk of a worklist of ``total`` items."""
        for lo in range(0, total, self.chunk):
            yield lo, min(self.chunk, total - lo)

    def _expand_chunks(self, op, b, out_cap, cap2, rows2, src, verts2, cols,
                       total):
        """Slice a compacted (src, verts) worklist into next-level device
        chunks; yields (cols2, carry2, vch, m)."""
        cfn = self._plan_chunk_fn(op, b, out_cap, cap2, self.chunk)
        fwd = [c for c in op.out_cols if c < op.level]
        fwdvals = tuple(cols[c] for c in fwd)
        for lo, m in self._chunk_steps(total):
            with self._host_span("slice"):
                outs, vch, carry2 = cfn(rows2, src, verts2, fwdvals, lo, m)
            cols2 = dict(zip(fwd, outs))
            if op.level in op.out_cols:
                cols2[op.level] = vch
            yield cols2, carry2, vch, m

    def _expand_chunks_device(self, op, caps_sig, cap_base, out_cap,
                              out_items, b, cols, vals, carry, n):
        """Run one expand level on the device; yield the next wave's chunks
        as (cols2, caps2, carry2, vch, m)."""
        exp = self._expand_device(op, caps_sig, cap_base, out_cap, out_items,
                                  vals, carry, n)
        if exp is None:
            return
        rows2, src, verts2, total, caps2, cap2, _ = exp
        for cols2, carry2, vch, m in self._expand_chunks(
                op, b, out_cap, cap2, rows2, src, verts2, cols, total):
            yield cols2, caps2, carry2, vch, m

    def _expand_chunks_host(self, op, caps_sig, cap_base, out_cap, cols, vals,
                            carry, n, ride_out: dict | None = None):
        """Host-path twin of ``_expand_chunks_device``, with the same
        yield: the level's keep mask and one compact-rows launch on the
        device, one read of (rows, counts), the ``compact`` oracle, and the
        next wave's chunks uploaded. ``ride_out`` (forest count rides) gets
        the survivor total under ``"count_part"``."""
        self._bump(op, host=True)
        hfn = self._plan_expand_host_fn(op, caps_sig, cap_base, out_cap)
        rows2, counts2 = self._dispatch(op, hfn, (self.g, vals, carry, n), items=n,
                                        caps_sig=caps_sig, host=True)
        with self._host_span("sync"):
            rows_h, counts_h = _host(rows2), _host(counts2)     # the level's host sync
        if ride_out is not None:
            ride_out["count_part"] = int(counts_h.sum(dtype=np.int64))
        wave, ii = compact(rows_h, counts_h, return_src=True)
        self._ct["host_syncs"].inc()
        self._ct["host_compactions"].inc()
        if wave is None:
            return
        total = len(wave)
        self._ct["items"].inc(total)
        self._h_wave_items.observe(total)
        fwd = [c for c in op.out_cols if c < op.level]
        hostcols = {c: _host(cols[c])[ii] for c in fwd}
        caps2 = {c: _neighbor_cap(self.host_g, wave.verts if c == op.level
                                  else hostcols[c])
                 for c in op.gather_refs}
        for lo in range(0, total, self.chunk):
            m = min(self.chunk, total - lo)
            sl = slice(lo, lo + self.chunk)
            cols2 = {c: self._upload(_pad_to(hostcols[c][sl], self.chunk, 0))
                     for c in fwd}
            vch = self._upload(_pad_to(wave.verts[sl], self.chunk, 0))
            if op.level in op.out_cols:
                cols2[op.level] = vch
            carry2 = self._upload(_pad_to(wave.rows[sl], self.chunk, SENTINEL)) \
                if op.carry_out else None
            yield cols2, caps2, carry2, vch, m

    # ----------------------------------------------- plan wrappers (compat)
    def count_edges(self, symmetric: bool = True, bounded: bool = True) -> int:
        """Σ over edges of |N(v0) ∩ N(v1) (∩ [0, v1))| — triangle / nested
        triangle counting as a one-level plan."""
        return self.run(compile_pattern(_EDGE_COUNT_PATTERNS[(symmetric, bounded)]))

    def clique(self, k: int) -> int:
        """k-clique counting, k >= 3 (compiled chain-restricted plan)."""
        if k < 3:
            raise ValueError("clique needs k >= 3")
        return self.run(compile_pattern(clique_pattern(k)))

    def three_chain_induced(self) -> int:
        """Per directed edge (m, a): |{b ∈ N(m): b > a, b ∉ N(a)}|."""
        return self.run(compile_pattern(THREE_CHAIN_INDUCED))

    def tailed_triangle(self) -> int:
        """Fig. 2b: BoundedIntersect(N0, N1, v0) per directed edge; the tail
        level compiles away into the closed-form deg(v1) - 2 multiplier."""
        return self.run(compile_pattern(TAILED_TRIANGLE))
