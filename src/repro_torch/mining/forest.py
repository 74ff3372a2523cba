"""Plan-forest scheduler: fuse a *set* of compiled plans into one
shared-prefix stream program.

Motif workloads (3-motif, 4-motif, FSM) run several patterns over the same
graph. Executed independently, each ``WavePlan`` re-materialises the level-1
edge feed and re-runs every interior expand even when another pattern in the
batch performs identical work — 4-motif's diamond, paw and 4-clique all
start from the N(v0) ∩ N(v1) wing stream. This module merges the batch into
a ``PlanForest``: a prefix trie whose shared interior nodes run ONCE per
wave chunk and fan out to per-pattern suffix branches, with per-leaf
count/emit accumulators (AutoMine's multi-pattern schedule reuse and
TrieJax's shared-prefix join tries, restated on the §IV-F plan IR;
interpreted by ``engine.WaveRunner.run_set``).

Canonical-prefix rules
----------------------

Plans are grouped by feed orientation first (``WavePlan.symmetric``: the
half-edge v1 < v0 feed vs the directed feed) — a forest has at most one
root set per orientation and each feed is materialised and iterated once.
Column names need no renumbering: every compiled plan matches vertices in
schedule order, so prefix column ``j`` means "the vertex matched at level
``j``" in every plan and ``LevelOp`` references are directly comparable.

Two expand ops can share a node iff their **stream keys** agree —
``(level, use_carry, base, inter, sub)``, the fields that define which
survivor *elements* the level materialises. Bound and injectivity fields
(``ub``/``lb``/``exclude``) do NOT need to agree: the shared node is
**relaxed** to the intersection of the branches' constraint sets, and each
branch's surplus is pushed one level down:

* as a **residual** on the branch's next op — a per-item constraint
  (``('lt', i, j)`` ≡ v_i < v_j, ``('ne', i, j)`` ≡ v_i != v_j) that the
  engine folds into the per-row bound operand (bound 0 ⇒ the kernels' tile
  schedule skips the whole row), and
* when the branch's next op **carries** the shared survivor stream, the
  surplus ``ub``/``lb``/``exclude`` are additionally re-added to that op's
  own element constraints, restoring exactly the filter the relaxation
  dropped from the carried elements.

Terminal (count/emit) ops are never relaxed — they ARE the per-pattern
semantics — and merge only when identical, in which case the count runs
once and is credited to every owning plan. Residual sets shared by every
branch of a node are applied at the node; disagreeing residuals defer
further down. Relaxation therefore never changes any leaf's result, only
*where* constraints are enforced — ``run_set`` output is bit-identical to
running each plan independently (property-tested in tests/test_forest.py).
The same forest interprets unchanged on the mesh-sharded runner
(``mining.shard.ShardedWaveRunner``): the fan-out and residual packs are
per-shard SPMD, count leaves psum across the mesh, and per-plan results
stay bit-identical to both the single-device forest and independent runs.

**Count-rides-expand fusion**: a terminal count leaf (no degree tail)
whose stream key AND full constraint set (ub/lb/exclude/residual) equal a
sibling expand node's relaxed op dispatches no kernel at all — the expand
already computes that exact per-item survivor-count vector, so the leaf's
plans are recorded in the node's ``ride_plans`` and ``run_set`` credits
them with the expand's count partial (a 4-clique leaf rides a 5-clique's
level-3 expand; the 4-clique leaf does NOT ride the 4-motif wing expand,
which is relaxed below its bounds).

Schedule search (``schedule_patterns``)
---------------------------------------

Which *matching order* each pattern uses decides what can share. For
``Motif`` inputs (unordered shapes, no hand-written order or restrictions)
``schedule_patterns`` runs AutoMine's compilation loop: every motif's
candidate orders (``plan.matching_orders``, restrictions derived from the
automorphism group) are searched by coordinate descent to minimise a
static cost — one trie-node dispatch weight per feed edge orientation
(directed feeds iterate twice the half-edge feed's chunks) plus the feed
passes themselves — which maximises shared canonical prefixes across the
batch. Explicit ``Pattern`` inputs are respected as-is (fixed points of
the search). The 4-motif batch lands on 3 shared level-2 nodes over 2
feed passes with no hand-ordered definitions anywhere.

Trie interpretation contract (``WaveRunner.run_set``)
-----------------------------------------------------

* liveness is recomputed across branches: an interior node's ``out_cols`` /
  ``gather_refs`` are the union of its subtree's value/row references (so
  residual columns are forwarded), and ``carry_out`` is the OR over children
  — non-carrying children simply ignore the carry;
* every node is executed through the same cached executables as the
  single-plan path (``LevelOp`` hashes by value, residuals included), so a
  forest node and an identical single-plan level share compiled traces;
* each expand node runs its gather + masks + on-device compaction once per
  wave chunk and feeds the resulting (cols2, caps2, carry2) to every child;
* leaf partials — (hi, lo) int32 count pairs or embedding blocks — are
  appended to per-plan accumulators and finalised per plan (division by
  ``Pattern.div``, emit concatenation) exactly as ``run`` does.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

from .plan import LevelOp, Motif, Pattern, WavePlan, compile_pattern, \
    matching_orders

__all__ = ["ForestNode", "PlanForest", "build_forest", "schedule_patterns"]


@dataclasses.dataclass(frozen=True)
class ForestNode:
    """One trie node: an expand interior (``children``) or a count/emit leaf
    (``plans`` = indices of the source plans credited with its output).

    ``ride_plans`` (interior expands only) are plans whose terminal count
    leaf matched this node's stream AND constraints exactly: they dispatch
    no kernel — the engine credits them with this expand's survivor-count
    sum (count-rides-expand fusion)."""

    op: LevelOp
    children: tuple["ForestNode", ...] = ()
    plans: tuple[int, ...] = ()
    ride_plans: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PlanForest:
    """A merged pattern batch: per-feed root sets over ``plans``."""

    plans: tuple[WavePlan, ...]
    symmetric_roots: tuple[ForestNode, ...]
    directed_roots: tuple[ForestNode, ...]

    def all_roots(self) -> tuple[ForestNode, ...]:
        return self.symmetric_roots + self.directed_roots

    def sharing_stats(self) -> dict:
        """Static fusion report: per-(kind, level) op counts, plans vs trie.

        ``feed_passes`` counts level-1 edge-feed traversals: one per plan
        when run independently, one per used orientation when fused.
        ``count_rides`` counts terminal count leaves folded into a sibling
        expand (they appear in ``plan_ops`` but dispatch nothing)."""
        plan_ops: Counter = Counter()
        for p in self.plans:
            for op in p.ops:
                plan_ops[(op.kind, op.level)] += 1
        forest_ops: Counter = Counter()
        rides = 0

        def walk(node: ForestNode) -> None:
            nonlocal rides
            forest_ops[(node.op.kind, node.op.level)] += 1
            rides += len(node.ride_plans)
            for ch in node.children:
                walk(ch)

        for root in self.all_roots():
            walk(root)
        feeds = int(bool(self.symmetric_roots)) + int(bool(self.directed_roots))
        return {
            "plans": len(self.plans),
            "plan_ops": dict(plan_ops),
            "forest_ops": dict(forest_ops),
            "count_rides": rides,
            "ops_saved": sum(plan_ops.values()) - sum(forest_ops.values()),
            "feed_passes": {"independent": len(self.plans), "fused": feeds},
        }


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------


def _merge(branches: list[tuple[int, list[LevelOp]]]) -> tuple[ForestNode, ...]:
    """Merge one trie level. ``branches`` = (plan index, remaining ops) with
    any constraints deferred from relaxed ancestors already folded into
    ``ops[0]``. Deterministic: groups keep first-seen plan order."""
    leaves: dict[LevelOp, list[int]] = {}
    groups: dict[tuple, list[tuple[int, list[LevelOp]]]] = {}
    for idx, ops in branches:
        if ops[0].kind == "expand":
            groups.setdefault(ops[0].stream_key(), []).append((idx, ops))
        else:
            leaves.setdefault(ops[0], []).append(idx)
    merged: dict[tuple, list] = {}       # stream key -> [relaxed, kids, rides]
    for key, group in groups.items():
        relaxed, sub = _relax(group)
        merged[key] = [relaxed, _merge(sub), []]
    nodes: list[ForestNode] = []
    for op, idxs in leaves.items():
        # count-rides-expand: a tail-free count leaf matching a sibling
        # expand's stream AND relaxed constraints reads that expand's
        # survivor-count vector instead of dispatching its own kernel.
        # Aggregate leaves never ride: an expand yields counts, not values.
        tgt = merged.get(op.stream_key()) \
            if op.kind == "count" and op.tail is None and op.agg is None \
            else None
        if tgt is not None and (op.ub, op.lb, op.exclude, op.residual) == \
                (tgt[0].ub, tgt[0].lb, tgt[0].exclude, tgt[0].residual):
            tgt[2].extend(idxs)
        else:
            nodes.append(ForestNode(op=op, plans=tuple(idxs)))
    for relaxed, children, rides in merged.values():
        nodes.append(_with_liveness(relaxed, children, tuple(rides)))
    return tuple(nodes)


def _relax(group: list[tuple[int, list[LevelOp]]]):
    """Relax a stream-key group to its shared constraint intersection; push
    each branch's surplus down as residuals (+ re-added element constraints
    when the branch's next op carries the shared stream)."""
    ops0 = [ops[0] for _, ops in group]
    sh_ub = set.intersection(*[set(o.ub) for o in ops0])
    sh_lb = set.intersection(*[set(o.lb) for o in ops0])
    sh_ex = set.intersection(*[set(o.exclude) for o in ops0])
    sh_res = set.intersection(*[set(o.residual) for o in ops0])
    relaxed = dataclasses.replace(
        ops0[0], ub=tuple(sorted(sh_ub)), lb=tuple(sorted(sh_lb)),
        exclude=tuple(sorted(sh_ex)), residual=tuple(sorted(sh_res)))
    sub: list[tuple[int, list[LevelOp]]] = []
    for idx, ops in group:
        op0, nxt = ops[0], ops[1]
        s_ub = set(op0.ub) - sh_ub
        s_lb = set(op0.lb) - sh_lb
        s_ex = set(op0.exclude) - sh_ex
        res = set(nxt.residual) | (set(op0.residual) - sh_res) \
            | {("lt", op0.level, u) for u in s_ub} \
            | {("lt", w, op0.level) for w in s_lb} \
            | {("ne", op0.level, e) for e in s_ex}
        if nxt.use_carry and (s_ub or s_lb or s_ex):
            # the carried elements lost the surplus filters with the
            # relaxation: restore them on the consuming op
            nxt = dataclasses.replace(
                nxt, ub=tuple(sorted(set(nxt.ub) | s_ub)),
                lb=tuple(sorted(set(nxt.lb) | s_lb)),
                exclude=tuple(sorted(set(nxt.exclude) | s_ex)))
        nxt = dataclasses.replace(nxt, residual=tuple(sorted(res)))
        sub.append((idx, [nxt] + ops[2:]))
    return relaxed, sub


def _subtree_refs(node: ForestNode) -> tuple[set[int], set[int]]:
    """(value refs, row refs) of a subtree — the liveness a parent must
    forward. Emit leaves additionally consume their output columns."""
    vals = set(node.op.val_refs())
    rows = set(node.op.row_refs())
    if node.op.kind == "emit":
        vals |= set(node.op.out_cols)
    for ch in node.children:
        v, r = _subtree_refs(ch)
        vals |= v
        rows |= r
    return vals, rows


def _with_liveness(op: LevelOp, children: tuple[ForestNode, ...],
                   ride_plans: tuple[int, ...] = ()) -> ForestNode:
    """Interior-node liveness = union over the child subtrees (residual
    columns included via ``val_refs``); carry is produced iff any child
    consumes it. Riding count leaves add no liveness: their constraint set
    equals the node's, so every column they read is already consumed."""
    vals: set[int] = set()
    rows: set[int] = set()
    for ch in children:
        v, r = _subtree_refs(ch)
        vals |= v
        rows |= r
    return ForestNode(
        op=dataclasses.replace(
            op,
            out_cols=tuple(sorted(c for c in vals if c <= op.level)),
            gather_refs=tuple(sorted(c for c in rows if c <= op.level)),
            carry_out=any(ch.op.use_carry for ch in children)),
        children=children, ride_plans=ride_plans)


# ---------------------------------------------------------------------------
# automatic matching-order search (the schedule stage)
# ---------------------------------------------------------------------------


def _schedule_score(forest: PlanForest) -> tuple:
    """Static cost of a candidate schedule, lower is better.

    Every trie node dispatches once per level-1 feed chunk of its
    orientation, and the directed feed iterates all E edges where the
    half-edge feed iterates E/2 — so nodes under directed roots weigh 2,
    nodes under symmetric roots weigh 1, and each used orientation adds its
    own feed-materialisation weight. Total forest ops and feed-pass count
    break ties; all components are schedule facts (machine-independent)."""
    weighted = 0

    def walk(node: ForestNode, w: int) -> None:
        nonlocal weighted
        weighted += w
        for ch in node.children:
            walk(ch, w)

    for root in forest.symmetric_roots:
        walk(root, 1)
    for root in forest.directed_roots:
        walk(root, 2)
    feeds = int(bool(forest.symmetric_roots)) \
        + 2 * int(bool(forest.directed_roots))
    stats = forest.sharing_stats()
    return (weighted + feeds, sum(stats["forest_ops"].values()),
            stats["feed_passes"]["fused"])


_SCHEDULE_CACHE: dict[tuple, tuple[Pattern, ...]] = {}


def schedule_patterns(items: Sequence, context: Sequence[WavePlan] = ()) \
        -> list[Pattern]:
    """Pick a matching order per pattern to maximise batch sharing.

    ``items`` mixes ``Motif``s (unordered shapes — every candidate order
    from ``plan.matching_orders`` is in play) and ``Pattern``s (explicit
    schedules, respected as-is). ``context`` plans join the scoring forest
    without being rescheduled (a session batch alongside fixed queries).
    Coordinate descent over the candidate lists minimises
    ``_schedule_score`` until a fixpoint — AutoMine's compilation loop on
    the plan IR. Deterministic (pure host combinatorics, first-improvement
    in stable order) and memoised; returns one ``Pattern`` per item, in
    input order."""
    items = tuple(items)
    key = (items, tuple(p.canonical_key() for p in context))
    hit = _SCHEDULE_CACHE.get(key)
    if hit is not None:
        return list(hit)
    cands: list[tuple[Pattern, ...]] = []
    for it in items:
        if isinstance(it, Pattern):
            cands.append((it,))
        elif isinstance(it, Motif):
            cands.append(matching_orders(it))
        else:
            raise TypeError(f"schedule_patterns wants Pattern|Motif, got "
                            f"{type(it).__name__}")
    fixed = list(context)
    choice = [0] * len(cands)

    def score(ch: list[int]) -> tuple:
        plans = [compile_pattern(c[i]) for c, i in zip(cands, ch)] + fixed
        return _schedule_score(build_forest(plans))

    best = score(choice)
    improved = True
    while improved:
        improved = False
        for pi, cand in enumerate(cands):
            if len(cand) < 2:
                continue
            for ci in range(len(cand)):
                if ci == choice[pi]:
                    continue
                trial = list(choice)
                trial[pi] = ci
                sc = score(trial)
                if sc < best:
                    best, choice = sc, trial
                    improved = True
    picked = tuple(c[i] for c, i in zip(cands, choice))
    _SCHEDULE_CACHE[key] = picked
    return list(picked)


def build_forest(plans: Sequence[WavePlan]) -> PlanForest:
    """Merge compiled plans into a ``PlanForest``.

    Plans appear in the result exactly in input order (``run_set`` returns
    per-plan results positionally). The merge is structural — stream-key
    grouping for expands, full-op equality for leaves — so duplicate plans
    (equal ``WavePlan.canonical_key()``) collapse onto fully shared paths,
    down to one shared leaf credited to both."""
    plans = tuple(plans)
    if not plans:
        raise ValueError("build_forest needs at least one plan")
    sym = [(i, list(p.ops)) for i, p in enumerate(plans) if p.symmetric]
    dirc = [(i, list(p.ops)) for i, p in enumerate(plans) if not p.symmetric]
    return PlanForest(plans=plans,
                      symmetric_roots=_merge(sym) if sym else (),
                      directed_roots=_merge(dirc) if dirc else ())
