"""Pattern-plan compiler: declarative patterns -> stream-op level programs.

This module is the software twin of the paper's nested-intersection
translator (§IV-F). There, S_NESTINTER is decoded into a *translation
buffer* holding a µop sequence — one bounded stream instruction per
candidate extension, each naming its operand streams (R1/R2), its bound
register (R3) and whether it counts or materialises. Here a ``Pattern``
(adjacency matrix + AutoMine-style symmetry-breaking restrictions) is
compiled once, on the host, into a ``WavePlan`` whose per-level ``LevelOp``
records play exactly that role for the wavefront engine
(``mining.engine.WaveRunner.run``):

  paper §IV-F translation buffer          ``LevelOp`` field
  --------------------------------        ---------------------------------
  µop opcode (S_INTER / S_SUB)            ``inter`` / ``sub`` column lists
  R1 operand (running stream)             ``use_carry`` / ``base`` column
  R2 operand (neighbor stream S_READ)     each column in ``inter``/``sub``
  R3 bound register (early termination)   ``ub`` (+ ``lb``, beyond-paper)
  count vs materialise disposition        ``kind``: count / expand / emit
  closed-form retire (stream len reuse)   ``tail`` degree-factor multiplier

A ``LevelOp`` for level ``l`` selects candidates for pattern vertex v_l out
of one *base* stream — either the parent level's materialised survivor
stream (``use_carry``, the S-Cache-resident operand reuse of §IV-D) or a
freshly gathered neighbor list N(v_base) — by AND-ing membership masks:

  keep = base∈N(v_j) ∀j∈inter  ∧  base∉N(v_j) ∀j∈sub
         ∧ base < min(v_u: u∈ub) ∧ base > max(v_w: w∈lb) ∧ base ≠ v_e ∀e∈exclude

``sub`` columns realise *induced* (non-edge) constraints; ``ub``/``lb``
realise the declared symmetry-breaking restrictions; ``exclude`` keeps the
embedding injective where neither adjacency nor an order constraint already
implies it.  The compiler additionally performs:

  * **carry reuse** — level l starts from the parent's survivor stream when
    every constraint that defined the parent stream is implied by level l's
    own constraint set (clique chains hit this on every level, which is how
    the generic interpreter reproduces the hand-coded clique schedule
    executable-for-executable);
  * **tail folding** — a final level whose candidate set is one neighbor
    list minus statically-known members collapses to a closed-form
    ``deg(v_b) - c`` multiplier fused into the previous level's count (the
    paper's stream-length reuse; tailed-triangle's ``deg(v1) - 2``);
  * **liveness** — ``out_cols`` / ``gather_refs`` record which prefix
    columns deeper levels still reference, so the engine forwards (and
    meta-sizes) only those.

Beyond the ordered ``Pattern``, this module also models the *unordered*
shape a user actually asks for: a ``Motif`` is adjacency (+ inducedness)
only — no matching order, no hand-written symmetry-breaking restrictions.
``matching_orders`` enumerates every connected matching order of a motif
and derives each order's restrictions automatically from the automorphism
group (``auto_restrictions``: keep exactly the lexicographically largest
matched sequence of every embedding orbit, so each subgraph is counted
once and ``div`` is always 1). The batch-aware choice *between* those
orders — AutoMine's compilation loop, maximising shared canonical prefixes
across a pattern set — lives in ``mining.forest.schedule_patterns``; the
``FOUR_MOTIFS`` dict (and the per-motif names ``DIAMOND``/``CYCLE4``/
``PAW_INDUCED``/``PATH4``/``STAR4``) are resolved lazily from the
``FOUR_MOTIF_SHAPES`` adjacency-only definitions through that search, so
no 4-motif schedule is hand-ordered anywhere.

Nothing in this module touches a device: a ``WavePlan`` is a pure host
datum, and compiling the same ``Pattern`` twice yields structurally equal
(hashable) ops, so ``WaveRunner``'s executable cache keys on them directly.
"""
from __future__ import annotations

import dataclasses
import itertools

# FOUR_MOTIFS / DIAMOND / CYCLE4 / PAW_INDUCED / PATH4 / STAR4 are module
# attributes too, resolved lazily via __getattr__ (schedule search).
__all__ = [
    "Pattern", "LevelOp", "WavePlan", "compile_pattern", "pattern",
    "clique_pattern", "Motif", "motif", "auto_restrictions",
    "matching_orders", "resolve_query", "TRIANGLE", "TRIANGLE_NESTED",
    "THREE_CHAIN_INDUCED", "TAILED_TRIANGLE", "FOUR_MOTIF_SHAPES",
]


# ---------------------------------------------------------------------------
# declarative pattern model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A vertex pattern in matching order (AutoMine-style schedule).

    ``adj``          k×k symmetric boolean adjacency (no self loops); index
                     i is the i-th matched vertex.
    ``restrictions`` symmetry-breaking constraints ``(i, j)`` ≡ v_i < v_j;
                     must be consistent with some total order (acyclic) and
                     any constraint between vertices 0 and 1 must be
                     ``(1, 0)`` (the engine's half-edge feed yields v1 < v0).
    ``induced``      non-edges of ``adj`` become S_SUB constraints.
    ``div``          residual automorphism count the raw total over-counts
                     by when the restrictions break symmetry only partially
                     (the Fig. 4a nested-triangle stream divides by 6).
    """

    name: str
    adj: tuple[tuple[bool, ...], ...]
    restrictions: tuple[tuple[int, int], ...] = ()
    induced: bool = False
    div: int = 1

    @property
    def k(self) -> int:
        return len(self.adj)


def pattern(name: str, k: int, edges, restrictions=(), induced: bool = False,
            div: int = 1) -> Pattern:
    """Build a validated ``Pattern`` from an edge list over vertices 0..k-1."""
    adj = [[False] * k for _ in range(k)]
    for i, j in edges:
        if i == j:
            raise ValueError(f"{name}: self loop ({i},{j})")
        adj[i][j] = adj[j][i] = True
    p = Pattern(name=name, adj=tuple(tuple(r) for r in adj),
                restrictions=tuple((int(i), int(j)) for i, j in restrictions),
                induced=induced, div=div)
    _validate(p)
    return p


def clique_pattern(k: int) -> Pattern:
    """k-clique: complete adjacency, descending chain v_{i+1} < v_i."""
    return pattern(f"{k}-clique", k, itertools.combinations(range(k), 2),
                   restrictions=[(i + 1, i) for i in range(k - 1)])


# ---------------------------------------------------------------------------
# unordered motif shapes + automatic symmetry breaking
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Motif:
    """An unordered pattern *shape*: adjacency + inducedness, nothing else.

    A ``Motif`` is what a query names ("count paws") before any schedule
    decision is made: it carries no matching order and no hand-written
    symmetry-breaking restrictions. ``matching_orders`` lowers it to the
    candidate ``Pattern``s (one per structurally distinct matching order,
    restrictions derived from the automorphism group), and the forest
    scheduler picks between them per batch."""

    name: str
    adj: tuple[tuple[bool, ...], ...]
    induced: bool = False

    @property
    def k(self) -> int:
        return len(self.adj)


def motif(name: str, k: int, edges, induced: bool = False) -> Motif:
    """Build a validated ``Motif`` from an edge list over vertices 0..k-1."""
    adj = [[False] * k for _ in range(k)]
    for i, j in edges:
        if i == j:
            raise ValueError(f"{name}: self loop ({i},{j})")
        adj[i][j] = adj[j][i] = True
    return Motif(name=name, adj=tuple(tuple(r) for r in adj),
                 induced=induced)


def _automorphisms(adj) -> list[tuple[int, ...]]:
    """All adjacency-preserving vertex permutations (brute force; k <= 5
    for every mining pattern, so k! stays trivial)."""
    k = len(adj)
    return [perm for perm in itertools.permutations(range(k))
            if all(adj[i][j] == adj[perm[i]][perm[j]]
                   for i in range(k) for j in range(k))]


def auto_restrictions(adj) -> tuple[tuple[int, int], ...]:
    """Symmetry-breaking restrictions for a matching order, derived from
    the automorphism group.

    For each non-identity automorphism σ, let i be the first position σ
    moves; requiring v_{σ(i)} < v_i keeps exactly the lexicographically
    *largest* matched sequence of each embedding orbit (positions before i
    are fixed by σ, so the orbit comparison is decided at i). Every
    embedding is therefore counted exactly once — no residual ``div`` —
    and since σ(i) > i always, every restriction points at a lower level
    (acyclic, and any v0/v1 constraint is the half-edge feed's (1, 0)).
    Transitively implied restrictions are pruned."""
    k = len(adj)
    ident = tuple(range(k))
    restr = set()
    for sig in _automorphisms(adj):
        if sig == ident:
            continue
        i = min(p for p in range(k) if sig[p] != p)
        restr.add((sig[i], i))            # v_sig(i) < v_i, and sig(i) > i
    for e in sorted(restr):               # transitive reduction
        if e in _closure(k, restr - {e}):
            restr.discard(e)
    return tuple(sorted(restr))


def matching_orders(m: Motif) -> tuple[Pattern, ...]:
    """All structurally distinct matching orders of ``m`` as ``Pattern``s.

    Enumerates vertex permutations that yield a valid matching order (v0-v1
    an edge, every later vertex adjacent to an earlier one), attaches each
    order's ``auto_restrictions``, and dedupes by compiled canonical plan
    key — orders that perform identical work item-for-item collapse to one
    candidate (a k-clique has exactly one)."""
    k = len(m.adj)
    out: list[Pattern] = []
    seen: set[tuple] = set()
    for perm in itertools.permutations(range(k)):
        radj = tuple(tuple(m.adj[perm[a]][perm[b]] for b in range(k))
                     for a in range(k))
        if not radj[0][1]:
            continue
        if any(not any(radj[lvl][j] for j in range(lvl))
               for lvl in range(2, k)):
            continue
        p = Pattern(name=m.name, adj=radj,
                    restrictions=auto_restrictions(radj),
                    induced=m.induced, div=1)
        key = compile_pattern(p).canonical_key()
        if key in seen:
            continue
        seen.add(key)
        out.append(p)
    if not out:
        raise ValueError(f"{m.name}: no connected matching order")
    return tuple(out)


# ---------------------------------------------------------------------------
# compiled plan model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelOp:
    """One translation-buffer entry: how to extend prefixes to vertex ``level``.

    All column references are prefix indices < ``level``. Hashable by value:
    the engine's executable cache keys on (op, capacities, chunk).
    """

    level: int
    use_carry: bool               # base = parent's materialised survivors
    base: int                     # else base = N(v_base) (column in inter set)
    inter: tuple[int, ...]        # S_INTER refs beyond the base
    sub: tuple[int, ...]          # S_SUB refs (induced non-edges)
    ub: tuple[int, ...]           # candidate < min over these columns (R3)
    lb: tuple[int, ...]           # candidate > max over these columns
    exclude: tuple[int, ...]      # explicit injectivity: candidate != v_e
    kind: str                     # 'expand' | 'count' | 'emit'
    tail: tuple[int, int] | None  # (col, c): weight each count by deg(v_col)-c
    out_cols: tuple[int, ...]     # prefix columns forwarded to deeper levels
    gather_refs: tuple[int, ...]  # columns deeper levels gather rows for
    carry_out: bool               # next level starts from our survivors
    # SVPU value disposition (count leaves only; compile_pattern(...,
    # aggregate=...)). ``agg`` names the reduction over embedding values —
    # 'sum' | 'max' | 'min' — where an embedding's value is the product of
    # its pattern-edge weights. The leaf computes that product locally:
    # ``agg_scale_edges`` are the prefix-prefix pattern edges (both
    # endpoints < level, incl. the (0,1) feed edge) folded into a per-item
    # scale via CSR weight lookups; ``agg_cand_cols`` are candidate-adjacent
    # prefix columns no INTER ref of THIS op covers (carry-reuse hides
    # them), looked up per (item, slot). A count leaf has agg None and both
    # tuples empty — its LevelOp hash/eq is what it always was.
    agg: str | None = None
    agg_scale_edges: tuple[tuple[int, int], ...] = ()
    agg_cand_cols: tuple[int, ...] = ()
    # deferred per-item constraints, installed by the forest scheduler when a
    # shared ancestor was *relaxed* (its bound/injectivity surplus dropped so
    # several patterns could share one expand). Entries ('lt', i, j) ≡ require
    # v_i < v_j, ('ne', i, j) ≡ require v_i != v_j; i, j < level. An item
    # failing a residual contributes nothing: the engine folds residuals into
    # the per-row bound operand (bound := 0), so whole rows die inside the
    # kernels' tile schedule. compile_pattern never emits residuals — a
    # single-plan LevelOp always has residual == ().
    residual: tuple[tuple[str, int, int], ...] = ()

    def row_refs(self) -> tuple[int, ...]:
        """Columns whose neighbor rows this op gathers."""
        refs = (() if self.use_carry else (self.base,)) + self.inter + self.sub
        return tuple(sorted(set(refs)))

    def val_refs(self) -> tuple[int, ...]:
        """Columns whose *values* this op reads (gather starts, bounds, ...)."""
        refs = set(self.row_refs()) | set(self.ub) | set(self.lb) \
            | set(self.exclude)
        if self.tail is not None:
            refs.add(self.tail[0])
        for _, i, j in self.residual:
            refs.add(i)
            refs.add(j)
        for i, j in self.agg_scale_edges:
            refs.add(i)
            refs.add(j)
        refs |= set(self.agg_cand_cols)
        return tuple(sorted(refs))

    def stream_key(self) -> tuple:
        """What defines the *survivor stream* (not which items stay live):
        ops with equal stream keys materialise element-identical streams and
        can share one expand + compaction in a ``PlanForest``."""
        return (self.level, self.use_carry, self.base, self.inter, self.sub)

    def semantic_key(self) -> tuple:
        """Canonical form: every field with count/stream semantics, none of
        the liveness bookkeeping (``out_cols``/``gather_refs``/``carry_out``
        are schedule-dependent and recomputed by the forest builder). Two ops
        with equal semantic keys are interchangeable work."""
        return (self.level, self.use_carry, self.base, self.inter, self.sub,
                self.ub, self.lb, self.exclude, self.kind, self.tail,
                tuple(sorted(self.residual)), self.agg,
                self.agg_scale_edges, self.agg_cand_cols)


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """A compiled stream program: level-1 feed spec + one op per level ≥ 2."""

    pattern: Pattern
    symmetric: bool               # half-edge feed (v1 < v0) vs directed
    ops: tuple[LevelOp, ...]
    div: int = 1

    @property
    def k(self) -> int:
        return self.pattern.k

    def canonical_key(self) -> tuple:
        """Stable plan hash: feed orientation + per-level semantic keys +
        retire division. Plans with equal canonical keys perform identical
        work item-for-item (whatever their ``Pattern`` was named) —
        ``apps.pattern_set_run`` memoises built ``PlanForest``s on the batch
        of these keys, and inside a forest such plans collapse onto fully
        shared paths."""
        return (self.symmetric, tuple(op.semantic_key() for op in self.ops),
                self.div)


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def _closure(k: int, restrictions) -> set[tuple[int, int]]:
    """Transitive closure of the strict order v_i < v_j; raises on cycles."""
    less = set(restrictions)
    changed = True
    while changed:
        changed = False
        for (a, b), (c, d) in itertools.product(tuple(less), tuple(less)):
            if b == c and (a, d) not in less:
                less.add((a, d))
                changed = True
    for i in range(k):
        if (i, i) in less:
            raise ValueError("restrictions contain a cycle")
    return less


def _validate(p: Pattern) -> None:
    k = p.k
    if k < 3:
        raise ValueError("patterns need k >= 3 (k=2 is the edge feed itself)")
    for i in range(k):
        if p.adj[i][i]:
            raise ValueError("self loop in pattern adjacency")
        for j in range(k):
            if p.adj[i][j] != p.adj[j][i]:
                raise ValueError("pattern adjacency must be symmetric")
    if not p.adj[0][1]:
        raise ValueError("matching order must start on an edge (v0, v1)")
    for lvl in range(2, k):
        if not any(p.adj[lvl][j] for j in range(lvl)):
            raise ValueError(
                f"{p.name}: vertex {lvl} not adjacent to any earlier vertex "
                "(matching order must keep the pattern connected)")
    for i, j in p.restrictions:
        if not (0 <= i < k and 0 <= j < k and i != j):
            raise ValueError(f"bad restriction ({i},{j})")
    if (0, 1) in p.restrictions:
        raise ValueError(
            "restriction between v0 and v1 must be (1, 0): the half-edge "
            "feed enumerates v1 < v0")


# compiled-plan memo: the schedule search and the session compile stage both
# revisit patterns; Pattern/WavePlan are immutable so sharing is free
_PLAN_CACHE: dict[tuple[Pattern, bool, str | None], WavePlan] = {}

AGG_OPS = ("sum", "max", "min")


def compile_pattern(p: Pattern, emit: bool = False,
                    aggregate: str | None = None) -> WavePlan:
    """Lower a ``Pattern`` to a ``WavePlan`` (§IV-F translation, on host).

    ``emit=True`` compiles an enumeration program: the final level
    materialises embeddings instead of counting (FSM's triangle feed).
    ``aggregate`` ('sum'/'max'/'min') compiles a *weighted* program: the
    count leaf becomes an SVPU aggregate leaf reducing per-embedding edge-
    weight products (tail folding is disabled — a folded closed-form count
    cannot carry per-edge values — and earlier ops forward whatever prefix
    columns the leaf's weight lookups reference). The plan's *stream* structure
    is otherwise identical to the unweighted plan's, which is what lets a
    forest fuse weighted and unweighted queries onto shared expands.
    Compilation is memoised (host-pure, immutable output).
    """
    if aggregate is not None and aggregate not in AGG_OPS:
        raise ValueError(f"unknown aggregate {aggregate!r}; use one of "
                         f"{AGG_OPS}")
    if aggregate is not None and emit:
        raise ValueError("aggregate plans are count programs (emit=False)")
    if aggregate is not None and p.div != 1:
        raise ValueError(
            f"{p.name}: aggregate needs fully symmetry-broken schedules "
            "(div == 1) — a residual automorphism factor divides counts but "
            "not max/min aggregates")
    cached = _PLAN_CACHE.get((p, emit, aggregate))
    if cached is not None:
        return cached
    _validate(p)
    k = p.k
    less = _closure(k, p.restrictions)
    # v1 < v0 (declared or implied) => the half-edge feed already enumerates
    # exactly the valid (v0, v1) pairs; otherwise feed all directed edges
    symmetric = (1, 0) in less
    # effective constraint sets per level (for carry implication checks)
    eff_i: dict[int, set] = {}
    eff_s: dict[int, set] = {}
    eff_ub: dict[int, set] = {}
    eff_lb: dict[int, set] = {}
    raw_ops: list[dict] = []
    for lvl in range(2, k):
        icols = {j for j in range(lvl) if p.adj[lvl][j]}
        scols = {j for j in range(lvl)
                 if not p.adj[lvl][j]} if p.induced else set()
        ub = {j for (i, j) in p.restrictions if i == lvl and j < lvl}
        lb = {j for (j, i) in p.restrictions if i == lvl and j < lvl}
        ordered = {j for j in range(lvl)
                   if (lvl, j) in less or (j, lvl) in less}
        exclude = {j for j in range(lvl)
                   if j not in icols and j not in ordered}
        eff_i[lvl], eff_s[lvl], eff_ub[lvl], eff_lb[lvl] = \
            icols, scols, ub, lb
        # ---- carry reuse: is the parent's survivor stream a superset? ----
        use_carry = False
        if lvl > 2:
            pi, ps, pub, plb = eff_i[lvl - 1], eff_s[lvl - 1], \
                eff_ub[lvl - 1], eff_lb[lvl - 1]
            ub_ok = all(any(u2 == u or (u2, u) in less for u2 in ub)
                        for u in pub)
            lb_ok = all(any(w2 == w or (w, w2) in less for w2 in lb)
                        for w in plb)
            use_carry = (raw_ops[-1]["kind"] == "expand" and pi <= icols
                         and ps <= scols and ub_ok and lb_ok)
        if use_carry:
            inter = icols - eff_i[lvl - 1]
            sub = scols - eff_s[lvl - 1]
            base = -1
        else:
            inter = set(icols)
            base = min(inter)
            inter.discard(base)
            sub = set(scols)
        raw_ops.append(dict(
            level=lvl, use_carry=use_carry, base=base,
            inter=tuple(sorted(inter)), sub=tuple(sorted(sub)),
            ub=tuple(sorted(ub)), lb=tuple(sorted(lb)),
            exclude=tuple(sorted(exclude)),
            kind=("emit" if emit else "count") if lvl == k - 1 else "expand",
            tail=None))
    # ---- tail folding: closed-form final level -> degree multiplier ----
    last = raw_ops[-1]
    if (not emit and aggregate is None and len(raw_ops) >= 2
            and last["kind"] == "count"
            and not last["sub"] and not last["ub"] and not last["lb"]
            and last["use_carry"] is False and not last["inter"]):
        lvl, b = last["level"], last["base"]
        # every earlier vertex must be statically a member of N(v_b), so the
        # exclusion count is a compile-time constant (non-induced only:
        # an induced pattern would have sub refs and fail the guard above)
        if b <= lvl - 2 and all(p.adj[j][b] for j in range(lvl) if j != b):
            raw_ops.pop()
            raw_ops[-1]["kind"] = "count"
            raw_ops[-1]["tail"] = (b, lvl - 1)
    # ---- value disposition: stamp the count leaf with SVPU agg fields ----
    if aggregate is not None:
        leaf = raw_ops[-1]
        lvl = leaf["level"]
        leaf["agg"] = aggregate
        # pattern edges wholly inside the prefix (incl. the (0,1) feed edge):
        # folded into a per-item scale via CSR weight lookups at the leaf
        leaf["agg_scale_edges"] = tuple(
            (i, j) for i in range(lvl) for j in range(i + 1, lvl)
            if p.adj[i][j])
        # candidate-adjacent prefix columns whose matched value the leaf's
        # own kernel refs do NOT observe (carry reuse: the membership test
        # happened at an ancestor level) — looked up per (item, slot)
        covered = set(leaf["inter"]) \
            | (set() if leaf["use_carry"] else {leaf["base"]})
        leaf["agg_cand_cols"] = tuple(sorted(
            {j for j in range(lvl) if p.adj[lvl][j]} - covered))
    # ---- liveness: which columns do deeper levels still touch? ----
    ops: list[LevelOp] = []
    for idx, ro in enumerate(raw_ops):
        deeper = raw_ops[idx + 1:]
        needed: set[int] = set()
        rows_needed: set[int] = set()
        for d in deeper:
            drows = (set() if d["use_carry"] else {d["base"]}) \
                | set(d["inter"]) | set(d["sub"])
            dvals = drows | set(d["ub"]) | set(d["lb"]) | set(d["exclude"])
            if d["tail"] is not None:
                dvals.add(d["tail"][0])
            for a, b in d.get("agg_scale_edges", ()):
                dvals.add(a)
                dvals.add(b)
            dvals |= set(d.get("agg_cand_cols", ()))
            needed |= {c for c in dvals if c <= ro["level"]}
            rows_needed |= {c for c in drows if c <= ro["level"]}
        if emit:
            needed |= set(range(ro["level"] + 1))   # embeddings output all
        ops.append(LevelOp(
            level=ro["level"], use_carry=ro["use_carry"], base=ro["base"],
            inter=ro["inter"], sub=ro["sub"], ub=ro["ub"], lb=ro["lb"],
            exclude=ro["exclude"], kind=ro["kind"], tail=ro["tail"],
            agg=ro.get("agg"),
            agg_scale_edges=ro.get("agg_scale_edges", ()),
            agg_cand_cols=ro.get("agg_cand_cols", ()),
            out_cols=tuple(sorted(needed)),
            gather_refs=tuple(sorted(rows_needed)),
            carry_out=(idx + 1 < len(raw_ops)
                       and raw_ops[idx + 1]["use_carry"])))
    plan = WavePlan(pattern=p, symmetric=symmetric, ops=tuple(ops),
                    div=1 if emit else p.div)
    _PLAN_CACHE[(p, emit, aggregate)] = plan
    return plan


# ---------------------------------------------------------------------------
# canned patterns — the paper's apps + the 4-motif family, declaratively
# ---------------------------------------------------------------------------

# triangle, each counted once: v2 < v1 < v0 (§VI-B "T")
TRIANGLE = pattern("triangle", 3, [(0, 1), (0, 2), (1, 2)],
                   restrictions=[(1, 0), (2, 1)])

# paper-faithful Fig. 4a S_NESTINTER stream: unbounded, every triangle
# reached 6x, one division at retire ("TS")
TRIANGLE_NESTED = pattern("triangle-nested", 3, [(0, 1), (0, 2), (1, 2)],
                          div=6)

# induced three-chain a—m—b with (a,b) ∉ E; v0 = center m, leaf order
# broken with v2 > v1 — a *lower* bound level ("TC")
THREE_CHAIN_INDUCED = pattern("three-chain-induced", 3, [(0, 1), (0, 2)],
                              restrictions=[(1, 2)], induced=True)

# non-induced tailed triangle (paper "TT"): triangle {0,1,2} + tail (1,3);
# the wing swap v0<->v2 broken with v2 < v0. The tail level folds to the
# closed-form deg(v1) - 2 multiplier at compile time.
TAILED_TRIANGLE = pattern("tailed-triangle", 4,
                          [(0, 1), (0, 2), (1, 2), (1, 3)],
                          restrictions=[(2, 0)])

# the six connected 4-vertex motifs as *unordered shapes* (induced counts).
# Vertex numbering here is arbitrary — matching order and symmetry-breaking
# restrictions are derived automatically (auto_restrictions + the forest
# scheduler's matching-order search), so nothing below is hand-scheduled.
FOUR_MOTIF_SHAPES: dict[str, Motif] = {
    "4-clique": motif("4-clique", 4,
                      itertools.combinations(range(4), 2), induced=True),
    "diamond": motif("diamond", 4,
                     [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)], induced=True),
    "4-cycle": motif("4-cycle", 4,
                     [(0, 1), (1, 2), (2, 3), (0, 3)], induced=True),
    "paw": motif("paw", 4, [(0, 1), (0, 2), (1, 2), (2, 3)], induced=True),
    "4-path": motif("4-path", 4, [(0, 1), (1, 2), (2, 3)], induced=True),
    "4-star": motif("4-star", 4, [(0, 1), (0, 2), (0, 3)], induced=True),
}

# named query surface for the session API (mining.session.Miner): strings a
# query may use, each resolving to a paper-faithful Pattern (fixed schedule)
# or a Motif (schedule chosen by the batch-aware matching-order search)
_NAMED_QUERIES: dict[str, object] = {
    "triangle": TRIANGLE,
    "triangle-nested": TRIANGLE_NESTED,
    "three-chain": THREE_CHAIN_INDUCED,
    "three-chain-induced": THREE_CHAIN_INDUCED,
    "tailed-triangle": TAILED_TRIANGLE,
    "5-clique": clique_pattern(5),
    **FOUR_MOTIF_SHAPES,
}


def resolve_query(q):
    """Resolve a session query — a name, ``Motif`` or ``Pattern`` — to the
    ``Motif``/``Pattern`` object the compile/schedule stages consume."""
    if isinstance(q, (Motif, Pattern)):
        return q
    try:
        return _NAMED_QUERIES[q]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown pattern query {q!r}; use a Pattern, a Motif or one of "
            f"{sorted(_NAMED_QUERIES)}") from None


# per-motif names + FOUR_MOTIFS resolve lazily through the schedule search
# (mining.forest.schedule_patterns) the first time they are touched — the
# search needs build_forest, which imports this module
_SCHEDULED_NAMES = {"DIAMOND": "diamond", "CYCLE4": "4-cycle",
                    "PAW_INDUCED": "paw", "PATH4": "4-path",
                    "STAR4": "4-star"}


def __getattr__(name: str):
    if name == "FOUR_MOTIFS" or name in _SCHEDULED_NAMES:
        from .forest import schedule_patterns
        pats = schedule_patterns(list(FOUR_MOTIF_SHAPES.values()))
        four = dict(zip(FOUR_MOTIF_SHAPES, pats))
        globals()["FOUR_MOTIFS"] = four
        for attr, motif_name in _SCHEDULED_NAMES.items():
            globals()[attr] = four[motif_name]
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
