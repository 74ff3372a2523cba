"""Public mining API: the ``Miner`` session (sharded over a device mesh
with ``mesh=``), the concurrent ``MiningService`` over a pool of sessions
(``repro_torch.serving``), the query language, the multi-pattern fusion
layer, and the workloads over the session (FSM, the exhaustive-check
baseline, and the one-shot ``apps`` surface with the FSM feed).

The counterpart of ``repro.mining``'s surface, less ``reference`` (the
brute-force oracles need networkx). The historical one-shot helpers
(``apps.triangle_count`` and friends) are re-exported lazily as deprecated
shims over ``Miner``: importable, but each call emits a
``DeprecationWarning``; ``shared_session`` stays supported.
"""
from . import apps
from .apps import fsm_pattern_feed, shared_session, triangle_list_host
from .exhaustive import exhaustive_count
from .forest import PlanForest, build_forest, schedule_patterns
from .fsm import fsm, random_labels, sfsm
from .plan import (FOUR_MOTIF_SHAPES, Motif, Pattern, WavePlan, compile_pattern, motif,
                   pattern, resolve_query)
from .session import ExecutableCache, Miner, MinerConfig, mesh_signature
from .shard import ShardedWaveRunner, shard_edge_steps

__all__ = ["Miner", "MinerConfig", "MiningService", "ExecutableCache", "mesh_signature",
           "ShardedWaveRunner", "shard_edge_steps", "Pattern", "Motif",
           "WavePlan", "compile_pattern", "motif", "pattern", "resolve_query",
           "FOUR_MOTIFS", "FOUR_MOTIF_SHAPES", "PlanForest", "build_forest",
           "schedule_patterns", "fsm", "sfsm", "random_labels", "exhaustive_count", "apps",
           "fsm_pattern_feed", "shared_session", "triangle_list_host"]

# legacy names re-exported for source compatibility; the one-shot helpers
# among them warn on each CALL (importing does not)
_APPS_REEXPORTS = (
    "clique_count", "four_motif", "pattern_count", "pattern_embeddings",
    "pattern_set_count", "pattern_set_run", "shared_session",
    "tailed_triangle_count", "three_chain_count", "three_motif",
    "triangle_count", "triangle_count_nested", "triangle_list",
)


def __getattr__(name: str):
    if name == "MiningService":
        # lazy: repro_torch.serving imports this package (sessions,
        # patterns), so the service resolves on first touch
        from repro_torch.serving import MiningService
        return MiningService
    if name == "FOUR_MOTIFS":
        # lazy in plan too: resolving it runs the matching-order search
        from . import plan
        return plan.FOUR_MOTIFS
    if name in _APPS_REEXPORTS:
        return getattr(apps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
