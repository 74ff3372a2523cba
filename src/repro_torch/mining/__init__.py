"""Public mining API: the ``Miner`` session (sharded over a device mesh
with ``mesh=``), the query language, and the workloads over the session
(FSM, the exhaustive-check baseline, and the one-shot ``apps`` surface with
the FSM feed)."""
from . import apps
from .apps import fsm_pattern_feed, shared_session, triangle_list_host
from .exhaustive import exhaustive_count
from .fsm import fsm, random_labels, sfsm
from .plan import (Motif, Pattern, WavePlan, compile_pattern, motif, pattern,
                   resolve_query)
from .session import ExecutableCache, Miner, MinerConfig, mesh_signature
from .shard import ShardedWaveRunner, shard_edge_steps

__all__ = ["Miner", "MinerConfig", "ExecutableCache", "mesh_signature",
           "ShardedWaveRunner", "shard_edge_steps", "Pattern", "Motif",
           "WavePlan", "compile_pattern", "motif", "pattern", "resolve_query",
           "fsm", "sfsm", "random_labels", "exhaustive_count", "apps",
           "fsm_pattern_feed", "shared_session", "triangle_list_host"]
