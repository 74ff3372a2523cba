"""Public mining API: the ``Miner`` session, the query language, and the
workloads over the session (FSM, the exhaustive-check baseline, and the
one-shot ``apps`` surface with the FSM feed)."""
from . import apps
from .apps import fsm_pattern_feed, shared_session, triangle_list_host
from .exhaustive import exhaustive_count
from .fsm import fsm, random_labels, sfsm
from .plan import (Motif, Pattern, WavePlan, compile_pattern, motif, pattern,
                   resolve_query)
from .session import ExecutableCache, Miner, MinerConfig

__all__ = ["Miner", "MinerConfig", "ExecutableCache", "Pattern", "Motif",
           "WavePlan", "compile_pattern", "motif", "pattern", "resolve_query",
           "fsm", "sfsm", "random_labels", "exhaustive_count", "apps",
           "fsm_pattern_feed", "shared_session", "triangle_list_host"]
