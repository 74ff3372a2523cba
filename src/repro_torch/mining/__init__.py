"""Public mining API: the ``Miner`` session and the query language."""
from .plan import (Motif, Pattern, WavePlan, compile_pattern, motif, pattern,
                   resolve_query)
from .session import ExecutableCache, Miner, MinerConfig

__all__ = ["Miner", "MinerConfig", "ExecutableCache", "Pattern", "Motif",
           "WavePlan", "compile_pattern", "motif", "pattern", "resolve_query"]
