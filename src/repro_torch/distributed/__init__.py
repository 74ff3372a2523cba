"""The LM partition rules and the mining mesh (``sharding``), the int8
cross-pod mean (``compression``), and the fault-tolerance control plane of
``fault_tolerance`` (a copy of the JAX package's, numpy only): the train
step's ``StepGuard``, ``HeartbeatMonitor``, ``elastic_remesh`` and the
straggler-aware partitioner."""
from .fault_tolerance import (HeartbeatMonitor, StepGuard, balanced_vertex_partition,
                              elastic_remesh)
from .sharding import (DEFAULT_RULES, FSDP_RULES, Axes, Mesh, ShardingRules, constrain,
                       logical_to_physical, make_mining_mesh, mesh_context, named_sharding)

__all__ = ["Axes", "Mesh", "make_mining_mesh", "balanced_vertex_partition", "StepGuard",
           "HeartbeatMonitor", "elastic_remesh", "ShardingRules", "DEFAULT_RULES",
           "FSDP_RULES", "logical_to_physical", "named_sharding", "mesh_context", "constrain"]
