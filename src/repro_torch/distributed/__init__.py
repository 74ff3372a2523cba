"""The mining mesh and the LM's logical ``Axes`` (``sharding``), and the
fault-tolerance control plane of ``fault_tolerance`` (a copy of the JAX
package's, numpy only): the train step's ``StepGuard``, ``HeartbeatMonitor``,
``elastic_remesh`` and the straggler-aware partitioner."""
from .fault_tolerance import (HeartbeatMonitor, StepGuard, balanced_vertex_partition,
                              elastic_remesh)
from .sharding import Axes, Mesh, make_mining_mesh

__all__ = ["Axes", "Mesh", "make_mining_mesh", "balanced_vertex_partition", "StepGuard",
           "HeartbeatMonitor", "elastic_remesh"]
