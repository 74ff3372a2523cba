"""The mining mesh and the LM's logical ``Axes`` (``sharding``), and the
straggler-aware partitioner of ``fault_tolerance`` (a copy of the JAX package's, numpy only)."""
from .fault_tolerance import balanced_vertex_partition
from .sharding import Axes, Mesh, make_mining_mesh

__all__ = ["Axes", "Mesh", "make_mining_mesh", "balanced_vertex_partition"]
