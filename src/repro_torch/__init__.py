"""repro_torch — IntersectX (stream-intersection graph mining) in PyTorch,
for an NVIDIA H100.

The counterpart of ``repro`` (the JAX package), module for module:

  core/        stream constants and the batched plain-torch stream ops
  graph/       CSR graph substrate as torch tensors, synthetic datasets
  kernels/     hand-written CUDA kernels (``csrc/``), ``build.py`` that builds them, and
               their op wrappers, each beside its plain torch version
  mining/      pattern plans, the wavefront engine (and its sharded runner), the
               ``Miner`` session, and the workloads over it (FSM, the
               exhaustive baseline, ``apps``)
  distributed/ the mining mesh (a list of devices), the degree-balanced partitioner
  obs/         metrics registry behind the engine's counters, span tracer
  launch/      ``python -m repro_torch.launch.mine``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
each kernel wrapper takes its plain version only for a CPU tensor.
"""

__version__ = "0.1.0"

from .mining.session import Miner, MinerConfig  # noqa: E402

__all__ = ["Miner", "MinerConfig", "__version__"]
