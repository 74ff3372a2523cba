"""repro_torch — IntersectX (stream-intersection graph mining) in PyTorch,
for an NVIDIA H100.

The counterpart of ``repro`` (the JAX package), module for module:

  core/        the stream ISA (``Stream``, Table I ops, S_NESTINTER) and the
               batched plain-torch stream ops
  graph/       CSR graph substrate as torch tensors, synthetic datasets
  kernels/     hand-written CUDA kernels (``csrc/``), ``build.py`` that builds them, and
               their op wrappers, each beside its plain torch version
  mining/      pattern plans, the wavefront engine (and its sharded runner), the
               ``Miner`` session, and the workloads over it (FSM, the
               exhaustive baseline, ``apps``)
  serving/     the concurrent mining service over a pool of sessions
  distributed/ the mining mesh (a list of devices), the LM's logical ``Axes``,
               the degree-balanced partitioner
  obs/         metrics registry behind the engine's counters, span tracer
  models/      the LM: one transformer skeleton for ten architectures (GQA/MLA
               attention, MoE, Mamba, RWKV-6 blocks) in plain torch, its KV/state
               caches and decode step, and ``convert`` for the JAX package's weights
  configs/     the ten architectures' published and smoke configs (``get_arch``)
  launch/      ``python -m repro_torch.launch.mine``, ``launch.serve --mine`` and
               ``launch.serve --arch`` (greedy decoding)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
each kernel wrapper takes its plain version only for a CPU tensor.
"""

__version__ = "0.1.0"

from .mining.session import Miner, MinerConfig  # noqa: E402

__all__ = ["Miner", "MinerConfig", "__version__"]
