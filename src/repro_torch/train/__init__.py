"""LM training on one device or sharded over a mesh: the optimizer and its
ZeRO shardings (``optimizer``), the synthetic data pipeline (``data``), the
train steps and schedule (``train_step``) and checkpoints in the JAX
package's format (``checkpoint``)."""
from .optimizer import adamw_init, adamw_update, OptConfig
from .data import SyntheticLMData
from .train_step import ShardedTrainStep, jit_train_step, lr_schedule, make_train_step
from .checkpoint import CheckpointManager

__all__ = ["adamw_init", "adamw_update", "OptConfig", "SyntheticLMData",
           "make_train_step", "ShardedTrainStep", "jit_train_step",
           "lr_schedule", "CheckpointManager"]
