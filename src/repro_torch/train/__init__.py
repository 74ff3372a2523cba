"""LM training on one device: the chunked loss's optimizer (``optimizer``),
the synthetic data pipeline (``data``), the train step and schedule
(``train_step``) and checkpoints in the JAX package's format (``checkpoint``)."""
from .optimizer import adamw_init, adamw_update, OptConfig
from .data import SyntheticLMData
from .train_step import make_train_step, lr_schedule
from .checkpoint import CheckpointManager

__all__ = ["adamw_init", "adamw_update", "OptConfig", "SyntheticLMData",
           "make_train_step", "lr_schedule", "CheckpointManager"]
