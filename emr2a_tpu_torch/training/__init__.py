"""Contrastive fine-tuning of the dual-tower encoders, on one device or
over a mesh's data and model axes, and the Megatron sharding rules."""

from emr2a_tpu_torch.training.clip_trainer import (
    ContrastiveTrainer,
    TrainState,
    clip_contrastive_loss,
)
from emr2a_tpu_torch.training.sharding_rules import param_shardings, spec_for_param

__all__ = ["ContrastiveTrainer", "TrainState", "clip_contrastive_loss",
           "param_shardings", "spec_for_param"]
