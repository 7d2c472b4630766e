"""Contrastive fine-tuning of the dual-tower encoders, on one device.
JAX's ``training/sharding_rules.py`` (tensor-parallel shardings over a
mesh) has no counterpart here: ROADMAP.md, Queue 1, item 7."""

from emr2a_tpu_torch.training.clip_trainer import (
    ContrastiveTrainer,
    TrainState,
    clip_contrastive_loss,
)

__all__ = ["ContrastiveTrainer", "TrainState", "clip_contrastive_loss"]
