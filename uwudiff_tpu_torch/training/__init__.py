"""The training step of the port: trainer, optimizers, LR schedules."""

from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import adamw_factored, build_optimizer, stochastic_round_add
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = [
    "DMTrainer",
    "adamw_factored",
    "build_optimizer",
    "stochastic_round_add",
    "warmup_cosine_schedule",
]
