"""The training step of the port: trainers, optimizers, LR schedules."""

from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import adamw_factored, build_optimizer, stochastic_round_add
from uwudiff_tpu_torch.training.textual_inversion import TextualInversionTrainer
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = [
    "DMTrainer",
    "TextualInversionTrainer",
    "adamw_factored",
    "build_optimizer",
    "stochastic_round_add",
    "warmup_cosine_schedule",
]
