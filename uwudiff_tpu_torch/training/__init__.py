"""The training side of the port: trainers and their ``fit`` loop,
checkpoints, logging, profiling and callbacks, optimizers, LR schedules;
LoRA/LoKr adapters and kohya LoRA files (merged at serving so far)."""

from uwudiff_tpu_torch.training.adapters import AdapterConfig, AdapterTarget, LycorisAdapter, build_adapter_config
from uwudiff_tpu_torch.training.callbacks import LogAdditionalLosses, PlotValLossPerTimestep, SampleImages
from uwudiff_tpu_torch.training.checkpoint import CheckpointManager, load_params_npz, save_params_npz
from uwudiff_tpu_torch.training.kohya_lora import (
    export_kohya_lora,
    import_kohya_lora,
    load_kohya_lora,
    save_kohya_lora,
)
from uwudiff_tpu_torch.training.logging import build_logger
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import adamw_factored, build_optimizer, stochastic_round_add
from uwudiff_tpu_torch.training.textual_inversion import TextualInversionTrainer
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = [
    "AdapterConfig",
    "AdapterTarget",
    "CheckpointManager",
    "DMTrainer",
    "LogAdditionalLosses",
    "LycorisAdapter",
    "PlotValLossPerTimestep",
    "SampleImages",
    "TextualInversionTrainer",
    "adamw_factored",
    "build_adapter_config",
    "build_logger",
    "build_optimizer",
    "export_kohya_lora",
    "import_kohya_lora",
    "load_kohya_lora",
    "load_params_npz",
    "save_kohya_lora",
    "save_params_npz",
    "stochastic_round_add",
    "warmup_cosine_schedule",
]
