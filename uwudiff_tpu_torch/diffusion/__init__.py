from uwudiff_tpu_torch.diffusion.losses import DiffusionLoss, DiffusionLossAux, RectifiedFlowLoss
from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule

__all__ = ["DiffusionLoss", "DiffusionLossAux", "NoiseSchedule", "RectifiedFlowLoss"]
