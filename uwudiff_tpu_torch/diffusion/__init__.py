from uwudiff_tpu_torch.diffusion.schedules import NoiseSchedule

__all__ = ["NoiseSchedule"]
