from uwudiff_tpu_torch.sampling.cfg import (
    apply_cfg_rescale,
    build_cfg_fn,
    default_time_ids,
    encode_cfg_inputs,
)
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.noise import (
    expand_seeds,
    make_per_sample_noise_sampler,
    per_sample_init_noise,
)
from uwudiff_tpu_torch.sampling.wrapper import KDiffusionDenoiser, get_ancestral_step, to_d

__all__ = [
    "KDiffusionDenoiser",
    "apply_cfg_rescale",
    "build_cfg_fn",
    "default_time_ids",
    "encode_cfg_inputs",
    "expand_seeds",
    "get_ancestral_step",
    "make_per_sample_noise_sampler",
    "per_sample_init_noise",
    "sample_euler_ancestral",
    "to_d",
]
