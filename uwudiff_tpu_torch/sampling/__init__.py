from uwudiff_tpu_torch.sampling.cfg import (
    apply_cfg_rescale,
    build_cfg_fn,
    default_time_ids,
    encode_cfg_inputs,
)
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral
from uwudiff_tpu_torch.sampling.get_sigmas import (
    dynamic_shift_time,
    get_sigmas_for_rf,
    mu_for_image_seq_len,
    shift_time,
    uniform_time,
)
from uwudiff_tpu_torch.sampling.noise import (
    expand_seeds,
    make_per_sample_noise_sampler,
    per_sample_init_noise,
)
from uwudiff_tpu_torch.sampling.sampling import diffusion_sampling
from uwudiff_tpu_torch.sampling.wrapper import (
    KDiffusionDenoiser,
    RFDenoiser,
    denoiser_for_loss,
    get_ancestral_step,
    to_d,
)

__all__ = [
    "KDiffusionDenoiser",
    "RFDenoiser",
    "apply_cfg_rescale",
    "build_cfg_fn",
    "default_time_ids",
    "denoiser_for_loss",
    "diffusion_sampling",
    "dynamic_shift_time",
    "encode_cfg_inputs",
    "expand_seeds",
    "get_ancestral_step",
    "get_sigmas_for_rf",
    "make_per_sample_noise_sampler",
    "mu_for_image_seq_len",
    "per_sample_init_noise",
    "sample_euler_ancestral",
    "shift_time",
    "to_d",
    "uniform_time",
]
