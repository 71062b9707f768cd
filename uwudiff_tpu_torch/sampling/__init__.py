from uwudiff_tpu_torch.sampling.cfg import (
    apply_cfg_rescale,
    build_cfg_fn,
    cfg_wrapper,
    cond_text_wrapper,
    default_time_ids,
    encode_cfg_inputs,
)
from uwudiff_tpu_torch.sampling.dpm2 import sample_dpm2, sample_dpm2_cfgpp
from uwudiff_tpu_torch.sampling.dpmpp import (
    sample_dpmpp_2m,
    sample_dpmpp_2m_sde,
    sample_dpmpp_2s_ancestral,
    sample_dpmpp_3m_sde,
    sample_dpmpp_sde,
)
from uwudiff_tpu_torch.sampling.euler import sample_euler_ancestral, sample_euler_ancestral_cfgpp
from uwudiff_tpu_torch.sampling.euler_latent import euler_latent_sampling
from uwudiff_tpu_torch.sampling.get_sigmas import (
    ays_sigmas,
    beta_sigmas,
    dynamic_shift_time,
    exponential_sigmas,
    get_sigmas_for_rf,
    karras_sigmas,
    mu_for_image_seq_len,
    polyexponential_sigmas,
    shift_time,
    sigmoid_time,
    sigmoid_time_scale,
    uniform_time,
)
from uwudiff_tpu_torch.sampling.heun import sample_heun
from uwudiff_tpu_torch.sampling.img2img import image_to_image_sampling, img2img_sigmas, masked_model_wrapper
from uwudiff_tpu_torch.sampling.lcm import LCMDenoiser, get_sigmas_lcm, sample_lcm
from uwudiff_tpu_torch.sampling.noise import (
    batch_fallback_generator,
    expand_seeds,
    make_per_sample_noise_sampler,
    per_sample_init_noise,
    supports_noise_sampler,
)
from uwudiff_tpu_torch.sampling.sampling import diffusion_sampling
from uwudiff_tpu_torch.sampling.unipc import sample_unipc
from uwudiff_tpu_torch.sampling.wrapper import (
    EDMDenoiser,
    KDiffusionDenoiser,
    RFDenoiser,
    VDenoiser,
    denoiser_for_loss,
    get_ancestral_step,
    to_d,
)

# every sampler of the package, by name
SAMPLERS = {
    "euler_ancestral": sample_euler_ancestral,
    "euler_ancestral_cfgpp": sample_euler_ancestral_cfgpp,
    "heun": sample_heun,
    "dpm2": sample_dpm2,
    "dpm2_cfgpp": sample_dpm2_cfgpp,
    "dpmpp_2m": sample_dpmpp_2m,
    "dpmpp_2m_sde": sample_dpmpp_2m_sde,
    "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmpp_sde": sample_dpmpp_sde,
    "dpmpp_3m_sde": sample_dpmpp_3m_sde,
    "unipc": sample_unipc,
    "lcm": sample_lcm,
}

__all__ = [
    "EDMDenoiser",
    "KDiffusionDenoiser",
    "LCMDenoiser",
    "RFDenoiser",
    "SAMPLERS",
    "VDenoiser",
    "apply_cfg_rescale",
    "ays_sigmas",
    "batch_fallback_generator",
    "beta_sigmas",
    "build_cfg_fn",
    "cfg_wrapper",
    "cond_text_wrapper",
    "default_time_ids",
    "denoiser_for_loss",
    "diffusion_sampling",
    "dynamic_shift_time",
    "encode_cfg_inputs",
    "euler_latent_sampling",
    "expand_seeds",
    "exponential_sigmas",
    "get_ancestral_step",
    "get_sigmas_for_rf",
    "get_sigmas_lcm",
    "image_to_image_sampling",
    "img2img_sigmas",
    "karras_sigmas",
    "make_per_sample_noise_sampler",
    "masked_model_wrapper",
    "mu_for_image_seq_len",
    "per_sample_init_noise",
    "polyexponential_sigmas",
    "sample_dpm2",
    "sample_dpm2_cfgpp",
    "sample_dpmpp_2m",
    "sample_dpmpp_2m_sde",
    "sample_dpmpp_2s_ancestral",
    "sample_dpmpp_3m_sde",
    "sample_dpmpp_sde",
    "sample_euler_ancestral",
    "sample_euler_ancestral_cfgpp",
    "sample_heun",
    "sample_lcm",
    "sample_unipc",
    "shift_time",
    "sigmoid_time",
    "sigmoid_time_scale",
    "supports_noise_sampler",
    "to_d",
    "uniform_time",
]
