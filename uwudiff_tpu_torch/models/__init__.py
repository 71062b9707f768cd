"""Models of the port: SDXL (UNet, VAE, CLIP), SD3 (MMDiT, T5), Flux and the DiT."""

from uwudiff_tpu_torch.models.clip import CLIP_PRESETS, CLIPTextModel
from uwudiff_tpu_torch.models.dit import DIT_PRESETS, DiT
from uwudiff_tpu_torch.models.flux import FLUX_PRESETS, Flux
from uwudiff_tpu_torch.models.mmdit import MMDIT_PRESETS, MMDiT
from uwudiff_tpu_torch.models.t5 import T5_PRESETS, T5EncoderModel
from uwudiff_tpu_torch.models.text_encoders import (
    ConcatTextEncoders,
    TextEncodingPipeline,
    TextModelExtraConfig,
)
from uwudiff_tpu_torch.models.tokenizers import CLIPBPETokenizer, SimpleTokenizer, T5SPTokenizer
from uwudiff_tpu_torch.models.unet import UNET_PRESETS, UNet2DConditionModel
from uwudiff_tpu_torch.models.vae import VAE_PRESETS, AutoencoderKL

__all__ = [
    "AutoencoderKL",
    "CLIPBPETokenizer",
    "CLIPTextModel",
    "CLIP_PRESETS",
    "ConcatTextEncoders",
    "DIT_PRESETS",
    "DiT",
    "FLUX_PRESETS",
    "Flux",
    "MMDIT_PRESETS",
    "MMDiT",
    "SimpleTokenizer",
    "T5EncoderModel",
    "T5SPTokenizer",
    "T5_PRESETS",
    "TextEncodingPipeline",
    "TextModelExtraConfig",
    "UNET_PRESETS",
    "UNet2DConditionModel",
    "VAE_PRESETS",
]
