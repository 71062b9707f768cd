"""Models of the SDXL serving slice."""

from uwudiff_tpu_torch.models.clip import CLIP_PRESETS, CLIPTextModel
from uwudiff_tpu_torch.models.text_encoders import (
    ConcatTextEncoders,
    TextEncodingPipeline,
    TextModelExtraConfig,
)
from uwudiff_tpu_torch.models.tokenizers import SimpleTokenizer
from uwudiff_tpu_torch.models.unet import UNET_PRESETS, UNet2DConditionModel
from uwudiff_tpu_torch.models.vae import VAE_PRESETS, AutoencoderKL

__all__ = [
    "AutoencoderKL",
    "CLIPTextModel",
    "CLIP_PRESETS",
    "ConcatTextEncoders",
    "SimpleTokenizer",
    "TextEncodingPipeline",
    "TextModelExtraConfig",
    "UNET_PRESETS",
    "UNet2DConditionModel",
    "VAE_PRESETS",
]
