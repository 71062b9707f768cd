"""Full-width training configurations of the port, on random weights.

``build_trainer_and_batch()`` is the counterpart of the SDXL branch of
``bench.py::build_trainer_and_batch`` (``BENCH_MODEL=sdxl`` defaults):
the ``sdxl`` UNet, full fine-tune, no text encoder and no VAE, on
precached inputs; ``DiffusionLoss(NoiseSchedule.sd15())`` (eps, MSE);
``adamw_factored(lr=1e-5, weight_decay=0.01, b1=0.9,
clipping_threshold=1.0)`` under the warm-up-free cosine schedule; bf16
parameters with stochastic-rounding updates; no global-norm clipping;
the grad-norm metric on. The weights are random, from
``torch.manual_seed(seed)``; the batch comes from numpy with the same
seed. Used by ``chip_smoke.py`` and ``profile_serving.py --train``.

``build_ti_trainer_and_batch()`` is SD3-medium textual inversion through
the full triple text encoder: model, data and loss from
``configs/demo_training_latent_sd3.yaml`` with its T5-XXL bucket on
(``sd3_medium`` MMDiT; CLIP-L + CLIP-bigG pooled, ``layer_idx=-2``, in
bucket 0; T5-XXL at 256 tokens with its key mask in bucket 1;
``zero_for_padding=False``, ``pad_context_to=4096``; 64x64x16 precached
latents; ``RectifiedFlowLoss(NoiseSchedule.sdxl(), logit_normal)``; every
frozen module in bf16), trainer settings from
``configs/demo_training_textual_inversion.yaml`` (``adamw``, lr 5e-3, no
warm-up, global-norm clip 1.0, ``"<concept>"`` with 2 vectors, caption
``"a photo of <concept>"``). Cuts: random weights instead of checkpoints,
``SimpleTokenizer`` instead of the CLIP BPE / T5 SentencePiece
tokenizers, no gradient checkpointing, a plain list of blocks instead of
``scan_blocks``.
"""

from __future__ import annotations

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule, RectifiedFlowLoss
from uwudiff_tpu_torch.models import ConcatTextEncoders, MMDiT, SimpleTokenizer, UNet2DConditionModel
from uwudiff_tpu_torch.training.textual_inversion import TextualInversionTrainer
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = ["SD3_TEXT_ENCODERS", "build_ti_trainer_and_batch", "build_trainer_and_batch", "fill_zero_initialised"]

SD3_TEXT_ENCODERS = [
    ({"model_type": "clip", "preset": "clip_l"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "clip", "preset": "clip_bigg"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "t5", "preset": "t5_xxl"},
     {"concat_bucket": 1, "use_pooled": False, "layer_idx": -1, "need_mask": True}),
]
TI_CAPTION = "a photo of <concept>"


def build_trainer_and_batch(batch: int = 8, latent: int = 64, seed: int = 0, device="cuda"):
    """-> (trainer, batch dict of numpy arrays)."""
    torch.manual_seed(seed)
    unet = UNet2DConditionModel.from_config("sdxl", device=device, dtype=torch.bfloat16)
    trainer = DMTrainer(
        model_config={"unet": unet, "te": None, "vae": None},
        lr=1e-5,
        optimizer="adamw_factored",
        opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999), "clipping_threshold": 1.0},
        use_warm_up=False,
        loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()),
        grad_clip=None,
        param_dtype="bfloat16",
        log_grad_norm=True,
        seed=seed,
        device=device,
    )
    rng = np.random.default_rng(seed)
    pooled_dim = unet.add_embedding.linear_1.in_features - 6 * unet.addition_time_embed_dim
    data = {
        "sample": rng.standard_normal((batch, latent, latent, 4), dtype=np.float32),
        "ctx": rng.standard_normal((batch, 77, 2048), dtype=np.float32),
        "added_cond": {
            "time_ids": np.tile(np.asarray([[1024, 1024, 0, 0, 1024, 1024]], np.float32), (batch, 1)),
        },
        "pooled": rng.standard_normal((batch, pooled_dim), dtype=np.float32),
    }
    return trainer, data


def fill_zero_initialised(mmdit: MMDiT) -> MMDiT:
    """Give the leaves the JAX init zeroes (every adaLN modulation, the final
    modulation and projection) torch's default Linear draws: at zero they
    cut the gradient from the loss to the text context, and textual
    inversion would learn nothing."""
    for name, m in mmdit.named_modules():
        if name.rsplit(".", 1)[-1] in ("adaLN_x", "adaLN_ctx", "final_modulation", "final_proj"):
            m.reset_parameters()
    return mmdit


def build_ti_trainer_and_batch(batch: int = 8, latent: int = 64, seed: int = 0, device="cuda"):
    """-> (textual-inversion trainer, batch dict of numpy arrays)."""
    torch.manual_seed(seed)
    te = ConcatTextEncoders.from_config(SD3_TEXT_ENCODERS, device=device, dtype=torch.bfloat16,
                                        zero_for_padding=False, pad_context_to=4096)
    mmdit = fill_zero_initialised(MMDiT.from_config("sd3_medium", device=device, dtype=torch.bfloat16))
    tokenizers = [SimpleTokenizer(), SimpleTokenizer(), SimpleTokenizer(model_max_length=256)]
    trainer = TextualInversionTrainer(
        {"unet": mmdit, "te": te, "vae": None, "tokenizers": tokenizers},
        lr=5e-3,
        optimizer="adamw",
        use_warm_up=False,
        loss_config=RectifiedFlowLoss(schedule=NoiseSchedule.sdxl(), time_sampling_type="logit_normal"),
        placeholder_token="<concept>",
        num_vectors=2,
        seed=seed,
        device=device,
    )
    rng = np.random.default_rng(seed)
    data = {
        "latent": rng.standard_normal((batch, latent, latent, 16), dtype=np.float32),
        "tokenizer_outputs": [tok([TI_CAPTION] * batch) for tok in trainer.tokenizers],
    }
    return trainer, data
