"""Full-width training configurations of the port, on random weights.

``build_trainer_and_batch()`` is the counterpart of
``bench.py::build_trainer_and_batch``, a full fine-tune of a UNet or a
Flux with no text encoder and no VAE, on precached inputs, with
``DiffusionLoss(NoiseSchedule.sd15())`` (eps, MSE; for every model, Flux
too, as ``bench.py`` builds it) under the warm-up-free cosine schedule at
lr 1e-5 and the grad-norm metric on:

- ``model="sdxl"`` (the default; ``BENCH_MODEL=sdxl``'s settings): the
  ``sdxl`` UNet, batch 8, ``adamw_factored(weight_decay=0.01, b1=0.9,
  clipping_threshold=1.0)``, bf16 parameters with stochastic-rounding
  updates, no global-norm clipping;
- ``model="sd15"`` (``BENCH_MODEL=sd15``'s): the ``sd15`` UNet, batch 16,
  ``adamw_fp16(weight_decay=0.01, betas=(0.9, 0.999))``, global-norm clip
  1.0, fp32 master parameters under bf16 compute (the JAX
  ``param_dtype=None`` over a ``dtype=bfloat16`` module; the weights
  initialised in fp32), 77 tokens of 768-wide context;
- ``model="flux_1b"`` (``BENCH_MODEL=flux_1b``'s): the ``flux_1b`` Flux (6
  double and 12 single blocks, width 1536, 12 heads of 128, 16 latent
  channels; 0.955 G params) with ``gradient_checkpointing`` (bench.py's
  full-block remat), built in bf16 with its zero-initialised leaves drawn
  (``fill_zero_initialised``: at zero ``final_proj`` would send a zero
  gradient to every block), the SDXL recipe's trainer settings, batch 8,
  77 tokens of 4096-wide context and a 768-wide pooled vector;
- ``model="dit_xl_2"`` (``BENCH_MODEL=dit_xl_2``'s): the class-conditional
  ``dit_xl_2`` DiT (28 blocks, width 1152, 16 heads of 72; 0.675 G
  params), batch 64 on 32x32x4 latents (256 tokens; ``bench.py``'s default
  latent for the DiT family), fp32 master parameters under bf16 compute
  (the JAX ``param_dtype=None`` over a ``dtype=bfloat16`` module) with its
  zero-initialised leaves drawn, ``adamw(weight_decay=0.01, betas=(0.9,
  0.999))``, global-norm clip 1.0, label dropout 0.1 from the trainer's
  generator; the batch holds ``class_labels`` in ``[0, 1000)`` and no
  context.

The batch is the model's: latents of its input channels, context of its
width, and the pooled vector its conditioning takes (SDXL's
``text_time``, Flux's ``pooled_text``). The weights are random, from
``torch.manual_seed(seed)``; the batch comes from numpy with the same
seed, drawn in ``bench.py``'s order. Used by ``chip_smoke.py`` and
``profile_serving.py --train``.

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
from uwudiff_tpu_torch.models import ConcatTextEncoders, DiT, Flux, MMDiT, SimpleTokenizer, UNet2DConditionModel
from uwudiff_tpu_torch.training.textual_inversion import TextualInversionTrainer
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = ["SD3_TEXT_ENCODERS", "TRAIN_RECIPES", "build_ti_trainer_and_batch", "build_trainer_and_batch",
           "fill_zero_initialised"]

SD3_TEXT_ENCODERS = [
    ({"model_type": "clip", "preset": "clip_l"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "clip", "preset": "clip_bigg"}, {"use_pooled": True, "layer_idx": -2}),
    ({"model_type": "t5", "preset": "t5_xxl"},
     {"concat_bucket": 1, "use_pooled": False, "layer_idx": -1, "need_mask": True}),
]
TI_CAPTION = "a photo of <concept>"


_FACTORED_BF16 = dict(  # bench.py's adamw_factored recipe: bf16 params, update-RMS clip, no global clip
    optimizer="adamw_factored",
    opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999), "clipping_threshold": 1.0},
    grad_clip=None, param_dtype="bfloat16")

# model -> the batch and latent size, the model's class, the dtype and
# options it is built with, and DMTrainer's settings
TRAIN_RECIPES = {
    "sdxl": dict(batch=8, latent=64, cls=UNet2DConditionModel, dtype=torch.bfloat16, build={},
                 trainer=_FACTORED_BF16),
    "sd15": dict(batch=16, latent=64, cls=UNet2DConditionModel, dtype=torch.float32, build={}, trainer=dict(
        optimizer="adamw_fp16", opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999)},
        grad_clip=1.0, compute_dtype="bfloat16")),
    "flux_1b": dict(batch=8, latent=64, cls=Flux, dtype=torch.bfloat16, build=dict(gradient_checkpointing=True),
                    trainer=_FACTORED_BF16),
    "dit_xl_2": dict(batch=64, latent=32, cls=DiT, dtype=torch.float32, build={}, trainer=dict(
        optimizer="adamw", opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999)},
        grad_clip=1.0, compute_dtype="bfloat16")),
}


def build_trainer_and_batch(batch: int | None = None, latent: int | None = None, seed: int = 0, device="cuda",
                            model: str = "sdxl"):
    """-> (trainer, batch dict of numpy arrays); ``batch`` and ``latent``
    default to the recipe's (8 for ``sdxl`` and ``flux_1b``, 16 for
    ``sd15``, 64 for ``dit_xl_2``; 64x64 latents, 32x32 for the DiT)."""
    recipe = TRAIN_RECIPES[model]
    batch = batch or recipe["batch"]
    latent = latent or recipe["latent"]
    torch.manual_seed(seed)
    unet = recipe["cls"].from_config(model, device=device, dtype=recipe["dtype"], **recipe["build"])
    if isinstance(unet, (Flux, DiT)):
        fill_zero_initialised(unet)
    trainer = DMTrainer(
        model_config={"unet": unet, "te": None, "vae": None},
        lr=1e-5,
        use_warm_up=False,
        loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()),
        log_grad_norm=True,
        seed=seed,
        device=device,
        **recipe["trainer"],
    )
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((batch, latent, latent, getattr(unet, "in_channels", 4)), dtype=np.float32)
    if isinstance(unet, DiT):  # class-conditional: labels, no text context
        return trainer, {"sample": sample, "class_labels": rng.integers(0, unet.num_classes, batch).astype(np.int32)}
    ctx_dim = unet.context_dim if isinstance(unet, Flux) else unet.cross_attention_dim
    data = {
        "sample": sample,
        "ctx": rng.standard_normal((batch, 77, ctx_dim), dtype=np.float32),
        "added_cond": {  # SDXL's micro-conditioning (unused by Flux)
            "time_ids": np.tile(np.asarray([[1024, 1024, 0, 0, 1024, 1024]], np.float32), (batch, 1)),
        },
    }
    if unet.addition_embed_type == "text_time":
        pooled_dim = unet.add_embedding.linear_1.in_features - 6 * unet.addition_time_embed_dim
        data["pooled"] = rng.standard_normal((batch, pooled_dim), dtype=np.float32)
    elif unet.addition_embed_type == "pooled_text":
        data["pooled"] = rng.standard_normal((batch, unet.pooled_dim), dtype=np.float32)
    return trainer, data


def fill_zero_initialised(model):
    """Give the leaves the JAX init zeroes in the MMDiT, Flux and the DiT
    (every adaLN modulation, the final modulation and projection) torch's
    default Linear draws: at zero they cut the gradient from the loss to the
    text context, so textual inversion would learn nothing, and a fresh Flux
    or DiT outputs zeros, which every check would pass."""
    for name, m in model.named_modules():
        if name.rsplit(".", 1)[-1] in ("adaLN", "adaLN_x", "adaLN_ctx", "adaLN_modulation", "final_modulation",
                                       "final_proj"):
            m.reset_parameters()
    return model


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
