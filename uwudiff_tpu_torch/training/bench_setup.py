"""The SDXL full fine-tune step at full width, as ``bench.py`` builds it.

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
"""

from __future__ import annotations

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models import UNet2DConditionModel
from uwudiff_tpu_torch.training.trainer import DMTrainer

__all__ = ["build_trainer_and_batch"]


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
