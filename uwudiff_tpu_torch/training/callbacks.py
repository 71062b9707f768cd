"""Trainer callbacks (``uwudiff_tpu/training/callbacks.py``).

- ``LogAdditionalLosses``: EMA-smoothed streams of fields of the loss's aux
  output.
- ``PlotValLossPerTimestep``: the validation loss's mean and std per
  timestep bin, logged as an image (matplotlib where importable, else the
  three curves as an array).
- ``SampleImages``: fixed prompts (``Txt2ImgPipeline.from_trainer``) or
  class labels (``sampling.class_conditional_sampling``) sampled from the
  current weights every ``every_steps`` steps and at the end of ``fit``;
  latents only (their shape logged) when the trainer has no VAE.

Aux tensors are read to the host as the JAX callbacks read their arrays,
so both compute the same numbers from the same values.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["LogAdditionalLosses", "PlotValLossPerTimestep", "SampleImages"]


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


class LogAdditionalLosses:
    """EMA streams for aux-output fields."""

    def __init__(self, loss_names: list[str], ema_decay: float = 0.99):
        self.loss_names = list(loss_names)
        self.ema_decay = ema_decay
        self.ema_values: dict[str, float] = {}

    def state_dict(self) -> dict:
        return {"ema_values": dict(self.ema_values)}

    def load_state_dict(self, state: dict):
        self.ema_values = dict(state.get("ema_values", {}))

    def on_train_batch_end(self, trainer, step, metrics, aux, logger):
        scalars = {}
        for name in self.loss_names:
            value = getattr(aux, name, None)
            if value is None:
                continue
            value = float(np.mean(_host(value)))
            decay = min(step / (10 + step), self.ema_decay)
            prev = self.ema_values.get(name, 0.0)
            ema = decay * prev + (1 - decay) * value
            self.ema_values[name] = ema
            scalars[f"train/{name}"] = value
            scalars[f"train/ema_{name}"] = ema
        if scalars:
            logger.log_scalars(step, scalars)


class PlotValLossPerTimestep:
    """Accumulate (timestep, loss) pairs over a validation run and log a
    mean +- std curve per timestep bin."""

    def __init__(self, n_bins: int = 50, n_timesteps: int = 1000):
        self.n_bins = n_bins
        self.n_timesteps = n_timesteps
        self._timesteps: list[np.ndarray] = []
        self._losses: list[np.ndarray] = []

    def on_validation_start(self, trainer):
        self._timesteps.clear()
        self._losses.clear()

    def on_validation_batch_end(self, trainer, aux):
        self._timesteps.append(np.asarray(_host(aux.timesteps), dtype=np.float64))
        self._losses.append(np.asarray(_host(aux.losses), dtype=np.float64))

    def compute(self):
        t = np.concatenate(self._timesteps)
        ls = np.concatenate(self._losses)
        edges = np.linspace(0, self.n_timesteps, self.n_bins + 1)
        centers = (edges[:-1] + edges[1:]) / 2
        means = np.full(self.n_bins, np.nan)
        stds = np.full(self.n_bins, np.nan)
        idx = np.clip(np.digitize(t, edges) - 1, 0, self.n_bins - 1)
        for b in range(self.n_bins):
            sel = ls[idx == b]
            if len(sel):
                means[b] = sel.mean()
                stds[b] = sel.std()
        return centers, means, stds

    def on_validation_end(self, trainer, step, logger):
        if not self._timesteps:
            return
        centers, means, stds = self.compute()
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(6, 4))
            valid = ~np.isnan(means)
            ax.plot(centers[valid], means[valid])
            ax.fill_between(centers[valid], (means - stds)[valid], (means + stds)[valid], alpha=0.3)
            ax.set_xlabel("timestep")
            ax.set_ylabel("val loss")
            fig.canvas.draw()
            img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            plt.close(fig)
            logger.log_image(step, "val/loss_per_timestep", img)
        except ImportError:
            logger.log_image(step, "val/loss_per_timestep", np.stack([centers, means, stds]))


class SampleImages:
    """Sample fixed prompts (or class labels) from the current weights every
    ``every_steps`` steps and at the end of ``fit``, and log them. The text
    pipeline is built once (``Txt2ImgPipeline.from_trainer``) and samples
    the trainer's live modules; ``use_ema`` samples the weight EMA, written
    into the UNet for the call and the trained weights written back."""

    def __init__(
        self,
        prompts: list[str] | None = None,
        class_labels: list[int] | None = None,
        neg_prompt: str = "",
        every_steps: int = 500,
        num_steps: int = 16,
        cfg_scale: float = 5.0,
        width: int = 512,
        height: int = 512,
        seed: int = 0,
        use_ema: bool = False,
        also_on_fit_end: bool = True,
    ):
        if (prompts is None) == (class_labels is None):
            raise ValueError("SampleImages needs exactly one of prompts / class_labels")
        self.prompts = list(prompts) if prompts is not None else None
        self.class_labels = list(class_labels) if class_labels is not None else None
        self.neg_prompt = neg_prompt
        self.every_steps = every_steps
        self.num_steps = num_steps
        self.cfg_scale = cfg_scale
        self.width = width
        self.height = height
        self.seed = seed
        self.use_ema = use_ema
        self.also_on_fit_end = also_on_fit_end
        self._pipeline = None
        self._last_step = None
        self.last_output = None  # the latest samples: latents, or a list of uint8 images

    def _to_uint8(self, img) -> np.ndarray:
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            return arr
        return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)

    def _sample_text(self, trainer):
        from uwudiff_tpu_torch.serving import Txt2ImgPipeline

        if self._pipeline is None:
            self._pipeline = Txt2ImgPipeline.from_trainer(trainer)
        return self._pipeline(
            prompt=self.prompts, neg_prompt=self.neg_prompt, num_steps=self.num_steps,
            num_samples=len(self.prompts), cfg_scale=self.cfg_scale, width=self.width, height=self.height,
            seed=self.seed, return_latents=trainer.vae is None,
        )

    def _sample_class(self, trainer):
        from uwudiff_tpu_torch.sampling import class_conditional_sampling, denoiser_for_loss

        unet = trainer.unet
        training = unet.training
        unet.eval()
        try:
            return class_conditional_sampling(
                lambda x, t, labels: unet(x, t, labels), trainer.loss.schedule, self.class_labels,
                null_label=unet.num_classes, vae_decode=None, num_steps=self.num_steps, cfg_scale=self.cfg_scale,
                width=self.width, height=self.height, seed=self.seed, vae_std=trainer.vae_std,
                vae_mean=trainer.vae_mean, latent_channels=getattr(unet, "in_channels", 4),
                denoiser_cls=denoiser_for_loss(trainer.loss), return_latents=True, device=trainer.device,
            )
        finally:
            unet.train(training)

    @torch.no_grad()
    def _sample(self, trainer):
        if not self.use_ema:
            return self._sample_text(trainer) if self.prompts is not None else self._sample_class(trainer)
        params = [p for _, p in trainer.params]
        held = [p.clone() for p in params]
        try:
            for p, e in zip(params, trainer.ema_weights().values()):
                p.copy_(e)
            return self._sample_text(trainer) if self.prompts is not None else self._sample_class(trainer)
        finally:
            for p, h in zip(params, held):
                p.copy_(h)

    def _run(self, trainer, step, logger):
        if step == self._last_step:  # fit-end after a triggering step
            return
        self._last_step = step
        out = self.last_output = self._sample(trainer)
        if hasattr(out, "shape"):  # latents (no VAE): log the shape only
            logging.getLogger(__name__).info("SampleImages step %d: latents %s (no VAE to decode)", step,
                                             tuple(out.shape))
            return
        for i, img in enumerate(out):
            label = self.prompts[i][:40] if self.prompts is not None else f"class_{self.class_labels[i]}"
            logger.log_image(step, f"samples/{i}_{label}", self._to_uint8(img))

    def on_train_batch_end(self, trainer, step, metrics, aux, logger):
        if self.every_steps and step % self.every_steps == 0:
            self._run(trainer, step, logger)

    def on_fit_end(self, trainer, step, logger):
        if self.also_on_fit_end:
            self._run(trainer, step, logger)
