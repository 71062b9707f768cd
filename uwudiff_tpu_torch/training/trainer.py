"""DMTrainer, the main path of the training step (``uwudiff_tpu/training/trainer.py``).

One ``train_step(batch)``: the diffusion loss over the UNet (its timesteps
and noise drawn from the trainer's ``torch.Generator`` or passed in), the
backward pass through the hand-written kernels' autograd functions, then
the whole parameter update in the optimizer's ``step_``: the global
gradient norm, optional global-norm clipping, the optimizer, for bf16
parameters a stochastic-rounding update whose noise bits are a pure
function of (seed, step, leaf index, element) or are passed in, and the
optional weight EMA (``ema_weights_decay``). With ``adamw_factored`` or
``adamw_fp16`` on the card that update is a fixed handful of fused kernel
launches.

Precision, as flax's two dtypes: ``param_dtype`` is the trainable
parameters' storage (None: the module's dtype, fp32 in the tests;
``"bfloat16"``: bf16 with stochastic-rounding updates, the SDXL recipe),
``compute_dtype`` the module's dtype in the forward and backward (None:
the storage's). Where the two differ the trainer keeps fp32 masters:
``compute_dtype="bfloat16"`` over an fp32 module is the JAX
``param_dtype=None`` over a ``dtype=bfloat16`` module, the SD1.5 recipe.
There the module holds a bf16 working copy that the forward and backward
use; its bf16 gradients are read as fp32 by the norm, the clip and the
update (flax's cast at use widens them the same way), and the update
writes the masters and rewrites the working copy from them.

Parity with the JAX ``DMTrainer``: the batch carries precached latents
(``sample`` or ``latent``; no VAE) and text conditioning (``ctx``,
``pooled``, ``added_cond.time_ids``), or, for the class-conditional DiT,
``class_labels`` (the model called as ``unet(noisy, t, labels,
train=True)``, its label dropout drawn from the trainer's generator or
given as ``drop_mask``); the metrics are ``train/loss``,
``train/ema_loss``, ``train/lr`` and ``train/grad_norm``. A text encoder
and its tokenizers are held for subclasses (``TextualInversionTrainer``
encodes inside its loss); the subclass hooks are the JAX trainer's
``_select_trainable_params`` and ``_loss_for_batch``. Meshes, the frozen
TE/VAE encodes of ``DMTrainer`` itself, caption dropout, adapter training
(the adapters and their merge are ``training/adapters.py``), MoE,
pipeline parallelism, gradient accumulation, ``fit``, export and
validation are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models.tokenizers import SimpleTokenizer
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import build_optimizer
from uwudiff_tpu_torch.utils import resolve_device

__all__ = ["DMTrainer"]


class DMTrainer:
    """Diffusion-model trainer over a UNet (or MMDiT), full fine-tune.

    ``model_config`` is ``{"unet": module, "te": None or ConcatTextEncoders,
    "vae": None, "tokenizers": None or a list}``; without tokenizers each
    text model gets a ``SimpleTokenizer()``, as in the JAX trainer.
    ``param_dtype="bfloat16"`` stores the parameters in bf16 and applies
    updates with stochastic rounding; ``None`` keeps the module's dtype.
    ``compute_dtype="bfloat16"`` runs the module in bf16; over fp32
    storage the trainable parameters stay fp32 masters
    (:meth:`master_weights`) and the module runs on their bf16 copy.
    ``ema_weights_decay`` (e.g. 0.9999) keeps an EMA of the trainable
    (master) parameters in their dtype (:meth:`ema_weights`), as the JAX
    trainer's ``ema_params``; None turns it off. Runs on ``device``
    (default CUDA, which raises without a GPU)."""

    def __init__(
        self,
        model_config: dict,
        lr: float = 1e-5,
        optimizer: str = "adamw",
        opt_config: dict | None = None,
        lr_scheduler_config: dict | None = None,
        use_warm_up: bool = True,
        warm_up_period: int = 1000,
        loss_config: DiffusionLoss | None = None,
        grad_clip: float | None = 1.0,
        ema_decay: float = 0.99,
        seed: int = 42,
        param_dtype: str | None = None,
        compute_dtype: str | None = None,
        ema_weights_decay: float | None = None,
        log_grad_norm: bool = True,
        device="cuda",
    ):
        if model_config.get("vae") is not None:
            raise NotImplementedError("training with a vae is not ported yet (ROADMAP.md, Queue 1)")
        self.device = resolve_device(device)
        self.unet = model_config["unet"]
        self.te = model_config.get("te")
        tokenizers = model_config.get("tokenizers")
        if tokenizers is None:
            n_tok = len(self.te.configs) if self.te is not None else 0
            tokenizers = [SimpleTokenizer() for _ in range(n_tok)]
        self.tokenizers = list(tokenizers)
        self.loss = loss_config if loss_config is not None else DiffusionLoss(schedule=NoiseSchedule.sdxl())
        self.lr_schedule = warmup_cosine_schedule(
            lr, warm_up_period=warm_up_period, use_warm_up=use_warm_up,
            **(lr_scheduler_config or {"T_max": 100_000, "eta_min": 1e-7}),
        )
        opt_config = {"weight_decay": 0.01, "betas": (0.9, 0.999)} if opt_config is None else opt_config
        self.tx = build_optimizer(optimizer, learning_rate=self.lr_schedule, **opt_config)
        self.grad_clip, self.ema_decay, self.seed = grad_clip, ema_decay, seed
        self.param_dtype = None if param_dtype is None else getattr(torch, param_dtype)
        if self.param_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"param_dtype {param_dtype!r}: only None and 'bfloat16'")
        self.compute_dtype = None if compute_dtype is None else getattr(torch, compute_dtype)
        if self.compute_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"compute_dtype {compute_dtype!r}: only None and 'bfloat16'")
        self.ema_weights_decay = ema_weights_decay
        self.log_grad_norm = log_grad_norm
        self.step = 0
        self.ema_loss = None
        self.params: list[tuple[str, torch.nn.Parameter]] = []
        self.masters: list[torch.Tensor] | None = None  # fp32 masters, where compute_dtype differs
        self.ema_params: list[torch.Tensor] | None = None
        self.opt_state = None
        self._gen = None
        self._events = None

    def setup(self):
        """Choose and place the trainable parameters and initialise the
        optimizer state. Idempotent."""
        if self.opt_state is not None:
            return
        self.params = self._select_trainable_params()
        if self.compute_dtype is not None and any(p.dtype != self.compute_dtype for _, p in self.params):
            # the masters keep the fp32 storage; the module's parameters become
            # its bf16 rounding, in the same memory layout
            self.masters = [p.detach() for _, p in self.params]
            if any(m.dtype != torch.float32 for m in self.masters):
                raise TypeError("compute_dtype other than the storage's needs fp32 trainable parameters")
            self.unet.to(dtype=self.compute_dtype)
        weights = self.masters or [p for _, p in self.params]
        self.opt_state = self.tx.init(weights)
        if self.ema_weights_decay is not None:
            self.ema_params = [w.clone() for w in weights]
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)  # timesteps, noise
        self.ema_loss = torch.zeros((), dtype=torch.float32, device=self.device)

    def _select_trainable_params(self) -> list[tuple[str, torch.nn.Parameter]]:
        """The trainable ``(name, parameter)`` list (the subclass hook):
        here the UNet, placed on the device in its storage dtype, in train
        mode."""
        dtype = self.param_dtype or next(self.unet.parameters()).dtype
        self.unet.to(device=self.device, dtype=dtype, memory_format=torch.channels_last).train()
        return [(n, p) for n, p in self.unet.named_parameters() if p.requires_grad]

    def _put(self, x, dtype=torch.float32):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _added_cond(self, batch: dict, pooled=None):
        """The UNet's extra conditioning: SDXL's ``time_ids`` and pooled
        text (``text_time``), or the pooled text alone (MMDiT's
        ``pooled_text``); ``pooled`` comes from the text encoder, else from
        the batch (``pooled``, or ``added_cond["text_embeds"]``)."""
        kind = getattr(self.unet, "addition_embed_type", None)
        if kind not in ("text_time", "pooled_text"):
            return None
        if pooled is None:
            added = batch.get("added_cond") or {}
            pooled = batch["pooled"] if batch.get("pooled") is not None else added.get("text_embeds")
            if pooled is None:
                raise ValueError(f"{kind} conditioning needs pooled text embeddings")
            pooled = self._put(pooled)
        if kind == "pooled_text":
            return {"text_embeds": pooled}
        return {"time_ids": self._put(batch["added_cond"]["time_ids"]), "text_embeds": pooled}

    def _loss_draws(self, noise=None, timesteps=None, time_draws=None, drop_mask=None):
        """The loss's injected draws, on the device, and the class-label
        dropout's mask (``drop_mask``, taken out again by
        :meth:`_loss_for_batch`)."""
        draws = {}
        if drop_mask is not None:
            draws["drop_mask"] = torch.as_tensor(drop_mask).to(self.device, torch.bool)
        if noise is not None:
            draws["noise"] = self._put(noise)
        if timesteps is not None:
            draws["timesteps"] = self._put(timesteps, torch.long)
        if time_draws is not None:
            draws["time_draws"] = torch.as_tensor(time_draws).to(self.device)
        return draws

    def _loss_for_batch(self, batch: dict, draws: dict):
        """(loss, aux) over ``batch`` with precached conditioning (the
        subclass hook)."""
        if batch.get("ctx") is None and self.te is not None:
            raise NotImplementedError("DMTrainer's frozen text-encoder encode is not ported yet"
                                      " (ROADMAP.md, Queue 1)")
        x = self._put(batch["latent"] if "latent" in batch else batch["sample"])
        draws = dict(draws)
        drop_mask = draws.pop("drop_mask", None)
        if "class_labels" in batch:  # class-conditional models (DiT): label dropout inside the model
            labels = self._put(batch["class_labels"], torch.long)

            def model_fn(noisy, t):
                return self.unet(noisy, t, labels, train=True, drop_mask=drop_mask, generator=self._gen)
        else:
            ctx = self._put(batch["ctx"]) if batch.get("ctx") is not None else None
            mask = self._put(batch["ctx_mask"]) if batch.get("ctx_mask") is not None else None
            added = self._added_cond(batch)

            def model_fn(noisy, t):
                return self.unet(noisy, t, ctx, mask, added)

        return self.loss(
            x, model_fn, generator=self._gen,
            sample_weight=None if batch.get("loss_weight") is None else self._put(batch["loss_weight"]),
            **draws,
        )

    def forward_backward(self, batch: dict, noise=None, timesteps=None, time_draws=None, drop_mask=None):
        """The loss over ``batch`` and its backward pass: leaves each
        trainable parameter's gradient in ``.grad``. ``noise``,
        ``timesteps`` (``DiffusionLoss``) and ``time_draws``
        (``RectifiedFlowLoss``) replace the loss's draws, ``drop_mask``
        ([B] bool) a class-conditional model's label-dropout draw. Returns
        (loss, aux)."""
        self.setup()
        for _, p in self.params:
            p.grad = None
        loss, aux = self._loss_for_batch(batch, self._loss_draws(noise, timesteps, time_draws, drop_mask))
        loss.backward()
        return loss.detach(), aux

    def master_weights(self) -> dict[str, torch.Tensor]:
        """The trainable parameters as the optimizer holds them, ``{name:
        tensor}``: the fp32 masters under a narrower ``compute_dtype``, else the
        module's parameters themselves (for export and comparison)."""
        self.setup()
        weights = self.masters or [p for _, p in self.params]
        return {name: w for (name, _), w in zip(self.params, weights)}

    def ema_weights(self) -> dict[str, torch.Tensor]:
        """The weight EMA, ``{name: tensor}`` in the trainable parameters'
        names, dtypes and layouts (for export and sampling); raises when
        ``ema_weights_decay`` is None."""
        if self.ema_weights_decay is None:
            raise ValueError("EMA weights not enabled (set ema_weights_decay)")
        self.setup()
        return {name: e for (name, _), e in zip(self.params, self.ema_params)}

    def _ema_step_decay(self) -> float | None:
        """This step's EMA decay, warm-up-aware as the JAX trainer's, in
        fp32: ``min((1 + step) / (10 + step), ema_weights_decay)``."""
        if self.ema_weights_decay is None:
            return None
        step = np.float32(self.step)
        return float(np.minimum((np.float32(1.0) + step) / (np.float32(10.0) + step),
                                np.float32(self.ema_weights_decay)))

    @torch.no_grad()
    def apply_updates(self, sr_bits: dict | None = None, ema_bits: dict | None = None):
        """The whole parameter update (the optimizer's ``step_``): global
        grad norm, optional clipping, the optimizer, the parameter update
        (stochastically rounded for bf16 parameters, with ``sr_bits[name]``
        where given; into the fp32 masters and the module's bf16 copy where
        ``compute_dtype`` differs from the storage) and the weight EMA
        (``ema_bits[name]``). Returns the grad norm."""
        names = [n for n, _ in self.params]
        params = [p for _, p in self.params]
        norm = self.tx.step_(
            self.masters or params, [p.grad for p in params], self.opt_state, grad_clip=self.grad_clip,
            seed=self.seed, step=self.step, sr_bits=None if sr_bits is None else [sr_bits.get(n) for n in names],
            ema_params=self.ema_params, ema_decay=self._ema_step_decay(),
            ema_bits=None if ema_bits is None else [ema_bits.get(n) for n in names],
            working=None if self.masters is None else params)
        for p in params:
            p.grad = None
        return norm

    def train_step(self, batch: dict, noise=None, timesteps=None, sr_bits: dict | None = None,
                   time_draws=None, drop_mask=None):
        """One optimizer step on ``batch``. ``noise`` [B, H, W, C],
        ``timesteps`` [B] and ``time_draws`` [B] replace the loss's draws,
        ``drop_mask`` [B] the label dropout's,
        ``sr_bits`` (parameter name -> integer tensor of its shape) the
        stochastic-rounding bits. Returns (metrics, aux); the metrics are
        0-dim device tensors and Python floats."""
        self.setup()
        timing = self.device.type == "cuda"
        if timing:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            self._events[0].record()
        loss, aux = self.forward_backward(batch, noise, timesteps, time_draws, drop_mask)
        if timing:
            self._events[1].record()
        norm = self.apply_updates(sr_bits)
        if timing:
            self._events[2].record()
        decay = min(self.step / (10.0 + self.step), self.ema_decay)
        self.ema_loss = decay * self.ema_loss + (1.0 - decay) * loss.float()
        metrics = {"train/loss": loss, "train/ema_loss": self.ema_loss,
                   "train/lr": self.lr_schedule(self.step)}
        if self.log_grad_norm:
            metrics["train/grad_norm"] = norm
        self.step += 1
        return metrics, aux

    def step_phase_ms(self) -> dict | None:
        """Device time of the last step's phases, from CUDA events
        (waits for the step to finish); None on the CPU."""
        if self._events is None:
            return None
        self._events[2].synchronize()
        e0, e1, e2 = self._events
        return {"forward_backward_ms": e0.elapsed_time(e1), "optimizer_ms": e1.elapsed_time(e2)}
