"""DMTrainer, the main path of the training step (``uwudiff_tpu/training/trainer.py``).

One ``train_step(batch)``: the diffusion loss over the UNet (its timesteps
and noise drawn from the trainer's ``torch.Generator`` or passed in), the
backward pass through the hand-written kernels' autograd functions, the
global gradient norm, optional global-norm clipping, the optimizer, and
for bf16 parameters a stochastic-rounding update whose noise bits come
from a generator seeded by (seed, step, leaf index), or are passed in.

Parity with the JAX ``DMTrainer``: the batch carries precached latents
(``sample`` or ``latent``; no VAE) and text conditioning (``ctx``,
``pooled``, ``added_cond.time_ids``); the metrics are ``train/loss``,
``train/ema_loss``, ``train/lr`` and ``train/grad_norm``. A text encoder
and its tokenizers are held for subclasses (``TextualInversionTrainer``
encodes inside its loss); the subclass hooks are the JAX trainer's
``_select_trainable_params`` and ``_loss_for_batch``. Meshes, the frozen
TE/VAE encodes of ``DMTrainer`` itself, caption dropout, adapters, MoE,
pipeline parallelism, weight EMA, gradient accumulation, ``fit`` and
validation are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models.tokenizers import SimpleTokenizer
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import build_optimizer, stochastic_round_add
from uwudiff_tpu_torch.utils import resolve_device

__all__ = ["DMTrainer"]

_MASK64 = (1 << 64) - 1


def _sr_seed(seed: int, step: int, index: int) -> int:
    """A 64-bit generator seed for (seed, step, leaf index): splitmix64 of
    the three, so neighbouring leaves and steps draw unrelated bits."""
    z = 0
    for v in (seed, step, index):
        z = (z ^ (v & _MASK64)) * 0x9E3779B97F4A7C15 & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z


class DMTrainer:
    """Diffusion-model trainer over a UNet (or MMDiT), full fine-tune.

    ``model_config`` is ``{"unet": module, "te": None or ConcatTextEncoders,
    "vae": None, "tokenizers": None or a list}``; without tokenizers each
    text model gets a ``SimpleTokenizer()``, as in the JAX trainer.
    ``param_dtype="bfloat16"`` stores the parameters in bf16 and applies
    updates with stochastic rounding; ``None`` keeps the module's dtype.
    Runs on ``device`` (default CUDA, which raises without a GPU)."""

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
        self.log_grad_norm = log_grad_norm
        self.step = 0
        self.ema_loss = None
        self.params: list[tuple[str, torch.nn.Parameter]] = []
        self.opt_state = None
        self._gen = self._sr_gen = None
        self._events = None

    def setup(self):
        """Choose and place the trainable parameters and initialise the
        optimizer state. Idempotent."""
        if self.opt_state is not None:
            return
        self.params = self._select_trainable_params()
        self.opt_state = self.tx.init([p for _, p in self.params])
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)  # timesteps, noise
        self._sr_gen = torch.Generator(device=self.device)  # reseeded for each leaf and step
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

    def _loss_draws(self, noise=None, timesteps=None, time_draws=None):
        """The loss's injected draws, on the device."""
        draws = {}
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
        ctx = self._put(batch["ctx"]) if batch.get("ctx") is not None else None
        mask = self._put(batch["ctx_mask"]) if batch.get("ctx_mask") is not None else None
        added = self._added_cond(batch)
        return self.loss(
            x, lambda noisy, t: self.unet(noisy, t, ctx, mask, added), generator=self._gen,
            sample_weight=None if batch.get("loss_weight") is None else self._put(batch["loss_weight"]),
            **draws,
        )

    def forward_backward(self, batch: dict, noise=None, timesteps=None, time_draws=None):
        """The loss over ``batch`` and its backward pass: leaves each
        trainable parameter's gradient in ``.grad``. ``noise``,
        ``timesteps`` (``DiffusionLoss``) and ``time_draws``
        (``RectifiedFlowLoss``) replace the loss's draws. Returns (loss, aux)."""
        self.setup()
        for _, p in self.params:
            p.grad = None
        loss, aux = self._loss_for_batch(batch, self._loss_draws(noise, timesteps, time_draws))
        loss.backward()
        return loss.detach(), aux

    @torch.no_grad()
    def apply_updates(self, sr_bits: dict | None = None):
        """Global grad norm, optional clipping, the optimizer, and the
        parameter update (stochastically rounded for bf16 parameters, with
        ``sr_bits[name]`` where given). Returns the grad norm (or None)."""
        grads = [p.grad for _, p in self.params]
        norm = None
        if self.log_grad_norm or self.grad_clip:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        if self.grad_clip:  # optax.clip_by_global_norm
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip) for g in grads]
        updates, self.opt_state = self.tx.update(grads, self.opt_state, [p for _, p in self.params])
        for i, ((name, p), u) in enumerate(zip(self.params, updates)):
            if p.dtype == torch.bfloat16:
                bits = None if sr_bits is None else sr_bits.get(name)
                if bits is None:
                    self._sr_gen.manual_seed(_sr_seed(self.seed, self.step, i))
                    bits = torch.randint(0, 1 << 16, p.shape, generator=self._sr_gen, device=p.device,
                                         dtype=torch.int32)
                p.copy_(stochastic_round_add(p, u, bits))
            else:
                p.copy_((p + u).to(p.dtype))
            p.grad = None
        return norm

    def train_step(self, batch: dict, noise=None, timesteps=None, sr_bits: dict | None = None,
                   time_draws=None):
        """One optimizer step on ``batch``. ``noise`` [B, H, W, C],
        ``timesteps`` [B] and ``time_draws`` [B] replace the loss's draws,
        ``sr_bits`` (parameter name -> integer tensor of its shape) the
        stochastic-rounding bits. Returns (metrics, aux); the metrics are
        0-dim device tensors and Python floats."""
        self.setup()
        timing = self.device.type == "cuda"
        if timing:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            self._events[0].record()
        loss, aux = self.forward_backward(batch, noise, timesteps, time_draws)
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
