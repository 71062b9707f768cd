"""DMTrainer, the training orchestrator (``uwudiff_tpu/training/trainer.py``).

One ``train_step(batch)``: the frozen text encoders' encode of the batch's
tokens (under ``torch.no_grad``, with caption dropout to the empty
prompt's encoding), the diffusion loss over the UNet, the backward pass
through the hand-written kernels' autograd functions, then the whole
parameter update in the optimizer's ``step_``: the global gradient norm,
optional global-norm clipping, the optimizer, for bf16 parameters a
stochastic-rounding update whose noise bits are a pure function of (seed,
step, leaf index, element) or are passed in, and the optional weight EMA
(``ema_weights_decay``). With ``adamw_factored`` or ``adamw_fp16`` on the
card that update is a fixed handful of fused kernel launches. A step's
other draws (timesteps, noise, caption or label dropout) come from the
trainer's generator reseeded with a key of (seed, step), as the JAX step
folds the step into its key: a resumed run draws what an unbroken one
would. Each draw can also be passed in.

Around the step, :meth:`fit` is the JAX trainer's loop: data module and
loader, logging, callbacks, checkpoints every ``ckpt_every`` steps and
``resume_from`` the latest one (``training/checkpoint.py``; the loader's
state rides along), validation every ``val_every`` steps, a
``torch.profiler`` trace of ``profile_steps``. :meth:`state_dict` /
:meth:`load_state_dict` hold the whole state (parameters, fp32 masters,
the optimizer's tensors, the weight EMA, ``ema_loss``, the step);
a load copies into the live tensors, so the fused update's table of
pointers stays valid. :meth:`export_params` writes the JAX trainer's
``.npz`` layout.

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

Parity with the JAX ``DMTrainer``: the batch carries latents (``sample``
or ``latent``; no VAE) and tokens (``tokenizer_outputs``, encoded inside
the step) or precached text conditioning (``ctx``, ``pooled``,
``added_cond.time_ids``), with an optional ``loss_mask`` (pooled to the latent grid) and
``loss_weight``, or, for the class-conditional DiT,
``class_labels`` (the model called as ``unet(noisy, t, labels,
train=True)``, its label dropout drawn or given as ``drop_mask``); the
metrics are ``train/loss``, ``train/ema_loss``, ``train/lr`` and
``train/grad_norm``; model and loss nodes of a config are instantiated
here, a module node's ``_load_config_`` applied (``loader.py``). Not
ported (each raises, naming its ROADMAP.md Queue 1 item): the VAE encode
inside the step (item 10), adapter training (item 14), gradient
accumulation (item 9), meshes and sequence and pipeline parallelism (item
17), MoE.
"""


from __future__ import annotations

import os

import numpy as np
import torch

from uwudiff_tpu_torch.config import instantiate_any
from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
from uwudiff_tpu_torch.models.tokenizers import SimpleTokenizer
from uwudiff_tpu_torch.training.lr_schedules import warmup_cosine_schedule
from uwudiff_tpu_torch.training.optimizers import build_optimizer, sr_key
from uwudiff_tpu_torch.utils import resolve_device

__all__ = ["DMTrainer"]

# the keys of a step's draws: (seed, step, 0, DRAW_STREAM) in training, (seed,
# i, 0, VAL_STREAM) for validation batch i (the rounding bits take streams 0-2)
DRAW_STREAM = 3
VAL_STREAM = 4


def _pool_mask_to(mask: torch.Tensor, hw) -> torch.Tensor:
    """[B, H, W] or [B, H, W, 1] loss mask -> [B, h, w] at the latent grid.
    Pixel-sized masks average-pool (exact when H, W are integer multiples,
    the VAE-downscale case); anything else resizes bilinearly with
    antialiasing, as ``jax.image.resize``; latent-sized masks pass through."""
    m = mask[..., 0] if mask.ndim == 4 else mask
    b, mh, mw = m.shape
    h, w = int(hw[0]), int(hw[1])
    if (mh, mw) == (h, w):
        return m
    if mh % h == 0 and mw % w == 0:
        return m.reshape(b, h, mh // h, w, mw // w).mean(dim=(2, 4))
    return torch.nn.functional.interpolate(m[:, None], size=(h, w), mode="bilinear", align_corners=False,
                                           antialias=True)[:, 0]


def _maybe_instantiate_module(node, device):
    """A model node of the config (``_load_config_`` applied), a module as
    it is, or None."""
    if isinstance(node, dict):
        from uwudiff_tpu_torch.loader import apply_load_config, load_any

        return apply_load_config(*load_any(node, device=device))
    return node


class DMTrainer:
    """Diffusion-model trainer over a UNet (or MMDiT or DiT), full fine-tune.

    ``model_config`` is ``{"unet": ..., "te": None or ConcatTextEncoders,
    "vae": None, "tokenizers": None or a list}``, each a module or a config
    node (built on ``device``); without tokenizers each text model gets a
    ``SimpleTokenizer()``, as in the JAX trainer. ``loss_config`` is a loss,
    a config node or None (``DiffusionLoss`` on SDXL's schedule).
    ``param_dtype="bfloat16"`` stores the parameters in bf16 and applies
    updates with stochastic rounding; ``None`` keeps the module's dtype.
    ``compute_dtype="bfloat16"`` runs the module in bf16; over fp32
    storage the trainable parameters stay fp32 masters
    (:meth:`master_weights`) and the module runs on their bf16 copy.
    ``ema_weights_decay`` (e.g. 0.9999) keeps an EMA of the trainable
    (master) parameters in their dtype (:meth:`ema_weights`), as the JAX
    trainer's ``ema_params``; None turns it off. ``caption_dropout`` swaps
    a sample's text conditioning for the empty prompt's with that
    probability; ``te_use_normed_ctx`` conditions on the text encoders'
    final-normed states. Runs on ``device`` (default CUDA, which raises
    without a GPU)."""

    def __init__(
        self,
        model_config: dict,
        te_use_normed_ctx: bool = False,
        vae_std: float | None = None,
        vae_mean: float = 0.0,
        name: str = "",
        lr: float = 1e-5,
        optimizer: str = "adamw",
        opt_config: dict | None = None,
        lr_scheduler_config: dict | None = None,
        use_warm_up: bool = True,
        warm_up_period: int = 1000,
        loss_config=None,
        lycoris_config=None,
        grad_clip: float | None = 1.0,
        grad_accum: int = 1,
        mesh_axes: dict | None = None,
        sequence_parallel_method: str = "ring",
        pipeline_microbatches: int | None = None,
        ema_decay: float = 0.99,
        seed: int = 42,
        param_dtype: str | None = None,
        compute_dtype: str | None = None,
        ema_weights_decay: float | None = None,
        caption_dropout: float = 0.0,
        log_grad_norm: bool = True,
        device="cuda",
    ):
        if lycoris_config is not None:
            raise NotImplementedError("adapter training (lycoris_config) is not ported yet (ROADMAP.md, Queue 1"
                                      " item 14)")
        if grad_accum > 1:
            raise NotImplementedError("gradient accumulation (grad_accum > 1) is not ported yet (ROADMAP.md,"
                                      " Queue 1 item 9)")
        if mesh_axes is not None or sequence_parallel_method != "ring" or pipeline_microbatches is not None:
            raise NotImplementedError("meshes, sequence and pipeline parallelism are not ported yet (ROADMAP.md,"
                                      " Queue 1 item 17)")
        if model_config.get("vae") is not None:
            raise NotImplementedError("training with a vae (its encode inside the step) is not ported yet"
                                      " (ROADMAP.md, Queue 1 item 10)")
        self.device = resolve_device(device)
        self.name = name
        self.unet = _maybe_instantiate_module(model_config["unet"], self.device)
        self.te = _maybe_instantiate_module(model_config.get("te"), self.device)
        self.vae = None
        tokenizers = model_config.get("tokenizers")
        if tokenizers is None:
            n_tok = len(self.te.configs) if self.te is not None else 0
            tokenizers = [SimpleTokenizer() for _ in range(n_tok)]
        else:
            tokenizers = [instantiate_any(t) for t in tokenizers]
        self.tokenizers = list(tokenizers)
        self.te_use_normed_ctx = te_use_normed_ctx
        self.vae_std, self.vae_mean = vae_std, vae_mean
        self.caption_dropout = caption_dropout
        if loss_config is None:
            self.loss = DiffusionLoss(schedule=NoiseSchedule.sdxl())
        elif isinstance(loss_config, dict):
            self.loss = instantiate_any(loss_config)
        else:
            self.loss = loss_config
        self.lr_schedule = warmup_cosine_schedule(
            lr, warm_up_period=warm_up_period, use_warm_up=use_warm_up,
            **(lr_scheduler_config or {"T_max": 100_000, "eta_min": 1e-7}),
        )
        opt_config = {"weight_decay": 0.01, "betas": (0.9, 0.999)} if opt_config is None else opt_config
        self.tx = build_optimizer(optimizer, learning_rate=self.lr_schedule, **opt_config)
        self.grad_clip, self.ema_decay, self.seed = grad_clip, ema_decay, seed
        self.param_dtype = None if param_dtype is None else getattr(torch, param_dtype)
        if self.param_dtype not in (None, torch.bfloat16):
            raise NotImplementedError(f"param_dtype {param_dtype!r}: only None and 'bfloat16' (ROADMAP.md, Queue 1"
                                      " item 9)")
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
        self._empty_encoding = None  # the empty prompt's (ctx, mask, pooled), for caption dropout

    def setup(self):
        """Choose and place the trainable parameters, freeze the text
        encoders on the device and initialise the optimizer state.
        Idempotent."""
        if self.opt_state is not None:
            return
        if self.te is not None:
            self.te.to(self.device).requires_grad_(False).eval()
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
        """The loss's injected draws, on the device, and the class-label or
        caption dropout's mask (``drop_mask``, taken out again by
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

    def _reseed(self, index: int, stream: int):
        """Key the generator's next draws by (seed, ``index``, ``stream``)."""
        self._gen.manual_seed(sr_key(self.seed, index, 0, stream))

    def _tokens(self, tokenizer_outputs) -> list[dict]:
        return [{k: torch.as_tensor(v).to(self.device) for k, v in t.items()} for t in tokenizer_outputs]

    def _empty_prompt(self):
        """The frozen text encoders' encoding of the empty prompt, (ctx,
        mask, pooled), computed once."""
        if self._empty_encoding is None:
            toks = [tok([""], padding="max_length", truncation=True) for tok in self.tokenizers]
            with torch.no_grad():
                emb, normed, pooled, mask = self.te(self._tokens(toks))
            self._empty_encoding = (normed if self.te_use_normed_ctx else emb, mask, pooled)
        return self._empty_encoding

    def _apply_caption_dropout(self, drop, ctx, mask, pooled):
        """Each sample where ``drop`` ([B] bool) is set gets the empty
        prompt's encoding (zeros when the batch brings precached ctx and no
        text encoder), the unconditional branch CFG samples against."""
        empty = None
        if self.te is not None and self.tokenizers:
            e_ctx, e_mask, e_pooled = self._empty_prompt()
            if e_ctx.shape[1] != ctx.shape[1] and ctx.shape[1] % e_ctx.shape[1] == 0:
                # long-prompt batches ([B, n * L] windows): n copies of the one
                # empty window, as n empty windows would encode
                reps = ctx.shape[1] // e_ctx.shape[1]
                e_ctx = e_ctx.repeat(1, reps, 1)
                e_mask = None if e_mask is None else e_mask.repeat(1, reps)
            if e_ctx.shape[1:] == ctx.shape[1:]:
                empty = (e_ctx, e_mask, e_pooled)
        if empty is not None:
            e_ctx, e_mask, e_pooled = empty
            ctx = torch.where(drop[:, None, None], e_ctx, ctx)
            if mask is not None and e_mask is not None:
                mask = torch.where(drop[:, None], e_mask, mask)
            if pooled is not None and e_pooled is not None:
                pooled = torch.where(drop[:, None], e_pooled, pooled)
        else:
            ctx = torch.where(drop[:, None, None], ctx.new_zeros(()), ctx)
            if pooled is not None:
                pooled = torch.where(drop[:, None], pooled.new_zeros(()), pooled)
        return ctx, mask, pooled

    def _encode_batch(self, batch: dict, drop_mask=None):
        """(latents, ctx, mask, added_cond) of a text-conditional batch:
        precached ``ctx`` (``ctx_mask``, ``pooled``) where the batch has it,
        else the frozen text encoders over ``tokenizer_outputs`` without
        autograd; then caption dropout (``drop_mask`` [B] bool, else drawn)."""
        x = self._put(batch["latent"] if "latent" in batch else batch["sample"])
        ctx = mask = pooled = None
        if batch.get("ctx") is not None:
            ctx = self._put(batch["ctx"])
            mask = self._put(batch["ctx_mask"]) if batch.get("ctx_mask") is not None else None
            pooled = self._put(batch["pooled"]) if batch.get("pooled") is not None else None
        elif self.te is not None:
            with torch.no_grad():
                emb, normed, pooled, mask = self.te(self._tokens(batch["tokenizer_outputs"]))
            ctx = normed if self.te_use_normed_ctx else emb
        if self.caption_dropout and ctx is not None:
            if drop_mask is None:
                drop_mask = torch.rand((x.shape[0],), generator=self._gen, device=self.device) < self.caption_dropout
            ctx, mask, pooled = self._apply_caption_dropout(drop_mask, ctx, mask, pooled)
        return x, ctx, mask, self._added_cond(batch, pooled)

    def _loss_for_batch(self, batch: dict, draws: dict):
        """(loss, aux) over ``batch`` (the subclass hook)."""
        draws = dict(draws)
        drop_mask = draws.pop("drop_mask", None)
        if "class_labels" in batch:  # class-conditional models (DiT): label dropout inside the model
            x = self._put(batch["latent"] if "latent" in batch else batch["sample"])
            labels = self._put(batch["class_labels"], torch.long)

            def model_fn(noisy, t):
                return self.unet(noisy, t, labels, train=True, drop_mask=drop_mask, generator=self._gen)
        else:
            x, ctx, mask, added = self._encode_batch(batch, drop_mask)

            def model_fn(noisy, t):
                return self.unet(noisy, t, ctx, mask, added)

        # masked loss: a pixel- or latent-sized mask, pooled to the latent grid
        loss_mask = batch.get("loss_mask")
        if loss_mask is not None:
            loss_mask = _pool_mask_to(self._put(loss_mask), x.shape[1:3])
        return self.loss(
            x, model_fn, generator=self._gen,
            sample_weight=None if batch.get("loss_weight") is None else self._put(batch["loss_weight"]),
            loss_mask=loss_mask, **draws,
        )

    def forward_backward(self, batch: dict, noise=None, timesteps=None, time_draws=None, drop_mask=None):
        """The loss over ``batch`` and its backward pass: leaves each
        trainable parameter's gradient in ``.grad``. ``noise``,
        ``timesteps`` (``DiffusionLoss``) and ``time_draws``
        (``RectifiedFlowLoss``) replace the loss's draws, ``drop_mask``
        ([B] bool) a class-conditional model's label-dropout draw or a text
        model's caption-dropout draw; the others come from the generator
        keyed by (seed, step). Returns (loss, aux)."""
        self.setup()
        for _, p in self.params:
            p.grad = None
        self._reseed(self.step, DRAW_STREAM)
        loss, aux = self._loss_for_batch(batch, self._loss_draws(noise, timesteps, time_draws, drop_mask))
        loss.backward()
        return loss.detach(), aux

    @torch.no_grad()
    def validation_step(self, batch: dict, index: int = 0, noise=None, timesteps=None, time_draws=None,
                        drop_mask=None):
        """The loss over ``batch`` at the current parameters, without
        autograd, its draws keyed by (seed, ``index``) as the JAX trainer's
        validation folds the batch's index into the seed's key (or given, as
        in :meth:`forward_backward`). Returns (loss, aux)."""
        self.setup()
        self._reseed(index, VAL_STREAM)
        return self._loss_for_batch(batch, self._loss_draws(noise, timesteps, time_draws, drop_mask))

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

    # -- the whole state ------------------------------------------------

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole training state as named tensors (the live ones, not
        copies): ``params/{name}``, ``masters/{name}`` (fp32 masters, where
        kept), ``opt_state/{name}/{field}`` (the optimizer's tensors of each
        leaf), ``opt_state/decay`` (``adamw_fp16``'s accumulated decay),
        ``ema_params/{name}``, ``ema_loss``, ``step`` and ``opt_state/count``
        (0-dim int64)."""
        self.setup()
        out: dict[str, torch.Tensor] = {}
        for name, p in self.params:
            out[f"params/{name}"] = p.detach()
        for (name, _), m in zip(self.params, self.masters or ()):
            out[f"masters/{name}"] = m
        for (name, _), leaf in zip(self.params, self.opt_state.leaves):
            for field, t in leaf.items():
                out[f"opt_state/{name}/{field}"] = t
        if self.opt_state.decay is not None:
            out["opt_state/decay"] = torch.from_numpy(self.opt_state.decay)
        for (name, _), e in zip(self.params, self.ema_params or ()):
            out[f"ema_params/{name}"] = e
        out["ema_loss"] = self.ema_loss
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        out["opt_state/count"] = torch.tensor(self.opt_state.count, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s tensors by copying into the live
        ones: no parameter, optimizer or EMA tensor is replaced, so the
        fused update's leaf table (``ops/fused_optim.py``, pointers to
        them) stays valid. Raises on a missing or extra key, or a shape or
        dtype that differs."""
        live = self.state_dict()
        missing, extra = sorted(set(live) - set(state)), sorted(set(state) - set(live))
        if missing or extra:
            raise KeyError(f"trainer state mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
        bad = [f"{k}: {tuple(state[k].shape)} {state[k].dtype} vs {tuple(t.shape)} {t.dtype}"
               for k, t in live.items() if state[k].shape != t.shape or state[k].dtype != t.dtype]
        if bad:
            raise ValueError("trainer state mismatch: " + "; ".join(bad[:8]))
        for key, t in live.items():
            if key not in ("step", "opt_state/count"):
                t.copy_(state[key])  # opt_state/decay: a view of the host array, written in place
        self.step = int(state["step"])
        self.opt_state.count = int(state["opt_state/count"])

    # -- fit ------------------------------------------------------------

    def fit(
        self,
        data_module,
        max_steps: int = 1000,
        max_epochs: int | None = None,
        log_dir: str | None = None,
        log_every: int = 10,
        ckpt_dir: str | None = None,
        ckpt_every: int | None = None,
        ckpt_keep: int = 2,
        resume_from: str | bool | None = None,
        val_every: int | None = None,
        callbacks: list | None = None,
        fast_dev_run: bool = False,
        logger=None,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (5, 10),
    ):
        """The training loop, in the JAX trainer's order: each step's
        metrics read to the host and logged with the step timer's, the
        callbacks, a checkpoint when due, validation when due, the next
        batch. ``resume_from`` (any true value) restores the latest
        checkpoint of ``ckpt_dir``, loader state included, when there is
        one. A last checkpoint is written at the end. Returns
        :meth:`state_dict`."""
        from uwudiff_tpu_torch.training.checkpoint import CheckpointManager
        from uwudiff_tpu_torch.training.logging import build_logger
        from uwudiff_tpu_torch.training.profiling import StepTimer, start_trace, stop_trace

        if fast_dev_run:
            max_steps = 1

        data_module.set_tokenizers(self.tokenizers)
        loader = data_module.train_dataloader()
        val_loader = data_module.val_dataloader()
        logger = logger or build_logger(log_dir, stdout_every=log_every)
        callbacks = callbacks or []

        ckpt_mgr = None
        if ckpt_dir is not None:
            ckpt_mgr = CheckpointManager(ckpt_dir, keep=ckpt_keep, save_every_steps=ckpt_every)

        data_iter = iter(loader)
        first_batch = next(data_iter)
        self.setup()
        if resume_from and ckpt_mgr is not None:
            try:
                restored, data_state = ckpt_mgr.restore()
                self.load_state_dict(restored)
                del restored
                if data_state:
                    loader.load_state_dict(data_state)
                    data_iter = iter(loader)
                    first_batch = next(data_iter)
            except FileNotFoundError:
                pass

        timer = StepTimer()
        step = self.step
        batch = first_batch
        prof = None
        while step < max_steps:
            if max_epochs is not None and loader.epoch >= max_epochs:
                break
            if profile_dir is not None and step == profile_steps[0]:
                prof = start_trace(profile_dir)
            metrics, aux = self.train_step(batch)
            step = self.step
            if prof is not None and step == profile_steps[1]:
                stop_trace(prof, profile_dir)
                prof = None
            host_metrics = {k: float(v) for k, v in metrics.items()}
            host_metrics.update(timer.tick())
            logger.log_scalars(step, host_metrics)
            for cb in callbacks:
                if hasattr(cb, "on_train_batch_end"):
                    cb.on_train_batch_end(self, step, host_metrics, aux, logger)
            if ckpt_mgr is not None and ckpt_mgr.should_save(step):
                ckpt_mgr.save(step, self.state_dict(), loader.state_dict())
            if val_every and step % val_every == 0 and val_loader is not None:
                self._run_validation(val_loader, logger, callbacks)
            if step >= max_steps:
                break
            batch = next(data_iter)
        if prof is not None:
            stop_trace(prof, profile_dir)

        if ckpt_mgr is not None:
            ckpt_mgr.save(step, self.state_dict(), loader.state_dict())
            ckpt_mgr.wait()
            ckpt_mgr.close()
        for cb in callbacks:
            if hasattr(cb, "on_fit_end"):
                cb.on_fit_end(self, step, logger)
        logger.close()
        return self.state_dict()

    def _run_validation(self, val_loader, logger, callbacks):
        losses = []
        for cb in callbacks:
            if hasattr(cb, "on_validation_start"):
                cb.on_validation_start(self)
        for i, batch in enumerate(val_loader.epoch_iter()):
            loss, aux = self.validation_step(batch, index=i)
            losses.append(float(loss))
            for cb in callbacks:
                if hasattr(cb, "on_validation_batch_end"):
                    cb.on_validation_batch_end(self, aux)
        if losses:
            logger.log_scalars(self.step, {"val/loss": float(np.mean(losses))})
        for cb in callbacks:
            if hasattr(cb, "on_validation_end"):
                cb.on_validation_end(self, self.step, logger)

    # -- export ---------------------------------------------------------

    def merged_unet_params(self) -> dict[str, torch.Tensor]:
        """The UNet's trained weights for inference, ``{name: tensor}``
        (:meth:`master_weights`; no adapter is trained here to merge)."""
        return self.master_weights()

    def export_params(self, path: str, ema: bool = False):
        """A flat ``.npz`` of the trainable (or EMA) parameters in the JAX
        trainer's keys and layouts (``convert.to_jax_params``), fp32."""
        from uwudiff_tpu_torch.convert import to_jax_params
        from uwudiff_tpu_torch.training.checkpoint import save_params_npz

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        save_params_npz(path, to_jax_params(self.unet, self.ema_weights() if ema else self.master_weights()))
