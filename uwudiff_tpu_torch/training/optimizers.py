"""Optimizers (``uwudiff_tpu/training/optimizers.py``), written out in PyTorch.

The JAX package builds its optimizers from optax; the port re-derives the
three on its main paths by hand, optax-style: an optimizer is
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)`` over lists of tensors. The state keeps the dtypes and the
step-count conventions of optax 0.2.6.

- :func:`adamw_factored`: optax's Adafactor chain (factored second moment
  -> per-leaf update-RMS clip -> learning rate -> bf16 momentum -> negate)
  followed by torch-AdamW lr-scaled weight decay (``p -= lr*wd*p``).
- :func:`adamw_fp16_state`: AdamW with both moments stored in bf16 (or
  fp16) and updated through fp32, bias correction of the denominator only,
  and a per-leaf accumulated weight decay that fires once it crosses a
  threshold (the JAX package's ``adamw_fp16_state``, SD1.5's optimizer).
- :func:`adamw`: optax's ``adamw``.
- :func:`stochastic_round_add`: ``param + update`` stochastically rounded
  to bf16, with the 16 noise bits per element passed in;
  :func:`draw_sr_bits` draws them from a counter-based generator.

Each optimizer also has ``step_``, the whole parameter update of a
training step in place: the global gradient norm, optional global-norm
clipping, the optimizer, the stochastically rounded parameter update, an
optional weight EMA and, where the parameters are fp32 masters of a bf16
module, the rewrite of the module's bf16 working copy
(:func:`apply_update_` is its plain version). On a CUDA device
``AdamWFactored.step_`` and ``AdamWFP16.step_`` run it as a fixed handful
of hand-written kernel launches over every leaf at once
(``ops/fused_optim.py``; no TPU kernel stood here: optax went through
XLA, which fused it); ``AdamW`` (the textual-inversion trainer's, a few
small leaves) runs it eagerly.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

__all__ = [
    "EMA_STREAM",
    "PARAM_STREAM",
    "PHASE_STREAM",
    "AdamW",
    "AdamWFP16",
    "AdamWFactored",
    "OptState",
    "adamw",
    "adamw_factored",
    "adamw_fp16_state",
    "apply_update_",
    "build_optimizer",
    "decay_phases",
    "ema_update_",
    "draw_sr_bits",
    "sr_key",
    "stochastic_round_add",
]


def stochastic_round_add(param: torch.Tensor, update: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``param + update`` (fp32) stochastically rounded back to bf16.

    ``bits`` holds one integer in ``[0, 0xFFFF]`` per element (any integer
    dtype; only its low 16 bits are used): it is added below the bf16
    mantissa cut of the fp32 sum, whose low 16 bits are then dropped, so
    the rounding is unbiased in expectation. Bitwise the JAX package's
    ``stochastic_round_add`` given the same bits; int32 arithmetic stands
    in for uint32 (the sum of a finite float's bits and 0xFFFF never
    wraps, and the low 16 bits are masked off)."""
    if param.dtype != torch.bfloat16:
        raise TypeError(f"stochastic_round_add takes a bf16 param, got {param.dtype}")
    x = param.float() + update.float()
    noise = bits.to(device=x.device, dtype=torch.int32) & 0xFFFF
    hi = (x.view(torch.int32) + noise) & -65536  # 0xFFFF0000
    return hi.view(torch.float32).to(torch.bfloat16)  # exact: the low 16 bits are 0


# ------------------------------------------------- stochastic-rounding bits

PARAM_STREAM = 0  # the parameters' rounding (the JAX step's fold_in(rng, 0x5757))
EMA_STREAM = 1  # the weight EMA's rounding (fold_in(rng, 0x5858))
PHASE_STREAM = 2  # adamw_fp16's per-leaf weight-decay phases (PRNGKey(0) split per leaf)
_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def _mix64(z: int) -> int:
    """splitmix64's finaliser."""
    z = ((z ^ (z >> 30)) * _MIX1) & _M64
    z = ((z ^ (z >> 27)) * _MIX2) & _M64
    return z ^ (z >> 31)


def sr_key(seed: int, step: int, leaf: int, stream: int) -> int:
    """The 64-bit key of one leaf's rounding bits at one step: splitmix64
    steps over (seed, step, leaf index, stream)."""
    z = 0
    for v in (seed, step, leaf, stream):
        z = _mix64(((z ^ (v & _M64)) + _GOLDEN) & _M64)
    return z


def _mix64_tensor(z: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` over an int64 tensor: products wrap as uint64's do,
    and the right shifts are made logical with a mask."""
    z = (z ^ ((z >> 30) & ((1 << 34) - 1))) * _signed(_MIX1)
    z = (z ^ ((z >> 27) & ((1 << 37) - 1))) * _signed(_MIX2)
    return z ^ ((z >> 31) & ((1 << 33) - 1))


def dense_layout(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill its memory span without gaps or overlaps."""
    expect = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def draw_sr_bits(like: torch.Tensor, seed: int, step: int, leaf: int, stream: int) -> torch.Tensor:
    """The 16 rounding bits of every element of ``like``: int32 of its
    shape and strides, on its device. A pure function of (seed, step,
    leaf, stream, element), where the element is its offset in ``like``'s
    memory: word ``w = offset // 4`` is splitmix64's output ``w`` for the
    leaf's :func:`sr_key`, and the element takes its 16-bit slice
    ``offset % 4`` (the lowest first). The fused kernels
    (``csrc/adamw_factored.cu``) draw the same bits."""
    if not dense_layout(like):
        raise ValueError("draw_sr_bits needs a tensor without gaps or overlaps")
    n = like.numel()
    words = torch.arange(1, (n + 3) // 4 + 1, dtype=torch.int64, device=like.device)
    z = _mix64_tensor(words * _signed(_GOLDEN) + _signed(sr_key(seed, step, leaf, stream)))
    flat = torch.stack([(z >> s) & 0xFFFF for s in (0, 16, 32, 48)], dim=1).reshape(-1)[:n].to(torch.int32)
    return flat.as_strided(like.shape, like.stride())


# ------------------------------------------------------------- the update

@dataclasses.dataclass
class OptState:
    """``count``: updates made (optax's counts, one for every stage of the
    chain, all equal). ``leaves``: one dict of tensors per parameter.
    ``dims``: ``AdamWFactored``'s factored axes (d1, d0) of each leaf, or
    None for a dense one, fixed at ``init``. ``decay``: ``AdamWFP16``'s
    accumulated weight decay, one fp32 value a leaf (host memory: it does
    not depend on the data). ``fused``: the CUDA kernels' leaf table
    (``ops/fused_optim.py``), built at the first step on the card and not
    copied with the state."""

    count: int
    leaves: list[dict]
    dims: list | None = None
    decay: np.ndarray | None = None
    fused: object = dataclasses.field(default=None, repr=False, compare=False)

    def __deepcopy__(self, memo):
        return OptState(self.count, copy.deepcopy(self.leaves, memo), copy.deepcopy(self.dims, memo),
                        copy.deepcopy(self.decay, memo))


@functools.lru_cache(maxsize=64)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX casts a Python scalar to the
    dtype of the array it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def _lr_fn(learning_rate) -> Callable[[int], float]:
    return learning_rate if callable(learning_rate) else (lambda _count: learning_rate)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the two largest axes, or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _stat_zeros(p: torch.Tensor, drop: int, keep: int) -> torch.Tensor:
    """Zeros of ``p``'s shape without axis ``drop``, laid out with axis
    ``keep`` innermost (the other axes outer, in order): the layout the
    fused kernels index the factored statistics by."""
    shape = [s for i, s in enumerate(p.shape) if i != drop]
    pos = keep - (keep > drop)
    outer = [s for i, s in enumerate(shape) if i != pos]
    return p.new_zeros(outer + [shape[pos]]).movedim(-1, pos)


@torch.no_grad()
def ema_update_(ema_params, params, decay: float, *, seed: int = 0, step: int = 0, bits=None) -> None:
    """The JAX trainer's weight EMA, in place, with this step's decay
    ``decay`` (an fp32 value): bf16 leaves ``e + (1 - decay) * (p - e)``
    stochastically rounded (bits ``bits[i]``, else :func:`draw_sr_bits` on
    ``EMA_STREAM``), others ``decay * e + (1 - decay) * p`` in fp32."""
    keep = float(np.float32(1.0) - np.float32(decay))
    for i, (e, p) in enumerate(zip(ema_params, params)):
        if e.dtype == torch.bfloat16:
            given = None if bits is None else bits[i]
            b = given if given is not None else draw_sr_bits(e, seed, step, i, EMA_STREAM)
            e.copy_(stochastic_round_add(e, keep * (p.float() - e.float()), b))
        else:
            e.copy_((decay * e.float() + keep * p.float()).to(e.dtype))


@torch.no_grad()
def apply_update_(tx, params, grads, state: OptState, *, grad_clip: float | None = None, seed: int = 0,
                  step: int = 0, sr_bits=None, ema_params=None, ema_decay: float | None = None,
                  ema_bits=None, working=None) -> torch.Tensor:
    """The plain whole-tree update of a training step, in place: the global
    gradient norm, optax's ``clip_by_global_norm(grad_clip)``, ``tx``'s
    update, then each parameter ``p + u``, stochastically rounded for bf16
    (bits ``sr_bits[i]``, else :func:`draw_sr_bits` on ``PARAM_STREAM``), then
    the weight EMA when ``ema_params`` are given (:func:`ema_update_` with
    ``ema_decay`` and ``ema_bits``). A gradient narrower than its parameter
    (the bf16 gradient of a bf16 module's fp32 master) is widened first, as
    flax's cast at use widens it; ``working``, the module's bf16 copies of
    the parameters, are then rewritten from them (rounded to nearest).
    Returns the fp32 global norm of the unclipped gradients (0-dim)."""
    grads = [g if g.dtype == p.dtype else g.to(p.dtype) for g, p in zip(grads, params)]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    if grad_clip:
        keep = norm < grad_clip
        grads = [torch.where(keep, g, g / norm.to(g.dtype) * grad_clip) for g in grads]
    updates, _ = tx.update(grads, state, params)
    for i, (p, u) in enumerate(zip(params, updates)):
        if p.dtype == torch.bfloat16:
            given = None if sr_bits is None else sr_bits[i]
            bits = given if given is not None else draw_sr_bits(p, seed, step, i, PARAM_STREAM)
            p.copy_(stochastic_round_add(p, u, bits))
        else:
            p.copy_((p + u).to(p.dtype))
    if ema_params is not None:
        ema_update_(ema_params, params, ema_decay, seed=seed, step=step, bits=ema_bits)
    for w, p in zip(working or (), params):
        w.copy_(p)
    return norm


class AdamWFactored:
    """Memory-lean AdamW-style optimizer: bf16 first moment, factored
    second moment (Adafactor), per-leaf update-RMS clipping, lr-scaled
    decoupled weight decay. See :func:`adamw_factored`."""

    def __init__(self, learning_rate, b1=0.9, eps=1e-8, weight_decay=0.0, min_dim_size_to_factor=128,
                 moment_dtype=torch.bfloat16, decay_rate=0.8, clipping_threshold=None):
        self.lr_fn = _lr_fn(learning_rate)
        self.b1, self.weight_decay = b1, weight_decay
        self.eps = max(eps, 1e-30)  # optax.adafactor's eps, added to g^2
        self.min_dim = min_dim_size_to_factor
        self.moment_dtype, self.decay_rate = moment_dtype, decay_rate
        self.clipping_threshold = clipping_threshold

    def init(self, params) -> OptState:
        """Zero state. The momentum takes each parameter's memory layout;
        a factored leaf's ``v_row`` (``v_col``) keeps its row (column)
        axis innermost, as the fused kernels index it."""
        leaves, dims = [], []
        for p in params:
            d = _factored_dims(tuple(p.shape), self.min_dim)
            st = {"mu": torch.zeros_like(p, dtype=self.moment_dtype)}
            if d is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = d
                st["v_row"] = _stat_zeros(p, drop=d0, keep=d1)
                st["v_col"] = _stat_zeros(p, drop=d1, keep=d0)
            leaves.append(st)
            dims.append(d)
        return OptState(0, leaves, dims)

    def scalars(self, count: int) -> tuple[float, float]:
        """(beta2, lr) of the update after ``count`` updates, in fp32:
        Adafactor's ``1 - t^-decay_rate`` and the schedule's rate."""
        t = np.float32(count + 1)
        beta2 = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))
        return beta2, float(np.float32(self.lr_fn(count)))

    def _leaf(self, g, st, p, beta2, lr, dims):
        """One leaf's update; tensors hold the dtypes of optax's stages:
        the statistics and the scaled gradient in the param dtype, the
        momentum in ``moment_dtype``, the decayed update promoted to fp32.
        The state is updated in place."""
        dtype = p.dtype
        gsq = (g * g + self.eps).float()
        if dims is None:
            v = (beta2 * st["v"].float() + (1.0 - beta2) * gsq).to(dtype)
            st["v"].copy_(v)
            factors = (v.float().rsqrt(),)
        else:
            d1, d0 = dims
            row = gsq.mean(dim=d0).to(dtype)
            col = gsq.mean(dim=d1).to(dtype)
            v_row = (beta2 * st["v_row"].float() + (1.0 - beta2) * row.float()).to(dtype)
            v_col = (beta2 * st["v_col"].float() + (1.0 - beta2) * col.float()).to(dtype)
            st["v_row"].copy_(v_row)
            st["v_col"].copy_(v_col)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = v_row.float().mean(dim=reduced_d1, keepdim=True).to(dtype)
            row_factor = (v_row.float() / row_mean.float()).rsqrt().to(dtype)
            col_factor = v_col.float().rsqrt().to(dtype)
            factors = (row_factor.float().unsqueeze(d0), col_factor.float().unsqueeze(d1))
        u = self.scaled(g, factors, dtype)
        denom = None
        if self.clipping_threshold is not None:
            rms = u.float().square().mean().sqrt()
            denom = torch.clamp(rms / self.clipping_threshold, min=1.0)
        return self.momentum_step(u, denom, st, p, lr)

    @staticmethod
    def scaled(g, factors, dtype):
        """u before the RMS clip: the gradient times its fp32 factors (the
        row and the column factor, or v^-1/2 of a dense leaf), in that
        order, rounded once to ``dtype``."""
        u = g.float()
        for f in factors:
            u = u * f
        return u.to(dtype)

    def momentum_step(self, u, denom, st, p, lr):
        """The elementwise rest of a leaf's update from ``u`` (:meth:`scaled`)
        and its RMS-clip denominator ``denom`` (a 0-dim fp32 tensor; None
        without ``clipping_threshold``): the clip, lr, the momentum
        (written to ``st["mu"]``) and weight decay. Returns the update."""
        dtype = p.dtype
        if denom is not None:
            u = (u.float() / denom).to(dtype)
        # optax casts the learning rate to the update's dtype first
        u = (_rounded(lr, dtype) * u.float()).to(dtype)
        # optax.ema, (1 - b1)*u + b1*mu, as XLA runs it: each Python scalar
        # takes its operand's dtype (b1 = 0.9 becomes bf16's 0.8984375 next
        # to a bf16 accumulator), the fused sum is fp32, the result promoted
        c_u, c_m = _rounded(1.0 - self.b1, dtype), _rounded(self.b1, self.moment_dtype)
        m = (c_u * u.float() + c_m * st["mu"].float()).to(torch.promote_types(dtype, self.moment_dtype))
        st["mu"].copy_(m)
        u = -m
        if self.weight_decay:
            # torch-AdamW semantics, p -= lr*wd*p; optax promotes to fp32 here
            u = u.float() - float(np.float32(lr) * np.float32(self.weight_decay)) * p.float()
        return u

    def update(self, grads, state: OptState, params):
        """-> (updates, new state); ``state`` is updated in place."""
        beta2, lr = self.scalars(state.count)
        dims = state.dims or [_factored_dims(tuple(p.shape), self.min_dim) for p in params]
        updates = [self._leaf(g, st, p, beta2, lr, d) for g, st, p, d in zip(grads, state.leaves, params, dims)]
        state.count += 1
        return updates, state

    def step_(self, params, grads, state: OptState, *, grad_clip: float | None = None, seed: int = 0,
              step: int = 0, sr_bits=None, ema_params=None, ema_decay: float | None = None,
              ema_bits=None, working=None) -> torch.Tensor:
        """The whole update of a training step, in place (see
        :func:`apply_update_`, its plain version, which runs for CPU
        tensors). CUDA tensors go through the fused kernels of
        ``ops/fused_optim.py``: a fixed handful of launches whatever the
        leaf count, no per-leaf eager work; they raise for what the kernels
        do not take (among it a bf16 working copy of fp32 masters). Returns
        the fp32 global gradient norm (0-dim)."""
        kw = dict(grad_clip=grad_clip, seed=seed, step=step, sr_bits=sr_bits, ema_params=ema_params,
                  ema_decay=ema_decay, ema_bits=ema_bits)
        device = params[0].device
        if device.type == "cpu":
            return apply_update_(self, params, grads, state, working=working, **kw)
        if device.type != "cuda":
            raise ValueError(f"AdamWFactored.step_: unsupported device {device}")
        if working is not None:
            raise NotImplementedError("fused adamw_factored: fp32 masters with a bf16 working copy are not taken")
        from uwudiff_tpu_torch.ops.fused_optim import fused_adamw_factored_step_

        return fused_adamw_factored_step_(self, params, grads, state, **kw)


class AdamW:
    """optax's ``adamw``: bias-corrected Adam moments in the param dtype,
    ``u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. Eager PyTorch
    leaf by leaf on every device (``step_`` is :func:`apply_update_`): the
    textual-inversion trainer's few small leaves do not need a fused pass."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
        self.lr_fn = _lr_fn(learning_rate)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params) -> OptState:
        return OptState(0, [{"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)} for p in params])

    def update(self, grads, state: OptState, params):
        count = state.count + 1
        lr = float(np.float32(self.lr_fn(state.count)))
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        updates = []
        for g, st, p in zip(grads, state.leaves, params):
            st["mu"] = (1 - self.b1) * g + self.b1 * st["mu"]
            st["nu"] = (1 - self.b2) * g * g + self.b2 * st["nu"]
            u = (st["mu"] / c1) / ((st["nu"] / c2).sqrt() + self.eps) + self.weight_decay * p
            updates.append(-lr * u)
        state.count = count
        return updates, state

    step_ = apply_update_


def decay_phases(n: int, threshold: float) -> np.ndarray:
    """``AdamWFP16``'s ``n`` per-leaf phases in ``[0, threshold)``, fp32: a
    24-bit uniform from leaf ``i``'s :func:`sr_key` (seed 0, step 0) on
    ``PHASE_STREAM``, times the threshold. A pure function of the leaf
    index, as the JAX package's threefry draws from ``PRNGKey(0)`` are,
    which torch cannot reproduce; tests hand ``init`` the JAX draws."""
    u = np.array([sr_key(0, 0, i, PHASE_STREAM) >> 40 for i in range(n)], dtype=np.float64) * 2.0**-24
    return u.astype(np.float32) * np.float32(threshold)


class AdamWFP16:
    """The JAX package's ``adamw_fp16_state`` (``duwu``'s ``AdamWFP16``):
    both moments stored in ``moment_dtype`` (bf16, or fp16) and updated in
    fp32, ``u = -lr * sqrt(1 - b2^t) * m / (sqrt(v) + eps)`` (the
    denominator's bias correction only), and lr-scaled weight decay
    accumulated per leaf from a phase in ``[0, decay_threshold)``: once the
    accumulator exceeds the threshold, ``p -= accum * p`` and it restarts.
    Every stage is optax's: the moments from the fp32 values before their
    rounding, ``lr`` at the step before the count, updates in the
    parameter dtype. On the card ``step_`` is two launches over every leaf
    (``ops/fused_optim.py``: the global norm, then ``adamw_fp16_apply``)."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                 moment_dtype=torch.bfloat16, decay_threshold=1e-2):
        self.lr_fn = _lr_fn(learning_rate)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.moment_dtype, self.decay_threshold = moment_dtype, decay_threshold

    def init(self, params, phases=None) -> OptState:
        """Zero moments in each parameter's layout; the accumulated decay
        starts at ``phases`` (one a leaf), by default :func:`decay_phases`."""
        phases = decay_phases(len(params), self.decay_threshold) if phases is None else phases
        phases = np.array(phases, dtype=np.float32).reshape(-1)
        if len(phases) != len(params):
            raise ValueError(f"{len(phases)} phases for {len(params)} leaves")
        leaves = [{"exp_avg": torch.zeros_like(p, dtype=self.moment_dtype),
                   "exp_avg_sq": torch.zeros_like(p, dtype=self.moment_dtype)} for p in params]
        return OptState(0, leaves, decay=phases)

    def consts(self) -> tuple[float, float, float, float, float]:
        """(b1, 1 - b1, b2, 1 - b2, eps) as the fp32 values optax multiplies by."""
        f = lambda x: float(np.float32(x))  # noqa: E731
        return f(self.b1), f(1 - self.b1), f(self.b2), f(1 - self.b2), f(self.eps)

    def advance(self, state: OptState) -> tuple[float, np.ndarray]:
        """The scalars of the update after ``state.count`` updates, in fp32:
        the step size ``-lr * sqrt(1 - b2^t)`` and each leaf's decay this
        step (its accumulator where it exceeds the threshold, else 0); the
        accumulators move on (``state.decay``). The count does not."""
        f32 = np.float32
        lr = f32(self.lr_fn(state.count))
        step_size = f32(-lr) * np.sqrt(f32(1.0) - f32(self.b2) ** f32(state.count + 1))
        accum = state.decay + f32(self.weight_decay) * lr
        now = np.where(accum > f32(self.decay_threshold), accum, f32(0.0)).astype(np.float32)
        state.decay = (accum - now).astype(np.float32)
        return float(step_size), now

    def update(self, grads, state: OptState, params):
        """-> (updates, new state); ``state`` is updated in place."""
        step_size, decay_now = self.advance(state)
        b1, omb1, b2, omb2, eps = self.consts()
        updates = []
        for g, st, p, d in zip(grads, state.leaves, params, decay_now):
            g = g.float()
            m = st["exp_avg"].float() * b1 + g * omb1
            v = st["exp_avg_sq"].float() * b2 + (g * g) * omb2
            u = (step_size * m) / (v.sqrt() + eps) - float(d) * p.float()
            st["exp_avg"].copy_(m)
            st["exp_avg_sq"].copy_(v)
            updates.append(u.to(p.dtype))
        state.count += 1
        return updates, state

    def step_(self, params, grads, state: OptState, *, grad_clip: float | None = None, seed: int = 0,
              step: int = 0, sr_bits=None, ema_params=None, ema_decay: float | None = None,
              ema_bits=None, working=None) -> torch.Tensor:
        """The whole update of a training step, in place (:func:`apply_update_`,
        its plain version, runs for CPU tensors). CUDA tensors go through
        ``ops/fused_optim.py``: the global norm and ``adamw_fp16_apply``,
        two launches whatever the leaf count, over fp32 masters, their bf16
        gradients, bf16 moments and the bf16 ``working`` copies, which the
        kernel rewrites; anything else on the card raises. Returns the fp32
        global gradient norm (0-dim)."""
        kw = dict(grad_clip=grad_clip, seed=seed, step=step, sr_bits=sr_bits, ema_params=ema_params,
                  ema_decay=ema_decay, ema_bits=ema_bits, working=working)
        device = params[0].device
        if device.type == "cpu":
            return apply_update_(self, params, grads, state, **kw)
        if device.type != "cuda":
            raise ValueError(f"AdamWFP16.step_: unsupported device {device}")
        from uwudiff_tpu_torch.ops.fused_optim import fused_adamw_fp16_step_

        return fused_adamw_fp16_step_(self, params, grads, state, **kw)


def adamw_fp16_state(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, moment_dtype=torch.bfloat16,
                     decay_threshold=1e-2) -> AdamWFP16:
    return AdamWFP16(learning_rate, b1, b2, eps, weight_decay, moment_dtype, decay_threshold)


def adamw_factored(
    learning_rate: float | Callable,
    b1: float = 0.9,
    b2: float = 0.999,  # accepted for config compatibility; the decay is 1 - t^-decay_rate
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 128,
    moment_dtype=torch.bfloat16,
    decay_rate: float = 0.8,
    clipping_threshold: float | None = None,
) -> AdamWFactored:
    """bf16 first moment + Adafactor's factored second moment: the leaf's
    two largest axes (both >= ``min_dim_size_to_factor``) keep row and
    column statistics, ``v ~ outer(v_row, v_col) / mean(v_row)``, which is
    symmetric in the two axes, so PyTorch's transposed weight layouts give
    optax's estimate. ``clipping_threshold`` clips each leaf's update RMS.
    Weight decay is lr-scaled (torch-AdamW), not Adafactor's raw
    ``weight_decay_rate``."""
    del b2
    return AdamWFactored(learning_rate, b1, eps, weight_decay, min_dim_size_to_factor, moment_dtype,
                         decay_rate, clipping_threshold)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4) -> AdamW:
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


# torch dotted-path aliases for config compatibility with the reference
_ALIASES = {
    "torch.optim.AdamW": "adamw",
    "torch.optim.Adam": "adam",
    "torch.optim.SGD": "sgd",
    "lion_pytorch.Lion": "lion",
    "duwu.trainer.optimizers.AdamWFP16": "adamw_fp16",
    "uwudiff_tpu.training.optimizers.adamw_fp16_state": "adamw_fp16",
}


def build_optimizer(
    name: str = "adamw",
    learning_rate: float | Callable = 1e-5,
    weight_decay: float = 0.01,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    **kwargs,
):
    name = _ALIASES.get(name, name)
    b1, b2 = betas
    if name == "adamw":
        return adamw(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, **kwargs)
    if name == "adamw_factored":
        return adamw_factored(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, **kwargs)
    if name == "adamw_fp16":
        return adamw_fp16_state(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, **kwargs)
    if name in ("adam", "lion", "sgd", "adafactor"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError(f"Unknown optimizer {name!r}")
