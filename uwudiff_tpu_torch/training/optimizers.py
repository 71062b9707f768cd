"""Optimizers (``uwudiff_tpu/training/optimizers.py``), written out in PyTorch.

The JAX package builds its optimizers from optax; the port re-derives the
two on its main path by hand, optax-style: an optimizer is ``init(params)
-> state`` and ``update(grads, state, params) -> (updates, state)`` over
lists of tensors, and the caller applies the updates. The state keeps the
dtypes and the step-count conventions of optax 0.2.6.

- :func:`adamw_factored`: optax's Adafactor chain (factored second moment
  -> per-leaf update-RMS clip -> learning rate -> bf16 momentum -> negate)
  followed by torch-AdamW lr-scaled weight decay (``p -= lr*wd*p``).
- :func:`adamw`: optax's ``adamw``.
- :func:`stochastic_round_add`: ``param + update`` stochastically rounded
  to bf16, with the 16 noise bits per element passed in.

Every update runs leaf by leaf in eager PyTorch: no TPU kernel stood here
(optax went through XLA), and a fused multi-tensor version is later work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

__all__ = [
    "AdamW",
    "AdamWFactored",
    "OptState",
    "adamw",
    "adamw_factored",
    "build_optimizer",
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


@dataclasses.dataclass
class OptState:
    """``count``: updates made (optax's counts, one for every stage of the
    chain, all equal). ``leaves``: one dict of tensors per parameter."""

    count: int
    leaves: list[dict]


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
        leaves = []
        for p in params:
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            st = {"mu": torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)}
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                st["v_row"] = p.new_zeros(tuple(s for i, s in enumerate(p.shape) if i != d0))
                st["v_col"] = p.new_zeros(tuple(s for i, s in enumerate(p.shape) if i != d1))
            leaves.append(st)
        return OptState(0, leaves)

    def _leaf(self, g, st, p, beta2, lr):
        """One leaf's update; tensors hold the dtypes of optax's stages:
        the statistics and the scaled gradient in the param dtype, the
        momentum in ``moment_dtype``, the decayed update promoted to fp32."""
        dtype = p.dtype
        gsq = (g * g + self.eps).float()
        dims = _factored_dims(tuple(p.shape), self.min_dim)
        if dims is None:
            v = (beta2 * st["v"].float() + (1.0 - beta2) * gsq).to(dtype)
            st["v"] = v
            u = (g.float() * v.float().rsqrt()).to(dtype)
        else:
            d1, d0 = dims
            row = gsq.mean(dim=d0).to(dtype)
            col = gsq.mean(dim=d1).to(dtype)
            v_row = (beta2 * st["v_row"].float() + (1.0 - beta2) * row.float()).to(dtype)
            v_col = (beta2 * st["v_col"].float() + (1.0 - beta2) * col.float()).to(dtype)
            st["v_row"], st["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = v_row.float().mean(dim=reduced_d1, keepdim=True).to(dtype)
            row_factor = (v_row.float() / row_mean.float()).rsqrt().to(dtype)
            col_factor = v_col.float().rsqrt().to(dtype)
            u = (g.float() * row_factor.float().unsqueeze(d0) * col_factor.float().unsqueeze(d1)).to(dtype)
        if self.clipping_threshold is not None:
            rms = u.float().square().mean().sqrt()
            u = (u.float() / torch.clamp(rms / self.clipping_threshold, min=1.0)).to(dtype)
        # optax casts the learning rate to the update's dtype first
        u = (_rounded(lr, dtype) * u.float()).to(dtype)
        # optax.ema, (1 - b1)*u + b1*mu, as XLA runs it: each Python scalar
        # takes its operand's dtype (b1 = 0.9 becomes bf16's 0.8984375 next
        # to a bf16 accumulator), the fused sum is fp32, the result promoted
        c_u, c_m = _rounded(1.0 - self.b1, dtype), _rounded(self.b1, self.moment_dtype)
        m = (c_u * u.float() + c_m * st["mu"].float()).to(torch.promote_types(dtype, self.moment_dtype))
        st["mu"] = m.to(self.moment_dtype)
        u = -m
        if self.weight_decay:
            # torch-AdamW semantics, p -= lr*wd*p; optax promotes to fp32 here
            u = u.float() - float(np.float32(lr) * np.float32(self.weight_decay)) * p.float()
        return u

    def update(self, grads, state: OptState, params):
        """-> (updates, new state); ``state`` is updated in place."""
        t = np.float32(state.count + 1)
        beta2 = float(np.float32(1.0) - t ** np.float32(-self.decay_rate))  # 1 - t^-0.8, fp32
        lr = float(np.float32(self.lr_fn(state.count)))
        updates = [self._leaf(g, st, p, beta2, lr) for g, st, p in zip(grads, state.leaves, params)]
        state.count += 1
        return updates, state


class AdamW:
    """optax's ``adamw``: bias-corrected Adam moments in the param dtype,
    ``u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

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
    if name in ("adam", "adamw_fp16", "lion", "sgd", "adafactor"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError(f"Unknown optimizer {name!r}")
