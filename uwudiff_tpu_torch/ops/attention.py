"""Attention dispatch: one surface for every attention of the port.

``dot_product_attention(q, k, v, bias)`` takes ``[B, S, H, D]`` tensors
and returns ``[B, Sq, H, D]``, as ``uwudiff_tpu/ops/attention.py`` does.

The gate is the port's own: on CUDA every call with a head dim up to
:data:`FLASH_MAX_HEAD_DIM` goes to the flash kernels, whatever Sq and Sk
are; that covers UNet self-attention, cross-attention over the 77 text
keys and CLIP's causal 77x77 attention with its full bias. The call goes
through the autograd function, so a backward pass runs the flash
backward kernels; without gradients it is the forward kernel alone. A
head dim in that range that a kernel was not built for
(:data:`~uwudiff_tpu_torch.ops.flash_attention.HEAD_DIMS`, and
``BWD_HEAD_DIMS`` for the backward) raises there.
The TPU's ``Sq >= 128``/``Sk >= 128`` thresholds were launch-cost
verdicts measured on the TPU and are not carried over. The einsum
(:func:`attention_reference`, fp32 softmax) serves CPU tensors and the
VAE's single-head D=512 attention, which has no kernel here or in the
JAX package. Ring, head- and sequence-parallel attention belong to a
later slice.
"""

from __future__ import annotations

import torch

from uwudiff_tpu_torch.ops.flash_attention import flash_attention

__all__ = [
    "FLASH_MAX_HEAD_DIM",
    "attention_bias_from_mask",
    "attention_reference",
    "dot_product_attention",
]

FLASH_MAX_HEAD_DIM = 256  # the TPU kernel's limit; the einsum takes larger heads


def attention_bias_from_mask(mask, dtype=torch.float32):
    """[B, Sk] boolean/0-1 key mask -> additive bias [B, 1, 1, Sk]."""
    if mask is None:
        return None
    neg = torch.finfo(dtype).min
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    bias = torch.where(mask.bool(), zero, torch.full_like(zero, neg))
    return bias[:, None, None, :]


def attention_reference(q, k, v, bias=None, scale=None):
    """Einsum attention, softmax in fp32 (``_xla_attention`` in the JAX package)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def dot_product_attention(q, k, v, bias=None, scale=None, bias_grad=False):
    """Scaled dot-product attention over ``[B, S, H, D]`` tensors; ``bias``
    is additive and broadcastable to ``[B, H, Sq, Sk]``. ``bias_grad=True``
    marks a learned bias: the flash path then computes its gradient (K5);
    the einsum is differentiable in the bias either way."""
    if q.is_cuda and q.shape[-1] <= FLASH_MAX_HEAD_DIM:
        return flash_attention(q, k, v, bias, scale, bias_grad=bias_grad)
    return attention_reference(q, k, v, bias=bias, scale=scale)
