"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Replaces ``uwudiff_tpu/ops/flash_attention.py::_fwd_kernel`` (the TPU's
online-softmax forward). The kernel is ``csrc/flash_fwd.cu``; its source
note says what bounds it on an H100 and how the design answers that.

Contract (the JAX function's): ``q`` ``[B, Sq, H, D]``, ``k``/``v``
``[B, Sk, H, D]``, out ``[B, Sq, H, D]`` in the input dtype and, on
request, the natural-log row logsumexp ``[B, H, Sq]`` in fp32. The bias
is none, a key bias broadcastable to ``[B, 1, 1, Sk]`` or a full bias
broadcastable to ``[B, H, Sq, Sk]``; it is clamped at ``-1e30`` so that
a bias holding ``-inf`` (CLIP adds ``finfo.min`` twice) gives no NaN.

:func:`flash_fwd` launches the kernel and takes CUDA tensors only;
:func:`flash_attention_reference` is the plain PyTorch version;
:func:`flash_attention` picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "HEAD_DIMS",
    "NEG_INF",
    "flash_attention",
    "flash_attention_reference",
    "flash_fwd",
]

NEG_INF = -1e30
HEAD_DIMS = (40, 64, 80, 160)  # the kernel's instantiations (SDXL 64; SD1.5 40/80/160)

_SOURCE = "flash_fwd.cu"
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from uwudiff_tpu_torch.ops._build import library

        fn = library(_SOURCE).uwu_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _split_bias(bias, b, h, sq, sk):
    """-> (mode, tensor): 0 none, 1 key bias [B, Sk], 2 full [B*H, Sq, Sk];
    fp32, clamped at NEG_INF, broadcasts expanded."""
    if bias is None:
        return 0, None
    bias = bias.float()
    while bias.dim() < 4:
        bias = bias[None]
    if bias.shape[1] == 1 and bias.shape[2] == 1:
        key = bias.expand(b, 1, 1, sk)[:, 0, 0, :]
        return 1, key.clamp_min(NEG_INF).contiguous()
    full = bias.expand(b, h, sq, sk).clamp_min(NEG_INF)
    return 2, full.reshape(b * h, sq, sk).contiguous()


def flash_attention_reference(q, k, v, bias=None, scale=None):
    """Plain version: fp32 logits, exact softmax. Returns (out, lse)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float().clamp_min(NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd: {name} is not a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd takes bf16, got {name}.dtype={t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_fwd: {name} must be [B, S, H, D]")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_fwd: {name} needs unit stride over D and strides that "
                f"are multiples of 8 elements, got {tuple(t.stride())}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} is not 16-byte aligned")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"flash_fwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"flash_fwd: unsupported sizes B*H={b * h}, Sq={sq}, Sk={sk}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")


def flash_fwd(q, k, v, bias=None, scale=None):
    """Launch the CUDA kernel. Returns (out [B, Sq, H, D], lse [B, H, Sq])."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d**-0.5
    mode, bias_t = _split_bias(bias, b, h, sq, sk)
    if bias_t is not None and bias_t.device != q.device:
        raise ValueError("flash_fwd: bias on another device than q")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]
    )
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_t.data_ptr() if bias_t is not None else None,
        out.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d, mode,
        ctypes.cast(strides, ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, bias=None, scale=None, return_lse=False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        out, lse = flash_fwd(q, k, v, bias, scale)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, bias, scale)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out
