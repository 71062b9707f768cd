"""GroupNorm (+ SiLU): the hand-written CUDA kernel pair and its plain version.

Replaces ``uwudiff_tpu/ops/groupnorm_silu.py::_gn_silu_kernel`` and
``::_gn_stats_kernel``. The TPU chose between a single-pass kernel and a
chunked-stats kernel by VMEM size; on the H100 both map onto one pair in
``csrc/groupnorm_silu.cu`` (its source note says what bounds it and how
the design answers that):

- :func:`gn_stats`: per-(n, group) statistics over ``[N, HW, C]`` ->
  per-(n, channel) ``scale = inv*gamma`` and ``shift = beta - mean*scale``;
- :func:`gn_silu_apply`: ``y = silu(x*scale + shift)`` elementwise.

Layout contract (the JAX function's): ``x`` is ``[N, H, W, C]`` or
``[N, S, C]``, channels last and contiguous; ``gamma``/``beta`` ``[C]``.
The kernels run at any HW and any ``C % groups == 0``; the TPU's
``_chunk_for``/``_tile_fits_vmem`` gates were VMEM artifacts. ``silu=False``
gives the plain GroupNorm that the transformer and VAE attention norms
use, through the same kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

__all__ = [
    "group_norm_silu",
    "group_norm_silu_reference",
    "gn_stats",
    "gn_stats_reference",
    "gn_silu_apply",
    "gn_silu_apply_reference",
]

_SOURCE = "groupnorm_silu.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECS = 256 * 3  # threads x vector columns per thread in gn_partial_kernel
_fns: dict = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from uwudiff_tpu_torch.ops._build import library

        fn = getattr(library(_SOURCE), name)
        fn.restype = ctypes.c_int
        if name == "uwu_gn_stats":
            fn.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p]
            )
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _fns[name] = fn
    return fn


def group_norm_silu_reference(x, gamma, beta, groups: int, eps: float, silu: bool = True):
    """Plain version: fp32 group mean/var, the affine, then SiLU."""
    n, c = x.shape[0], x.shape[-1]
    xr = x.reshape(n, -1, groups, c // groups).float()
    mean = xr.mean(dim=(1, 3), keepdim=True)
    var = xr.var(dim=(1, 3), unbiased=False, keepdim=True)
    xn = ((xr - mean) * torch.rsqrt(var + eps)).reshape(n, -1, c)
    y = xn * gamma.float() + beta.float()
    if silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


def gn_stats_reference(x3, gamma, beta, groups: int, eps: float):
    """Plain version of :func:`gn_stats`: (scale, shift), fp32 [N, C]."""
    n, _, c = x3.shape
    xr = x3.reshape(n, -1, groups, c // groups).float()
    mean = xr.mean(dim=(1, 3))
    inv = torch.rsqrt(xr.var(dim=(1, 3), unbiased=False) + eps)
    gs = c // groups
    scale = inv.repeat_interleave(gs, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(gs, dim=1) * scale
    return scale, shift


def gn_silu_apply_reference(x3, scale, shift, silu: bool = True):
    """Plain version of :func:`gn_silu_apply`."""
    z = x3.float() * scale[:, None, :] + shift[:, None, :]
    return (F.silu(z) if silu else z).to(x3.dtype)


def _check_x3(x3, who):
    if not x3.is_cuda:
        raise ValueError(f"{who}: x is not a CUDA tensor")
    if x3.dtype not in _DTYPES:
        raise TypeError(f"{who} takes fp32 or bf16, got {x3.dtype}")
    if x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"{who}: x must be a contiguous [N, HW, C] view")
    if x3.data_ptr() % 16:
        raise ValueError(f"{who}: x is not 16-byte aligned")
    n, hw, c = x3.shape
    vec = 16 // x3.element_size()
    if n == 0 or hw == 0 or c % vec or c // vec > _MAX_VECS:
        raise ValueError(f"{who}: unsupported shape {tuple(x3.shape)} for {x3.dtype}")


def gn_stats(x3, gamma, beta, groups: int, eps: float):
    """Launch the stats kernels on ``x3`` [N, HW, C]. Returns fp32
    (scale, shift) [N, C] with ``scale = inv*gamma``, ``shift = beta - mean*scale``."""
    _check_x3(x3, "gn_stats")
    n, hw, c = x3.shape
    if c % groups:
        raise ValueError(f"gn_stats: C={c} not divisible by groups={groups}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("gn_stats: gamma/beta must be [C]")
    gamma = gamma.to(device=x3.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x3.device, dtype=torch.float32).contiguous()
    # >= 64 rows per chunk keeps the partials a few percent of x's bytes;
    # ~2048 (n, chunk) blocks keep all SMs busy even at N = 1
    n_chunks = max(1, min(math.ceil(hw / 64), math.ceil(2048 / n)))
    partial = torch.empty((n, n_chunks, 2, c), dtype=torch.float32, device=x3.device)
    scale = torch.empty((n, c), dtype=torch.float32, device=x3.device)
    shift = torch.empty((n, c), dtype=torch.float32, device=x3.device)
    rc = _kernel("uwu_gn_stats")(
        x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), _DTYPES[x3.dtype], n, hw, c, groups,
        n_chunks, float(eps), torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gn_stats launch failed: cudaError {rc}")
    gn_stats.launches += 1
    return scale, shift


gn_stats.launches = 0


def gn_silu_apply(x3, scale, shift, silu: bool = True):
    """Launch ``y = silu(x*scale + shift)`` (or the affine alone) on ``x3`` [N, HW, C]."""
    _check_x3(x3, "gn_silu_apply")
    n, hw, c = x3.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or t.shape != (n, c) or not t.is_contiguous()
                or t.device != x3.device):
            raise ValueError(f"gn_silu_apply: {name} must be contiguous fp32 [N, C] on x's device")
    y = torch.empty_like(x3)
    rc = _kernel("uwu_gn_apply")(
        x3.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
        _DTYPES[x3.dtype], n, hw, c, int(silu),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gn_silu_apply launch failed: cudaError {rc}")
    gn_silu_apply.launches += 1
    return y


gn_silu_apply.launches = 0


def group_norm_silu(x, gamma, beta, groups: int = 32, eps: float = 1e-5, silu: bool = True):
    """GroupNorm(+SiLU) over a channels-last ``x``: the kernel pair for a
    CUDA tensor (which must be contiguous: no silent copy), the plain
    version for a CPU tensor."""
    if x.is_cuda:
        if not x.is_contiguous():
            raise ValueError(
                f"group_norm_silu: x {tuple(x.shape)} is not a contiguous channels-last view"
            )
        x3 = x.view(x.shape[0], -1, x.shape[-1])
        scale, shift = gn_stats(x3, gamma, beta, groups, eps)
        return gn_silu_apply(x3, scale, shift, silu).view(x.shape)
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, gamma, beta, groups, eps, silu)
    raise ValueError(f"group_norm_silu: unsupported device {x.device}")
