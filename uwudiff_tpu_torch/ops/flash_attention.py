"""Flash attention: the hand-written CUDA kernels and their plain versions.

Replaces ``uwudiff_tpu/ops/flash_attention.py``: the TPU's online-softmax
forward ``_fwd_kernel`` and its backward kernels ``_bwd_dq_kernel`` /
``_bwd_dq_dbias_kernel`` / ``_bwd_dkv_kernel``. Both sides dispatch on
the head dim, and every kernel is a Hopper one (TMA loads into an
mbarrier ring, wgmma, a producer warpgroup and two or three consumer
warpgroups) or an mma.sync one:

- the forward: ``csrc/flash_fwd_sm90.cu`` at D = 40, 64, 80, 128 and 160,
  one kernel template (64 is SDXL's, CLIP's, T5's and the SD3 MMDiT's;
  40/80/160 SD1.5's; 128 Flux's); ``csrc/flash_fwd.cu`` (mma.sync) computes the same function
  at 40/80/160 and stays built and tested as the yardstick, on no path;
- dQ and dK/dV: ``csrc/flash_bwd_sm90.cu`` at D = 40, 64, 80, 128 and
  160, one kernel template each (D = 64's 128-byte swizzled tiles at every
  head dim, the columns past D zero-filled; at 128 and 160 dK/dV's two
  consumer warpgroups share 64 keys, one accumulating dV and the other dK);
  ``csrc/flash_bwd.cu`` (mma.sync) computes the same function at D = 160
  and stays built and tested as the yardstick, on no path;
- dQ + dBias (K5): ``csrc/flash_bwd.cu`` at every backward head dim.

The Hopper kernels' tensor maps are computed and checked here
(:func:`tma_map`) and encoded by the C side. Any other head dim raises on
the card. Each source note says what bounds the kernel on an H100 and how
the design answers that.

Contract (the JAX function's): ``q`` ``[B, Sq, H, D]``, ``k``/``v``
``[B, Sk, H, D]``, out ``[B, Sq, H, D]`` in the input dtype and, on
request, the natural-log row logsumexp ``[B, H, Sq]`` in fp32. The bias
is none, a key bias broadcastable to ``[B, 1, 1, Sk]`` or a full bias
broadcastable to ``[B, H, Sq, Sk]``; it is clamped at ``-1e30`` so that
a bias holding ``-inf`` (CLIP adds ``finfo.min`` twice) gives no NaN.
With ``bias_grad=False`` (the default) the bias is a constant and gets no
gradient. With ``bias_grad=True`` it is a learned bias (T5's relative
position bias): it is taken as full ``[B, H, Sq, Sk]`` and the backward's
dQ pass is the dQ + dBias kernel (K5), whose dBias (natural-log units,
fp32) is summed back to the bias argument's shape. K5 runs only where
autograd keeps the bias's gradient; a frozen learned bias (textual
inversion's T5) takes K4. With ``return_lse`` the lse is differentiable:
its cotangent folds into the backward's delta (``delta - dlse``), as in
the JAX package.

:func:`flash_fwd` (through :func:`forward_kernel`: :func:`flash_fwd_sm90`
at every head dim; :func:`flash_fwd_mma` is called only by name),
:func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
(through :func:`backward_kernels`: the ``_sm90`` pair; the ``_mma`` pair
is called only by name) and
:func:`flash_bwd_dq_dbias` launch the kernels and take CUDA tensors only;
:func:`flash_attention_reference` and
:func:`flash_attention_backward_reference` are the plain PyTorch
versions; :class:`FlashAttentionFunction` is the autograd function (K1
forward; K4 or K5, and K6 backward) and picks between kernels and plain
versions by the tensors' device.
"""

from __future__ import annotations

import array
import ctypes
from typing import NamedTuple

import torch

__all__ = [
    "BWD_HEAD_DIMS",
    "FlashAttentionFunction",
    "HEAD_DIMS",
    "backward_kernels",
    "NEG_INF",
    "flash_attention",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dkv_mma",
    "flash_bwd_dkv_sm90",
    "flash_bwd_dq",
    "flash_bwd_dq_dbias",
    "flash_bwd_dq_mma",
    "flash_bwd_dq_sm90",
    "flash_fwd",
    "flash_fwd_mma",
    "flash_fwd_sm90",
    "forward_kernel",
    "sm90_bwd_box_rows",
    "tma_map",
]

NEG_INF = -1e30
HEAD_DIMS = (40, 64, 80, 128, 160)  # the Hopper forward's (D = 64: SDXL, CLIP, T5, the SD3 MMDiT; SD1.5's 40/80/160; Flux's 128)
MMA_HEAD_DIMS = (40, 80, 160)  # the mma.sync forward (SD1.5's), built and tested, on no path
SM90_BWD_HEAD_DIMS = (40, 64, 80, 128, 160)  # the Hopper dQ and dK/dV kernels (SD1.5's 40/80/160, Flux's 128, 64)
MMA_BWD_HEAD_DIMS = (160,)  # the mma.sync dQ and dK/dV kernels (SD1.5's D = 160), built and tested, on no path
BWD_HEAD_DIMS = (40, 64, 80, 128, 160)  # every head dim a backward (and K5) was built for

_fns: dict = {}


def _kernel(source, name, n_ptrs):
    fn = _fns.get(name)
    if fn is None:
        from uwudiff_tpu_torch.ops._build import library

        fn = getattr(library(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        )
        _fns[name] = fn
    return fn


def _split_bias(bias, b, h, sq, sk, full=False):
    """-> (mode, tensor): 0 none, 1 key bias [B, Sk], 2 full [B*H, Sq, Sk];
    fp32 and contiguous, broadcasts expanded. A bias that is already so
    (T5's, built once per forward and shared by every layer) passes
    uncopied; the kernels clamp it at NEG_INF as they load it. ``full``
    takes a key bias as full too (the dBias kernel's layout)."""
    if bias is None:
        return 0, None
    bias = bias.float()
    while bias.dim() < 4:
        bias = bias[None]
    if not full and bias.shape[1] == 1 and bias.shape[2] == 1:
        return 1, bias.expand(b, 1, 1, sk)[:, 0, 0, :].contiguous()
    return 2, bias.expand(b, h, sq, sk).reshape(b * h, sq, sk).contiguous()


def _logits(q, k, bias, scale):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float().clamp_min(NEG_INF)
    return logits


def flash_attention_reference(q, k, v, bias=None, scale=None):
    """Plain version: fp32 logits, exact softmax. Returns (out, lse)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = _logits(q, k, bias, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale=None, dlse=None):
    """Plain version of the backward kernels, in fp32: P recomputed from the
    forward's ``lse``, ``delta = rowsum(dO * O)``, ``dS = P (dP - delta)``.
    ``dlse``, the lse's cotangent ``[B, H, Sq]`` (or None), folds into delta
    as ``delta - dlse``: d lse / d logits is P. Returns (dq, dk, dv) in the
    inputs' dtype and dS, the logits' gradient (a full bias's gradient),
    fp32 ``[B, H, Sq, Sk]``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p = torch.exp(_logits(q, k, bias, scale) - lse[..., None])  # [B, H, Sq, Sk]
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    if dlse is not None:
        delta = delta - dlse.float()
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def _check(who, head_dims, *tensors):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{who}: {name} is not a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{who} takes bf16, got {name}.dtype={t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{who}: {name} must be [B, S, H, D]")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{who}: {name} needs unit stride over D and strides that "
                f"are multiples of 8 elements, got {tuple(t.stride())}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    (_, q), (_, k), (_, v) = tensors[:3]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d) or any(
        t.shape != q.shape for _, t in tensors[3:]
    ):
        shapes = " ".join(f"{n}{tuple(t.shape)}" for n, t in tensors)
        raise ValueError(f"{who}: shapes {shapes}")
    if d not in head_dims:
        raise ValueError(f"{who}: head dim {d} not in {head_dims}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"{who}: unsupported sizes B*H={b * h}, Sq={sq}, Sk={sk}")
    if any(t.device != q.device for _, t in tensors):
        raise ValueError(f"{who}: inputs on different devices")


def _bias_arg(who, bias, q, k, full=False):
    b, sq, h, _ = q.shape
    mode, bias_t = _split_bias(bias, b, h, sq, k.shape[1], full)
    if bias_t is not None and bias_t.device != q.device:
        raise ValueError(f"{who}: bias on another device than q")
    return mode, bias_t


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def _stats_arg(who, t, q):
    b, sq, h, _ = q.shape
    if t.dtype != torch.float32 or t.shape != (b, h, sq) or not t.is_contiguous() or t.device != q.device:
        raise ValueError(f"{who}: lse/delta must be contiguous fp32 [B, H, Sq] on q's device")
    return t


TMA_BOX_ROWS = 128  # rows of q (a work item's query tile) or k/v (a key tile) per TMA box, as the kernel tiles
# the Hopper forward's tiles by head dim (csrc/flash_fwd_sm90.cu, Cfg): a work
# item's query rows (BLOCK_M: three consumer warpgroups of 64 at D = 40, two
# elsewhere) and its key tile (BLOCK_N: 64 at D = 160, where a stage of 128
# keys leaves room for one stage only)
SM90_FWD_Q_ROWS = {40: 192, 64: 128, 80: 128, 128: 128, 160: 128}
SM90_FWD_KEY_ROWS = {40: 128, 64: 128, 80: 128, 128: 128, 160: 64}
# the Hopper backward's boxes: an item's rows (q and dout for dQ: 128; k and v
# for dK/dV: 128, or 64 at D = 128 and 160, where both consumer warpgroups
# share an item's keys) and the 64-row tiles streamed past them
SM90_BWD_ITEM_ROWS, SM90_BWD_TILE_ROWS = 128, 64
SM90_BWD_DKV_ITEM_ROWS = {40: 128, 64: 128, 80: 128, 128: 64, 160: 64}
_TMA_ENCODE_FAILED = 100000  # the C side's code for a tensor map the driver refused (+ its CUresult)


class TmaMap(NamedTuple):
    """A rank-4 TMA tensor map over a bf16 ``[B, S, H, D]`` view, innermost
    first: ``dims`` (D, H, S, B) in elements, ``strides`` of H, S and B in
    bytes, ``box`` (64, 1, rows, 1) in elements: one 128-byte swizzle row
    of 64 columns, loaded once per 64-column block of D (twice at
    D = 80 and 128, three times at 160), the columns past D zero-filled."""

    dims: tuple
    strides: tuple
    box: tuple

    def words(self):
        return self.dims + self.strides + self.box


_tma_maps: dict = {}  # (shape, strides, rows, head dims) -> TmaMap, for views already checked


def tma_map(t, who="flash_fwd_sm90", name="t", rows=TMA_BOX_ROWS, head_dims=HEAD_DIMS):
    """The tensor map a Hopper kernel loads ``t`` with, in boxes of
    ``rows`` rows of S (the kernel's tile, which its C side checks),
    checked against what TMA takes: a 16-byte aligned start, unit stride
    over a bf16 head dim in ``head_dims`` (the forward's
    :data:`HEAD_DIMS`, or the backward's :data:`SM90_BWD_HEAD_DIMS`),
    other strides positive multiples of 16 bytes below 2**40, dims below
    2**32. Raises ValueError for any other view: the kernel neither copies
    it nor takes it. A geometry seen before is taken from a cache, and only
    the start is checked again: the wrapper's host time is most of a call
    at CLIP's 77 tokens."""
    key = (t.shape, t.stride(), rows, head_dims)
    if t.dtype == torch.bfloat16:
        m = _tma_maps.get(key)
        if m is not None:
            if t.data_ptr() % 16:
                raise ValueError(f"{who}: {name} starts at an address TMA cannot take (not 16-byte aligned)")
            return m
    m = _tma_map_checked(t, who, name, rows, head_dims)
    if len(_tma_maps) >= 4096:
        _tma_maps.clear()
    _tma_maps[key] = m
    return m


def _tma_map_checked(t, who, name, rows, head_dims):
    if not 1 <= rows <= 256:
        raise ValueError(f"{who}: a TMA box holds 1 to 256 rows, not {rows}")
    if t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"{who}: {name} must be a bf16 [B, S, H, D] view for TMA, got {t.dtype} {tuple(t.shape)}")
    b, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    if d not in head_dims or sd != 1:
        raise ValueError(f"{who}: {name} needs a contiguous head dim in {head_dims} for TMA, got D={d} stride {sd}")
    if t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} starts at an address TMA cannot take (not 16-byte aligned)")
    strides = (2 * sh, 2 * ss, 2 * sb)
    if min(strides) <= 0 or max(strides) >= 2**40 or (sh | ss | sb) % 8:
        raise ValueError(f"{who}: {name} has strides TMA cannot take: {strides} bytes over (H, S, B); "
                         "each must be a positive multiple of 16 below 2**40")
    dims = (d, h, s, b)
    if max(dims) >= 2**32:
        raise ValueError(f"{who}: {name} dims {dims} out of TMA's range")
    return TmaMap(dims, strides, (64, 1, rows, 1))


def forward_kernel(d):
    """The forward kernel's wrapper for head dim ``d``: the Hopper kernel at
    every head dim in :data:`HEAD_DIMS`; any other raises."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in {HEAD_DIMS}")
    return flash_fwd_sm90


def flash_fwd(q, k, v, bias=None, scale=None):
    """Launch the forward kernel for q's head dim (K1, see
    :func:`forward_kernel`). Returns (out [B, Sq, H, D], lse [B, H, Sq])."""
    return forward_kernel(q.shape[-1])(q, k, v, bias, scale)


def _fwd_outputs(q, scale):
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return scale if scale is not None else d**-0.5, out, lse


def _bias_in_place(who, bias, q, k):
    """-> (mode, tensor, batch stride, head stride) for the Hopper forward.
    A full fp32 bias whose rows are Sk contiguous keys is read where it
    lies, through its batch and head strides (0 where it broadcasts, as
    CLIP's [B, 1, Sq, Sk] does over the heads), so it is not expanded and
    copied; any other bias goes through :func:`_split_bias`."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if bias is not None and bias.dim() == 4 and bias.dtype == torch.float32 and bias.device == q.device:
        bb, bh, bq, bk = bias.shape
        if bb in (1, b) and bh in (1, h) and (bq, bk) == (sq, sk) and bias.stride(3) == 1 and bias.stride(2) == sk:
            return 2, bias, bias.stride(0) if bb == b else 0, bias.stride(1) if bh == h else 0
    mode, bias_t = _bias_arg(who, bias, q, k)
    return (mode, bias_t) + ((sk, 0) if mode == 1 else (h * sq * sk, sq * sk))


def _check_sm90_rc(who, rc, maps):
    if rc >= _TMA_ENCODE_FAILED:
        raise RuntimeError(f"{who}: the driver refused a tensor map (CUresult {rc - _TMA_ENCODE_FAILED},"
                           f" {_TMA_ENCODE_FAILED} if cuTensorMapEncodeTiled was not found): {maps}")
    if rc != 0:
        raise RuntimeError(f"{who} launch failed: cudaError {rc}")


def flash_fwd_sm90(q, k, v, bias=None, scale=None):
    """Launch the Hopper forward (D = 40/64/80/128/160): q/k/v go in uncopied
    through TMA tensor maps (:func:`tma_map`; q in boxes of a work item's
    rows, k and v of the head dim's key tile). Returns (out, lse)."""
    _check("flash_fwd_sm90", HEAD_DIMS, ("q", q), ("k", k), ("v", v))
    b, sq, h, d = q.shape
    maps = [tma_map(t, who="flash_fwd_sm90", name=n, rows=r) for n, t, r in
            (("q", q, SM90_FWD_Q_ROWS[d]), ("k", k, SM90_FWD_KEY_ROWS[d]), ("v", v, SM90_FWD_KEY_ROWS[d]))]
    scale, out, lse = _fwd_outputs(q, scale)
    mode, bias_t, bias_sb, bias_sh = _bias_in_place("flash_fwd_sm90", bias, q, k)
    words = array.array("Q", maps[0].words() + maps[1].words() + maps[2].words() + (bias_sb, bias_sh))
    rc = _kernel("flash_fwd_sm90.cu", "uwu_flash_fwd_sm90", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_t.data_ptr() if bias_t is not None else None,
        out.data_ptr(), lse.data_ptr(),
        b, h, sq, k.shape[1], d, mode,
        words.buffer_info()[0], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_sm90_rc("flash_fwd_sm90", rc, maps)
    flash_fwd_sm90.launches += 1
    flash_fwd_sm90.head_dims[d] = flash_fwd_sm90.head_dims.get(d, 0) + 1
    return out, lse


flash_fwd_sm90.launches = 0
flash_fwd_sm90.head_dims = {}  # launches by head dim


def flash_fwd_mma(q, k, v, bias=None, scale=None):
    """Launch the mma.sync forward (D = 40/80/160), the yardstick of the
    Hopper one at SD1.5's head dims. Returns (out, lse)."""
    _check("flash_fwd_mma", MMA_HEAD_DIMS, ("q", q), ("k", k), ("v", v))
    b, sq, h, d = q.shape
    scale, out, lse = _fwd_outputs(q, scale)
    mode, bias_t = _bias_arg("flash_fwd_mma", bias, q, k)
    rc = _kernel("flash_fwd.cu", "uwu_flash_fwd", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_t.data_ptr() if bias_t is not None else None,
        out.data_ptr(), lse.data_ptr(),
        b, h, sq, k.shape[1], d, mode,
        ctypes.cast(_strides(q, k, v), ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd_mma launch failed: cudaError {rc}")
    flash_fwd_mma.launches += 1
    flash_fwd_mma.head_dims[d] = flash_fwd_mma.head_dims.get(d, 0) + 1
    return out, lse


flash_fwd_mma.launches = 0
flash_fwd_mma.head_dims = {}  # launches by head dim


def backward_kernels(d):
    """The backward's (dQ, dK/dV) wrappers for head dim ``d``: the Hopper
    kernels at every head dim in :data:`SM90_BWD_HEAD_DIMS`; any other
    raises. (K5, the dQ + dBias kernel, is mma.sync at every head dim.)"""
    if d in SM90_BWD_HEAD_DIMS:
        return flash_bwd_dq_sm90, flash_bwd_dkv_sm90
    raise ValueError(f"flash_bwd: head dim {d} not in {BWD_HEAD_DIMS}")


def flash_bwd_dq(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the dQ kernel (K4) for q's head dim (see
    :func:`backward_kernels`): ``dq`` [B, Sq, H, D] from the forward's
    ``lse`` and ``delta = rowsum(dO * O)``, both fp32 [B, H, Sq]."""
    return backward_kernels(q.shape[-1])[0](q, k, v, dout, lse, delta, bias, scale)


def flash_bwd_dkv(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the dK/dV kernel (K6) for q's head dim. Returns (dk, dv),
    each [B, Sk, H, D]."""
    return backward_kernels(q.shape[-1])[1](q, k, v, dout, lse, delta, bias, scale)


def sm90_bwd_box_rows(d, dkv):
    """(q and dout's box rows, k and v's) of the Hopper dQ kernel, or with
    ``dkv`` the dK/dV kernel, at head dim ``d``: an item's rows for the
    item's own inputs, a tile's for the streamed ones."""
    if dkv:
        return SM90_BWD_TILE_ROWS, SM90_BWD_DKV_ITEM_ROWS[d]
    return SM90_BWD_ITEM_ROWS, SM90_BWD_TILE_ROWS


def _bwd_sm90(who, q, k, v, dout, lse, delta, bias, scale, dkv):
    """What the two Hopper backward wrappers share: checks, tensor maps
    (boxes of an item's rows for the item's own inputs, q and dout for dQ,
    k and v for dK/dV with ``dkv``; of a tile's for the streamed ones), the
    bias in place, the C call's pointers before the outputs and its
    arguments after them. The C side reads the map specs from ``words``,
    which must outlive the call."""
    _check(who, SM90_BWD_HEAD_DIMS, ("q", q), ("k", k), ("v", v), ("dout", dout))
    q_rows, k_rows = sm90_bwd_box_rows(q.shape[-1], dkv)
    maps = [tma_map(t, who=who, name=n, rows=r, head_dims=SM90_BWD_HEAD_DIMS)
            for n, t, r in (("q", q, q_rows), ("k", k, k_rows), ("v", v, k_rows), ("dout", dout, q_rows))]
    b, sq, h, d = q.shape
    mode, bias_t, bias_sb, bias_sh = _bias_in_place(who, bias, q, k)
    lse, delta = _stats_arg(who, lse, q), _stats_arg(who, delta, q)
    words = array.array("Q", sum((m.words() for m in maps), ()) + (bias_sb, bias_sh))
    args = (b, h, sq, k.shape[1], d, mode, words.buffer_info()[0],
            float(scale if scale is not None else d**-0.5), torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_t.data_ptr() if bias_t is not None else None,
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    return maps, words, ptrs, args


def flash_bwd_dq_sm90(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the Hopper dQ kernel (K4, D = 40/64/80/128/160): q/k/v/dout go in
    uncopied through TMA tensor maps, a full bias is read in place."""
    maps, _words, ptrs, args = _bwd_sm90("flash_bwd_dq_sm90", q, k, v, dout, lse, delta, bias, scale, False)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _kernel("flash_bwd_sm90.cu", "uwu_flash_bwd_dq_sm90", 8)(*ptrs, dq.data_ptr(), *args)
    _check_sm90_rc("flash_bwd_dq_sm90", rc, maps)
    flash_bwd_dq_sm90.launches += 1
    flash_bwd_dq_sm90.head_dims[q.shape[-1]] = flash_bwd_dq_sm90.head_dims.get(q.shape[-1], 0) + 1
    return dq


flash_bwd_dq_sm90.launches = 0
flash_bwd_dq_sm90.head_dims = {}  # launches by head dim


def flash_bwd_dkv_sm90(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the Hopper dK/dV kernel (K6, D = 40/64/80/128/160). Returns (dk, dv)."""
    maps, _words, ptrs, args = _bwd_sm90("flash_bwd_dkv_sm90", q, k, v, dout, lse, delta, bias, scale, True)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    rc = _kernel("flash_bwd_sm90.cu", "uwu_flash_bwd_dkv_sm90", 9)(*ptrs, dk.data_ptr(), dv.data_ptr(), *args)
    _check_sm90_rc("flash_bwd_dkv_sm90", rc, maps)
    flash_bwd_dkv_sm90.launches += 1
    flash_bwd_dkv_sm90.head_dims[q.shape[-1]] = flash_bwd_dkv_sm90.head_dims.get(q.shape[-1], 0) + 1
    return dk, dv


flash_bwd_dkv_sm90.launches = 0
flash_bwd_dkv_sm90.head_dims = {}  # launches by head dim


def flash_bwd_dq_mma(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the mma.sync dQ kernel (K4, D = 160), the yardstick of the
    Hopper one there, on no path."""
    _check("flash_bwd_dq_mma", MMA_BWD_HEAD_DIMS, ("q", q), ("k", k), ("v", v), ("dout", dout))
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d**-0.5
    mode, bias_t = _bias_arg("flash_bwd_dq_mma", bias, q, k)
    lse, delta = _stats_arg("flash_bwd_dq_mma", lse, q), _stats_arg("flash_bwd_dq_mma", delta, q)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    rc = _kernel("flash_bwd.cu", "uwu_flash_bwd_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_t.data_ptr() if bias_t is not None else None,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, h, sq, k.shape[1], d, mode,
        ctypes.cast(_strides(q, k, v, dout), ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq_mma launch failed: cudaError {rc}")
    flash_bwd_dq_mma.launches += 1
    flash_bwd_dq_mma.head_dims[d] = flash_bwd_dq_mma.head_dims.get(d, 0) + 1
    return dq


flash_bwd_dq_mma.launches = 0
flash_bwd_dq_mma.head_dims = {}  # launches by head dim


def flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale=None):
    """Launch the dQ + dBias kernel (K5) for a learned bias, taken as full.
    Returns (dq [B, Sq, H, D], dbias [B*H, Sq, Sk] fp32, natural-log units)."""
    _check("flash_bwd_dq_dbias", BWD_HEAD_DIMS, ("q", q), ("k", k), ("v", v), ("dout", dout))
    if bias is None:
        raise ValueError("flash_bwd_dq_dbias: needs a bias")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d**-0.5
    mode, bias_t = _bias_arg("flash_bwd_dq_dbias", bias, q, k, full=True)
    lse, delta = _stats_arg("flash_bwd_dq_dbias", lse, q), _stats_arg("flash_bwd_dq_dbias", delta, q)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dbias = torch.empty((b * h, sq, sk), dtype=torch.float32, device=q.device)
    rc = _kernel("flash_bwd.cu", "uwu_flash_bwd_dq_dbias", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_t.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dbias.data_ptr(),
        b, h, sq, sk, d, mode,
        ctypes.cast(_strides(q, k, v, dout), ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq_dbias launch failed: cudaError {rc}")
    flash_bwd_dq_dbias.launches += 1
    return dq, dbias


flash_bwd_dq_dbias.launches = 0


def flash_bwd_dkv_mma(q, k, v, dout, lse, delta, bias=None, scale=None):
    """Launch the mma.sync dK/dV kernel (K6, D = 160), the yardstick of the
    Hopper one there, on no path. Returns (dk, dv)."""
    _check("flash_bwd_dkv_mma", MMA_BWD_HEAD_DIMS, ("q", q), ("k", k), ("v", v), ("dout", dout))
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d**-0.5
    mode, bias_t = _bias_arg("flash_bwd_dkv_mma", bias, q, k)
    lse, delta = _stats_arg("flash_bwd_dkv_mma", lse, q), _stats_arg("flash_bwd_dkv_mma", delta, q)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    fn = _kernel("flash_bwd.cu", "uwu_flash_bwd_dkv", 9)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias_t.data_ptr() if bias_t is not None else None,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, sq, sk, d, mode,
        ctypes.cast(_strides(q, k, v, dout), ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv_mma launch failed: cudaError {rc}")
    flash_bwd_dkv_mma.launches += 1
    flash_bwd_dkv_mma.head_dims[d] = flash_bwd_dkv_mma.head_dims.get(d, 0) + 1
    return dk, dv


flash_bwd_dkv_mma.launches = 0
flash_bwd_dkv_mma.head_dims = {}  # launches by head dim


def flash_bwd(q, k, v, bias, out, lse, dout, scale=None, bias_grad=False, dlse=None):
    """The backward kernels on CUDA tensors: ``delta = rowsum(dO * O)``
    (PyTorch; ``- dlse``, the lse's cotangent, when there is one), then K4
    (K5 with ``bias_grad`` and a bias) and K6. Returns (dq, dk, dv, dbias):
    dbias ``[B, H, Sq, Sk]`` fp32 from K5, else None."""
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    dbias = None
    if bias_grad and bias is not None:
        dq, dbias = flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale)
        dbias = dbias.view(q.shape[0], q.shape[2], q.shape[1], k.shape[1])
    else:
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, bias, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, bias, scale)
    return dq, dk, dv, dbias


def _forward(q, k, v, bias, scale):
    if q.is_cuda:
        return flash_fwd(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale)
    raise ValueError(f"flash attention: unsupported device {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the flash kernels on both sides: the forward (K1)
    saves ``q, k, v, out, lse``; the backward recomputes P from the lse
    (K4 + K6, or K5 + K6 when the bias's own gradient is asked for). Both
    outputs are differentiable: the lse's cotangent folds into delta. CPU
    tensors take the plain versions. The bias gets a gradient only with
    ``bias_grad``."""

    @staticmethod
    def forward(ctx, q, k, v, bias=None, scale=None, bias_grad=False):
        out, lse = _forward(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.bias_grad = scale, bias_grad
        ctx.set_materialize_grads(False)  # an unused lse's cotangent stays None: no zeros, no subtraction
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if dout is None:  # a loss on the lse alone
            dout = torch.zeros_like(out)
        with_dbias = ctx.bias_grad and bias is not None and ctx.needs_input_grad[3]
        if q.is_cuda:
            dq, dk, dv, dbias = flash_bwd(q, k, v, bias, out, lse, dout, ctx.scale, with_dbias, dlse)
        else:
            dq, dk, dv, dbias = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, ctx.scale, dlse)
        dbias = dbias.sum_to_size(bias.shape).to(bias.dtype) if with_dbias else None
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, bias=None, scale=None, return_lse=False, bias_grad=False):
    """Differentiable flash attention: the kernels for CUDA tensors, the
    plain versions for CPU tensors. Without gradients it is the forward
    alone, outside autograd. The lse, if returned, is differentiable too.
    ``bias_grad=True`` makes the bias a learned one (the JAX function's
    contract; not with ``return_lse``); K5 then runs only where autograd
    keeps the bias's gradient."""
    if bias_grad and return_lse:
        raise NotImplementedError("bias_grad with return_lse is unsupported")
    wants_grad = q.requires_grad or k.requires_grad or v.requires_grad
    if bias_grad and bias is not None:
        wants_grad = wants_grad or bias.requires_grad
    if torch.is_grad_enabled() and wants_grad:
        out, lse = FlashAttentionFunction.apply(q, k, v, bias, scale, bias_grad)
    else:
        out, lse = _forward(q, k, v, bias, scale)
    return (out, lse) if return_lse else out
