"""GroupNorm (+ SiLU): the hand-written CUDA kernels and their plain versions.

Replaces ``uwudiff_tpu/ops/groupnorm_silu.py``: the forward kernels
``_gn_silu_kernel`` (K2) and ``_gn_stats_kernel`` (K3) and the backward
kernels ``_gn_bwd_partials_kernel`` (K7) and ``_gn_bwd_dx_kernel`` (K8).
As the TPU chose between its two forward kernels by VMEM fit, the forward
takes one of two routes, chosen up front from the shape by
:func:`plan_gn` (a pure function of it; a route that fails raises, it
never falls back to the other):

- fused (K2, ``csrc/groupnorm_silu_sm90.cu``): :func:`gn_silu_fused`, one
  launch that keeps each (sample, channel slab) tile in the shared memory
  of a thread-block cluster, takes the group statistics there (exchanged
  across the cluster through distributed shared memory) and writes
  ``y = silu((x - mean) * inv * gamma + beta)``: x read once, y written
  once;
- chunked (K3 and the apply, ``csrc/groupnorm_silu.cu``), for tiles that
  do not fit 16 blocks' shared memory: :func:`gn_stats`, one launch of
  per-(n, group) statistics over ``[N, HW, C]`` -> per-(n, channel)
  ``scale = inv*gamma`` and ``shift = beta - mean*scale`` (and, for the
  backward, the per-group mean and inv); then :func:`gn_silu_apply`,
  ``y = silu(x*scale + shift)`` elementwise (the XLA apply of the JAX
  package's ``_gn_silu_fwd_chunked``).

The backward takes one of two routes the same way, chosen by
:func:`plan_gn_bwd` (the forward's rules applied to the x and dy tiles
together):

- fused (``csrc/groupnorm_silu_bwd_sm90.cu``): :func:`gn_silu_bwd_fused`,
  one launch that keeps each (sample, slab) tile of x and of the incoming
  gradient in a cluster's shared memory, takes the per-channel
  ``t1 = sum dz`` and ``t2 = sum dz*xhat`` (``dz = g*silu'(z)``) and the
  two group means of the GN backward there, and writes
  ``dx = inv*(gamma*dz - a - xhat*b)``: x and g read once, dx written once;
- pair (K7 then K8, ``csrc/groupnorm_silu.cu``), for tiles that do not fit:
  :func:`gn_bwd_partials`, one launch of the per-channel sums whose last
  merge also writes the coefficients of :func:`gn_bwd_dx`,
  ``dx = scale*dz + P*x + Q`` (the group means folded into ``P``, ``Q``).

Either way ``dbeta = sum_n t1`` and ``dgamma = sum_n t2`` are one small
reduction of the kernel's fp32 ``[N, 2, C]``.

:class:`GroupNormSiLUFunction` ties them together for autograd. It saves
``x``, ``gamma`` and the forward's ``[N, C]``/``[N, G]`` fp32 statistics
(either route writes them), never a full-size fp32 intermediate, so the
TPU backward's pass A (stats recomputed) is not needed.

Layout contract (the JAX function's): ``x`` is ``[N, H, W, C]`` or
``[N, S, C]``, channels last and contiguous; ``gamma``/``beta`` ``[C]``,
fp32 or bf16 (both the same), read in their own dtype by the kernels.
The kernels run at any HW and any ``C % groups == 0`` with 16-byte rows;
the TPU's ``_chunk_for``/``_tile_fits_vmem`` gates were VMEM artifacts.
``silu=False`` gives the plain GroupNorm that the transformer and VAE
attention norms use, through the same kernels (``dz = g``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = [
    "GnPlan",
    "GroupNormSiLUFunction",
    "gn_bwd_dx",
    "gn_bwd_dx_reference",
    "gn_bwd_partials",
    "gn_bwd_partials_reference",
    "gn_map_spec",
    "gn_silu_apply",
    "gn_silu_apply_reference",
    "gn_silu_bwd_fused",
    "gn_silu_bwd_fused_reference",
    "gn_silu_fused",
    "gn_stats",
    "gn_stats_reference",
    "group_norm_silu",
    "group_norm_silu_reference",
    "plan_gn",
    "plan_gn_bwd",
]

_SOURCE = "groupnorm_silu.cu"
_SM90_SOURCE = "groupnorm_silu_sm90.cu"
_SM90_BWD_SOURCE = "groupnorm_silu_bwd_sm90.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECS = 256 * 3  # threads x vector columns per thread in the chunked kernels
_ENCODE_FAILED = 100000  # the C side's code for a tensor map the driver refused (+ its CUresult)

# the fused kernels' limits, as csrc/groupnorm_silu_sm90.cu and
# csrc/groupnorm_silu_bwd_sm90.cu state them (the backward's tile is x's and
# dy's together)
MAX_BOX_ROWS = 256  # a TMA box dim holds at most 256 elements
MAX_BOXES = 64  # boxes (and mbarriers) of one block
MAX_SLAB = 256  # channels of a slab: one box's inner dim
MAX_SLAB_GROUPS = 8  # groups of a slab
MAX_CLUSTER = 16  # blocks of a cluster (over 8 is non-portable; the H100 takes 16)
TILE_MAX = 208896  # bytes of a block's tile: 227 KB less the kernel's static buffers
TILE_TWO_PER_SM = 92160  # bytes of a tile that lets two blocks share an SM
SMS = 132  # the H100 SXM's SMs: the plan fills them where the rows allow it
MIN_ROWS = 64  # rows a block keeps at least when the plan adds blocks to fill the card
_fns: dict = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from uwudiff_tpu_torch.ops._build import library

        source = {"uwu_gn_silu_fused": _SM90_SOURCE, "uwu_gn_silu_bwd_fused": _SM90_BWD_SOURCE}.get(name, _SOURCE)
        fn = getattr(library(source), name)
        fn.restype = ctypes.c_int
        if name == "uwu_gn_silu_fused":
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        elif name == "uwu_gn_silu_bwd_fused":
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        elif name == "uwu_gn_stats":
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
        elif name == "uwu_gn_bwd_partials":
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        else:  # uwu_gn_apply, uwu_gn_bwd_dx
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _fns[name] = fn
    return fn


class GnPlan(NamedTuple):
    """The route of one GroupNorm shape. ``route`` is ``"fused"`` (one
    launch: K2 forward, :func:`gn_silu_bwd_fused` backward), ``"chunked"``
    (the forward's K3 + the apply) or ``"pair"`` (the backward's K7 + K8);
    for ``"fused"``: ``slab`` channels (whole groups, a 16-byte multiple)
    per work unit, ``cluster`` blocks per (sample, slab), each holding
    ``rows_per_cta`` rows in ``rows_per_cta // box_rows`` TMA boxes of
    ``box_rows`` rows, ``tile_bytes`` of shared memory for them (x's, and
    the gradient's in the backward)."""

    route: str
    slab: int = 0
    cluster: int = 0
    rows_per_cta: int = 0
    box_rows: int = 0
    tile_bytes: int = 0


_CHUNKED = GnPlan("chunked")
_PAIR = GnPlan("pair")


def _cta_rows(hw, cluster):
    """(rows_per_cta, box_rows): ceil(hw / cluster) rows in the fewest boxes
    of at most MAX_BOX_ROWS rows, each a multiple of 8 rows (a box then
    starts 128-byte aligned in shared memory, as TMA needs)."""
    want = -(-hw // cluster)
    boxes = -(-want // MAX_BOX_ROWS)
    box = -(-want // boxes)
    box = -(-box // 8) * 8
    return boxes * box, box


def _plan(n, hw, c, groups, dtype, tiles, other):
    """The fused route's plan for ``tiles`` tiles a block (1: the forward's
    x; 2: the backward's x and dy), or ``other``; see :func:`plan_gn`."""
    if dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu takes fp32 or bf16, got {dtype}")
    if c % groups:
        raise ValueError(f"group_norm_silu: C={c} not divisible by groups={groups}")
    es = 2 if dtype == torch.bfloat16 else 4
    cg = c // groups
    gps = next((k for k in range(1, MAX_SLAB_GROUPS + 1) if groups % k == 0 and k * cg * es % 16 == 0), None)
    if gps is None or gps * cg > MAX_SLAB or n * hw == 0:
        return other
    slab = gps * cg
    fits = []
    for cluster in (1, 2, 4, 8, MAX_CLUSTER):
        rows, box = _cta_rows(hw, cluster)
        tile = tiles * rows * slab * es
        if tile <= TILE_MAX and rows // box <= MAX_BOXES:
            fits.append(GnPlan("fused", slab, cluster, rows, box, tile))
    if not fits:
        return other
    units = n * (groups // gps)
    if units * fits[0].cluster > SMS:
        # several waves: only tiles that let two blocks share an SM; with one
        # block an SM nothing overlaps its load, statistics and store, and the
        # chunked pair is faster (PERF.md, §6)
        return next((p for p in fits if p.tile_bytes <= TILE_TWO_PER_SM), other)
    plan = fits[0]
    for p in fits[1:]:
        if units * plan.cluster < SMS // 2 and -(-hw // p.cluster) >= MIN_ROWS:
            plan = p
    return plan


@functools.lru_cache(maxsize=4096)
def plan_gn(n: int, hw: int, c: int, groups: int, dtype: torch.dtype) -> GnPlan:
    """The forward's route for ``[n, hw, c]`` in ``dtype`` with ``groups``
    groups, a pure function of the shape (the TPU chose by VMEM fit).

    The slab is the fewest whole groups whose width is a multiple of 16
    bytes. The shape takes the fused kernel when a (sample, slab) tile fits
    a cluster of at most MAX_CLUSTER blocks of TILE_MAX bytes each and
    either the smallest such cluster's grid is one wave of one block an SM,
    or a cluster's tiles let two blocks share an SM (TILE_TWO_PER_SM), so
    that one block's stores overlap the other's loads; any other shape
    takes the chunked pair. The cluster: a larger one costs more than its
    share (barriers, remote reads, co-scheduling), so in a one-wave grid
    the smallest that fits (doubled while the grid fills fewer than half
    the SMS and each block keeps MIN_ROWS rows), else the smallest whose
    tiles fit TILE_TWO_PER_SM."""
    return _plan(n, hw, c, groups, dtype, 1, _CHUNKED)


@functools.lru_cache(maxsize=4096)
def plan_gn_bwd(n: int, hw: int, c: int, groups: int, dtype: torch.dtype) -> GnPlan:
    """The backward's route for ``[n, hw, c]``: :func:`plan_gn`'s slab,
    cluster and wave rules applied to a block's x and dy tiles together
    (``tile_bytes`` is both), giving ``"fused"`` (:func:`gn_silu_bwd_fused`,
    one launch) or ``"pair"`` (:func:`gn_bwd_partials`, then
    :func:`gn_bwd_dx`). A pure function of the shape; neither route falls
    back to the other."""
    return _plan(n, hw, c, groups, dtype, 2, _PAIR)


def gn_map_spec(n, hw, c, plan, dtype):
    """The rank-3 TMA map geometry of a ``[n, hw, c]`` tensor for the fused
    kernel, innermost first: dims (C, HW, N) in elements, strides of HW
    and N in bytes, box (slab, box_rows, 1). Raises ValueError for a shape
    TMA cannot take."""
    es = 2 if dtype == torch.bfloat16 else 4
    dims, strides, box = (c, hw, n), (c * es, hw * c * es), (plan.slab, plan.box_rows, 1)
    if max(dims) >= 2**32 or strides[1] >= 2**40 or strides[0] % 16:
        raise ValueError(f"gn_silu_fused: [{n}, {hw}, {c}] {dtype} is out of TMA's range")
    return dims + strides + box


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


def gn_stats_reference(x3, gamma, beta, groups: int, eps: float, with_group_stats: bool = False):
    """Plain version of :func:`gn_stats`: (scale, shift), fp32 [N, C], and
    with ``with_group_stats`` also (mean, inv), fp32 [N, G]."""
    n, _, c = x3.shape
    xr = x3.reshape(n, -1, groups, c // groups).float()
    mean = xr.mean(dim=(1, 3))
    inv = torch.rsqrt(xr.var(dim=(1, 3), unbiased=False) + eps)
    gs = c // groups
    scale = inv.repeat_interleave(gs, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(gs, dim=1) * scale
    return (scale, shift, mean, inv) if with_group_stats else (scale, shift)


def gn_silu_apply_reference(x3, scale, shift, silu: bool = True):
    """Plain version of :func:`gn_silu_apply`."""
    z = x3.float() * scale[:, None, :] + shift[:, None, :]
    return (F.silu(z) if silu else z).to(x3.dtype)


def _silu_dz(x, g, scale, shift):
    """dz of ``y = silu(z)``, ``z = x*scale + shift``, in fp32."""
    z = x * scale + shift
    sig = torch.sigmoid(z)
    return g * sig * (1.0 + z * (1.0 - sig))


def _bwd_reference(x3, g3, gamma, scale, shift, mean, inv, silu):
    """The backward's arithmetic in fp32 from the forward's statistics:
    (dz, xhat, inv per channel [N, 1, C], t = (sum dz, sum dz*xhat)
    [N, 2, C], the group means (a, b) of gamma*dz and gamma*dz*xhat per
    channel [N, 2, C])."""
    n, hw, c = x3.shape
    groups = mean.shape[1]
    gs = c // groups
    x, g = x3.float(), g3.float()
    inv_c = inv.float().repeat_interleave(gs, dim=1)[:, None]
    xhat = (x - mean.float().repeat_interleave(gs, dim=1)[:, None]) * inv_c
    dz = _silu_dz(x, g, scale[:, None], shift[:, None]) if silu else g
    t = torch.stack([dz.sum(1), (dz * xhat).sum(1)], dim=1)
    ab = (gamma.float() * t).view(n, 2, groups, gs).sum(-1) / (hw * gs)
    return dz, xhat, inv_c, t, ab.repeat_interleave(gs, dim=2)


def gn_silu_bwd_fused_reference(x3, g3, gamma, scale, shift, mean, inv, silu: bool = True):
    """Plain version of :func:`gn_silu_bwd_fused` (and of the whole
    backward): from the forward's fp32 scale/shift [N, C] and mean/inv
    [N, G], returns ``dx = inv*(gamma*dz - a - xhat*b)`` in x's dtype and
    fp32 ``t`` [N, 2, C] = (t1 = sum_hw dz, t2 = sum_hw dz*xhat)."""
    dz, xhat, inv_c, t, ab = _bwd_reference(x3, g3, gamma, scale, shift, mean, inv, silu)
    dx = inv_c * (gamma.float() * dz - ab[:, :1] - xhat * ab[:, 1:])
    return dx.to(x3.dtype), t


def gn_bwd_partials_reference(x3, g3, gamma, scale, shift, mean, inv, silu: bool = True):
    """Plain version of :func:`gn_bwd_partials`: fp32 ``t`` [N, 2, C] as
    :func:`gn_silu_bwd_fused_reference` gives it, and ``coef`` [N, 4, C] =
    (scale, shift, P, Q) with ``dx = scale*dz + P*x + Q``, the two group
    means folded into ``P = -inv^2 b`` and ``Q = -inv (a - b mean inv)``."""
    _, _, _, t, ab = _bwd_reference(x3, g3, gamma, scale, shift, mean, inv, silu)
    gs = x3.shape[-1] // mean.shape[1]
    inv_c = inv.float().repeat_interleave(gs, dim=1)
    nmi_c = -mean.float().repeat_interleave(gs, dim=1) * inv_c
    p = -inv_c * inv_c * ab[:, 1]
    q = -inv_c * (ab[:, 0] + ab[:, 1] * nmi_c)
    return t, torch.stack([scale, shift, p, q], dim=1)


def gn_bwd_dx_reference(x3, g3, coef, silu: bool = True):
    """Plain version of :func:`gn_bwd_dx`: ``coef`` [N, 4, C] holds
    (scale, shift, P, Q); returns ``scale*dz + P*x + Q`` in x's dtype."""
    x, g = x3.float(), g3.float()
    sc, sh, p, q = (coef[:, i, None, :] for i in range(4))
    dz = _silu_dz(x, g, sc, sh) if silu else g
    return (sc * dz + (p * x + q)).to(x3.dtype)


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


def _affine_arg(who, gamma, beta, x3):
    """-> 1 for bf16 gamma/beta, 0 for fp32: both [C], contiguous, on x's
    device and of one dtype (the kernels read them as they are)."""
    c = x3.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x3.device:
            raise ValueError(f"{who}: {name} must be a contiguous [C] on x's device")
    if gamma.dtype != beta.dtype or gamma.dtype not in _DTYPES:
        raise TypeError(f"{who}: gamma/beta must both be fp32 or both bf16, got {gamma.dtype}, {beta.dtype}")
    return _DTYPES[gamma.dtype]


_MERGE_SET = 64  # chunks whose partials one block of gn_stats / gn_bwd_partials merges (csrc/groupnorm_silu.cu::MERGE_SET)
_counters: dict = {}  # (device, stream) -> int32 zeros that gn_stats's (and K7's) last blocks leave zero


def _counter(x3, size):
    """At least ``size`` of gn_stats's arrival counters: zeros on x's
    device, one buffer per stream (the block that arrives last at a
    counter resets it to zero)."""
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    key = (x3.device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(1024, size), dtype=torch.int32, device=x3.device)
        _counters[key] = buf
    return buf, stream


def gn_stats(x3, gamma, beta, groups: int, eps: float, with_group_stats: bool = False):
    """Launch the stats kernel (K3, one launch) on ``x3`` [N, HW, C].
    Returns fp32 (scale, shift) [N, C] with ``scale = inv*gamma``,
    ``shift = beta - mean*scale``, and with ``with_group_stats`` also
    (mean, inv), fp32 [N, G]."""
    _check_x3(x3, "gn_stats")
    n, hw, c = x3.shape
    if c % groups:
        raise ValueError(f"gn_stats: C={c} not divisible by groups={groups}")
    affine_bf16 = _affine_arg("gn_stats", gamma, beta, x3)
    # >= 64 rows per chunk keeps the partials a few percent of x's bytes;
    # ~2048 (n, chunk) blocks keep all SMs busy even at N = 1
    n_chunks = max(1, min(math.ceil(hw / 64), math.ceil(2048 / n)))
    n_sets = -(-n_chunks // _MERGE_SET)
    partial = torch.empty((n, n_chunks, 2, c), dtype=torch.float32, device=x3.device)
    merged = torch.empty((n, n_sets, 2, c), dtype=torch.float64, device=x3.device)
    scale = torch.empty((n, c), dtype=torch.float32, device=x3.device)
    shift = torch.empty((n, c), dtype=torch.float32, device=x3.device)
    stats = (torch.empty((n, 2, groups), dtype=torch.float32, device=x3.device)
             if with_group_stats else None)
    counter, stream = _counter(x3, n * (n_sets + 1))
    rc = _kernel("uwu_gn_stats")(
        x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(), merged.data_ptr(), counter.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), stats.data_ptr() if stats is not None else None,
        _DTYPES[x3.dtype], affine_bf16, n, hw, c, groups, n_chunks, float(eps), stream,
    )
    if rc != 0:
        raise RuntimeError(f"gn_stats launch failed: cudaError {rc}")
    gn_stats.launches += 1
    return (scale, shift, stats[:, 0], stats[:, 1]) if with_group_stats else (scale, shift)


gn_stats.launches = 0


def gn_silu_apply(x3, scale, shift, silu: bool = True):
    """Launch ``y = silu(x*scale + shift)`` (or the affine alone) on ``x3`` [N, HW, C]."""
    _check_x3(x3, "gn_silu_apply")
    n, hw, c = x3.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or t.shape != (n, c) or not t.is_contiguous()
                or t.device != x3.device or t.data_ptr() % 16):
            raise ValueError(f"gn_silu_apply: {name} must be contiguous, aligned fp32 [N, C] on x's device")
    _check_offsets(x3, "gn_silu_apply")
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

@functools.lru_cache(maxsize=4096)
def _fused_plan(n, hw, c, groups, dtype):
    """(plan, the map spec as a ctypes array) of a fused shape, checked once."""
    plan = plan_gn(n, hw, c, groups, dtype)
    if plan.route != "fused":
        raise ValueError(f"gn_silu_fused: [{n}, {hw}, {c}] {dtype} does not fit a cluster's shared memory;"
                         " plan_gn routes it to gn_stats + gn_silu_apply")
    words = gn_map_spec(n, hw, c, plan, dtype)
    return plan, (ctypes.c_ulonglong * len(words))(*words)


def gn_silu_fused(x3, gamma, beta, groups: int, eps: float, silu: bool = True, with_stats: bool = False):
    """Launch the single-pass kernel (K2) on ``x3`` [N, HW, C]: the group
    statistics from a cluster's shared memory, then ``y = silu((x - mean) *
    inv * gamma + beta)`` (or the affine alone). Returns y, and with
    ``with_stats`` (y, (scale, shift, mean, inv)): fp32 [N, C] scale/shift
    and [N, G] mean/inv, as :func:`gn_stats` gives them. Raises for a shape
    that :func:`plan_gn` routes to the chunked pair."""
    _check_x3(x3, "gn_silu_fused")
    affine_bf16 = _affine_arg("gn_silu_fused", gamma, beta, x3)
    n, hw, c = x3.shape
    plan, spec = _fused_plan(n, hw, c, groups, x3.dtype)
    y = torch.empty_like(x3)
    scale = shift = stats = None
    if with_stats:
        scale = torch.empty((n, c), dtype=torch.float32, device=x3.device)
        shift = torch.empty((n, c), dtype=torch.float32, device=x3.device)
        stats = torch.empty((n, 2, groups), dtype=torch.float32, device=x3.device)
    rc = _kernel("uwu_gn_silu_fused")(
        x3.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        None if stats is None else stats.data_ptr(), spec, _DTYPES[x3.dtype], affine_bf16, n, hw, c, groups,
        plan.slab, plan.cluster, plan.rows_per_cta, plan.box_rows, float(eps), int(silu),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"gn_silu_fused: the driver refused a tensor map (CUresult {rc - _ENCODE_FAILED},"
                           f" {_ENCODE_FAILED} if cuTensorMapEncodeTiled was not found): {list(spec)}")
    if rc != 0:
        raise RuntimeError(f"gn_silu_fused launch failed: cudaError {rc} ({plan})")
    gn_silu_fused.launches += 1
    return (y, (scale, shift, stats[:, 0], stats[:, 1])) if with_stats else y


gn_silu_fused.launches = 0


def _check_coef(coef, x3, who):
    n, _, c = x3.shape
    if (coef.dtype != torch.float32 or coef.shape != (n, 4, c) or not coef.is_contiguous()
            or coef.device != x3.device or coef.data_ptr() % 16):
        raise ValueError(f"{who}: coef must be a contiguous, aligned fp32 [N, 4, C] on x's device")


def _check_g3(g3, x3, who):
    _check_x3(g3, who)
    if g3.shape != x3.shape or g3.dtype != x3.dtype or g3.device != x3.device:
        raise ValueError(f"{who}: g {tuple(g3.shape)} {g3.dtype} does not match x "
                         f"{tuple(x3.shape)} {x3.dtype}")


def _check_saved(who, x3, g3, gamma, scale, shift, mean, inv):
    """Checks what a backward kernel reads; returns (gamma's dtype code,
    the row stride of mean/inv [N, G], which may be views of the forward's
    [N, 2, G])."""
    _check_x3(x3, who)
    _check_g3(g3, x3, who)
    n, _, c = x3.shape
    dev = x3.device
    affine_bf16 = _affine_arg(who, gamma, gamma, x3)
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or t.shape != (n, c) or not t.is_contiguous()
                or t.device != dev or t.data_ptr() % 16):
            raise ValueError(f"{who}: {name} must be contiguous, aligned fp32 [N, C] on x's device")
    groups = mean.shape[-1]
    stride = mean.stride()
    if (mean.dtype != torch.float32 or inv.dtype != torch.float32 or mean.shape != (n, groups)
            or inv.shape != (n, groups) or stride[-1] != 1 or inv.stride() != stride or mean.device != dev
            or inv.device != dev or c % groups):
        raise ValueError(f"{who}: mean/inv must be fp32 [N, G] rows of one stride on x's device, G dividing C")
    return affine_bf16, stride[0]


def _check_offsets(x3, who):
    n, hw, c = x3.shape
    if hw * c // (16 // x3.element_size()) >= 2**31:
        raise ValueError(f"{who}: a sample of {hw}x{c} is past the kernel's 32-bit offsets")


@functools.lru_cache(maxsize=4096)
def _fused_bwd_plan(n, hw, c, groups, dtype):
    """(plan, the map spec as a ctypes array) of a fused backward shape, checked once."""
    plan = plan_gn_bwd(n, hw, c, groups, dtype)
    if plan.route != "fused":
        raise ValueError(f"gn_silu_bwd_fused: [{n}, {hw}, {c}] {dtype} does not fit a cluster's shared memory;"
                         " plan_gn_bwd routes it to gn_bwd_partials + gn_bwd_dx")
    words = gn_map_spec(n, hw, c, plan, dtype)
    return plan, (ctypes.c_ulonglong * len(words))(*words)


def gn_silu_bwd_fused(x3, g3, gamma, scale, shift, mean, inv, silu: bool = True):
    """Launch the single-pass backward on ``x3`` and the incoming gradient
    ``g3`` [N, HW, C], from the forward's fp32 scale/shift [N, C] and
    mean/inv [N, G]. Returns (dx in x's dtype, fp32 ``t`` [N, 2, C] = (t1 =
    sum_hw dz, t2 = sum_hw dz*xhat)): dbeta and dgamma are ``t.sum(0)``.
    Raises for a shape that :func:`plan_gn_bwd` routes to the pair."""
    affine_bf16, stat_stride = _check_saved("gn_silu_bwd_fused", x3, g3, gamma, scale, shift, mean, inv)
    n, hw, c = x3.shape
    groups = mean.shape[1]
    plan, spec = _fused_bwd_plan(n, hw, c, groups, x3.dtype)
    dx = torch.empty_like(x3)
    t = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    rc = _kernel("uwu_gn_silu_bwd_fused")(
        x3.data_ptr(), g3.data_ptr(), dx.data_ptr(), gamma.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), t.data_ptr(), spec, _DTYPES[x3.dtype], affine_bf16, n, hw, c, groups,
        stat_stride, plan.slab, plan.cluster, plan.rows_per_cta, plan.box_rows, int(silu),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"gn_silu_bwd_fused: the driver refused a tensor map (CUresult {rc - _ENCODE_FAILED},"
                           f" {_ENCODE_FAILED} if cuTensorMapEncodeTiled was not found): {list(spec)}")
    if rc != 0:
        raise RuntimeError(f"gn_silu_bwd_fused launch failed: cudaError {rc} ({plan})")
    gn_silu_bwd_fused.launches += 1
    return dx, t


gn_silu_bwd_fused.launches = 0


def gn_bwd_partials(x3, g3, gamma, scale, shift, mean, inv, silu: bool = True):
    """Launch the backward's sums (K7, one launch) on ``x3``, ``g3``
    [N, HW, C] from the forward's fp32 scale/shift [N, C] and mean/inv
    [N, G]. Returns fp32 ``t`` [N, 2, C] (t1 = sum_hw dz, t2 = sum_hw
    dz*xhat) and ``coef`` [N, 4, C] = (scale, shift, P, Q) for
    :func:`gn_bwd_dx`, the group means of the GN backward folded in."""
    affine_bf16, stat_stride = _check_saved("gn_bwd_partials", x3, g3, gamma, scale, shift, mean, inv)
    _check_offsets(x3, "gn_bwd_partials")
    n, hw, c = x3.shape
    groups = mean.shape[1]
    # >= 64 rows a chunk, ~2 blocks an SM over the grid: longer chunks where HW is large
    n_chunks = max(1, min(math.ceil(hw / 64), math.ceil(2 * SMS / n)))
    n_sets = -(-n_chunks // _MERGE_SET)
    partial = torch.empty((n, n_chunks, 2, c), dtype=torch.float32, device=x3.device)
    merged = torch.empty((n, n_sets, 2, c), dtype=torch.float64, device=x3.device)
    t = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    coef = torch.empty((n, 4, c), dtype=torch.float32, device=x3.device)
    counter, stream = _counter(x3, n * (n_sets + 1))
    rc = _kernel("uwu_gn_bwd_partials")(
        x3.data_ptr(), g3.data_ptr(), gamma.data_ptr(), scale.data_ptr(), shift.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), partial.data_ptr(), merged.data_ptr(), counter.data_ptr(), t.data_ptr(), coef.data_ptr(),
        _DTYPES[x3.dtype], affine_bf16, stat_stride, n, hw, c, groups, n_chunks, int(silu), stream,
    )
    if rc != 0:
        raise RuntimeError(f"gn_bwd_partials launch failed: cudaError {rc}")
    gn_bwd_partials.launches += 1
    return t, coef


gn_bwd_partials.launches = 0


def gn_bwd_dx(x3, g3, coef, silu: bool = True):
    """Launch the dx kernel (K8): ``dx = scale*dz + P*x + Q`` over
    ``x3``, ``g3`` [N, HW, C] with ``coef`` [N, 4, C] = (scale, shift, P, Q)."""
    _check_x3(x3, "gn_bwd_dx")
    _check_g3(g3, x3, "gn_bwd_dx")
    _check_coef(coef, x3, "gn_bwd_dx")
    _check_offsets(x3, "gn_bwd_dx")
    n, hw, c = x3.shape
    dx = torch.empty_like(x3)
    rc = _kernel("uwu_gn_bwd_dx")(
        x3.data_ptr(), g3.data_ptr(), coef.data_ptr(), dx.data_ptr(),
        _DTYPES[x3.dtype], n, hw, c, int(silu),
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gn_bwd_dx launch failed: cudaError {rc}")
    gn_bwd_dx.launches += 1
    return dx


gn_bwd_dx.launches = 0


def _gn_backward(x3, g3, gamma, scale, shift, mean, inv, silu):
    """dx, dgamma, dbeta (fp32) of GroupNorm(+SiLU) from the forward's
    statistics: for a CUDA ``x3`` the route :func:`plan_gn_bwd` picks (the
    fused kernel, or K7 then K8), for a CPU one the plain version; then
    one reduction of the per-sample sums."""
    saved = (gamma, scale, shift, mean, inv)
    if not x3.is_cuda:
        dx, t = gn_silu_bwd_fused_reference(x3, g3, *saved, silu)
    elif plan_gn_bwd(*x3.shape, mean.shape[1], x3.dtype).route == "fused":
        dx, t = gn_silu_bwd_fused(x3, g3, *saved, silu)
    else:
        t, coef = gn_bwd_partials(x3, g3, *saved, silu)
        dx = gn_bwd_dx(x3, g3, coef, silu)
    sums = t.sum(0)
    return dx, sums[1], sums[0]


def _forward(x, gamma, beta, groups, eps, silu, with_group_stats):
    """(y, stats): for a CUDA ``x`` the route :func:`plan_gn` picks (the
    fused kernel, or the stats kernel and the apply), for a CPU one the
    plain version; ``stats`` is (scale, shift, mean, inv) with
    ``with_group_stats``."""
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])  # a view: CUDA x is contiguous
    if x.is_cuda:
        n, hw, c = x3.shape
        if plan_gn(n, hw, c, groups, x3.dtype).route == "fused":
            out = gn_silu_fused(x3, gamma, beta, groups, eps, silu, with_group_stats)
            y, stats = out if with_group_stats else (out, ())
            return y.view(x.shape), stats
        stats = gn_stats(x3, gamma, beta, groups, eps, with_group_stats)
        return gn_silu_apply(x3, stats[0], stats[1], silu).view(x.shape), stats
    y = group_norm_silu_reference(x, gamma, beta, groups, eps, silu)
    return y, (gn_stats_reference(x3, gamma, beta, groups, eps, with_group_stats) if with_group_stats else ())


class GroupNormSiLUFunction(torch.autograd.Function):
    """GroupNorm(+SiLU) over a contiguous channels-last ``x`` with the
    kernels on both sides (CPU tensors take the plain versions).

    The incoming gradient must be channels-last too; one that is not is
    copied with ``.contiguous()``, and :attr:`grad_layout_copies` counts
    those copies so that a run can see them."""

    grad_layout_copies = 0

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, silu):
        y, stats = _forward(x, gamma, beta, groups, eps, silu, with_group_stats=True)
        ctx.save_for_backward(x, gamma, *stats)
        ctx.silu, ctx.beta_dtype = silu, beta.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, scale, shift, mean, inv = ctx.saved_tensors
        if not g.is_contiguous():
            g = g.contiguous()
            GroupNormSiLUFunction.grad_layout_copies += 1
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        dx, dgamma, dbeta = _gn_backward(x3, g.view(x3.shape), gamma, scale, shift, mean, inv, ctx.silu)
        return dx.view(x.shape), dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None, None, None


def group_norm_silu(x, gamma, beta, groups: int = 32, eps: float = 1e-5, silu: bool = True):
    """Differentiable GroupNorm(+SiLU) over a channels-last ``x``: the
    kernels for a CUDA tensor (which must be contiguous: no silent copy) on
    the route :func:`plan_gn` picks, the plain versions for a CPU tensor.
    Without gradients it is the forward alone, outside autograd."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError(
            f"group_norm_silu: x {tuple(x.shape)} is not a contiguous channels-last view"
        )
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return GroupNormSiLUFunction.apply(x, gamma, beta, groups, eps, silu)
    return _forward(x, gamma, beta, groups, eps, silu, with_group_stats=False)[0]
