"""The training step's parameter update as one multi-tensor pass: ``adamw_factored``
with the global-norm clip, bf16 stochastic rounding and the weight EMA (O1);
``adamw_fp16`` over fp32 masters and their bf16 working copy (O2).

The JAX step runs optax's chain inside one ``jax.jit``
(``uwudiff_tpu/training/trainer.py::_train_step_impl``), which XLA fuses;
no Pallas kernel stood here. The port's plain version,
``training/optimizers.py::apply_update_`` (``AdamWFactored._leaf`` leaf by
leaf), takes some 25 eager operations a leaf; on the card
``AdamWFactored.step_`` runs this module instead: the kernels of
``csrc/adamw_factored.cu`` over every leaf at once, a fixed handful of
launches a step whatever the leaf count.

- :func:`leaf_geometry` and :func:`plan_leaves`: how each leaf is walked
  (pure functions of shapes, strides and the factored axes, tested on the
  CPU); :class:`AdamWFactoredPlan`: the leaf table and scratch buffers,
  built once per optimizer state and resident on the device. It and O2's
  plan share ``_LeafPlan``: the table's upload, the checks of the step's
  gradients, the addresses the plan holds, the pinned per-step pointers.
- The wrappers :func:`adamw_norm` (only with a global-norm clip),
  :func:`adamw_stats`, :func:`adamw_finish`, :func:`adamw_rms` (only with
  ``clipping_threshold``) and :func:`adamw_apply`, one launch each, each
  with its launch count; :func:`fused_adamw_factored_step_` runs them.
- O2: :class:`AdamWFP16Plan` (every leaf dense, in memory order) and
  :func:`fused_adamw_fp16_step_`, ``AdamWFP16.step_`` on the card:
  :func:`adamw_norm` (the global norm, for the clip and the metric), then
  :func:`adamw_fp16_apply`, which reads the bf16 gradient, updates the bf16
  moments through fp32, applies the leaf's accumulated decay and writes the
  fp32 master and its bf16 working copy: 20 bytes a parameter.

O1 takes bf16 parameters (stochastic rounding) and fp32 parameters (``p +
u`` in fp32) with a bf16 momentum; O2 fp32 masters with bf16 gradients,
moments and working copies, all of one dense layout; anything else on
CUDA raises, and so does a leaf whose layout the kernels do not walk
(neither factored axis contiguous, a vector width that does not divide
the contiguous axis). No per-leaf eager path and no fallback to the plain
version.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

__all__ = [
    "LEAF_FIELDS",
    "AdamWFP16Plan",
    "AdamWFactoredPlan",
    "adamw_apply",
    "adamw_finish",
    "adamw_fp16_apply",
    "adamw_norm",
    "adamw_rms",
    "adamw_stats",
    "fused_adamw_factored_step_",
    "fused_adamw_fp16_step_",
    "leaf_geometry",
    "plan_leaves",
]

_SOURCE = "adamw_factored.cu"
# the kernel's constants (csrc/adamw_factored.cu)
TILE_SLOW = 64  # slow rows of a factored tile
DENSE_TILE = 256 * 32  # elements of a dense tile
STAT_TILE = 256  # statistics entries of a finish block
VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements of one 16-byte vector
# one 64-bit word each, in csrc/adamw_factored.cu::Leaf's order
LEAF_FIELDS = (
    "p", "mu", "v_a", "v_b", "rf", "cf", "row_mean",
    "numel", "factored", "K", "S", "F", "sk", "ss", "fast_is_c", "R", "C",
    "tile0", "n_tiles", "n_ts", "n_tf", "stat0", "n_stat", "part_f", "part_s",
)
_COL = {name: i for i, name in enumerate(LEAF_FIELDS)}
# csrc/adamw_factored.cu::Flag
_CLIP, _RMS, _WD, _EMA, _NORM_IN_STATS = 1, 2, 4, 8, 16


class _Args(ctypes.Structure):
    """csrc/adamw_factored.cu::Args, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "leaves", "ptrs", "tile_leaf", "stat_leaf", "part_f", "part_s", "tile_sq", "tile_u2", "leaf_norm",
            "leaf_denom", "counters", "out", "decay")]
        + [("n_leaves", ctypes.c_longlong), ("flags", ctypes.c_longlong), ("seed", ctypes.c_ulonglong),
           ("step", ctypes.c_ulonglong)]
        + [(name, ctypes.c_float) for name in (
            "eps", "b2", "omb2", "lr", "c_u", "c_m", "lrwd", "thr", "clip", "ema_dw", "ema_c", "step_size")]
    )


_fns: dict = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from uwudiff_tpu_torch.ops._build import library

        fn = getattr(library(_SOURCE), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        _fns[name] = fn
    return fn


def leaf_geometry(shape, stride, dims, vec: int) -> dict | None:
    """How the kernels walk one leaf: None for a dense leaf (``dims`` None),
    else the factored view ``[K, S, F]`` by element strides: rows ``R =
    shape[d1]`` and columns ``C = shape[d0]``; the contiguous one of the two
    is the fast axis (``F``, ``fast_is_c``), the other the slow one (``S``,
    stride ``ss``); the other axes merged into ``K`` with stride ``sk``.
    Raises for a layout the kernels cannot walk with ``vec``-element
    vectors."""
    if dims is None:
        return None
    d1, d0 = dims
    rest = [a for a in range(len(shape)) if a not in dims and shape[a] != 1]
    for a, b in zip(rest, rest[1:]):
        if stride[a] != shape[b] * stride[b]:
            raise ValueError(f"fused adamw_factored: the non-factored axes of {tuple(shape)} (strides "
                             f"{tuple(stride)}) do not merge into one")
    K = math.prod(shape[a] for a in rest)
    sk = stride[rest[-1]] if rest else 0
    R, C = shape[d1], shape[d0]
    if stride[d0] == 1:
        fast_is_c, F, S, ss = 1, C, R, stride[d1]
    elif stride[d1] == 1:
        fast_is_c, F, S, ss = 0, R, C, stride[d0]
    else:
        raise ValueError(f"fused adamw_factored: neither factored axis of {tuple(shape)} is contiguous "
                         f"(strides {tuple(stride)})")
    if F % vec or ss % vec or (K > 1 and sk % vec):
        raise ValueError(f"fused adamw_factored: {tuple(shape)} (strides {tuple(stride)}) does not split into "
                         f"{vec}-element vectors along its contiguous axis")
    return dict(K=K, S=S, F=F, sk=sk, ss=ss, fast_is_c=fast_is_c, R=R, C=C)


def plan_leaves(shapes, strides, dims, dtype) -> dict:
    """The leaf table's sizes and offsets (every pointer field 0) and the
    flat tile spaces of a list of leaves: ``table`` int64 [n, len(LEAF_FIELDS)],
    ``tile_leaf`` (int32, the leaf of every tile of the norm, stats, rms and
    apply passes), ``stat_leaf`` (of every finish block), and the fp32
    element counts of the partial, factor and row-mean buffers, each leaf's
    factors starting on a 16-byte boundary."""
    vec = VEC[dtype]
    tf_width = 32 * vec
    table = np.zeros((len(shapes), len(LEAF_FIELDS)), dtype=np.int64)
    tiles, stats = [], []
    sizes = dict(part_f=0, part_s=0, rf=0, cf=0, row_mean=0)
    offsets = []
    n_tiles = n_stat = 0
    for i, (shape, stride, d) in enumerate(zip(shapes, strides, dims)):
        row = table[i]
        numel = math.prod(shape)
        geo = leaf_geometry(shape, stride, d, vec)
        off = {}
        if geo is None:
            nt, ns = max(1, -(-numel // DENSE_TILE)), 1
        else:
            n_ts, n_tf = -(-geo["S"] // TILE_SLOW), -(-geo["F"] // tf_width)
            nt = geo["K"] * n_ts * n_tf
            ns = -(-geo["K"] * (geo["R"] + geo["C"]) // STAT_TILE)
            for name, v in geo.items():
                row[_COL[name]] = v
            row[_COL["factored"]], row[_COL["n_ts"]], row[_COL["n_tf"]] = 1, n_ts, n_tf
            row[_COL["part_f"]], row[_COL["part_s"]] = sizes["part_f"], sizes["part_s"]
            sizes["part_f"] += geo["K"] * geo["S"] * n_tf
            sizes["part_s"] += geo["K"] * geo["F"] * n_ts
            for name, n in (("rf", geo["K"] * geo["R"]), ("cf", geo["K"] * geo["C"]), ("row_mean", geo["K"])):
                off[name] = sizes[name]
                sizes[name] += -(-n // 4) * 4
        row[_COL["numel"]] = numel
        row[_COL["tile0"]], row[_COL["n_tiles"]] = n_tiles, nt
        row[_COL["stat0"]], row[_COL["n_stat"]] = n_stat, ns
        tiles.append(np.full(nt, i, dtype=np.int32))
        stats.append(np.full(ns, i, dtype=np.int32))
        n_tiles += nt
        n_stat += ns
        offsets.append(off)
    return dict(table=table, tile_leaf=np.concatenate(tiles), stat_leaf=np.concatenate(stats), sizes=sizes,
                offsets=offsets)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _layout(t: torch.Tensor) -> tuple:
    """The shape and the strides of the axes longer than 1: two tensors with
    the same layout hold each element at the same offset (a 1x1 conv's
    gradient may come contiguous beside its channels_last weight)."""
    return tuple(t.shape), tuple(st for st, n in zip(t.stride(), t.shape) if n != 1)


class _LeafPlan:
    """What both optimizers' plans share: the kernels' ``_Args``, the leaf
    table and the norm's buffers resident on the device, the zeroed
    counters, the addresses the plan was built over, and the per-step upload
    of the gradient pointers (rows of ``Args.ptrs``, the gradient first)
    from a pinned buffer. A subclass names its optimizer (``name``), its
    gradients' dtype (``dtype``) and the wrappers a step launches."""

    name = ""
    dtype = torch.bfloat16

    def __init__(self, params, state, extra=()):
        from uwudiff_tpu_torch.training.optimizers import dense_layout

        if not params:
            raise ValueError(f"{self.name}: no parameters")
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} runs on CUDA tensors, got {dev}")
        for i, p in enumerate(params):
            if p.device != dev or not dense_layout(p) or not _aligned(p):
                raise ValueError(f"{self.name}: leaf {i} {tuple(p.shape)} is not dense and 16-byte aligned"
                                 f" on {dev}")
        n = len(params)
        self.device, self.n_leaves = dev, n
        self._layouts = [_layout(p) for p in params]
        self._built_over = self._addresses(params, state, extra)
        self._host = torch.zeros((n, 4), dtype=torch.int64, pin_memory=True)
        self._ptrs = torch.zeros((n, 4), dtype=torch.int64, device=dev)
        self._copied = torch.cuda.Event()
        self.counters = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        self.args = _Args()
        self.args.ptrs, self.args.counters, self.args.n_leaves = self._ptrs.data_ptr(), self.counters.data_ptr(), n
        self.norm = None

    def _resident(self, plan: dict) -> None:
        """Put ``plan_leaves``' table (pointers filled in) and tile-to-leaf
        map on the device, with the norm's per-tile and per-leaf sums."""
        f32 = dict(dtype=torch.float32, device=self.device)
        self.n_tiles = len(plan["tile_leaf"])
        self.table = torch.from_numpy(plan["table"]).to(self.device)
        self.tile_leaf = torch.from_numpy(plan["tile_leaf"]).to(self.device)
        self.tile_sq = torch.empty(self.n_tiles, **f32)
        self.leaf_norm = torch.empty(self.n_leaves, **f32)
        a = self.args
        a.leaves, a.tile_leaf = self.table.data_ptr(), self.tile_leaf.data_ptr()
        a.tile_sq, a.leaf_norm = self.tile_sq.data_ptr(), self.leaf_norm.data_ptr()

    @staticmethod
    def _addresses(params, state, extra) -> list:
        return [t.data_ptr() for t in list(params) + list(extra)] + [
            t.data_ptr() for st in state.leaves for t in st.values()]

    def holds(self, params, state, extra=()) -> bool:
        """Whether the plan was built over these tensors (a state tensor
        replaced, not updated in place, makes a new plan)."""
        return self._built_over == self._addresses(params, state, extra)

    def _check_per_leaf(self, tensors, what: str) -> None:
        if len(tensors) != self.n_leaves:
            raise ValueError(f"{self.name}: {len(tensors)} {what}s for {self.n_leaves} leaves")
        for i, (t, lay) in enumerate(zip(tensors, self._layouts)):
            if t is None or t.dtype != self.dtype or _layout(t) != lay or t.data_ptr() % 16 or t.device != self.device:
                raise ValueError(f"{self.name}: leaf {i}'s {what} must be a 16-byte aligned {self.dtype} tensor "
                                 f"on {self.device} with its parameter's strides (axes longer than 1) {lay}")

    def _host_rows(self, grads) -> np.ndarray:
        """Wait until the previous step's copies have left the pinned
        buffers; returns the pinned pointer rows with the gradients' in
        column 0, for the caller to fill the rest before ``_upload``."""
        self._copied.synchronize()
        rows = self._host.numpy()
        rows[:, 0] = [g.data_ptr() for g in grads]
        return rows

    def _upload(self, *pinned) -> None:
        """Copy the pointer rows, and each (device, pinned) pair, to the
        device behind the work queued so far; a new norm output."""
        self._ptrs.copy_(self._host, non_blocking=True)
        for dst, src in pinned:
            dst.copy_(src, non_blocking=True)
        self._copied.record()
        self.norm = torch.empty((), dtype=torch.float32, device=self.device)
        self.args.out = self.norm.data_ptr()

    def launches(self) -> list:
        """The wrappers a prepared step launches, in order."""
        raise NotImplementedError

    def run(self) -> torch.Tensor:
        """Launch the prepared step; returns its fp32 global gradient norm."""
        for wrapper in self.launches():
            wrapper(self)
        return self.norm


class AdamWFactoredPlan(_LeafPlan):
    """O1's view of one ``AdamWFactored`` state over one list of CUDA
    parameters: beside what every plan holds, the partial-sum and factor
    buffers, and per step the given rounding bits and EMA tensors. Checks
    every leaf once and raises for what the kernels do not take."""

    name = "fused adamw_factored"

    def __init__(self, tx, params, state):
        self.dtype = params[0].dtype if params else torch.bfloat16
        super().__init__(params, state)
        dtype, dev = self.dtype, self.device
        if dtype not in VEC:
            raise TypeError(f"fused adamw_factored: parameters must be bf16 or fp32, got {dtype}")
        if tx.moment_dtype != torch.bfloat16:
            raise TypeError(f"fused adamw_factored: the momentum must be bf16, got {tx.moment_dtype}")
        dims = state.dims
        if dims is None or len(dims) != len(params):
            raise ValueError("fused adamw_factored: the state has no factored axes (AdamWFactored.init)")
        for i, (p, st) in enumerate(zip(params, state.leaves)):
            if p.dtype != dtype:
                raise TypeError(f"fused adamw_factored: leaf {i} is {p.dtype}, the first {dtype}")
            mu = st["mu"]
            if mu.dtype != torch.bfloat16 or _layout(mu) != _layout(p) or not _aligned(mu):
                raise ValueError(f"fused adamw_factored: leaf {i}'s momentum must be bf16 in its layout")
            stats = [st["v"]] if dims[i] is None else [st["v_row"], st["v_col"]]
            if any(v.dtype != dtype or v.device != dev for v in stats):
                raise TypeError(f"fused adamw_factored: leaf {i}'s statistics must be {dtype} on {dev}")
            if dims[i] is None and _layout(st["v"]) != _layout(p):
                raise ValueError(f"fused adamw_factored: leaf {i}'s v must take its layout")
            if dims[i] is not None:
                d1, d0 = dims[i]
                pos_r, pos_c = d1 - (d1 > d0), d0 - (d0 > d1)
                if not (st["v_row"].movedim(pos_r, -1).is_contiguous()
                        and st["v_col"].movedim(pos_c, -1).is_contiguous()):
                    raise ValueError(f"fused adamw_factored: leaf {i}'s v_row / v_col are not in the layout "
                                     "AdamWFactored.init gives them")
        plan = plan_leaves([tuple(p.shape) for p in params], [p.stride() for p in params], dims, dtype)
        sizes = plan["sizes"]
        f32 = dict(dtype=torch.float32, device=dev)
        self.n_stat_tiles = len(plan["stat_leaf"])
        self.rf = torch.empty(max(sizes["rf"], 4), **f32)
        self.cf = torch.empty(max(sizes["cf"], 4), **f32)
        self.row_mean = torch.empty(max(sizes["row_mean"], 4), **f32)
        self.part_f = torch.empty(max(sizes["part_f"], 1), **f32)
        self.part_s = torch.empty(max(sizes["part_s"], 1), **f32)
        self.tile_u2 = torch.empty(len(plan["tile_leaf"]), **f32)
        self.leaf_denom = torch.empty(len(params), **f32)
        table = plan["table"]
        for i, (p, st, off) in enumerate(zip(params, state.leaves, plan["offsets"])):
            row = table[i]
            row[_COL["p"]], row[_COL["mu"]] = p.data_ptr(), st["mu"].data_ptr()
            if dims[i] is None:
                row[_COL["v_a"]] = st["v"].data_ptr()
            else:
                row[_COL["v_a"]], row[_COL["v_b"]] = st["v_row"].data_ptr(), st["v_col"].data_ptr()
                for name, buf in (("rf", self.rf), ("cf", self.cf), ("row_mean", self.row_mean)):
                    row[_COL[name]] = buf.data_ptr() + 4 * off[name]
        self._resident(plan)
        self.stat_leaf = torch.from_numpy(plan["stat_leaf"]).to(dev)
        self.geometry = table  # host copy, pointers included
        self.sizes = sizes
        self._keep: list = []  # the given bits of the prepared step, alive until it is queued
        a = self.args
        for name in ("stat_leaf", "part_f", "part_s", "tile_u2", "leaf_denom"):
            setattr(a, name, getattr(self, name).data_ptr())
        self.flags = 0

    def _bits(self, bits, i, p):
        b = None if bits is None else bits[i]
        if b is None:
            return 0
        b = torch.empty_like(p, dtype=torch.int32).copy_(torch.as_tensor(b, device=p.device))
        self._keep.append(b)
        return b.data_ptr()

    def prepare(self, tx, grads, count: int, *, grad_clip=None, seed=0, step=0, sr_bits=None, ema_params=None,
                ema_decay=None, ema_bits=None) -> None:
        """Upload this step's pointers (one copy from pinned memory) and set
        its scalars: the optimizer's after ``count`` updates."""
        dtype = self.dtype
        self._check_per_leaf(grads, "gradient")
        if ema_params is not None:
            if ema_decay is None:
                raise ValueError("fused adamw_factored: one EMA tensor a leaf and the step's EMA decay")
            self._check_per_leaf(ema_params, "EMA")
        if (sr_bits is not None or ema_bits is not None) and dtype != torch.bfloat16:
            raise ValueError("fused adamw_factored: rounding bits apply to bf16 parameters only")
        host = self._host_rows(grads)
        self._keep = []
        # given bits, as int32 in the gradient's (the parameter's) layout
        host[:, 1] = 0 if sr_bits is None else [self._bits(sr_bits, i, g) for i, g in enumerate(grads)]
        host[:, 2] = 0 if ema_bits is None else [self._bits(ema_bits, i, g) for i, g in enumerate(grads)]
        host[:, 3] = [e.data_ptr() for e in ema_params] if ema_params is not None else 0
        self._upload()

        from uwudiff_tpu_torch.training.optimizers import _rounded

        beta2, lr = tx.scalars(count)
        a = self.args
        flags = (_CLIP if grad_clip else _NORM_IN_STATS) | (_RMS if tx.clipping_threshold is not None else 0)
        flags |= (_WD if tx.weight_decay else 0) | (_EMA if ema_params is not None else 0)
        a.flags = self.flags = flags
        a.seed, a.step = seed & (2**64 - 1), step & (2**64 - 1)
        a.eps, a.b2, a.omb2 = tx.eps, beta2, 1.0 - beta2
        a.lr = _rounded(lr, dtype)
        a.c_u, a.c_m = _rounded(1.0 - tx.b1, dtype), _rounded(tx.b1, tx.moment_dtype)
        a.lrwd = float(np.float32(lr) * np.float32(tx.weight_decay))
        a.thr = tx.clipping_threshold if tx.clipping_threshold is not None else 1.0
        a.clip = grad_clip if grad_clip else 0.0
        a.ema_dw = ema_decay if ema_params is not None else 0.0
        a.ema_c = float(np.float32(1.0) - np.float32(ema_decay)) if ema_params is not None else 0.0

    def launches(self) -> list:
        seq = [adamw_norm] if self.flags & _CLIP else []
        seq += [adamw_stats, adamw_finish]
        seq += [adamw_rms] if self.flags & _RMS else []
        return seq + [adamw_apply]


def _launch(name: str, plan: AdamWFactoredPlan, grid: int) -> None:
    if plan.norm is None:
        raise RuntimeError(f"{name}: the plan has no prepared step")
    stream = torch.cuda.current_stream(plan.device).cuda_stream
    with torch.cuda.device(plan.device):  # the launch goes to the current device
        rc = _kernel(name)(ctypes.byref(plan.args), grid, int(plan.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def adamw_norm(plan) -> None:
    """Launch the global gradient norm (O1: with a global-norm clip, before
    the statistics; O2: every step, before the apply)."""
    _launch("uwu_adamw_norm", plan, plan.n_tiles)
    adamw_norm.launches += 1


def adamw_stats(plan: AdamWFactoredPlan) -> None:
    """Launch the gradient statistics: the factored partial sums, dense v."""
    _launch("uwu_adamw_stats", plan, plan.n_tiles)
    adamw_stats.launches += 1


def adamw_finish(plan: AdamWFactoredPlan) -> None:
    """Launch the merge of the partials into v_row / v_col and the factors."""
    _launch("uwu_adamw_finish", plan, plan.n_stat_tiles)
    adamw_finish.launches += 1


def adamw_rms(plan: AdamWFactoredPlan) -> None:
    """Launch the per-leaf update-RMS clip's denominators."""
    _launch("uwu_adamw_rms", plan, plan.n_tiles)
    adamw_rms.launches += 1


def adamw_apply(plan: AdamWFactoredPlan) -> None:
    """Launch the elementwise update of the momentum, the parameters and the EMA."""
    _launch("uwu_adamw_apply", plan, plan.n_tiles)
    adamw_apply.launches += 1


def adamw_fp16_apply(plan: AdamWFP16Plan) -> None:
    """Launch O2's elementwise update of the moments, the masters and their working copies."""
    _launch("uwu_adamw_fp16_apply", plan, plan.n_tiles)
    adamw_fp16_apply.launches += 1


for _w in (adamw_norm, adamw_stats, adamw_finish, adamw_rms, adamw_apply, adamw_fp16_apply):
    _w.launches = 0


def fused_adamw_factored_step_(tx, params, grads, state, *, grad_clip=None, seed=0, step=0, sr_bits=None,
                               ema_params=None, ema_decay=None, ema_bits=None) -> torch.Tensor:
    """``AdamWFactored.step_`` on CUDA tensors: the plan is built at the
    first step over these parameters, then each step uploads its pointers
    and launches the kernels. Returns the fp32 global gradient norm."""
    if state.fused is None or not state.fused.holds(params, state):
        state.fused = AdamWFactoredPlan(tx, params, state)
    plan = state.fused
    plan.prepare(tx, grads, state.count, grad_clip=grad_clip, seed=seed, step=step, sr_bits=sr_bits,
                 ema_params=ema_params, ema_decay=ema_decay, ema_bits=ema_bits)
    norm = plan.run()
    state.count += 1
    return norm


class AdamWFP16Plan(_LeafPlan):
    """O2's view of one ``AdamWFP16`` state over fp32 master parameters and
    the module's bf16 working copies: every leaf dense, walked in memory
    order, so the master, its working copy, its moments and its bf16
    gradient share one dense layout; beside what every plan holds, a pinned
    buffer for the per-step leaf decays. Checks every leaf once and raises
    for what the kernel does not take."""

    name = "fused adamw_fp16"

    def __init__(self, tx, params, state, working):
        super().__init__(params, state, working or [])
        n = self.n_leaves
        if tx.moment_dtype != torch.bfloat16:
            raise TypeError(f"fused adamw_fp16: the moments must be bf16, got {tx.moment_dtype}")
        if working is None or len(working) != n:
            raise ValueError("fused adamw_fp16: takes fp32 masters with one bf16 working copy a leaf")
        for i, (p, st) in enumerate(zip(params, state.leaves)):
            if p.dtype != torch.float32:
                raise TypeError(f"fused adamw_fp16: master {i} is {p.dtype}, not fp32")
        for name, tensors in (("working copy", working), ("exp_avg", [st["exp_avg"] for st in state.leaves]),
                              ("exp_avg_sq", [st["exp_avg_sq"] for st in state.leaves])):
            self._check_per_leaf(tensors, name)
        plan = plan_leaves([tuple(p.shape) for p in params], [p.stride() for p in params], [None] * n,
                           torch.bfloat16)
        for row, p, w, st in zip(plan["table"], params, working, state.leaves):
            row[_COL["p"]], row[_COL["mu"]] = p.data_ptr(), st["exp_avg"].data_ptr()
            row[_COL["v_a"]], row[_COL["v_b"]] = st["exp_avg_sq"].data_ptr(), w.data_ptr()
        self._resident(plan)
        self._host_decay = torch.zeros(n, dtype=torch.float32, pin_memory=True)
        self._decay = torch.zeros(n, dtype=torch.float32, device=self.device)
        self.args.decay = self._decay.data_ptr()

    def prepare(self, tx, grads, state, *, grad_clip=None) -> None:
        """Upload this step's gradient pointers and leaf decays (two copies
        from pinned memory) and set its scalars; moves ``state``'s decay
        accumulators on (``AdamWFP16.advance``)."""
        self._check_per_leaf(grads, "gradient")
        step_size, decay_now = tx.advance(state)
        self._host_rows(grads)
        self._host_decay.numpy()[:] = decay_now
        self._upload((self._decay, self._host_decay))
        b1, omb1, b2, omb2, eps = tx.consts()
        a = self.args
        a.flags = _CLIP if grad_clip else 0
        a.c_m, a.c_u, a.b2, a.omb2, a.eps = b1, omb1, b2, omb2, eps
        a.step_size = step_size
        a.clip = grad_clip if grad_clip else 0.0

    def launches(self) -> list:
        return [adamw_norm, adamw_fp16_apply]


def fused_adamw_fp16_step_(tx, params, grads, state, *, grad_clip=None, seed=0, step=0, sr_bits=None,
                           ema_params=None, ema_decay=None, ema_bits=None, working=None) -> torch.Tensor:
    """``AdamWFP16.step_`` on CUDA tensors: fp32 masters ``params``, their
    bf16 ``grads`` and ``working`` copies. The plan is built at the first
    step over these tensors; each step then uploads its pointers and decays
    and launches two kernels. Returns the fp32 global gradient norm. Raises
    for a weight EMA and for rounding bits (no bf16 parameter takes them)."""
    del seed, step
    if ema_params is not None or sr_bits is not None or ema_bits is not None:
        raise NotImplementedError("fused adamw_fp16: no weight EMA and no rounding bits")
    if state.fused is None or not state.fused.holds(params, state, working or []):
        state.fused = AdamWFP16Plan(tx, params, state, working)
    plan = state.fused
    plan.prepare(tx, grads, state, grad_clip=grad_clip)
    norm = plan.run()
    state.count += 1
    return norm
