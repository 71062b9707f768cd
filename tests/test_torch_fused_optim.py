"""The whole-tree parameter update of the port (``AdamWFactored.step_``) on the CPU.

On the CPU ``step_`` is the plain version (``apply_update_``): it must be
``update()`` followed by ``stochastic_round_add`` (bf16) or ``p + u``
(fp32), bitwise, with the global-norm clip before it and the weight EMA
after it, whether the rounding bits are given or drawn. The bits are a
pure function of (seed, step, leaf, stream, element offset) that the CUDA
kernels draw too (``csrc/adamw_factored.cu``): deterministic, different
for any other counter, uniform, and the rounding with them unbiased. The
kernels' leaf table (``ops/fused_optim.py``) is planned in Python: every
layout of the SDXL step's leaves is walked, and every element of every
leaf lies in exactly one tile (the kernels' index arithmetic mirrored
here). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import copy
import math

import numpy as np
import pytest
import torch

from test_torch_models import one_torch_thread  # noqa: F401  (autouse: one torch thread in this module)
from uwudiff_tpu_torch.ops.fused_optim import LEAF_FIELDS, TILE_SLOW, VEC, leaf_geometry, plan_leaves
from uwudiff_tpu_torch.training import DMTrainer
from uwudiff_tpu_torch.training.optimizers import (
    EMA_STREAM,
    PARAM_STREAM,
    OptState,
    adamw_factored,
    draw_sr_bits,
    sr_key,
    stochastic_round_add,
)

# test_torch_train_optim.py's leaves in PyTorch's layout, and a channels_last conv
SHAPES = ((256, 256), (384, 128), (192, 160, 3, 3), (100, 64), (320,), (256, 128, 3, 3))
CHANNELS_LAST = 5


def _leaves(rng, dtype, scale, like=None):
    out = []
    for i, shape in enumerate(SHAPES):
        t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
        if like is not None:
            t = torch.empty_like(like[i]).copy_(t)
        elif i == CHANNELS_LAST:
            t = t.contiguous(memory_format=torch.channels_last)
        out.append(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("given", [False, True])
def test_step_is_update_then_rounding(dtype, clip, given):
    rng = np.random.default_rng(0)
    tx = adamw_factored(1e-3, weight_decay=0.01, clipping_threshold=1.0)
    params = _leaves(rng, dtype, 0.1)
    assert params[CHANNELS_LAST].stride()[1] == 1
    ema = [p.clone() for p in params]
    state = tx.init(params)
    ref_p, ref_e, ref_state = [p.clone() for p in params], [p.clone() for p in params], copy.deepcopy(state)
    for step in range(3):
        grads = _leaves(rng, dtype, 0.05, like=params)  # global norm ~30: the clip bites
        bits = ([torch.from_numpy(rng.integers(0, 1 << 16, p.shape)) for p in params]
                if given and dtype == torch.bfloat16 else None)
        decay = float(np.float32(0.5) + np.float32(0.1) * step)
        norm = tx.step_(params, grads, state, grad_clip=clip, seed=5, step=step, sr_bits=bits,
                        ema_params=ema, ema_decay=decay)

        want = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                                     for g in grads]))
        assert norm.dtype == torch.float32 and norm.dim() == 0 and torch.equal(norm, want)
        if clip:
            assert want > clip
            grads = [g / want.to(dtype) * clip for g in grads]
        updates, _ = tx.update(grads, ref_state, ref_p)
        for i, (p, u) in enumerate(zip(ref_p, updates)):
            if dtype == torch.bfloat16:
                b = bits[i] if bits is not None else draw_sr_bits(p, 5, step, i, PARAM_STREAM)
                p.copy_(stochastic_round_add(p, u, b))
            else:
                p.copy_(p + u)
        keep = float(np.float32(1) - np.float32(decay))
        for i, (e, p) in enumerate(zip(ref_e, ref_p)):
            if dtype == torch.bfloat16:
                e.copy_(stochastic_round_add(e, keep * (p.float() - e.float()),
                                             draw_sr_bits(e, 5, step, i, EMA_STREAM)))
            else:
                e.copy_(decay * e + keep * p)
        for got, ref in zip(params + ema, ref_p + ref_e):
            assert torch.equal(got, ref)
        for st, rst in zip(state.leaves, ref_state.leaves):
            assert all(torch.equal(st[k], rst[k]) for k in st)
    assert state.count == 3 and state.fused is None
    assert params[CHANNELS_LAST].is_contiguous(memory_format=torch.channels_last)
    assert state.leaves[CHANNELS_LAST]["mu"].stride() == params[CHANNELS_LAST].stride()


def _bits_python(key, offsets):
    """The bits of the elements at ``offsets``, with Python integers."""
    mask = (1 << 64) - 1
    out = []
    for e in offsets:
        z = (key + (e // 4 + 1) * 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        out.append(((z ^ (z >> 31)) >> (16 * (e % 4))) & 0xFFFF)
    return out


def test_rounding_bits_are_a_pure_function_of_their_counters():
    x = torch.empty((1 << 20,), dtype=torch.bfloat16)
    bits = draw_sr_bits(x, 7, 3, 11, PARAM_STREAM)
    assert bits.dtype == torch.int32 and torch.equal(bits, draw_sr_bits(x, 7, 3, 11, PARAM_STREAM))
    assert 0 <= int(bits.min()) and int(bits.max()) <= 0xFFFF
    # uniform: the mean of 2^20 draws is within 6 sigma (18919 / 1024 each) of 32767.5
    assert abs(bits.double().mean().item() - 32767.5) < 6 * 65536 / math.sqrt(12) / 1024
    for other in ((8, 3, 11, 0), (7, 4, 11, 0), (7, 3, 12, 0), (7, 3, 11, EMA_STREAM)):
        assert (draw_sr_bits(x, *other) == bits).float().mean().item() < 1e-3, other
    picks = [0, 1, 2, 3, 4, 1023, 777777, (1 << 20) - 1]
    assert bits[picks].tolist() == _bits_python(sr_key(7, 3, 11, 0), picks)
    # by memory offset: a channels_last tensor's element takes its offset's bits
    w = torch.empty((8, 16, 3, 3)).contiguous(memory_format=torch.channels_last)
    wb = draw_sr_bits(w, 1, 0, 2, 0)
    assert wb.stride() == w.stride()
    assert wb[5, 9, 2, 1].item() == _bits_python(sr_key(1, 0, 2, 0), [5 * 144 + 2 * 48 + 1 * 16 + 9])[0]


def test_stochastic_rounding_with_drawn_bits_is_unbiased():
    n = 1 << 20
    for base, frac in ((1.0, 0.3), (-3.0, 0.7), (0.015625, 0.05)):
        p = torch.full((n,), base, dtype=torch.bfloat16)
        ulp = 2.0 ** (math.floor(math.log2(abs(base))) - 7)
        out = stochastic_round_add(p, torch.full((n,), frac * ulp), draw_sr_bits(p, 0, 0, 0, PARAM_STREAM))
        assert set(out.float().unique().tolist()) <= {base, base + ulp}
        # the mean moves by frac of a step, within 6 sigma of the binomial's spread
        moved = (out.double().mean().item() - base) / ulp
        assert abs(moved - frac) < 6 * math.sqrt(frac * (1 - frac) / n), (base, moved)


def test_leaf_geometry_walks_every_layout_of_the_step():
    def geo(t, dims, vec=8):
        return leaf_geometry(tuple(t.shape), t.stride(), dims, vec)

    conv = torch.empty((1280, 2560, 3, 3)).contiguous(memory_format=torch.channels_last)
    assert geo(conv, (0, 1)) == dict(K=9, S=1280, F=2560, sk=2560, ss=9 * 2560, fast_is_c=1, R=1280, C=2560)
    up = torch.empty((640, 320, 3, 3)).contiguous(memory_format=torch.channels_last)  # rows = the inputs
    assert geo(up, (1, 0)) == dict(K=9, S=640, F=320, sk=320, ss=9 * 320, fast_is_c=0, R=320, C=640)
    geglu = torch.empty((10240, 1280))
    assert geo(geglu, (1, 0)) == dict(K=1, S=10240, F=1280, sk=0, ss=1280, fast_is_c=0, R=1280, C=10240)
    one = torch.empty((1280, 640, 1, 1)).contiguous(memory_format=torch.channels_last)
    assert geo(one, (1, 0))["K"] == 1 and geo(one, (1, 0))["F"] == 640
    assert geo(torch.empty(320), None) is None
    with pytest.raises(ValueError, match="contiguous"):
        geo(torch.empty((128, 128, 4)), (0, 1))
    with pytest.raises(ValueError, match="vectors"):
        geo(torch.empty((256, 132)), (1, 0))  # 132 is no multiple of 8 elements
    with pytest.raises(ValueError, match="merge"):
        geo(torch.empty((3, 128, 5, 128)).permute(2, 1, 0, 3), (1, 3))


def _kernel_offsets(row, tile, vec):
    """The element offsets of one tile, as the kernels compute them."""
    c = {k: int(row[i]) for i, k in enumerate(LEAF_FIELDS)}
    if not c["factored"]:
        return [e for e in range(tile * 8192, (tile + 1) * 8192) if e < c["numel"]]
    tf, rest = tile % c["n_tf"], tile // c["n_tf"]
    ts, k = rest % c["n_ts"], rest // c["n_ts"]
    out = []
    for s in range(ts * TILE_SLOW, min((ts + 1) * TILE_SLOW, c["S"])):
        for f in range(tf * 32 * vec, min((tf + 1) * 32 * vec, c["F"])):
            out.append(k * c["sk"] + s * c["ss"] + f)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_tiles_cover_every_element_once(dtype):
    leaves = [torch.empty((200, 136)), torch.empty((136, 96, 3, 3)).contiguous(memory_format=torch.channels_last),
              torch.empty((1000, 128)), torch.empty(9000), torch.empty((64, 40))]
    dims = [(1, 0), (1, 0), (1, 0), None, None]
    plan = plan_leaves([tuple(t.shape) for t in leaves], [t.stride() for t in leaves], dims, dtype)
    table, tile_leaf = plan["table"], plan["tile_leaf"]
    col = {k: i for i, k in enumerate(LEAF_FIELDS)}
    parts = []
    for i, t in enumerate(leaves):
        row = table[i]
        assert (tile_leaf[row[col["tile0"]]:row[col["tile0"]] + row[col["n_tiles"]]] == i).all()
        seen = np.zeros(t.numel(), dtype=np.int64)
        for tile in range(row[col["n_tiles"]]):
            np.add.at(seen, _kernel_offsets(row, tile, VEC[dtype]), 1)
        assert (seen == 1).all(), i
        if row[col["factored"]]:
            k, s, f = row[col["K"]], row[col["S"]], row[col["F"]]
            parts.append((row[col["part_f"]], k * s * row[col["n_tf"]], "f"))
            parts.append((row[col["part_s"]], k * f * row[col["n_ts"]], "s"))
            assert k * (row[col["R"]] + row[col["C"]]) <= row[col["n_stat"]] * 256
    for kind in "fs":  # each leaf's partials in a range of its own
        spans = sorted((a, a + n) for a, n, w in parts if w == kind)
        assert all(e0 <= a1 for (_, e0), (a1, _) in zip(spans, spans[1:]))
        assert spans[-1][1] == plan["sizes"]["part_" + kind]
    assert len(plan["stat_leaf"]) == table[:, col["n_stat"]].sum()


def test_cpu_state_builds_no_kernel_plan_and_copies_without_one():
    tx = adamw_factored(1e-3)
    p = [torch.zeros((256, 128, 3, 3)).contiguous(memory_format=torch.channels_last), torch.zeros(64)]
    state = tx.init(p)
    assert state.dims == [(1, 0), None]
    assert state.leaves[0]["v_row"].shape == (128, 3, 3) and state.leaves[0]["v_row"].stride() == (1, 384, 128)
    assert state.leaves[0]["v_col"].shape == (256, 3, 3) and state.leaves[0]["v_col"].stride() == (1, 768, 256)
    state.fused = object()
    clone = copy.deepcopy(state)
    assert clone.fused is None and clone.dims == state.dims and clone.count == state.count
    assert isinstance(clone, OptState) and clone.leaves[0]["v_row"].stride() == (1, 384, 128)


def test_trainer_keeps_a_weight_ema():
    net = torch.nn.Linear(8, 8)
    tr = DMTrainer({"unet": net}, ema_weights_decay=0.999, device="cpu")
    with pytest.raises(ValueError, match="ema_weights_decay"):
        DMTrainer({"unet": torch.nn.Linear(2, 2)}, device="cpu").ema_weights()
    ema = tr.ema_weights()
    assert set(ema) == {"weight", "bias"} and torch.equal(ema["weight"], net.weight)
    assert ema["weight"] is not net.weight
    assert tr._ema_step_decay() == float(np.float32(0.1))  # (1 + 0) / (10 + 0)
    tr.step = 10**6
    assert tr._ema_step_decay() == float(np.float32(0.999))
