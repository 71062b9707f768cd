"""What surrounds the Hopper flash forward, on the CPU: the head-dim dispatch
(the Hopper kernel at D = 40/64/72/80/128/160) and the TMA tensor-map arithmetic
for ``[B, S, H, D]`` views (64-column boxes at every head dim).

The kernel itself (``csrc/flash_fwd_sm90.cu``) runs only on the card and is
held against the plain version in ``tests/test_torch_cuda.py``; its C side
only encodes the maps computed and checked here.
"""

import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from uwudiff_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    SM90_FWD_KEY_ROWS,
    SM90_FWD_Q_ROWS,
    TMA_BOX_ROWS,
    flash_fwd_sm90,
    forward_kernel,
    tma_map,
)

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parent.parent


def _variants_script():
    spec = importlib.util.spec_from_file_location("flash_variants", ROOT / "flash_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VARIANTS = _variants_script().VARIANTS


@pytest.mark.parametrize("d,kernel", [(64, flash_fwd_sm90), (40, flash_fwd_sm90), (72, flash_fwd_sm90),
                                      (80, flash_fwd_sm90), (128, flash_fwd_sm90), (160, flash_fwd_sm90)])
def test_head_dim_selects_the_forward(d, kernel):
    assert d in HEAD_DIMS
    assert forward_kernel(d) is kernel


@pytest.mark.parametrize("d", [16, 32, 48, 96, 256])
def test_other_head_dims_raise(d):
    with pytest.raises(ValueError, match="head dim"):
        forward_kernel(d)


def test_the_two_forwards_split_the_head_dims_and_take_cuda_tensors_only():
    # the Hopper kernel was built for, and routed, every head dim; the
    # mma.sync one, on no path, is the yardstick at SD1.5's
    from uwudiff_tpu_torch.ops.flash_attention import MMA_HEAD_DIMS

    assert set(MMA_HEAD_DIMS) < set(HEAD_DIMS)
    assert set(SM90_FWD_Q_ROWS) == set(SM90_FWD_KEY_ROWS) == set(HEAD_DIMS)
    q = torch.zeros((1, 8, 1, 64), dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_sm90(q, q, q)


def test_map_of_a_contiguous_view():
    t = torch.zeros((2, 100, 3, 64), dtype=BF16)
    m = tma_map(t)
    assert m.dims == (64, 3, 100, 2)  # innermost first: D, H, S, B
    assert m.strides == (128, 3 * 128, 100 * 3 * 128)  # bytes, of H, S and B
    assert m.box == (64, 1, TMA_BOX_ROWS, 1)
    assert len(m.words()) == 11  # the C side's MAP_WORDS
    assert m.words() == m.dims + m.strides + m.box


@pytest.mark.parametrize("which", [0, 1, 2])
def test_map_of_a_head_slice_of_a_fused_qkv(which):
    qkv = torch.zeros((2, 100, 3, 4, 64), dtype=BF16)
    t = qkv[:, :, which]
    m = tma_map(t)
    assert m.dims == (64, 4, 100, 2)
    assert m.strides == (128, 3 * 4 * 128, 100 * 3 * 4 * 128)
    assert t.data_ptr() - qkv.data_ptr() == which * 4 * 128  # the map starts at the view, uncopied


@pytest.mark.parametrize("d", [40, 72, 80, 160])
def test_maps_at_sd15s_head_dims(d):
    # one 64-column box per column block, the columns past D zero-filled by
    # TMA: the map's own head dim stays D; q in boxes of a work item's rows
    # (three consumer warpgroups' 192 at D = 40), k and v of the key tile
    t = torch.zeros((2, 100, 3, d), dtype=BF16)
    q_map = tma_map(t, rows=SM90_FWD_Q_ROWS[d])
    k_map = tma_map(t, rows=SM90_FWD_KEY_ROWS[d])
    assert q_map.dims == k_map.dims == (d, 3, 100, 2)
    assert q_map.strides == (2 * d, 3 * 2 * d, 100 * 3 * 2 * d)
    assert q_map.box == (64, 1, 192 if d == 40 else TMA_BOX_ROWS, 1)
    assert k_map.box == (64, 1, 64 if d == 160 else 128, 1)


def test_maps_at_fluxs_head_dim():
    # D = 128 fills two 64-column boxes exactly (TMA zero-fills nothing past
    # D); q in boxes of a work item's 128 rows, k and v of 128-key tiles
    t = torch.zeros((1, 4608, 24, 128), dtype=BF16)
    q_map = tma_map(t, rows=SM90_FWD_Q_ROWS[128])
    k_map = tma_map(t, rows=SM90_FWD_KEY_ROWS[128])
    assert q_map.dims == k_map.dims == (128, 24, 4608, 1)
    assert q_map.strides == (256, 24 * 256, 4608 * 24 * 256)
    assert q_map.box == k_map.box == (64, 1, 128, 1)
    assert 2 * q_map.box[0] == q_map.dims[0]


def test_the_c_side_builds_an_instance_for_each_head_dim():
    # the forward's switch and its Cfg's static_assert name the Python side's
    # head dims, no more and no fewer
    import re

    src = (ROOT / "uwudiff_tpu_torch" / "csrc" / "flash_fwd_sm90.cu").read_text()
    assert set(map(int, re.findall(r"case (\d+): return run<", src))) == set(HEAD_DIMS)
    asserted = re.search(r"static_assert\(((?:D == \d+(?: \|\| )?)+)", src).group(1)
    assert set(map(int, re.findall(r"D == (\d+)", asserted))) == set(HEAD_DIMS)


@pytest.mark.parametrize("d", [40, 72, 160])
def test_map_of_a_head_slice_of_a_fused_qkv_at_sd15s_head_dims(d):
    qkv = torch.zeros((2, 100, 3, 8, d), dtype=BF16)
    t = qkv[:, :, 1]
    m = tma_map(t)
    assert m.dims == (d, 8, 100, 2)
    assert m.strides == (2 * d, 3 * 8 * 2 * d, 100 * 3 * 8 * 2 * d)
    assert t.data_ptr() - qkv.data_ptr() == 8 * 2 * d  # the map starts at the view, uncopied


def test_map_of_a_heads_first_tensor_seen_as_b_s_h_d():
    t = torch.zeros((2, 4, 300, 64), dtype=BF16).transpose(1, 2)
    m = tma_map(t)
    assert m.dims == (64, 4, 300, 2)
    assert m.strides == (300 * 128, 128, 4 * 300 * 128)


def test_a_short_sequence_keeps_its_length_under_a_full_box():
    m = tma_map(torch.zeros((1, 77, 2, 64), dtype=BF16))
    assert m.box == (64, 1, TMA_BOX_ROWS, 1)
    assert m.dims == (64, 2, 77, 1)  # rows past S are zero-filled by TMA, not padded here


def _misaligned():
    flat = torch.zeros(2 * 16 * 2 * 64 + 4, dtype=BF16)
    return flat[4:].view(2, 16, 2, 64)  # starts 8 bytes past an aligned address


def _refused():
    base = torch.zeros((2, 16, 2, 64), dtype=BF16)
    return {
        "misaligned start": (_misaligned(), "aligned"),
        "zero head stride": (base[:, :, :1].expand(2, 16, 2, 64), "strides"),
        "head stride of 136 bytes": (torch.zeros((2, 16, 2, 68), dtype=BF16)[..., :64], "strides"),
        "head dim 32": (torch.zeros((2, 16, 2, 32), dtype=BF16), "head dim"),
        "head dim not innermost": (torch.zeros((2, 16, 64, 64), dtype=BF16).transpose(2, 3), "head dim"),
        "fp32": (base.float(), "bf16"),
        "3-d": (base[0], "bf16"),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_views_tma_cannot_take_are_refused(case):
    t, match = _refused()[case]
    with pytest.raises(ValueError, match=match):
        tma_map(t)


def _refused_at_40():
    flat = torch.zeros(2 * 16 * 2 * 40 + 4, dtype=BF16)
    base = torch.zeros((2, 16, 2, 40), dtype=BF16)
    return {
        "misaligned start": (flat[4:].view(2, 16, 2, 40), "aligned"),  # 8 bytes past an aligned address
        "zero head stride": (base[:, :, :1].expand(2, 16, 2, 40), "strides"),
        "head stride of 88 bytes": (torch.zeros((2, 16, 2, 44), dtype=BF16)[..., :40], "strides"),
        "head dim 48": (torch.zeros((2, 16, 2, 48), dtype=BF16), "head dim"),
    }


@pytest.mark.parametrize("case", list(_refused_at_40()))
def test_forward_views_tma_cannot_take_at_d40_are_refused(case):
    t, match = _refused_at_40()[case]
    with pytest.raises(ValueError, match=match):
        tma_map(t)


@pytest.mark.parametrize(
    "shape,mode,strides",
    [
        ((2, 1, 77, 77), 2, (77 * 77, 0)),  # CLIP: causal + padding, one per prompt, broadcast over heads
        ((1, 4, 77, 77), 2, (0, 77 * 77)),  # one per head, broadcast over the batch
        ((2, 4, 77, 77), 2, (4 * 77 * 77, 77 * 77)),  # T5's: full
        ((2, 1, 1, 77), 1, (77, 0)),  # a key mask
    ],
)
def test_the_hopper_forward_takes_a_bias_in_place(shape, mode, strides):
    from uwudiff_tpu_torch.ops.flash_attention import _bias_in_place

    q = torch.zeros((2, 77, 4, 64), dtype=BF16)
    bias = torch.zeros(shape)
    got_mode, t, sb, sh = _bias_in_place("flash_fwd_sm90", bias, q, q)
    assert (got_mode, (sb, sh)) == (mode, strides)
    if mode == 2:
        assert t.data_ptr() == bias.data_ptr()  # read where it lies, not expanded


def test_a_bias_with_strided_rows_is_copied_full():
    from uwudiff_tpu_torch.ops.flash_attention import _bias_in_place

    q = torch.zeros((2, 77, 4, 64), dtype=BF16)
    bias = torch.zeros((2, 4, 77, 80))[..., :77]  # rows of 80, not Sk
    mode, t, sb, sh = _bias_in_place("flash_fwd_sm90", bias, q, q)
    assert mode == 2 and t.shape == (8, 77, 77) and t.is_contiguous() and (sb, sh) == (4 * 77 * 77, 77 * 77)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_each_variant_changes_one_line_of_the_kernel(name):
    # flash_variants.py builds each variant by replacing one line of the
    # kernel's Cfg and launches it through flash_fwd_sm90's library slot,
    # with the variant's work-item rows and key tile: each must still find
    # what it edits
    (old, new), q_rows, key_rows, shapes = VARIANTS[name]
    src = (ROOT / "uwudiff_tpu_torch" / "csrc" / "flash_fwd_sm90.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert set(q_rows) <= set(SM90_FWD_Q_ROWS) and all(r % 64 == 0 for r in q_rows.values())
    assert set(key_rows) <= set(SM90_FWD_KEY_ROWS) and all(r % 64 == 0 for r in key_rows.values())
    assert {shape[-1] for shape in shapes} <= set(HEAD_DIMS)
    assert '"uwu_flash_fwd_sm90"' in inspect.getsource(flash_fwd_sm90)
