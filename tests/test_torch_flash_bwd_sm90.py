"""What surrounds the Hopper flash backward, on the CPU: the head-dim
dispatch of dQ and dK/dV (Hopper at D = 40/64/80, mma.sync at 160), the
launch counters, the TMA boxes (128-byte swizzle rows of 64 columns at
every head dim) and the bias the kernels read in place.

The kernels themselves (``csrc/flash_bwd_sm90.cu``) run only on the card
and are held against the plain version in ``tests/test_torch_cuda.py``;
their C side only encodes the maps computed and checked here.
"""

import re
from pathlib import Path

import pytest
import torch

from uwudiff_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from uwudiff_tpu_torch.ops._build import SOURCES
from uwudiff_tpu_torch.ops.flash_attention import (
    BWD_HEAD_DIMS,
    SM90_BWD_HEAD_DIMS,
    SM90_BWD_ITEM_ROWS,
    SM90_BWD_TILE_ROWS,
    _bias_in_place,
    backward_kernels,
    flash_bwd_dkv,
    flash_bwd_dkv_mma,
    flash_bwd_dkv_sm90,
    flash_bwd_dq,
    flash_bwd_dq_mma,
    flash_bwd_dq_sm90,
    tma_map,
)

BF16 = torch.bfloat16
CSRC = Path(__file__).resolve().parent.parent / "uwudiff_tpu_torch" / "csrc"


@pytest.mark.parametrize("d,kernels", [(64, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (40, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (80, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (160, (flash_bwd_dq_mma, flash_bwd_dkv_mma))])
def test_head_dim_selects_the_backward(d, kernels):
    assert d in BWD_HEAD_DIMS
    assert backward_kernels(d) == kernels


@pytest.mark.parametrize("d", [16, 32, 48, 96, 128, 152, 256])
def test_other_head_dims_raise(d):
    with pytest.raises(ValueError, match="head dim"):
        backward_kernels(d)
    t = torch.zeros((1, 8, 1, d), dtype=BF16)
    stats = torch.zeros((1, 1, 8))
    for dispatcher in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="head dim"):
            dispatcher(t, t, t, t, stats, stats)


@pytest.mark.parametrize("wrapper", [flash_bwd_dq_sm90, flash_bwd_dkv_sm90, flash_bwd_dq, flash_bwd_dkv])
def test_the_hopper_backward_takes_cuda_tensors_only(wrapper):
    t = torch.zeros((1, 8, 1, 64), dtype=BF16)
    stats = torch.zeros((1, 1, 8))
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(t, t, t, t, stats, stats)
    assert launch_counts()["flash_bwd_dq"] == launch_counts()["flash_bwd_dkv"] == 0


def test_each_backward_kernel_counts_apart_and_the_pairs_sum_under_the_old_names():
    for name in ("flash_bwd_dq_sm90", "flash_bwd_dq_mma", "flash_bwd_dkv_sm90", "flash_bwd_dkv_mma"):
        assert name in KERNELS
    assert "flash_bwd_dq" not in KERNELS and "flash_bwd_dkv" not in KERNELS  # sums, not kernels
    reset_launch_counts()
    try:
        flash_bwd_dq_sm90.launches, flash_bwd_dq_mma.launches = 3, 2
        flash_bwd_dkv_sm90.launches, flash_bwd_dkv_mma.launches = 5, 0
        counts = launch_counts()
        assert (counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (5, 5)
        assert counts["flash_bwd_dq_sm90"] == 3 and counts["flash_bwd_dkv_mma"] == 0
    finally:
        reset_launch_counts()
    assert all(v == 0 for v in launch_counts().values())


def test_the_source_is_built_and_its_tiles_match_the_boxes():
    assert "flash_bwd_sm90.cu" in SOURCES and "flash_bwd.cu" in SOURCES
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    assert int(re.search(r"constexpr int ITEM_ROWS = (\d+);", src)[1]) == SM90_BWD_ITEM_ROWS
    assert int(re.search(r"constexpr int TILE = (\d+);", src)[1]) == SM90_BWD_TILE_ROWS
    # the C side's instances are the Python side's head dims, and its swizzle
    # row (64 columns at every head dim) is the maps' box
    assert re.search(r"static_assert\(D == 40 \|\| D == 64 \|\| D == 80,", src)
    assert set(map(int, re.findall(r"case (\d+): return run<", src))) == set(SM90_BWD_HEAD_DIMS)
    assert int(re.search(r"constexpr int COLS = (\d+);", src)[1]) == 64
    common = (CSRC / "hopper_common.cuh").read_text()
    words = int(re.search(r"constexpr int MAP_WORDS = (\d+);", common)[1])
    for d in SM90_BWD_HEAD_DIMS:
        m = tma_map(torch.zeros((1, 8, 1, d), dtype=BF16), head_dims=SM90_BWD_HEAD_DIMS)
        assert words == len(m.words())


@pytest.mark.parametrize("rows", [SM90_BWD_TILE_ROWS, SM90_BWD_ITEM_ROWS])
def test_maps_of_the_backward_inputs_and_outputs_take_the_box_rows(rows):
    for shape in ((2, 100, 3, 64), (8, 1357, 24, 64), (8, 77, 20, 64)):
        t = torch.zeros(shape, dtype=BF16)
        m = tma_map(t, who="flash_bwd_dkv_sm90", name="dout", rows=rows)
        b, s, h, d = shape
        assert m.box == (64, 1, rows, 1)
        assert m.dims == (d, h, s, b)  # rows past S are zero-filled by TMA, not padded here
        assert m.strides == (128, h * 128, s * h * 128)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_a_64_row_map_of_a_fused_qkv_head_slice(which):
    qkv = torch.zeros((2, 1024, 3, 10, 64), dtype=BF16)
    t = qkv[:, :, which]
    m = tma_map(t, rows=SM90_BWD_TILE_ROWS)
    assert m.dims == (64, 10, 1024, 2)
    assert m.strides == (128, 3 * 10 * 128, 1024 * 3 * 10 * 128)
    assert m.box == (64, 1, 64, 1)


def test_a_64_row_map_of_a_heads_first_gradient():
    t = torch.zeros((2, 4, 300, 64), dtype=BF16).transpose(1, 2)
    m = tma_map(t, rows=64)
    assert m.strides == (300 * 128, 128, 4 * 300 * 128) and m.box == (64, 1, 64, 1)


@pytest.mark.parametrize("d,rows", [(40, SM90_BWD_TILE_ROWS), (40, SM90_BWD_ITEM_ROWS), (80, SM90_BWD_TILE_ROWS),
                                    (80, SM90_BWD_ITEM_ROWS)])
def test_a_backward_map_at_sd15s_head_dims_is_64_column_boxes(d, rows):
    # SD1.5's level-0 / level-1 self-attention, contiguous: the box is one
    # 64-column block (128 bytes, the 128-byte swizzle), the kernel loads
    # ceil(D / 64) of them and TMA zero-fills the columns past D
    t = torch.zeros((16, 4096, 8, d), dtype=BF16)
    m = tma_map(t, who="flash_bwd_dq_sm90", name="q", rows=rows, head_dims=SM90_BWD_HEAD_DIMS)
    assert m.dims == (d, 8, 4096, 16)
    assert m.strides == (2 * d, 8 * 2 * d, 4096 * 8 * 2 * d)
    assert m.box == (64, 1, rows, 1)
    assert len(m.words()) == 11


@pytest.mark.parametrize("d,which", [(40, 0), (40, 2), (80, 1)])
def test_a_backward_map_of_a_head_slice_of_a_fused_tensor(d, which):
    qkv = torch.zeros((2, 1024, 4, 8, d), dtype=BF16)
    t = qkv[:, :, which]  # q, k, v or dO cut from one [B, S, 4, H, D] tensor, uncopied
    m = tma_map(t, rows=SM90_BWD_TILE_ROWS, head_dims=SM90_BWD_HEAD_DIMS)
    assert m.dims == (d, 8, 1024, 2)
    assert m.strides == (2 * d, 4 * 8 * 2 * d, 1024 * 4 * 8 * 2 * d)
    assert m.box == (64, 1, SM90_BWD_TILE_ROWS, 1)


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
def test_backward_views_tma_cannot_take_at_d40_are_refused(case):
    t, match = _refused_at_40()[case]
    with pytest.raises(ValueError, match=match):
        tma_map(t, who="flash_bwd_dkv_sm90", rows=SM90_BWD_TILE_ROWS, head_dims=SM90_BWD_HEAD_DIMS)


@pytest.mark.parametrize("d", [40, 80])
def test_the_forwards_map_still_refuses_sd15s_head_dims(d):
    # K1 at D = 40/80 is the mma.sync kernel: its Hopper map takes D = 64 only,
    # also after the backward's map of the same view was made and cached
    t = torch.zeros((2, 256, 8, d), dtype=BF16)
    tma_map(t, rows=SM90_BWD_TILE_ROWS, head_dims=SM90_BWD_HEAD_DIMS)
    with pytest.raises(ValueError, match="head dim"):
        tma_map(t, rows=SM90_BWD_TILE_ROWS)
    with pytest.raises(ValueError, match="head dim"):
        tma_map(t)


@pytest.mark.parametrize("rows", [0, 257])
def test_a_box_tma_cannot_hold_is_refused(rows):
    with pytest.raises(ValueError, match="box"):
        tma_map(torch.zeros((1, 8, 1, 64), dtype=BF16), rows=rows)


@pytest.mark.parametrize(
    "name,q_shape,bias_shape,mode,strides",
    [
        # CLIP-L / CLIP-bigG: causal + padding, one per prompt, broadcast over heads
        ("clip_l", (8, 77, 12, 64), (8, 1, 77, 77), 2, (77 * 77, 0)),
        ("clip_bigg", (8, 77, 20, 64), (8, 1, 77, 77), 2, (77 * 77, 0)),
        # T5-XXL: the shared relative-position table plus padding, full
        ("t5_xxl", (8, 256, 64, 64), (8, 64, 256, 256), 2, (64 * 256 * 256, 256 * 256)),
        # T5's table alone, broadcast over the batch
        ("t5_table", (8, 256, 4, 64), (1, 4, 256, 256), 2, (0, 256 * 256)),
        # the MMDiT's joint attention: a key mask over 77 + 256 + 1024 tokens
        ("mmdit_joint", (8, 1357, 24, 64), (8, 1, 1, 1357), 1, (1357, 0)),
    ],
)
def test_the_hopper_backward_reads_the_paths_biases_in_place(name, q_shape, bias_shape, mode, strides):
    q = torch.zeros(q_shape, dtype=BF16)
    bias = torch.zeros(bias_shape)
    got_mode, t, sb, sh = _bias_in_place("flash_bwd_dq_sm90", bias, q, q)
    assert (got_mode, (sb, sh)) == (mode, strides)
    assert t.data_ptr() == bias.data_ptr()  # no [B*H, Sq, Sk] copy: read where it lies
    assert t.numel() == bias.numel()
