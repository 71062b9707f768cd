"""What surrounds the Hopper flash forward, on the CPU: the head-dim dispatch
and the TMA tensor-map arithmetic for ``[B, S, H, D]`` views.

The kernel itself (``csrc/flash_fwd_sm90.cu``) runs only on the card and is
held against the plain version in ``tests/test_torch_cuda.py``; its C side
only encodes the maps computed and checked here.
"""

import pytest
import torch

from uwudiff_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    TMA_BOX_ROWS,
    flash_fwd_mma,
    flash_fwd_sm90,
    forward_kernel,
    tma_map,
)

BF16 = torch.bfloat16


@pytest.mark.parametrize("d,kernel", [(64, flash_fwd_sm90), (40, flash_fwd_mma), (80, flash_fwd_mma),
                                      (160, flash_fwd_mma)])
def test_head_dim_selects_the_forward(d, kernel):
    assert d in HEAD_DIMS
    assert forward_kernel(d) is kernel


@pytest.mark.parametrize("d", [16, 32, 48, 96, 128, 256])
def test_other_head_dims_raise(d):
    with pytest.raises(ValueError, match="head dim"):
        forward_kernel(d)


def test_the_two_forwards_split_the_head_dims_and_take_cuda_tensors_only():
    from uwudiff_tpu_torch.ops.flash_attention import MMA_HEAD_DIMS, SM90_HEAD_DIMS

    assert set(SM90_HEAD_DIMS) | set(MMA_HEAD_DIMS) == set(HEAD_DIMS)
    assert not set(SM90_HEAD_DIMS) & set(MMA_HEAD_DIMS)
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
