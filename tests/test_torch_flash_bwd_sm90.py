"""What surrounds the Hopper flash backward, on the CPU: the head-dim
dispatch of dQ and dK/dV (Hopper at D = 40/64/80/128/160; the mma.sync pair at
160 on no path), the launch counters, the TMA boxes (128-byte swizzle rows
of 64 columns at every head dim, the item rows of each kernel), the
kernels' shared-memory layouts and the bias the kernels read in place.

The kernels themselves (``csrc/flash_bwd_sm90.cu``) run only on the card
and are held against the plain version in ``tests/test_torch_cuda.py``;
their C side only encodes the maps computed and checked here.
"""

import importlib.util
import inspect
import re
from pathlib import Path

import pytest
import torch

from uwudiff_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from uwudiff_tpu_torch.ops._build import SOURCES
from uwudiff_tpu_torch.ops.flash_attention import (
    BWD_HEAD_DIMS,
    MMA_BWD_HEAD_DIMS,
    SM90_BWD_DKV_ITEM_ROWS,
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
    sm90_bwd_box_rows,
    tma_map,
)

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "uwudiff_tpu_torch" / "csrc"


def _bwd_variants():
    spec = importlib.util.spec_from_file_location("flash_variants", ROOT / "flash_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.BWD_VARIANTS


BWD_VARIANTS = _bwd_variants()


@pytest.mark.parametrize("d,kernels", [(64, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (40, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (80, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (128, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90)),
                                       (160, (flash_bwd_dq_sm90, flash_bwd_dkv_sm90))])
def test_head_dim_selects_the_backward(d, kernels):
    assert d in BWD_HEAD_DIMS
    assert backward_kernels(d) == kernels
    # the mma.sync pair (D = 160) is on no path: called by name only
    assert all(flash_bwd_dq_mma not in backward_kernels(e) for e in BWD_HEAD_DIMS)
    assert all(flash_bwd_dkv_mma not in backward_kernels(e) for e in BWD_HEAD_DIMS)
    assert set(MMA_BWD_HEAD_DIMS) <= set(SM90_BWD_HEAD_DIMS)


@pytest.mark.parametrize("d", [16, 32, 48, 96, 120, 152, 256])
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
    # dK/dV's item at D = 128 and 160, the keys both consumers share, is the
    # box of its k and v maps
    item = int(re.search(r"ITEM = SPLIT \? (\d+) : ITEM_ROWS;", src)[1])
    assert item == SM90_BWD_DKV_ITEM_ROWS[128] == SM90_BWD_DKV_ITEM_ROWS[160]
    # the C side's instances are the Python side's head dims, and its swizzle
    # row (64 columns at every head dim) is the maps' box
    assert re.search(r"static_assert\(D == 40 \|\| D == 64 \|\| D == 80 \|\| D == 128 \|\| D == 160,", src)
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
                                    (80, SM90_BWD_ITEM_ROWS), (128, SM90_BWD_TILE_ROWS),
                                    (128, SM90_BWD_DKV_ITEM_ROWS[128]), (160, SM90_BWD_TILE_ROWS),
                                    (160, SM90_BWD_ITEM_ROWS)])
def test_a_backward_map_at_sd15s_head_dims_is_64_column_boxes(d, rows):
    # SD1.5's level-0 / 1 / 2 self-attention and the flux_1b step's joint
    # attention (8 x 1101 tokens, 12 heads of 128), contiguous: the box is
    # one 64-column block (128 bytes, the 128-byte swizzle), the kernel
    # loads ceil(D / 64) of them (1, 2, 2, 3) and TMA zero-fills the columns
    # past D (none at 128)
    b, s, h = (8, 1101, 12) if d == 128 else (16, 4096 if d < 160 else 256, 8)
    t = torch.zeros((b, s, h, d), dtype=BF16)
    m = tma_map(t, who="flash_bwd_dq_sm90", name="q", rows=rows, head_dims=SM90_BWD_HEAD_DIMS)
    assert m.dims == (d, h, s, b)
    assert m.strides == (2 * d, h * 2 * d, s * h * 2 * d)
    assert m.box == (64, 1, rows, 1)
    assert -(-d // m.box[0]) == {40: 1, 80: 2, 128: 2, 160: 3}[d]
    assert len(m.words()) == 11


@pytest.mark.parametrize("d", [40, 64, 80, 128, 160])
def test_each_backward_kernel_boxes_its_item_and_its_tiles(d):
    # dQ: q and dout in boxes of an item's 128 query rows, k and v of a
    # 64-key tile; dK/dV: k and v in boxes of an item's keys (128, or at
    # D = 128 and 160 the 64 both consumers share), q and dout of a 64-row
    # tile
    assert sm90_bwd_box_rows(d, False) == (SM90_BWD_ITEM_ROWS, SM90_BWD_TILE_ROWS) == (128, 64)
    assert sm90_bwd_box_rows(d, True) == (SM90_BWD_TILE_ROWS, 64 if d >= 128 else 128)
    t = torch.zeros((16, 256, 8, d), dtype=BF16)
    for dkv in (False, True):
        q_rows, k_rows = sm90_bwd_box_rows(d, dkv)
        assert tma_map(t, rows=q_rows, head_dims=SM90_BWD_HEAD_DIMS).box == (64, 1, q_rows, 1)
        assert tma_map(t, rows=k_rows, head_dims=SM90_BWD_HEAD_DIMS).box == (64, 1, k_rows, 1)
        assert (k_rows if dkv else q_rows) == _bwd_layout(d, dkv)["item"]
    assert '"uwu_flash_bwd_dkv_sm90"' in inspect.getsource(flash_bwd_dkv_sm90)
    assert "sm90_bwd_box_rows" in inspect.getsource(inspect.getmodule(flash_bwd_dkv_sm90)._bwd_sm90)


def _bwd_layout(d, dkv):
    """The shared memory of the dQ (or, with ``dkv``, the dK/dV) kernel at
    head dim ``d``, laid out as ``Cfg`` in csrc/flash_bwd_sm90.cu lays it
    out, from the constants the source declares: the item's two inputs in
    one or two buffers, then as many ring stages (two streamed tiles and
    two fp32 vectors) as fit, at most MAX_STAGES, then the mbarriers."""
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", src)[1])
             for n in ("ITEM_ROWS", "TILE", "COLS", "SMEM_MAX", "MAX_STAGES")}
    row_bytes, vec_bytes = 2 * const["COLS"], 4 * const["TILE"]
    nblk = -(-d // const["COLS"])
    item = 64 if dkv and d >= 128 else const["ITEM_ROWS"]
    bufs = 1 if d > 128 else 2
    item_bytes, tile_bytes = nblk * item * row_bytes, nblk * const["TILE"] * row_bytes
    stage_bytes = 2 * tile_bytes + 2 * vec_bytes
    fit = (const["SMEM_MAX"] - 1024 - 16 * (bufs + const["MAX_STAGES"]) - 2 * bufs * item_bytes) // stage_bytes
    stages = min(fit, const["MAX_STAGES"])
    smem = 1024 + 2 * bufs * item_bytes + stages * stage_bytes + 16 * (bufs + stages)
    return {"item": item, "bufs": bufs, "stages": stages, "smem": smem, "smem_max": const["SMEM_MAX"]}


@pytest.mark.parametrize("dkv", [False, True])
@pytest.mark.parametrize("d", [40, 64, 80, 128, 160])
def test_each_backward_layout_fits_shared_memory(d, dkv):
    # the Python mirror above follows the source's Cfg lines ...
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    for line in ("SPLIT = DKV && D >= 128;", "ITEM = SPLIT ? 64 : ITEM_ROWS;", "ITEM_BUFS = D > 128 ? 1 : 2;",
                 "STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;", "SMEM_MAX = 232448;"):
        assert line in src
    # ... and every layout fits the 227 KB a block may have, with a ring of
    # at least two stages: at D = 128 two item buffers, dQ's 64 KB of Q and
    # dO twice beside three stages, dK/dV's 32 KB of K and V (64 keys) twice
    # beside four; at 160 one, dQ's 96 KB beside two stages, dK/dV's 48 KB
    # beside three; D = 40/64/80 keep the layouts they had before
    lay = _bwd_layout(d, dkv)
    assert lay["smem"] <= lay["smem_max"] == 227 * 1024
    assert lay["stages"] == {40: 5, 64: 5, 80: 3, 128: 4 if dkv else 3, 160: 3 if dkv else 2}[d]
    assert lay["bufs"] == (1 if d == 160 else 2)
    assert lay["smem"] == {40: 151152, 64: 151152, 80: 232016}.get(d, lay["smem"])
    if d == 128:
        assert lay["smem"] == (199776 if dkv else 232016)
    if d == 160:
        assert lay["smem"] == (199232 if dkv else 198704)


def test_the_d160_instances_are_in_the_source():
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    assert "case 160: return run<160, DKV>" in src
    assert "else if constexpr (D == 160) wgmma_m64n160k16_rs_tb(d, a, desc_b);" in src  # dQ, dK and dV at N = 160
    assert "wgmma_m64n160k16_rs_tb" in (CSRC / "hopper_common.cuh").read_text()
    # the split's two roles, each with its own register budget
    for role, regs in (("DV_ONLY", 224), ("DK_ONLY", 240)):
        assert re.search(rf"setmaxnreg_inc<{regs}>\(\);\s+consume\(std::integral_constant<Role, {role}>", src)


@pytest.mark.parametrize("name", sorted(BWD_VARIANTS))
def test_each_backward_variant_changes_one_line_of_the_kernel(name):
    # flash_variants.py builds each backward variant by replacing one line of
    # flash_bwd_sm90.cu and launches it through the two wrappers' library
    # slots (boxing k and v in the variant's dK/dV item rows): each must
    # still find what it edits
    (old, new), dkv_rows, shapes = BWD_VARIANTS[name]
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    assert src.count(old) == 1 and old != new
    assert {shape[-1] for shape in shapes} <= set(SM90_BWD_HEAD_DIMS)
    assert set(dkv_rows) <= set(SM90_BWD_HEAD_DIMS) and set(dkv_rows.values()) <= {64, 128}
    assert '"uwu_flash_bwd_dq_sm90"' in inspect.getsource(flash_bwd_dq_sm90)


@pytest.mark.parametrize("d,which", [(40, 0), (40, 2), (80, 1), (128, 2), (160, 1), (160, 3)])
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


@pytest.mark.parametrize("d", [40, 80, 160])
def test_the_forwards_map_takes_sd15s_head_dims(d):
    # K1 at D = 40/80/160 is the Hopper kernel too: the forward's map of a view
    # whose backward map was made and cached first is the same geometry,
    # checked against the forward's head dims and boxed as its tiles
    from uwudiff_tpu_torch.ops.flash_attention import SM90_FWD_KEY_ROWS, SM90_FWD_Q_ROWS

    t = torch.zeros((2, 256, 8, d), dtype=BF16)
    bwd = tma_map(t, rows=SM90_BWD_TILE_ROWS, head_dims=SM90_BWD_HEAD_DIMS)
    fwd_q = tma_map(t, rows=SM90_FWD_Q_ROWS[d])
    fwd_k = tma_map(t, rows=SM90_FWD_KEY_ROWS[d])
    assert fwd_q.dims == fwd_k.dims == bwd.dims == (d, 8, 256, 2)
    assert fwd_q.strides == bwd.strides
    assert (fwd_q.box, fwd_k.box, bwd.box) == ((64, 1, 192 if d == 40 else 128, 1),
                                               (64, 1, SM90_FWD_KEY_ROWS[d], 1), (64, 1, SM90_BWD_TILE_ROWS, 1))
    assert SM90_FWD_KEY_ROWS[d] == (64 if d == 160 else 128)


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


def test_the_d128_instances_are_in_the_source():
    # Flux's head dim: dQ, dK and dV at N = 128 on wgmma.m64n128k16, both
    # kernels reading their item's operands from shared memory, dK/dV's
    # consumers split by role over 64 shared keys as at 160
    src = (CSRC / "flash_bwd_sm90.cu").read_text()
    assert "case 128: return run<128, DKV>" in src
    assert "else if constexpr (D == 128) wgmma_m64n128k16_rs_tb(d, a, desc_b);" in src
    assert "wgmma_m64n128k16_rs_tb" in (CSRC / "hopper_common.cuh").read_text()
    assert "A_SMEM = D > 64 && (DKV || D >= 128);" in src
    assert set(SM90_BWD_HEAD_DIMS) == set(BWD_HEAD_DIMS) == {40, 64, 80, 128, 160}
    # K5 (flash_bwd.cu) is built at every backward head dim
    k5 = (CSRC / "flash_bwd.cu").read_text()
    assert {int(d) for d in re.findall(r"case (\d+): return dispatch_bias<KIND, \d+>", k5)} == set(BWD_HEAD_DIMS)
