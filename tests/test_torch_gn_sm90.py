"""What surrounds the GroupNorm forward's and backward's two routes each,
on the CPU: the plans that pick the route from the shape, the fused
kernels' tensor maps and limits, the wrappers' refusal of CPU tensors and
the launch counters.

The GroupNorm shapes of the three paths are read off the models
themselves: the SDXL UNet at 1024x1024 (a served batch of 4 under CFG, 8
rows of 128x128 latents) and at the training step's 64x64 latents (batch
8), and the SDXL VAE decoder at 1024x1024 (batch 4), each run once on the
meta device with the GroupNorm and attention calls recorded, not computed.
The served UNet's shapes are also those of a 1024x1024 training step at
batch 8. The kernels themselves (``csrc/groupnorm_silu_sm90.cu``,
``csrc/groupnorm_silu_bwd_sm90.cu``, ``csrc/groupnorm_silu.cu``) run only
on the card and are held against the plain versions in
``tests/test_torch_cuda.py``.
"""

import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from uwudiff_tpu_torch.models import AutoencoderKL, UNet2DConditionModel, layers
from uwudiff_tpu_torch.models import transformer as transformer_mod
from uwudiff_tpu_torch.models import vae as vae_mod
from uwudiff_tpu_torch.models.unet import UNET_PRESETS
from uwudiff_tpu_torch.models.vae import VAE_PRESETS
from uwudiff_tpu_torch.ops import KERNELS, launch_counts, reset_launch_counts
from uwudiff_tpu_torch.ops import groupnorm_silu as gn
from uwudiff_tpu_torch.ops._build import SOURCES
from uwudiff_tpu_torch.ops.groupnorm_silu import (
    gn_bwd_dx,
    gn_bwd_partials,
    gn_map_spec,
    gn_silu_apply,
    gn_silu_bwd_fused,
    gn_silu_fused,
    gn_stats,
    group_norm_silu,
    group_norm_silu_reference,
    plan_gn,
    plan_gn_bwd,
)

BF16 = torch.bfloat16
CSRC = Path(__file__).resolve().parent.parent / "uwudiff_tpu_torch" / "csrc"
SOURCE = CSRC / "groupnorm_silu_sm90.cu"
BWD_SOURCE = CSRC / "groupnorm_silu_bwd_sm90.cu"


def _record(run):
    """(n, hw, c, groups) of every GroupNorm that ``run`` calls, in order."""
    seen = []

    def fake_gn(x, gamma, beta, groups=32, eps=1e-5, silu=True):
        seen.append((x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1], groups))
        return torch.empty_like(x)

    def fake_attention(q, k, v, bias=None, **_):
        return torch.empty_like(q)

    with pytest.MonkeyPatch.context() as mp, torch.device("meta"), torch.no_grad():
        mp.setattr(layers, "group_norm_silu", fake_gn)
        mp.setattr(transformer_mod, "dot_product_attention", fake_attention)
        mp.setattr(vae_mod, "dot_product_attention", fake_attention)
        run()
    return seen


def _unet(batch, latent):
    unet = UNet2DConditionModel(**UNET_PRESETS["sdxl"]).to(BF16)
    unet(torch.empty((batch, latent, latent, 4), dtype=BF16), torch.zeros(batch),
         torch.empty((batch, 77, 2048), dtype=BF16),
         added_cond={"time_ids": torch.empty((batch, 6)), "text_embeds": torch.empty((batch, 1280), dtype=BF16)})


@pytest.fixture(scope="module")
def paths():
    return {"train": _record(lambda: _unet(8, 64)), "serve": _record(lambda: _unet(8, 128)),
            "vae": _record(lambda: AutoencoderKL(**VAE_PRESETS["sdxl"]).to(BF16).decode(
                torch.empty((4, 128, 128, 4), dtype=BF16)))}


def test_every_groupnorm_of_the_training_step_takes_the_fused_kernel(paths):
    assert len(paths["train"]) == 46
    assert all(plan_gn(*s, BF16).route == "fused" for s in paths["train"]), Counter(paths["train"])


def test_the_served_unet_routes_all_but_its_widest_level_0_norm_to_the_fused_kernel(paths):
    assert len(paths["serve"]) == 46
    chunked = [s for s in paths["serve"] if plan_gn(*s, BF16).route == "chunked"]
    # the first up-block ResNet at level 0: a 120-channel slab (4 groups of
    # 30, the fewest whole groups in 16 bytes) of 16384 rows is 3.9 MB, over
    # 16 blocks of TILE_MAX
    assert chunked == [(8, 16384, 960, 32)]


def test_the_vae_decoder_fuses_its_128_level_only(paths):
    """The 256^2 level fits 16 blocks of 128 KB, one block an SM over many
    waves: the chunked pair is faster there, and plan_gn sends it there."""
    assert len(paths["vae"]) == 30
    for s in paths["vae"]:
        assert plan_gn(*s, BF16).route == ("fused" if s[1] <= 128 * 128 else "chunked"), s


def test_every_groupnorm_backward_of_the_training_step_fuses_but_the_widest_level_0_one(paths):
    """plan_gn's rules applied to the x and dy tiles together: the up
    path's [8,4096,960] (a 120-channel slab of 4096 rows, two tiles of
    1.97 MB) fits only 16 blocks of 123 KB, one block an SM over several
    waves, and takes the pair; the other 45 fuse."""
    routes = Counter((s, plan_gn_bwd(*s, BF16).route) for s in paths["train"])
    assert [s for (s, r), k in routes.items() if r == "pair" for _ in range(k)] == [(8, 4096, 960, 32)]
    assert sum(k for (_, r), k in routes.items() if r == "fused") == 45


def test_a_1024_training_step_sends_its_widest_norms_to_the_pair(paths):
    """At 128x128 latents (the served UNet's shapes, batch 8) level 0 at
    16384 rows does not fit a cluster's shared memory as x and dy, nor do
    the two widest concatenations of level 1."""
    pair = Counter(s for s in paths["serve"] if plan_gn_bwd(*s, BF16).route == "pair")
    assert pair == Counter({(8, 16384, 320, 32): 8, (8, 16384, 640, 32): 2, (8, 16384, 960, 32): 1,
                            (8, 4096, 960, 32): 1, (8, 4096, 1920, 32): 1})


def test_every_fused_plan_fits_the_kernel(paths):
    """Each fused plan of the paths: a slab of whole groups and a 16-byte
    multiple (a legal TMA box), boxes of at most 256 rows that start
    128-byte aligned, a tile within one block's shared memory, a cluster
    of at most 16 blocks that covers every row."""
    for n, hw, c, groups in sorted(set(paths["train"] + paths["serve"] + paths["vae"])):
        for dtype, es in ((BF16, 2), (torch.float32, 4)):
            p = plan_gn(n, hw, c, groups, dtype)
            if p.route != "fused":
                continue
            cg = c // groups
            assert p.slab % cg == 0 and c % p.slab == 0 and p.slab // cg <= gn.MAX_SLAB_GROUPS
            assert p.slab * es % 16 == 0 and p.slab <= gn.MAX_SLAB
            assert p.cluster in (1, 2, 4, 8, 16) and p.cluster <= gn.MAX_CLUSTER
            assert p.box_rows % 8 == 0 and 8 <= p.box_rows <= gn.MAX_BOX_ROWS
            assert p.rows_per_cta % p.box_rows == 0 and p.rows_per_cta // p.box_rows <= gn.MAX_BOXES
            assert p.rows_per_cta * p.cluster >= hw > (p.rows_per_cta - p.box_rows) * p.cluster - p.box_rows
            assert p.tile_bytes == p.rows_per_cta * p.slab * es <= gn.TILE_MAX
            words = gn_map_spec(n, hw, c, p, dtype)
            assert words == (c, hw, n, c * es, hw * c * es, p.slab, p.box_rows, 1)


def test_every_fused_backward_plan_fits_the_kernel(paths):
    """As the forward's, with both tiles (x and dy) in tile_bytes; the
    slab is the forward's, so the backward's maps have the forward's
    geometry at its own box rows."""
    for n, hw, c, groups in sorted(set(paths["train"] + paths["serve"] + paths["vae"])):
        for dtype, es in ((BF16, 2), (torch.float32, 4)):
            p = plan_gn_bwd(n, hw, c, groups, dtype)
            if p.route != "fused":
                assert p.route == "pair"
                continue
            assert p.slab in (plan_gn(n, hw, c, groups, dtype).slab, 0) and p.slab // (c // groups) <= 8
            assert p.cluster in (1, 2, 4, 8, 16) and p.rows_per_cta * p.cluster >= hw
            assert p.box_rows % 8 == 0 and 8 <= p.box_rows <= gn.MAX_BOX_ROWS
            assert p.rows_per_cta % p.box_rows == 0 and p.rows_per_cta // p.box_rows <= gn.MAX_BOXES
            assert p.tile_bytes == 2 * p.rows_per_cta * p.slab * es <= gn.TILE_MAX
            units = n * c // p.slab
            assert units * p.cluster <= gn.SMS or p.tile_bytes <= gn.TILE_TWO_PER_SM
            assert gn_map_spec(n, hw, c, p, dtype) == (c, hw, n, c * es, hw * c * es, p.slab, p.box_rows, 1)


@pytest.mark.parametrize("shape,cluster,rows", [((8, 4096, 320), 8, 512), ((8, 4096, 640), 8, 512),
                                                ((8, 1024, 640), 1, 1024), ((8, 1024, 320), 2, 512),
                                                ((8, 256, 1280), 1, 256), ((8, 1024, 1920), 8, 128),
                                                ((4, 16384, 512), 16, 1024), ((3, 77, 64), 1, 80)])
def test_backward_plan_pins_the_cluster(shape, cluster, rows):
    """The smallest cluster that fits a one-wave grid ([8,1024,640]: 128
    blocks of 160 KB), doubled once at [8,1024,320] to fill half the SMs;
    in a multi-wave grid the smallest whose two tiles let two blocks share
    an SM ([8,4096,320]: 512 blocks of 80 KB)."""
    n, hw, c = shape
    p = plan_gn_bwd(n, hw, c, 32 if c > 64 else 8, BF16)
    assert (p.route, p.cluster, p.rows_per_cta) == ("fused", cluster, rows)


@pytest.mark.parametrize("shape,cluster,rows", [((8, 1024, 320), 2, 512), ((8, 4096, 320), 2, 2048),
                                                ((8, 1024, 2560), 2, 512), ((8, 16384, 320), 16, 1024),
                                                ((4, 16384, 512), 8, 2048), ((8, 1024, 1280), 1, 1024),
                                                ((3, 77, 64), 1, 80)])
def test_plan_pins_the_cluster(shape, cluster, rows):
    """The cluster: the smallest that fits when its grid is one wave (at
    [8,1024,320] doubled once to fill half the SMs), else two blocks an
    SM."""
    n, hw, c = shape
    p = plan_gn(n, hw, c, 32 if c > 64 else 8, BF16)
    assert (p.route, p.cluster, p.rows_per_cta) == ("fused", cluster, rows)


def test_plan_constants_are_the_sources():
    """The Python plan and the kernel agree on every limit, and the tile
    limits leave room for the kernel's static buffers in 227 KB a block
    (TILE_MAX) and in 228 KB for two blocks an SM (TILE_TWO_PER_SM, with
    the 1 KB the card reserves a block)."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    for name in ("MAX_BOX_ROWS", "MAX_BOXES", "MAX_SLAB", "MAX_SLAB_GROUPS", "MAX_CLUSTER", "TILE_MAX",
                 "TILE_TWO_PER_SM"):
        assert const(name) == getattr(gn, name), name
    threads, groups = const("THREADS"), const("MAX_SLAB_GROUPS")
    static = (threads * 8 * 4 + threads * 4 + 3 * const("MAX_SLAB") * 4
              + groups * (4 + const("MAX_CLUSTER")) * 4 + const("MAX_BOXES") * 8)
    align = const("TILE_ALIGN")
    assert gn.TILE_MAX + align + static <= 232448
    assert 2 * (gn.TILE_TWO_PER_SM + align + static + 1024) <= 233472
    assert "groupnorm_silu_sm90.cu" in SOURCES


def test_backward_kernel_constants_are_the_sources():
    """The backward kernel keeps the forward's limits, so plan_gn_bwd uses
    plan_gn's constants, and its static buffers (the per-row-thread sums,
    the row segments, four per-channel coefficient rows, the group means,
    the mbarriers) leave TILE_MAX for both tiles in 227 KB a block and
    TILE_TWO_PER_SM for two blocks an SM."""
    text = BWD_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    for name in ("MAX_BOX_ROWS", "MAX_BOXES", "MAX_SLAB", "MAX_SLAB_GROUPS", "MAX_CLUSTER", "TILE_MAX",
                 "TILE_TWO_PER_SM"):
        assert const(name) == getattr(gn, name), name
    threads, slab = const("THREADS"), const("MAX_SLAB")
    vec = const("THREAD_BYTES") // 2  # bf16 channels a thread holds: the larger buffer of the sums
    static = (threads * vec * 2 * 4 + const("SEG") * 4 + 4 * slab * 4 + 2 * const("MAX_SLAB_GROUPS") * 4
              + const("MAX_BOXES") * 8)
    assert const("SEG") >= max(threads, 2 * slab)
    assert gn.TILE_MAX + const("TILE_ALIGN") + static <= 232448
    assert 2 * (gn.TILE_TWO_PER_SM + const("TILE_ALIGN") + static + 1024) <= 233472
    assert "groupnorm_silu_bwd_sm90.cu" in SOURCES


def test_backward_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        plan_gn_bwd(1, 64, 64, 32, torch.float16)
    with pytest.raises(ValueError, match="divisible"):
        plan_gn_bwd(1, 64, 96, 64, BF16)
    assert plan_gn_bwd(1, 64, 15, 5, BF16).route == "pair"  # no 16-byte slab of whole groups
    # the forward fuses these (one tile fits), the backward's two tiles do not
    for shape in ((8, 4096, 960), (8, 16384, 320)):
        assert plan_gn(*shape, 32, BF16).route == "fused" and plan_gn_bwd(*shape, 32, BF16).route == "pair"
    assert plan_gn_bwd(1, 64, 64, 32, BF16) is plan_gn_bwd(1, 64, 64, 32, BF16)  # cached: a pure function


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        plan_gn(1, 64, 64, 32, torch.float16)
    with pytest.raises(ValueError, match="divisible"):
        plan_gn(1, 64, 96, 64, BF16)
    # no whole number of groups is 16 bytes wide: 3 channels a group, 5 groups
    assert plan_gn(1, 64, 15, 5, BF16).route == "chunked"
    # the VAE's last level: 16 blocks cannot hold a slab of 1048576 rows
    assert plan_gn(4, 1048576, 128, 32, BF16).route == "chunked"
    # the VAE's 256^2 level: 16 blocks of 128 KB, one an SM, over many waves
    assert plan_gn(4, 65536, 512, 32, BF16).route == "chunked"
    assert plan_gn(1, 64, 64, 32, BF16) is plan_gn(1, 64, 64, 32, BF16)  # cached: a pure function


@pytest.mark.parametrize("wrapper", ["fused", "stats", "apply"])
def test_the_kernels_take_cuda_tensors_only(wrapper):
    x = torch.zeros((2, 64, 64), dtype=BF16)
    gamma, beta = torch.ones(64), torch.zeros(64)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "fused":
            gn_silu_fused(x, gamma, beta, 32, 1e-5)
        elif wrapper == "stats":
            gn_stats(x, gamma, beta, 32, 1e-5)
        else:
            gn_silu_apply(x, torch.ones(2, 64), torch.zeros(2, 64))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("wrapper", ["bwd_fused", "partials", "dx"])
def test_the_backward_kernels_take_cuda_tensors_only(wrapper):
    x = torch.zeros((2, 64, 64), dtype=BF16)
    gamma, sc = torch.ones(64), torch.ones(2, 64)
    mean, inv = torch.zeros(2, 32), torch.ones(2, 32)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "bwd_fused":
            gn_silu_bwd_fused(x, x, gamma, sc, sc, mean, inv)
        elif wrapper == "partials":
            gn_bwd_partials(x, x, gamma, sc, sc, mean, inv)
        else:
            gn_bwd_dx(x, x, torch.ones(2, 4, 64))
    assert not any(launch_counts().values())


def test_backward_launch_counters_and_the_cpu_path():
    """The fused backward is a kernel of its own in KERNELS; autograd on
    CPU tensors runs the plain backward and launches nothing."""
    assert KERNELS["gn_silu_bwd_fused"] is gn_silu_bwd_fused
    gn_silu_bwd_fused.launches = 2
    assert launch_counts()["gn_silu_bwd_fused"] == 2
    reset_launch_counts()
    assert launch_counts()["gn_silu_bwd_fused"] == 0
    x = torch.randn((2, 8, 8, 64), requires_grad=True)
    gamma, beta = torch.randn(64, requires_grad=True), torch.randn(64, requires_grad=True)
    grads = torch.autograd.grad(group_norm_silu(x, gamma, beta, 32, 1e-5).sum(), (x, gamma, beta))
    assert all(torch.isfinite(g).all() for g in grads)
    assert not any(launch_counts().values())


def test_launch_counters_and_the_cpu_path():
    assert KERNELS["gn_silu_fused"] is gn_silu_fused
    gn_silu_fused.launches = 3
    assert launch_counts()["gn_silu_fused"] == 3
    reset_launch_counts()
    assert launch_counts()["gn_silu_fused"] == 0
    x = torch.randn((2, 8, 8, 64))
    gamma, beta = torch.randn(64), torch.randn(64)
    y = group_norm_silu(x, gamma, beta, 32, 1e-5)  # plain version: counts nothing
    assert torch.equal(y, group_norm_silu_reference(x, gamma, beta, 32, 1e-5))
    assert not any(launch_counts().values())
