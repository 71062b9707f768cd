"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Every test is marked ``cuda`` and skips where no GPU is visible. This
file imports torch and the port only, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are bf16 ones: the kernels round their outputs (and flash
attention its P and dS tiles) to bf16 once, the plain versions compute
in fp32. The Hopper forward and the backward kernels are also held to
bitwise reproducibility.
"""

import pytest
import torch

from uwudiff_tpu_torch.ops import FORWARD_KERNELS, launch_counts, reset_launch_counts
from uwudiff_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_fwd,
    flash_fwd_mma,
    flash_fwd_sm90,
)
from uwudiff_tpu_torch.ops.groupnorm_silu import (
    gn_bwd_dx,
    gn_bwd_dx_reference,
    gn_bwd_partials,
    gn_bwd_partials_reference,
    gn_silu_apply,
    gn_silu_bwd_fused,
    gn_silu_bwd_fused_reference,
    gn_silu_fused,
    gn_stats,
    gn_stats_reference,
    group_norm_silu,
    group_norm_silu_reference,
    plan_gn,
    plan_gn_bwd,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bias(kind, b, h, sq, sk, dev, gen):
    neg = torch.finfo(torch.float32).min
    if kind == "none":
        return None
    if kind == "key":
        keep = torch.arange(sk, device=dev)[None, :] < torch.tensor([sk // 3, sk] * b, device=dev)[:b, None]
        return torch.where(keep, 0.0, neg)[:, None, None, :]
    causal = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
    full = torch.where(causal, 0.0, neg)[None, None] + torch.where(causal, 0.0, neg)[None, None]
    return full + torch.randn((b, h, sq, sk), generator=gen, device=dev)


def _assert_flash_close(out, ref):
    """The bound of every kernel check, per output (out, dq, dk, dv, t1/t2,
    dx, dgamma, dbeta). Out and ref are both rounded to bf16, so they may
    differ by one bf16 step (2**-7 relative at most) per element: the
    largest error is held to one step of the largest output plus 2**-10
    for the P (or dS) tile's rounding, and the RMS error to one step of
    the RMS output, which a lost K/V tile (~1/n_tiles of every row)
    exceeds many times over."""
    diff, ref = (out.float() - ref.float()), ref.float()
    assert diff.abs().max().item() <= 2.0**-7 * ref.abs().max().item() + 2.0**-10
    assert diff.pow(2).mean().sqrt().item() <= 2.0**-7 * ref.pow(2).mean().sqrt().item()


@pytest.mark.parametrize(
    "b,sq,sk,h,d,kind",
    [
        (2, 256, 256, 2, 64, "none"),
        (2, 200, 77, 3, 64, "none"),
        (2, 77, 77, 4, 64, "full"),
        (2, 130, 300, 2, 40, "key"),
        (1, 64, 129, 2, 80, "none"),
        (1, 100, 100, 2, 160, "full"),
        (2, 130, 300, 2, 128, "key"),
    ],
)
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, d, kind):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    bias = _bias(kind, b, h, sq, sk, dev, gen)
    out, lse = flash_fwd(q, k, v, bias)
    ref, ref_lse = flash_attention_reference(q, k, v, bias)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


def test_flash_kernel_takes_strided_heads(dev):
    """q/k/v as column slices of one fused projection: no copy needed."""
    qkv = torch.randn((2, 96, 3 * 4 * 64), device=dev, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 96, 4, 64) for t in qkv.chunk(3, dim=-1))
    out, _ = flash_fwd(q, k, v)
    ref, _ = flash_attention_reference(q, k, v)
    _assert_flash_close(out, ref)


# every D = 64 attention shape the serve, train and textual-inversion paths
# run (B, Sq, Sk, H, D, bias kind, scale), and a ragged one with a key mask;
# SD1.5's eight at D = 40/80/160 (each level's self- and cross-attention at
# 64^2 latents, batch cut to 2), and a key and a full bias at each head dim;
# Flux's D = 128 joint attention at 1024^2 (512 text + 4096 image tokens,
# the T5 mask as a key bias) and at 512^2, unmasked
_PATH_CASES = [
    (8, 4096, 4096, 10, 64, "none", None),  # SDXL level 1 self-attention, serving (128^2 latents)
    (8, 1024, 1024, 20, 64, "none", None),  # level 2, serving
    (8, 4096, 77, 10, 64, "none", None),  # cross-attention over the 77 text tokens
    (8, 1024, 77, 20, 64, "none", None),
    (8, 1024, 1024, 10, 64, "none", None),  # the training step at 64^2 latents
    (8, 256, 256, 20, 64, "none", None),
    (8, 1024, 77, 10, 64, "none", None),
    (8, 256, 77, 20, 64, "none", None),
    (8, 77, 77, 20, 64, "full", None),  # CLIP-bigG, causal + padding
    (8, 77, 77, 12, 64, "full", None),  # CLIP-L
    (8, 256, 256, 64, 64, "full", 1.0),  # T5-XXL: learned bias, no 1/sqrt(d)
    (8, 1357, 1357, 24, 64, "key", None),  # the SD3 MMDiT's joint attention with the text mask
    (2, 200, 200, 4, 64, "key", None),
    (2, 4096, 4096, 8, 40, "none", None),  # SD1.5 level 0
    (2, 4096, 77, 8, 40, "none", None),
    (2, 1024, 1024, 8, 80, "none", None),  # level 1
    (2, 1024, 77, 8, 80, "none", None),
    (2, 256, 256, 8, 160, "none", None),  # level 2
    (2, 256, 77, 8, 160, "none", None),
    (2, 64, 64, 8, 160, "none", None),  # the mid block
    (2, 64, 77, 8, 160, "none", None),
    (2, 300, 200, 3, 40, "key", None),
    (2, 130, 130, 3, 40, "full", None),
    (2, 300, 200, 3, 80, "key", None),
    (2, 130, 130, 3, 80, "full", None),
    (2, 300, 200, 3, 160, "key", None),
    (2, 130, 130, 3, 160, "full", None),
    (1, 4608, 4608, 24, 128, "key", None),  # flux_dev's served step
    (2, 1536, 1536, 24, 128, "none", None),  # a 512^2 request
    (2, 300, 200, 3, 128, "key", None),
    (2, 130, 130, 3, 128, "full", None),
    (16, 256, 256, 16, 72, "none", None),  # DiT-XL/2: CFG over 8 labels at 256^2
    (2, 1024, 1024, 16, 72, "none", None),  # a lone 512^2 request
    (2, 300, 200, 3, 72, "key", None),
    (2, 130, 130, 3, 72, "full", None),
]


@pytest.mark.parametrize("b,sq,sk,h,d,kind,scale", _PATH_CASES)
def test_hopper_forward_matches_plain_at_the_path_shapes(dev, b, sq, sk, h, d, kind, scale):
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    bias = _bias(kind, b, h, sq, sk, dev, gen)
    reset_launch_counts()
    out, lse = flash_fwd(q, k, v, bias, scale)
    assert launch_counts()["flash_fwd_sm90"] == 1 and launch_counts()["flash_fwd_mma"] == 0
    again = flash_fwd(q, k, v, bias, scale)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])  # bitwise from run to run
    del again
    ref, ref_lse = flash_attention_reference(q, k, v, bias, scale)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("d", [64, 40, 128, 72])
def test_hopper_forward_takes_fused_qkv_head_views(dev, d):
    """q/k/v as [B, S, H, D] views of one [B, S, 3, H, D] projection go
    into the tensor maps with their own strides, uncopied."""
    gen = torch.Generator(device=dev).manual_seed(8)
    qkv = torch.randn((2, 300, 3, 4, d), generator=gen, device=dev, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out, lse = flash_fwd_sm90(q, k, v)
    ref, ref_lse = flash_attention_reference(q, k, v)
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("bias_shape", [(2, 1, 100, 130), (1, 3, 100, 130), (1, 1, 100, 130)])
def test_hopper_forward_reads_a_broadcast_full_bias_in_place(dev, bias_shape):
    """A full bias that broadcasts over heads or batch (CLIP's [B, 1, Sq,
    Sk]) is read through zero strides, not expanded into a copy."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((2, 100, 3, 64), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((2, 130, 3, 64), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    bias = torch.randn(bias_shape, generator=gen, device=dev)
    bias[..., 100:] = float("-inf")
    out, lse = flash_fwd_sm90(q, k, v, bias)
    ref, ref_lse = flash_attention_reference(q, k, v, bias)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


def test_hopper_forward_refuses_views_tma_cannot_take(dev):
    """A stride-0 head view (k shared across heads) and a start that is not
    16-byte aligned raise; nothing is copied and nothing launches."""
    q = torch.randn((2, 128, 4, 64), device=dev, dtype=torch.bfloat16)
    shared = torch.randn((2, 128, 1, 64), device=dev, dtype=torch.bfloat16).expand(2, 128, 4, 64)
    flat = torch.randn(2 * 128 * 4 * 64 + 4, device=dev, dtype=torch.bfloat16)
    misaligned = flat[4:].view(2, 128, 4, 64)  # 8 bytes past an aligned start
    reset_launch_counts()
    with pytest.raises(ValueError, match="TMA"):
        flash_fwd(q, shared, shared)
    with pytest.raises(ValueError, match="aligned"):
        flash_fwd(q, misaligned, misaligned)
    assert launch_counts()["flash_fwd"] == 0


@pytest.mark.parametrize("d,kernel", [(64, "flash_fwd_sm90"), (40, "flash_fwd_sm90"), (80, "flash_fwd_sm90"),
                                      (128, "flash_fwd_sm90"), (160, "flash_fwd_sm90"), (72, "flash_fwd_sm90")])
def test_forward_dispatches_on_the_head_dim(dev, d, kernel):
    """Every head dim on the Hopper forward; the mma.sync one, on no path,
    refuses D = 64 and 128 and is right at SD1.5's head dims."""
    from uwudiff_tpu_torch.ops.flash_attention import MMA_HEAD_DIMS, forward_kernel

    assert forward_kernel(d) is flash_fwd_sm90
    q = torch.randn((1, 130, 2, d), device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    out, _ = flash_fwd(q, q, q)
    counts = launch_counts()
    assert counts[kernel] == counts["flash_fwd"] == 1
    ref = flash_attention_reference(q, q, q)[0]
    _assert_flash_close(out, ref)
    if d not in MMA_HEAD_DIMS:
        with pytest.raises(ValueError, match="head dim"):
            flash_fwd_mma(q, q, q)
    else:
        _assert_flash_close(flash_fwd_mma(q, q, q)[0], ref)


@pytest.mark.parametrize(
    "b,sq,sk,h,d,kind",
    [(2, 4096, 4096, 2, 40, "none"), (2, 256, 77, 8, 40, "key"), (2, 1024, 1024, 2, 80, "none"),
     (2, 130, 300, 2, 80, "full"), (2, 256, 256, 8, 160, "none"), (1, 100, 100, 2, 160, "full")],
)
def test_mma_forward_matches_plain(dev, b, sq, sk, h, d, kind):
    """The mma.sync forward, the Hopper one's yardstick at SD1.5's head
    dims, called directly: it stays right though no path launches it."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    bias = _bias(kind, b, h, sq, sk, dev, gen)
    reset_launch_counts()
    out, lse = flash_fwd_mma(q, k, v, bias)
    assert launch_counts()["flash_fwd_mma"] == 1 and launch_counts()["flash_fwd_sm90"] == 0
    ref, ref_lse = flash_attention_reference(q, k, v, bias)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_flash_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,hw,c,groups", [(2, 1000, 320, 32), (1, 4096, 2560, 32), (3, 77, 64, 8)])
@pytest.mark.parametrize("silu", [True, False])
def test_gn_kernels_match_plain(dev, dtype, n, hw, c, groups, silu):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((n, hw, c), generator=gen, device=dev) * 3.0 + 1.0).to(dtype)
    gamma = torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0
    beta = torch.randn(c, generator=gen, device=dev) * 0.1
    scale, shift = gn_stats(x, gamma, beta, groups, 1e-5)
    rs, rsh = gn_stats_reference(x, gamma, beta, groups, 1e-5)
    torch.testing.assert_close(scale, rs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(shift, rsh, rtol=1e-4, atol=1e-4)
    y = group_norm_silu(x, gamma, beta, groups, 1e-5, silu=silu)
    yr = group_norm_silu_reference(x, gamma, beta, groups, 1e-5, silu=silu)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (y.float() - yr.float()).abs().max().item() <= tol * max(1.0, yr.abs().max().item())


# the GroupNorm shapes of the paths on both routes (plan_gn): the training
# step's and the served UNet's levels and the VAE decoder's 128^2 level
# (fused), the served UNet's [8,16384,960] and the VAE's 256^2 and 512^2
# levels (chunked), and a ragged small shape
GN_PATH_CASES = [
    (8, 1024, 320, 32), (8, 256, 2560, 32), (8, 4096, 1920, 32), (8, 16384, 320, 32), (4, 16384, 512, 32),
    (4, 65536, 512, 32), (3, 77, 64, 8), (8, 16384, 960, 32), (1, 262144, 256, 32),
    # the SDXL VAE encoder's at a 1024^2 batch of 4 that no other path runs:
    # down_1 res_0's first norm and down_2 res_0's
    (4, 262144, 128, 32), (4, 65536, 256, 32),
]


@pytest.mark.parametrize("dtype,n,hw,c,groups", [(torch.bfloat16, *s) for s in GN_PATH_CASES]
                         + [(torch.float32, *s) for s in GN_PATH_CASES if s[0] * s[1] * s[2] <= 40_000_000])
@pytest.mark.parametrize("silu", [True, False])
def test_gn_routes_match_plain(dev, dtype, n, hw, c, groups, silu):
    """Each route against the plain version: y within one bf16 step of the
    largest output plus 1e-3 (bf16) or 1e-4 relative (fp32), the
    statistics the autograd function saves within 1e-4 relative (shift,
    which cancels, within 1e-4 absolute + relative), bitwise
    over two runs, one launch on the fused route (two on the chunked).
    fp32 at the shapes up to 40 M elements (both routes among them)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
    gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).to(dtype)
    beta = (torch.randn(c, generator=gen, device=dev) * 0.1).to(dtype)
    fused = plan_gn(n, hw, c, groups, dtype).route == "fused"
    reset_launch_counts()
    y = group_norm_silu(x, gamma, beta, groups, 1e-5, silu=silu)
    counts = launch_counts()
    assert (counts["gn_silu_fused"], counts["gn_stats"], counts["gn_silu_apply"]) == ((1, 0, 0) if fused else (0, 1, 1))
    assert torch.equal(y, group_norm_silu(x, gamma, beta, groups, 1e-5, silu=silu))
    yr = group_norm_silu_reference(x, gamma, beta, groups, 1e-5, silu=silu).float()
    tol = 2.0**-7 * yr.abs().max().item() + 1e-3 if dtype == torch.bfloat16 else 1e-4 * max(1.0, yr.abs().max().item())
    assert (y.float() - yr).abs().max().item() <= tol
    if fused:
        y2, stats = gn_silu_fused(x, gamma, beta, groups, 1e-5, silu, with_stats=True)
        assert torch.equal(y2, y)
    else:
        stats = gn_stats(x, gamma, beta, groups, 1e-5, with_group_stats=True)
    scale, shift, mean, inv = stats
    rs, rsh, rm, ri = gn_stats_reference(x, gamma, beta, groups, 1e-5, with_group_stats=True)
    for got, ref in ((scale, rs), (mean, rm), (inv, ri)):
        assert ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max().item() <= 1e-4
    # shift = beta - mean*scale cancels near zero: held as test_gn_kernels_match_plain holds it
    torch.testing.assert_close(shift, rsh, rtol=1e-4, atol=1e-4)


def test_gn_fused_refuses_a_chunked_shape(dev):
    x = torch.zeros((8, 16384, 960), device=dev, dtype=torch.bfloat16)
    one = torch.ones(960, device=dev)
    with pytest.raises(ValueError, match="plan_gn"):
        gn_silu_fused(x, one, one, 32, 1e-5)


@pytest.mark.parametrize("n,hw,c", [(8, 1024, 640), (2, 4096, 320)])
def test_gn_fused_stats_feed_the_backward(dev, n, hw, c):
    """Autograd through the fused kernel's saved statistics into the fused
    backward, against autograd of the fp32 plain forward."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
    g = torch.randn((n, hw, c), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).requires_grad_()
    beta = (torch.randn(c, generator=gen, device=dev) * 0.1).requires_grad_()
    assert plan_gn(n, hw, c, 32, torch.bfloat16).route == plan_gn_bwd(n, hw, c, 32, torch.bfloat16).route == "fused"
    xg = x.detach().requires_grad_()
    reset_launch_counts()
    got = torch.autograd.grad(group_norm_silu(xg, gamma, beta, 32, 1e-5), (xg, gamma, beta), g)
    counts = launch_counts()
    assert counts["gn_silu_fused"] == counts["gn_silu_bwd_fused"] == 1
    assert counts["gn_stats"] == counts["gn_bwd_partials"] == counts["gn_bwd_dx"] == 0
    xr = x.float().requires_grad_()
    ref = torch.autograd.grad(group_norm_silu_reference(xr, gamma, beta, 32, 1e-5), (xr, gamma, beta), g.float())
    for a, r in zip(got, ref):
        _assert_flash_close(a, r)


def test_attention_dispatch_on_cuda(dev):
    """Every head dim up to 256 goes to the kernel, at any Sq/Sk (77 keys
    included), and raises if the kernel was not built for it; the VAE's
    single-head D=512 takes the einsum."""
    from uwudiff_tpu_torch.ops.attention import attention_reference, dot_product_attention

    q = torch.randn((2, 300, 2, 64), device=dev, dtype=torch.bfloat16)
    kv = torch.randn((2, 77, 2, 64), device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    dot_product_attention(q, kv, kv)
    assert launch_counts()["flash_fwd"] == 1
    q32 = torch.randn((2, 300, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        dot_product_attention(q32, q32, q32)
    x = torch.randn((1, 256, 1, 512), device=dev, dtype=torch.bfloat16)
    out = dot_product_attention(x, x, x)
    assert launch_counts()["flash_fwd"] == 1
    assert torch.equal(out, attention_reference(x, x, x))


def test_gn_stats_is_bitwise_reproducible(dev):
    x = torch.randn((2, 4096, 640), device=dev, dtype=torch.bfloat16)
    gamma, beta = torch.ones(640, device=dev), torch.zeros(640, device=dev)
    first = gn_stats(x, gamma, beta, 32, 1e-5)
    for _ in range(3):
        again = gn_stats(x, gamma, beta, 32, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.randn((1, 16, 2, 64), device=dev)
    with pytest.raises(TypeError):
        flash_fwd(q, q, q)  # fp32
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(qb[..., :48], qb[..., :48], qb[..., :48])
    x = torch.randn((1, 8, 8, 64), device=dev).permute(0, 3, 1, 2)  # NCHW, not channels-last
    with pytest.raises(ValueError, match="contiguous"):
        group_norm_silu(x.permute(0, 2, 3, 1).transpose(1, 2), torch.ones(64, device=dev),
                        torch.zeros(64, device=dev))
    with pytest.raises(ValueError):
        gn_silu_apply(torch.randn((1, 8, 12), device=dev, dtype=torch.bfloat16),
                      torch.ones(1, 12, device=dev), torch.zeros(1, 12, device=dev))


def test_tiny_pipeline_runs_through_the_kernels(dev):
    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.models import (
        AutoencoderKL,
        ConcatTextEncoders,
        SimpleTokenizer,
        TextEncodingPipeline,
        UNet2DConditionModel,
    )
    from uwudiff_tpu_torch.serving import Txt2ImgPipeline

    torch.manual_seed(0)
    bf16 = torch.bfloat16
    # head dim 64 everywhere: the tiny presets' 16 and 32 are not among
    # the flash kernel's head dims and raise on the card
    clip = {"preset": "tiny", "hidden_size": 128, "num_heads": 2}
    te = ConcatTextEncoders.from_config(
        [(clip, {"layer_idx": -2}), (clip, {"use_pooled": True, "layer_idx": -2})],
        device=dev, dtype=bf16,
    )
    unet = UNet2DConditionModel.from_config(
        "tiny_sdxl", device=dev, dtype=bf16, block_out_channels=(64, 128),
        cross_attention_dim=256, projection_class_embeddings_input_dim=128 + 48,
    )
    vae = AutoencoderKL.from_config("tiny", device=dev, dtype=bf16, block_out_channels=(32, 64))
    pipe = Txt2ImgPipeline(unet, TextEncodingPipeline(te, [SimpleTokenizer()] * 2, device=dev),
                           vae, NoiseSchedule.sdxl(), device=dev)
    reset_launch_counts()
    images = pipe(["a cat", "a dog"], num_steps=2, num_samples=2, width=64, height=64, seed=[1, 2])
    counts = launch_counts()
    assert all(img.shape == (64, 64, 3) for img in images)
    # every GroupNorm of this small pipeline fits a cluster (plan_gn), so the
    # chunked pair of the forward kernels is not launched; serving runs no backward
    assert counts.pop("gn_stats") == counts.pop("gn_silu_apply") == 0, counts
    assert all(counts[k] > 0 for k in FORWARD_KERNELS if k in counts), counts


def test_vae_tiles_on_the_card(dev):
    """A single-tile ``decode_tiled``/``encode_tiled`` is the untiled call,
    bitwise; the multi-tile ones run through the kernels to finite outputs
    of the untiled shapes."""
    from uwudiff_tpu_torch.models import AutoencoderKL

    torch.manual_seed(0)
    vae = AutoencoderKL.from_config("tiny", device=dev, dtype=torch.bfloat16, block_out_channels=(32, 64))
    gen = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((2, 32, 32, 4), generator=gen, device=dev)
    x = torch.rand((2, 64, 64, 3), generator=gen, device=dev) * 2 - 1
    with torch.inference_mode():
        assert torch.equal(vae.decode_tiled(z, tile=32), vae.decode(z))
        single = vae.encode_tiled(x, tile=64)
        whole = vae.encode(x)
        assert torch.equal(single.mean, whole.mean) and torch.equal(single.logvar, whole.logvar)
        reset_launch_counts()
        tiled = vae.decode_tiled(z, tile=16, overlap=4)
        assert launch_counts()["gn_silu_fused"] > 0
        moments = vae.encode_tiled(x, tile=32, overlap=8)
    assert tiled.shape == (2, 64, 64, 3) and torch.isfinite(tiled).all()
    assert moments.mean.shape == (2, 32, 32, 4) and torch.isfinite(moments.mean).all()


# ------------------------------------------------------------------ backward

@pytest.mark.parametrize(
    "b,sq,sk,h,d,kind",
    [
        (2, 256, 256, 2, 64, "none"),
        (2, 200, 77, 3, 64, "none"),  # ragged Sq, cross-attention's 77 keys
        (2, 128, 77, 2, 64, "key"),
        (2, 77, 77, 4, 64, "full"),
        (1, 130, 300, 2, 40, "key"),
        (1, 64, 129, 2, 80, "none"),
        # SD1.5's D = 160 (level 2 and the mid block, self- and
        # cross-attention; batch cut to 2), a ragged key-masked one and a
        # full bias: the Hopper pair, whose dK/dV consumers split by role
        (2, 256, 256, 8, 160, "none"),
        (2, 256, 77, 8, 160, "none"),
        (2, 64, 64, 8, 160, "none"),
        (2, 64, 77, 8, 160, "none"),
        (1, 130, 300, 2, 160, "key"),
        (2, 130, 130, 3, 160, "full"),
        # Flux's D = 128 (the flux_1b step's 1101 joint tokens, heads cut to
        # 2), ragged with a key mask, and a full bias: the Hopper pair, whose
        # dK/dV consumers split by role as at 160
        (2, 1101, 1101, 2, 128, "none"),
        (1, 130, 300, 2, 128, "key"),
        (2, 130, 130, 3, 128, "full"),
    ],
)
def test_flash_bwd_kernels_match_plain(dev, b, sq, sk, h, d, kind):
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_backward_reference, flash_bwd

    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    bias = _bias(kind, b, h, sq, sk, dev, gen)
    out, lse = flash_fwd(q, k, v, bias)
    dout = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    got = flash_bwd(q, k, v, bias, out, lse, dout)
    ref = flash_attention_backward_reference(q, k, v, bias, out, lse, dout)
    assert got[3] is None  # no dBias without bias_grad
    for g, r in zip(got[:3], ref[:3]):
        assert torch.isfinite(g).all()
        _assert_flash_close(g, r)
    again = flash_bwd(q, k, v, bias, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], again[:3]))  # no atomics: bitwise reproducible


@pytest.mark.parametrize("kind", ["key", "full"])
def test_flash_kernels_clamp_an_infinite_bias_they_take_uncopied(dev, kind):
    """An fp32 contiguous bias reaches the kernels as it is (no clamped
    copy); each kernel clamps its -inf entries at -1e30 as it loads them."""
    from uwudiff_tpu_torch.ops.flash_attention import (
        _split_bias,
        flash_attention_backward_reference,
        flash_bwd,
    )

    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, h, d = 2, 96, 2, 64
    q, k, v, dout = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
    shape = (b, 1, 1, s) if kind == "key" else (b, h, s, s)
    bias = torch.randn(shape, generator=gen, device=dev)
    bias[..., s - 30:] = float("-inf")
    assert _split_bias(bias, b, h, s, s)[1].data_ptr() == bias.data_ptr()
    out, lse = flash_fwd(q, k, v, bias)
    ref, _ = flash_attention_reference(q, k, v, bias)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_flash_close(out, ref)
    for bias_grad in (False, True):
        got = flash_bwd(q, k, v, bias, out, lse, dout, bias_grad=bias_grad)
        refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout)
        for g, r in zip(got[:3], refs[:3]):
            assert torch.isfinite(g).all()
            _assert_flash_close(g, r)
        if bias_grad:
            _assert_dbias_close(got[3], refs[3])
            assert got[3][..., s - 30:].abs().max() == 0
    assert bias[..., s - 1].isneginf().all()  # the caller's bias is untouched


def test_flash_autograd_runs_the_kernel_pair_on_strided_heads(dev):
    """q/k/v as column slices of one projection, as the models make them."""
    qkv = torch.randn((2, 96, 3 * 2 * 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.view(2, 96, 2, 64) for t in qkv.chunk(3, dim=-1))
    reset_launch_counts()
    out = flash_attention(q, k, v)
    out.backward(torch.ones_like(out))
    counts = launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1
    ref_qkv = qkv.detach().float().requires_grad_()
    rq, rk, rv = (t.view(2, 96, 2, 64) for t in ref_qkv.chunk(3, dim=-1))
    flash_attention_reference(rq, rk, rv)[0].backward(torch.ones_like(out).float())
    _assert_flash_close(qkv.grad, ref_qkv.grad)


def test_flash_bwd_raises_for_a_head_dim_it_was_not_built_for(dev):
    """D = 96 passes the JAX kernels' d % 8 == 0, d <= 256 but no kernel of
    the port was built for it: the backward raises, it does not fall back."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_bwd

    q = torch.randn((1, 64, 2, 96), device=dev, dtype=torch.bfloat16)
    out, lse = flash_attention_reference(q, q, q)
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(q, q, q, None, out, lse, torch.ones_like(out))
    assert launch_counts()["flash_bwd_dq"] == launch_counts()["flash_bwd_dkv"] == 0


def test_flash_autograd_runs_the_hopper_pair_at_fluxs_head_dim(dev):
    """At D = 128 the autograd function's backward is the Hopper dQ and
    dK/dV, once each, held to the plain backward."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_backward_reference

    q, k, v = (torch.randn((1, 130, 2, 128), device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    reset_launch_counts()
    out = flash_attention(q, k, v)
    dout = torch.randn_like(out)
    out.backward(dout)
    counts = launch_counts()
    assert counts["flash_fwd_sm90"] == counts["flash_bwd_dq_sm90"] == counts["flash_bwd_dkv_sm90"] == 1
    assert counts["flash_bwd_dq_mma"] == counts["flash_bwd_dkv_mma"] == 0
    _, lse = flash_fwd(q.detach(), k.detach(), v.detach())
    refs = flash_attention_backward_reference(q.detach(), k.detach(), v.detach(), None, out.detach(), lse, dout)
    for t, r in zip((q, k, v), refs[:3]):
        _assert_flash_close(t.grad, r)


# every D = 64 backward shape of the train and textual-inversion paths (B,
# Sq, Sk, H, bias kind, scale), and a ragged one with a key mask
_BWD_PATH_CASES = [
    (8, 1024, 1024, 10, "none", None),  # SDXL training, level 1 self-attention (64^2 latents)
    (8, 1024, 77, 10, "none", None),  # level 1 cross-attention
    (8, 256, 256, 20, "none", None),  # level 2
    (8, 256, 77, 20, "none", None),
    (2, 200, 77, 4, "key", None),  # ragged Sq and Sk, key mask
    (8, 77, 77, 20, "full", None),  # CLIP-bigG (its full bias)
    (8, 77, 77, 12, "full", None),  # CLIP-L
    (8, 256, 256, 64, "full", 1.0),  # T5-XXL's dK/dV (its dQ is K5)
    (8, 1357, 1357, 24, "key", None),  # the SD3 MMDiT's joint attention with the text mask
]


def _bwd_inputs(b, sq, sk, h, kind, scale, seed, d=64):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
               for s in (sq, sk, sk))
    bias = _bias(kind, b, h, sq, sk, "cuda", gen)
    out, lse = flash_fwd(q, k, v, bias, scale)
    dout = torch.randn(out.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, bias, out, lse, dout, delta


@pytest.mark.parametrize("kind", ["none", "key"])
def test_hopper_backward_matches_plain_at_the_flux_1b_step(dev, kind):
    """The flux_1b step's joint attention, [8, 1101, 1101, 12, 128], with
    no bias (bench.py's batch has no text mask) and with a key mask (a T5
    bucket's): dQ and dK/dV at D = 128, bitwise from run to run."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_backward_reference, flash_bwd_dkv, flash_bwd_dq

    q, k, v, bias, out, lse, dout, delta = _bwd_inputs(8, 1101, 1101, 12, kind, None, seed=15, d=128)
    reset_launch_counts()
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, bias)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, bias)
    assert launch_counts()["flash_bwd_dq_sm90"] == launch_counts()["flash_bwd_dkv_sm90"] == 1
    refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout)[:3]
    for g, r in zip((dq, dk, dv), refs):
        assert torch.isfinite(g).all()
        _assert_flash_close(g, r)
    assert torch.equal(dq, flash_bwd_dq(q, k, v, dout, lse, delta, bias))
    assert all(torch.equal(x, y) for x, y in zip((dk, dv), flash_bwd_dkv(q, k, v, dout, lse, delta, bias)))


@pytest.mark.parametrize("kind", ["none", "key"])
def test_hopper_backward_matches_plain_at_the_dit_xl_2_step(dev, kind):
    """The dit_xl_2 step's attention, [64, 256, 256, 16, 72] (bench.py's
    batch of 64 on 32x32 latents), and a ragged key-bias shape: dQ and dK/dV
    at D = 72 on the Hopper kernels, bitwise from run to run."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_backward_reference, flash_bwd_dkv, flash_bwd_dq

    b, sq, sk, h = (64, 256, 256, 16) if kind == "none" else (2, 130, 300, 2)
    q, k, v, bias, out, lse, dout, delta = _bwd_inputs(b, sq, sk, h, kind, None, seed=16, d=72)
    reset_launch_counts()
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, bias)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, bias)
    assert launch_counts()["flash_bwd_dq_sm90"] == launch_counts()["flash_bwd_dkv_sm90"] == 1
    refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout)[:3]
    for g, r in zip((dq, dk, dv), refs):
        assert torch.isfinite(g).all()
        _assert_flash_close(g, r)
    assert torch.equal(dq, flash_bwd_dq(q, k, v, dout, lse, delta, bias))
    assert all(torch.equal(x, y) for x, y in zip((dk, dv), flash_bwd_dkv(q, k, v, dout, lse, delta, bias)))


@pytest.mark.parametrize("b,sq,sk,h,kind,scale", _BWD_PATH_CASES)
def test_hopper_backward_matches_plain_at_the_path_shapes(dev, b, sq, sk, h, kind, scale):
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_backward_reference, flash_bwd_dkv, flash_bwd_dq

    q, k, v, bias, out, lse, dout, delta = _bwd_inputs(b, sq, sk, h, kind, scale, seed=10)
    reset_launch_counts()
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, bias, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, bias, scale)
    counts = launch_counts()
    assert counts["flash_bwd_dq_sm90"] == counts["flash_bwd_dkv_sm90"] == 1
    assert counts["flash_bwd_dq_mma"] == counts["flash_bwd_dkv_mma"] == 0
    refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale)[:3]
    for g, r in zip((dq, dk, dv), refs):
        assert torch.isfinite(g).all()
        _assert_flash_close(g, r)
    assert torch.equal(dq, flash_bwd_dq(q, k, v, dout, lse, delta, bias, scale))  # bitwise from run to run
    assert all(torch.equal(x, y) for x, y in zip((dk, dv), flash_bwd_dkv(q, k, v, dout, lse, delta, bias, scale)))


@pytest.mark.parametrize("d", [64, 72])
def test_hopper_backward_takes_fused_qkv_head_views(dev, d):
    """q/k/v/dO as [B, S, H, D] views of one [B, S, 4, H, D] tensor go into
    the tensor maps with their own strides, uncopied (at D = 72 a view's
    rows are 144 bytes, its second 64-column box 8 columns wide)."""
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd_dkv_sm90,
        flash_bwd_dq_sm90,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn((2, 300, 4, 3, d), generator=gen, device=dev, dtype=torch.bfloat16)
    q, k, v, dout = qkv.unbind(2)
    out, lse = flash_fwd(q, k, v)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = (flash_bwd_dq_sm90(q, k, v, dout, lse, delta),) + flash_bwd_dkv_sm90(q, k, v, dout, lse, delta)
    for g, r in zip(got, flash_attention_backward_reference(q, k, v, None, out, lse, dout)[:3]):
        _assert_flash_close(g, r)


def test_hopper_backward_refuses_views_tma_cannot_take(dev):
    """A stride-0 head view and a start that is not 16-byte aligned raise;
    nothing is copied and nothing launches."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq

    q, k, v, _, out, lse, dout, delta = _bwd_inputs(2, 128, 128, 4, "none", None, seed=12)
    shared = k[:, :, :1].expand(k.shape)
    flat = torch.randn(q.numel() + 4, device=dev, dtype=torch.bfloat16)
    misaligned = flat[4:].view(q.shape)  # 8 bytes past an aligned start
    reset_launch_counts()
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="TMA"):
            fn(q, shared, shared, dout, lse, delta)
        with pytest.raises(ValueError, match="aligned"):
            fn(q, k, v, misaligned, lse, delta)
    assert launch_counts()["flash_bwd_dq"] == launch_counts()["flash_bwd_dkv"] == 0


@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_hopper_backward_reads_clips_bias_in_place(dev, which):
    """CLIP's causal + padding bias [B, 1, Sq, Sk] is read through a zero
    head stride: the call allocates its outputs and no [B*H, Sq, Sk] copy."""
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd_dkv_sm90,
        flash_bwd_dq_sm90,
    )

    gen = torch.Generator(device=dev).manual_seed(13)
    b, s, h = 8, 77, 20
    q, k, v, dout = (torch.randn((b, s, h, 64), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
    neg = torch.finfo(torch.float32).min
    causal = torch.where(torch.ones(s, s, dtype=torch.bool, device=dev).tril(), 0.0, neg)
    pad = torch.where(torch.arange(s, device=dev)[None, :] < torch.arange(1, b + 1, device=dev)[:, None] * 9, 0.0, neg)
    bias = causal[None, None] + pad[:, None, None, :]  # [B, 1, Sq, Sk], -inf where both mask
    out, lse = flash_fwd(q, k, v, bias)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    fn, out_bytes = (flash_bwd_dq_sm90, q.numel() * 2) if which == "dq" else (flash_bwd_dkv_sm90, 2 * k.numel() * 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = fn(q, k, v, dout, lse, delta, bias)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= out_bytes + 1024  # 512-byte allocator blocks
    got = (got,) if which == "dq" else got
    refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout)[:3]
    for g, r in zip(got, refs[:1] if which == "dq" else refs[1:]):
        assert torch.isfinite(g).all()
        _assert_flash_close(g, r)


@pytest.mark.parametrize("d,suffix", [(64, "_sm90"), (40, "_sm90"), (80, "_sm90"), (128, "_sm90"), (160, "_sm90"),
                                      (72, "_sm90")])
def test_backward_dispatches_on_the_head_dim(dev, d, suffix):
    from uwudiff_tpu_torch.ops.flash_attention import (
        MMA_BWD_HEAD_DIMS,
        flash_attention_backward_reference,
        flash_bwd,
        flash_bwd_dkv_mma,
        flash_bwd_dq_mma,
    )

    q, k, v, bias, out, lse, dout, delta = _bwd_inputs(1, 130, 200, 2, "none", None, seed=14, d=d)
    reset_launch_counts()
    got = flash_bwd(q, k, v, None, out, lse, dout)
    counts = launch_counts()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name + suffix] == counts[name] == 1
    refs = flash_attention_backward_reference(q, k, v, None, out, lse, dout)[:3]
    for g, r in zip(got[:3], refs):
        _assert_flash_close(g, r)
    if d not in MMA_BWD_HEAD_DIMS:
        with pytest.raises(ValueError, match="head dim"):
            flash_bwd_dkv_mma(q, k, v, dout, lse, delta)
    else:  # the mma.sync pair, on no path, is the yardstick there: called by name, held to the same bound
        mma = (flash_bwd_dq_mma(q, k, v, dout, lse, delta),) + flash_bwd_dkv_mma(q, k, v, dout, lse, delta)
        for g, r in zip(mma, refs):
            _assert_flash_close(g, r)
        assert launch_counts()["flash_bwd_dq_mma"] == launch_counts()["flash_bwd_dkv_mma"] == 1


def _gn_bwd_inputs(dev, n, hw, c, groups, dtype=torch.bfloat16, seed=3):
    """x, the incoming gradient and what the forward saves for the backward
    (gamma, scale, shift, mean, inv), the statistics from the forward's route."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
    g = torch.randn((n, hw, c), generator=gen, device=dev).to(dtype)
    gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).to(dtype)
    beta = (torch.randn(c, generator=gen, device=dev) * 0.1).to(dtype)
    if plan_gn(n, hw, c, groups, dtype).route == "fused":
        stats = gn_silu_fused(x, gamma, beta, groups, 1e-5, with_stats=True)[1]
    else:
        stats = gn_stats(x, gamma, beta, groups, 1e-5, with_group_stats=True)
    return x, g, (gamma, *stats)


@pytest.mark.parametrize("n,hw,c,groups", [(2, 1000, 320, 32), (8, 256, 2560, 32), (3, 77, 40, 4)])
@pytest.mark.parametrize("silu", [True, False])
def test_gn_bwd_kernels_match_plain(dev, n, hw, c, groups, silu):
    """K7 (t and K8's coefficients) and K8 against their plain versions at
    any shape (they take every one; plan_gn_bwd sends the large ones to
    them), bitwise over two runs, and the whole backward through autograd
    against autograd of the fp32 plain forward."""
    x, g, saved = _gn_bwd_inputs(dev, n, hw, c, groups)
    t, coef = gn_bwd_partials(x, g, *saved, silu)
    tr, coef_r = gn_bwd_partials_reference(x, g, *saved, silu)
    _assert_flash_close(t, tr)  # fp32 sums over HW: far inside the bound
    _assert_flash_close(coef, coef_r)
    again = gn_bwd_partials(x, g, *saved, silu)
    assert torch.equal(t, again[0]) and torch.equal(coef, again[1])
    dx = gn_bwd_dx(x, g, coef, silu)
    _assert_flash_close(dx, gn_bwd_dx_reference(x, g, coef, silu))
    assert torch.equal(dx, gn_bwd_dx(x, g, coef, silu))
    _assert_flash_close(dx, gn_silu_bwd_fused_reference(x, g, *saved, silu)[0])
    # the whole backward through autograd, against autograd of the plain forward
    gen = torch.Generator(device=dev).manual_seed(4)
    xg = x.detach().requires_grad_()
    gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).requires_grad_()
    beta = (torch.randn(c, generator=gen, device=dev) * 0.1).requires_grad_()
    got = torch.autograd.grad(group_norm_silu(xg, gamma, beta, groups, 1e-5, silu), (xg, gamma, beta), g)
    xr = x.float().requires_grad_()
    ref = torch.autograd.grad(group_norm_silu_reference(xr, gamma, beta, groups, 1e-5, silu),
                              (xr, gamma, beta), g.float())
    for a, r in zip(got, ref):
        _assert_flash_close(a, r)


# the SDXL training step's GroupNorm shapes at 64x64 latents (46 calls, 12
# shapes: all fused but [8,4096,960]) and level 0 of a 1024^2 step (pair)
GN_TRAIN_SHAPES = [(8, 256, c, 32) for c in (640, 1280, 1920, 2560)] + [
    (8, 1024, c, 32) for c in (320, 640, 960, 1280, 1920)] + [(8, 4096, c, 32) for c in (320, 640, 960)] + [
    (8, 16384, 320, 32)]


@pytest.mark.parametrize("dtype,n,hw,c,groups", [(torch.bfloat16, *s) for s in GN_TRAIN_SHAPES]
                         + [(torch.float32, 2, 1000, 320, 32), (torch.float32, 8, 4096, 960, 32)])
@pytest.mark.parametrize("silu", [True, False])
def test_gn_bwd_routes_match_plain(dev, dtype, n, hw, c, groups, silu):
    """Each shape on the route plan_gn_bwd gives it, against the plain
    backward (dx and t = (t1, t2)), bitwise over two runs; autograd
    through group_norm_silu launches exactly that route (one fused launch,
    or K7 and K8)."""
    x, g, saved = _gn_bwd_inputs(dev, n, hw, c, groups, dtype)
    fused = plan_gn_bwd(n, hw, c, groups, dtype).route == "fused"
    if fused:
        dx, t = gn_silu_bwd_fused(x, g, *saved, silu)
        assert all(torch.equal(a, b) for a, b in zip((dx, t), gn_silu_bwd_fused(x, g, *saved, silu)))
    else:
        t, coef = gn_bwd_partials(x, g, *saved, silu)
        dx = gn_bwd_dx(x, g, coef, silu)
        assert torch.equal(dx, gn_bwd_dx(x, g, gn_bwd_partials(x, g, *saved, silu)[1], silu))
    dx_r, t_r = gn_silu_bwd_fused_reference(x, g, *saved, silu)
    _assert_flash_close(dx, dx_r)
    _assert_flash_close(t, t_r)
    xg = x.detach().requires_grad_()
    gamma, beta = saved[0].clone().requires_grad_(), saved[0].clone().requires_grad_()
    y = group_norm_silu(xg, gamma, beta, groups, 1e-5, silu)
    reset_launch_counts()
    torch.autograd.grad(y, (xg, gamma, beta), g)
    counts = launch_counts()
    assert (counts["gn_silu_bwd_fused"], counts["gn_bwd_partials"], counts["gn_bwd_dx"]) == (
        (1, 0, 0) if fused else (0, 1, 1))


def test_gn_bwd_fused_refuses_a_pair_shape(dev):
    x, g, saved = _gn_bwd_inputs(dev, 8, 4096, 960, 32)
    with pytest.raises(ValueError, match="plan_gn_bwd"):
        gn_silu_bwd_fused(x, g, *saved)


def test_tensor_map_kernels_run_from_a_fresh_thread(dev):
    """The kernels that encode TMA maps work from a thread that has made no
    CUDA runtime call (as autograd's device thread may be): the encoder, a
    driver call, needs the thread's context bound first."""
    import threading

    x, g, saved = _gn_bwd_inputs(dev, 2, 1024, 320, 32)
    q = torch.randn((2, 256, 2, 64), device=dev, dtype=torch.bfloat16)
    want = (gn_silu_bwd_fused(x, g, *saved), flash_fwd_sm90(q, q, q)[0])
    got = {}

    def run():
        try:
            got["out"] = (gn_silu_bwd_fused(x, g, *saved), flash_fwd_sm90(q, q, q)[0])
        except Exception as e:  # noqa: BLE001  (reported below)
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert "error" not in got, got.get("error")
    assert all(torch.equal(a, b) for a, b in zip(got["out"][0], want[0])) and torch.equal(got["out"][1], want[1])


def test_tiny_unet_trains_through_every_kernel(dev):
    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.models import UNet2DConditionModel
    from uwudiff_tpu_torch.training import DMTrainer

    torch.manual_seed(0)
    unet = UNet2DConditionModel.from_config(
        "tiny_sdxl", device=dev, dtype=torch.bfloat16, block_out_channels=(64, 128),
        cross_attention_dim=256, projection_class_embeddings_input_dim=128 + 48,
    )
    trainer = DMTrainer({"unet": unet}, lr=1e-4, optimizer="adamw_factored", use_warm_up=False,
                        opt_config={"weight_decay": 0.01, "betas": (0.9, 0.999), "clipping_threshold": 1.0},
                        loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), grad_clip=None,
                        param_dtype="bfloat16", seed=0, device=dev)
    batch = {"sample": torch.randn(2, 32, 32, 4), "ctx": torch.randn(2, 77, 256),
             "pooled": torch.randn(2, 128), "added_cond": {"time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2)}}
    reset_launch_counts()
    metrics, _ = trainer.train_step(batch)
    counts = launch_counts()
    assert counts.pop("flash_bwd_dq_dbias") == 0, counts  # the UNet learns no attention bias
    assert counts.pop("flash_fwd_mma") == 0, counts  # head dim 64: every forward is the Hopper kernel
    assert counts.pop("flash_bwd_dq_mma") == counts.pop("flash_bwd_dkv_mma") == 0, counts  # and every backward
    # every GroupNorm of the tiny UNet fits a cluster both ways: one fused
    # launch each, forward and backward, none on the chunked pair or K7/K8;
    # the fused backward reads the fused forward's statistics
    assert counts.pop("gn_stats") == counts.pop("gn_silu_apply") == 0, counts
    assert counts.pop("gn_bwd_partials") == counts.pop("gn_bwd_dx") == 0, counts
    assert counts.pop("adamw_norm") == 0, counts  # no global-norm clip: the norm comes with the statistics
    assert counts.pop("adamw_fp16_apply") == 0, counts  # adamw_factored's update, not adamw_fp16's
    assert all(v > 0 for v in counts.values()), counts
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == counts["flash_bwd_dkv"]
    assert counts["gn_silu_fused"] == counts["gn_silu_bwd_fused"]
    assert torch.isfinite(metrics["train/loss"]) and torch.isfinite(metrics["train/grad_norm"])


# ------------------------------------------------------------ dQ + dBias (K5)

def _t5_bias(b, h, s, dev, gen):
    """A T5-style full bias: a smooth relative-position part per head plus
    key padding (finfo.min on the last keys of every other row)."""
    rel = torch.arange(s, device=dev)[None, :] - torch.arange(s, device=dev)[:, None]
    bias = torch.randn((1, h, 1, 1), generator=gen, device=dev) * torch.tanh(rel / 16.0)[None, None]
    lengths = torch.tensor([s, s - 37], device=dev).repeat(b)[:b]
    keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return bias + torch.where(keep, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]


def _assert_dbias_close(got, ref):
    """dBias is dS pointwise (no sum over D to average rounding out): max
    error 2^-12 of the largest |dS|, RMS error 2^-12 of the RMS dS."""
    diff, ref = got.float() - ref.float(), ref.float()
    assert torch.isfinite(got).all()
    assert diff.abs().max().item() <= 2.0**-12 * ref.abs().max().item()
    assert diff.pow(2).mean().sqrt().item() <= 2.0**-12 * ref.pow(2).mean().sqrt().item()


@pytest.mark.parametrize(
    "b,s,h,d,scale",
    [
        (8, 256, 64, 64, 1.0),  # T5-XXL: no 1/sqrt(d) scale, padded keys
        (2, 200, 4, 64, 1.0),  # ragged: Sq, Sk not multiples of the 64-row tiles
        (2, 256, 8, 80, None),
        (1, 130, 2, 40, None),
        (1, 77, 2, 80, None),  # odd Sk: 4-byte dBias stores
        (2, 256, 8, 160, None),  # SD1.5's level-2 shape (no path trains a bias there)
        (2, 200, 12, 128, None),  # Flux's head dim, ragged (no path trains a bias there)
    ],
)
def test_flash_dbias_kernel_matches_plain(dev, b, s, h, d, scale):
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd,
        flash_bwd_dq_dbias,
    )

    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    bias = _t5_bias(b, h, s, dev, gen)
    out, lse = flash_fwd(q, k, v, bias, scale)
    dout = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    dq, dk, dv, dbias = flash_bwd(q, k, v, bias, out, lse, dout, scale, bias_grad=True)
    assert launch_counts()["flash_bwd_dq_dbias"] == 1 and launch_counts()["flash_bwd_dq"] == 0
    rq, rk, rv, rds = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale)
    for g, r in ((dq, rq), (dk, rk), (dv, rv)):
        _assert_flash_close(g, r)
    assert dbias.shape == (b, h, s, s) and dbias.dtype == torch.float32
    _assert_dbias_close(dbias, rds)
    # both outputs bitwise reproducible; dQ is the Hopper K4's, bitwise, at
    # D = 40/80/160 and within the flash bound of it at D = 64 and 128 (other
    # products, summed in another order)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq2, db2 = flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale)
    assert torch.equal(dq, dq2) and torch.equal(dbias.reshape(b * h, s, s), db2)
    dq_k4 = flash_bwd(q, k, v, bias, out, lse, dout, scale)[0]
    if d in (64, 128):
        _assert_flash_close(dq, dq_k4)
    else:
        assert torch.equal(dq, dq_k4)


def test_flash_autograd_bias_grad_runs_k5(dev):
    """A learned [1, H, S, S] bias through the autograd function: its
    gradient is dBias summed over the batch, and only the bias needs to
    require a gradient for the call to go through autograd."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, h, d = 2, 192, 2, 64
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    rel = torch.randn((1, h, s, s), generator=gen, device=dev, requires_grad=True)
    pad = torch.where(torch.arange(s, device=dev) < s - 20, 0.0, torch.finfo(torch.float32).min)
    dout = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    out = flash_attention(q, k, v, rel + pad, 1.0, bias_grad=True)
    out.backward(dout)
    counts = launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq_dbias"] == counts["flash_bwd_dkv"] == 1
    assert counts["flash_bwd_dq"] == 0
    ref_rel = rel.detach().clone().requires_grad_()
    ref, _ = flash_attention_reference(q.float(), k.float(), v.float(), ref_rel + pad, 1.0)
    ref.backward(dout.float())
    _assert_flash_close(rel.grad, ref_rel.grad)
    # without bias_grad the same bias is a constant
    rel.grad = None
    flash_attention(q.requires_grad_(), k, v, rel + pad, 1.0).backward(dout)
    assert rel.grad is None


def test_flash_frozen_learned_bias_takes_k4(dev):
    """``bias_grad=True`` with a bias autograd keeps no gradient for (a
    frozen T5's): the backward runs K4, not K5."""
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, h, d = 2, 128, 2, 64
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.randn((1, h, s, s), generator=gen, device=dev)
    dout = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    q.requires_grad_()
    reset_launch_counts()
    flash_attention(q, k, v, bias, 1.0, bias_grad=True).backward(dout)
    counts = launch_counts()
    assert counts["flash_bwd_dq_dbias"] == 0 and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 1
    ref_q = q.detach().float().requires_grad_()
    ref, _ = flash_attention_reference(ref_q, k.float(), v.float(), bias, 1.0)
    ref.backward(dout.float())
    _assert_flash_close(q.grad, ref_q.grad)


def test_flash_lse_is_differentiable_on_the_card(dev):
    """A loss on out and lse: the lse's cotangent folds into delta."""
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, h, d = 2, 200, 2, 64
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    dlse = torch.randn((b, h, s), generator=gen, device=dev)
    out, lse = flash_attention(q, k, v, return_lse=True)
    got = torch.autograd.grad((out.float() * dout.float()).sum() + (lse * dlse).sum(), (q, k, v))
    rq, rk, rv = (t.detach().float().requires_grad_() for t in (q, k, v))
    rout, rlse = flash_attention_reference(rq, rk, rv)
    ref = torch.autograd.grad((rout * dout.float()).sum() + (rlse * dlse).sum(), (rq, rk, rv))
    for a, r in zip(got, ref):
        _assert_flash_close(a, r)


@pytest.mark.parametrize("d", [96, 72])
def test_flash_dbias_raises_for_a_head_dim_it_was_not_built_for(dev, d):
    """K5 at D = 96 (see the test above) raises, and at DiT-XL/2's 72,
    where dQ and dK/dV are built but no path trains an attention bias."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_bwd

    q = torch.randn((1, 64, 2, d), device=dev, dtype=torch.bfloat16)
    bias = torch.zeros((1, 2, 64, 64), device=dev)
    out, lse = flash_attention_reference(q, q, q, bias)
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(q, q, q, bias, out, lse, torch.ones_like(out), bias_grad=True)
    assert launch_counts()["flash_bwd_dq_dbias"] == 0


# ------------------------------------------------- the fused optimizer update

# leaves of every kind the update walks: factored with the columns
# contiguous (a Linear weight, a channels_last 3x3 conv), with the rows
# contiguous (a GEGLU-like projection), and dense (a narrow Linear, a bias)
_OPT_SHAPES = ((256, 384), (384, 256, 3, 3), (1024, 128), (64, 104), (320,))


def _opt_case(dev, dtype, seed=0):
    from uwudiff_tpu_torch.training.optimizers import adamw_factored

    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaves(scale, like=None):
        out = []
        for i, shape in enumerate(_OPT_SHAPES):
            x = (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
            out.append(torch.empty_like(like[i]).copy_(x) if like is not None else
                       x.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else x)
        return out

    params = leaves(0.02)
    grads = [leaves(1e-2, params) for _ in range(3)]  # global norm ~11
    tx = adamw_factored(1e-3, weight_decay=0.01, clipping_threshold=1.0)
    return tx, params, grads


def _opt_steps(tx, params, grads, clip, given):
    """Three steps with the weight EMA (decay 0.99) through the kernels;
    before each, a copy of the state takes the same step through the plain
    version. Yields (kernel, plain) after each step: dicts of the
    parameters, the EMA, the state's tensors and the momentum before it."""
    import copy

    import numpy as np

    from uwudiff_tpu_torch.training.optimizers import apply_update_

    params = [p.clone() for p in params]
    ema = [p.clone() for p in params]
    state = tx.init(params)
    for step, g in enumerate(grads):
        d_w = float(min(np.float32(1 + step) / np.float32(10 + step), np.float32(0.99)))
        bits = ([(torch.arange(p.numel(), device=p.device).reshape(p.shape) * 7919 + step) % 65536 for p in params]
                if given else None)
        kw = dict(grad_clip=clip, seed=3, step=step, sr_bits=bits, ema_decay=d_w,
                  ema_bits=None if bits is None else [b.flip(0) for b in bits])
        pp, pe, ps = [p.clone() for p in params], [e.clone() for e in ema], copy.deepcopy(state)
        mu_old = [st["mu"].clone() for st in state.leaves]
        nk = tx.step_(params, g, state, ema_params=ema, **kw)
        np_ = apply_update_(tx, pp, g, ps, ema_params=pe, **kw)
        assert state.fused is not None and ps.fused is None and state.count == ps.count == step + 1
        torch.testing.assert_close(nk, np_, rtol=1e-6, atol=0)
        yield (dict(p=params, ema=ema, leaves=state.leaves, mu_old=mu_old),
               dict(p=pp, ema=pe, leaves=ps.leaves))


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("given", [False, True])
def test_fused_optimizer_matches_plain_bf16(dev, clip, given):
    """Three bf16 steps, each from the same state on both sides, EMA on:
    the momentum and the statistics within one bf16 step (the momentum's
    taken at the larger of its values and its new term (1 - b1) * u) and
    >= 99.9 % bitwise (the sums run in another order); the parameters and
    the EMA bitwise wherever the momentum is (the same rounding bits, drawn
    or given); the global norm within 1e-6."""
    tx, params, grads = _opt_case(dev, torch.bfloat16)
    for k, p in _opt_steps(tx, params, grads, clip, given):
        for i in range(len(params)):
            for key, a in k["leaves"][i].items():
                b = p["leaves"][i][key]
                scale = torch.maximum(a.float().abs(), b.float().abs())
                if key == "mu":
                    scale = torch.maximum(scale, (b.float() - 0.8984375 * k["mu_old"][i].float()).abs())
                assert ((a.float() - b.float()).abs() <= 2.0**-7 * scale).all(), (i, key)
                assert (a == b).float().mean().item() >= 0.999, (i, key)
            same = k["leaves"][i]["mu"] == p["leaves"][i]["mu"]
            assert torch.equal(k["p"][i][same], p["p"][i][same]), i
            assert torch.equal(k["ema"][i][same], p["ema"][i][same]), i
    assert all(not torch.equal(a, b) for a, b in zip(k["p"], params))


def test_fused_optimizer_matches_plain_fp32(dev):
    """fp32 parameters (bf16 momentum): p + u in fp32, and the EMA, within
    2^-16 of the largest update plus one fp32 step of the value (where that
    difference moves the rounding of p + u); the momentum >= 99.9 % bitwise."""
    tx, params, grads = _opt_case(dev, torch.float32)
    before = [p.clone() for p in params]
    for k, p in _opt_steps(tx, params, grads, 1.0, False):
        for i in range(len(params)):
            moved = (p["p"][i] - before[i]).abs().max().item()
            assert moved > 0
            torch.testing.assert_close(k["p"][i], p["p"][i], rtol=2.0**-23, atol=2.0**-16 * moved)
            torch.testing.assert_close(k["ema"][i], p["ema"][i], rtol=2.0**-23, atol=2.0**-16 * moved)
            assert (k["leaves"][i]["mu"] == p["leaves"][i]["mu"]).float().mean().item() >= 0.999
        before = [t.clone() for t in k["p"]]


def _opt_run(tx, params, grads, clip):
    """Three kernel steps with the EMA; the final parameters, EMA and state."""
    params = [p.clone() for p in params]
    ema = [p.clone() for p in params]
    state = tx.init(params)
    for step, g in enumerate(grads):
        tx.step_(params, g, state, grad_clip=clip, seed=3, step=step, ema_params=ema, ema_decay=0.5)
    return params, ema, state


def test_fused_optimizer_is_bitwise_reproducible_and_counts_its_launches(dev):
    tx, params, grads = _opt_case(dev, torch.bfloat16, seed=1)
    reset_launch_counts()
    first = _opt_run(tx, params, grads, 1.0)
    counts = launch_counts()
    assert {k: counts[k] for k in ("adamw_norm", "adamw_stats", "adamw_finish", "adamw_rms", "adamw_apply")} == {
        "adamw_norm": 3, "adamw_stats": 3, "adamw_finish": 3, "adamw_rms": 3, "adamw_apply": 3}
    second = _opt_run(tx, params, grads, 1.0)
    for a, b in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(a, b)
    for sa, sb in zip(first[2].leaves, second[2].leaves):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    reset_launch_counts()
    tx.clipping_threshold = None
    _opt_run(tx, params, grads[:1], None)
    assert launch_counts()["adamw_rms"] == launch_counts()["adamw_norm"] == 0


def test_fused_optimizer_raises_on_what_the_kernels_do_not_take(dev):
    from uwudiff_tpu_torch.training.optimizers import adamw_factored

    tx = adamw_factored(1e-3)
    half = [torch.zeros((256, 256), device=dev, dtype=torch.float16)]
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tx.step_(half, half, tx.init(half))
    cube = [torch.zeros((128, 128, 4), device=dev, dtype=torch.bfloat16)]  # neither factored axis contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tx.step_(cube, cube, tx.init(cube))
    p = [torch.zeros((256, 384), device=dev, dtype=torch.bfloat16)]
    g = [torch.zeros((384, 256), device=dev, dtype=torch.bfloat16).t()]  # another layout than its parameter
    with pytest.raises(ValueError, match="strides"):
        tx.step_(p, g, tx.init(p))


def test_fused_optimizer_rebuilds_its_plan_for_a_replaced_state_tensor(dev):
    """The plan holds the state's addresses: a state tensor replaced (as a
    checkpoint restore would) makes a new plan, which updates the new one."""
    tx, params, grads = _opt_case(dev, torch.bfloat16, seed=2)
    params = [p.clone() for p in params]
    state = tx.init(params)
    tx.step_(params, grads[0], state, seed=3)
    plan = state.fused
    tx.step_(params, grads[1], state, seed=3, step=1)
    assert state.fused is plan
    state.leaves[0]["mu"] = restored = state.leaves[0]["mu"].clone()
    before = restored.clone()
    tx.step_(params, grads[2], state, seed=3, step=2)
    assert state.fused is not plan and state.leaves[0]["mu"] is restored
    assert not torch.equal(restored, before)


# ------------------------------------------------------- adamw_fp16 (O2)

# fp32 masters of every layout the SD1.5 step has: a channels_last 3x3 conv,
# a 1x1 conv, a Linear weight, biases and norm weights of odd lengths (a
# last partial vector)
_FP16_SHAPES = ((320, 4, 3, 3), (640, 320, 1, 1), (1280, 768), (77,), (4,), (5, 3), (1280,))


def _fp16_case(dev, seed=0):
    from uwudiff_tpu_torch.training.optimizers import adamw_fp16_state

    gen = torch.Generator(device=dev).manual_seed(seed)
    masters = []
    for shape in _FP16_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev) * 0.05
        masters.append(x.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else x)
    grads = [[torch.empty_like(m, dtype=torch.bfloat16).copy_(torch.randn(m.shape, generator=gen, device=dev) * 0.3)
              for m in masters] for _ in range(3)]  # global norm ~300
    # wd * lr above the threshold: some leaves' decay fires at every step
    tx = adamw_fp16_state(1e-3, weight_decay=0.5, decay_threshold=1e-3)
    return tx, masters, grads


@pytest.mark.parametrize("clip", [None, 1.0, 1e4])
def test_fused_adamw_fp16_matches_plain_bitwise(dev, clip):
    """Three steps of O2 (adamw_norm + adamw_fp16_apply), each from the same
    state as the plain version (apply_update_), which is fed the gradients
    O2 clips with its own norm: masters, working copies and both moments
    bitwise, the decay accumulators equal, the norm within 1e-6 of the
    plain version's; the working copy is the masters' bf16 rounding."""
    import copy

    from uwudiff_tpu_torch.training.optimizers import apply_update_

    tx, masters, grads = _fp16_case(dev)
    p_k = [m.clone() for m in masters]
    w_k = [m.to(torch.bfloat16) for m in p_k]
    st_k = tx.init(p_k)
    fired = 0
    for g in grads:
        p_r, w_r, st_r = [p.clone() for p in p_k], [w.clone() for w in w_k], copy.deepcopy(st_k)
        reset_launch_counts()
        n_k = tx.step_(p_k, g, st_k, grad_clip=clip, working=w_k)
        assert launch_counts()["adamw_norm"] == launch_counts()["adamw_fp16_apply"] == 1
        fired += int((st_r.decay + 0.5 * 1e-3 > 1e-3).sum())
        g_r = [x.float() for x in g]
        if clip:
            g_r = [torch.where(n_k < clip, x, x / n_k * clip) for x in g_r]
        apply_update_(tx, p_r, g_r, st_r, working=w_r)
        n_r = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x.float()) for x in g]))
        torch.testing.assert_close(n_k, n_r, rtol=1e-6, atol=0)
        for a, b in zip(p_k + w_k, p_r + w_r):
            assert torch.equal(a, b)
        for a, b in zip(st_k.leaves, st_r.leaves):
            assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert (st_k.decay == st_r.decay).all() and st_k.count == st_r.count
        assert all(torch.equal(w, p.to(torch.bfloat16)) for w, p in zip(w_k, p_k))
    assert fired > 0
    assert all(not torch.equal(a, b) for a, b in zip(p_k, masters))


def test_fused_adamw_fp16_raises_on_what_the_kernel_does_not_take(dev):
    tx, masters, grads = _fp16_case(dev, seed=1)
    working = [m.to(torch.bfloat16) for m in masters]
    with pytest.raises(ValueError, match="working copy"):
        tx.step_(masters, grads[0], tx.init(masters))
    bf16 = [m.to(torch.bfloat16) for m in masters]
    with pytest.raises(TypeError, match="fp32"):
        tx.step_(bf16, grads[0], tx.init(bf16), working=working)
    fp32_grads = [g.float() for g in grads[0]]
    with pytest.raises(ValueError, match="strides"):
        tx.step_(masters, fp32_grads, tx.init(masters), working=working)
    with pytest.raises(NotImplementedError, match="EMA"):
        tx.step_(masters, grads[0], tx.init(masters), working=working, ema_params=masters, ema_decay=0.5)


def test_tiny_sd15_step_on_the_card_matches_the_cpu(dev):
    """An SD1.5-layout UNet whose head dims are SD1.5's 40/80/160, trained
    by the SD1.5 recipe (fp32 masters under bf16 compute, adamw_fp16, clip
    1.0) on the card and in fp32 on the CPU from the same weights, noise
    and timesteps: the loss and the gradients within 5e-2 (bf16 through a
    few dozen layers); every attention on its head dim's kernels
    (the forward, dQ and dK/dV Hopper at 40/80/160, the mma.sync ones at
    none); the update in two launches, every master moved,
    the module's weights their bf16 rounding."""
    import copy

    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.models import UNet2DConditionModel
    from uwudiff_tpu_torch.ops import launches_by_head_dim
    from uwudiff_tpu_torch.training import DMTrainer

    torch.manual_seed(0)
    cpu = UNet2DConditionModel.from_config("sd15", device="cpu", block_out_channels=(80, 160, 320, 320),
                                           num_attention_heads=2, cross_attention_dim=64, norm_num_groups=16)
    gpu = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(1)
    batch = {"sample": torch.randn((2, 32, 32, 4), generator=gen), "ctx": torch.randn((2, 77, 64), generator=gen)}
    noise, timesteps = torch.randn((2, 32, 32, 4), generator=gen), torch.tensor([37, 712])
    out = {}
    for where, unet, compute in (("cpu", cpu, None), ("cuda", gpu, "bfloat16")):
        tr = DMTrainer({"unet": unet}, optimizer="adamw_fp16", use_warm_up=False, grad_clip=1.0,
                       loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), compute_dtype=compute,
                       device=where)
        reset_launch_counts()
        loss, _ = tr.forward_backward(batch, noise, timesteps)
        out[where] = (tr, loss.float().cpu(), torch.cat([p.grad.float().cpu().flatten() for _, p in tr.params]))
    by_dim = launches_by_head_dim()
    # five transformers at each of levels 0-2 (2 down, 3 up) and the mid block's, self- and cross-attention
    assert by_dim["flash_fwd_sm90"] == {40: 10, 80: 10, 160: 12} and by_dim["flash_fwd_mma"] == {}
    assert by_dim["flash_bwd_dq_sm90"] == by_dim["flash_bwd_dkv_sm90"] == {40: 10, 80: 10, 160: 12}
    assert by_dim["flash_bwd_dq_mma"] == by_dim["flash_bwd_dkv_mma"] == {}
    (_, loss_c, grad_c), (tr, loss_g, grad_g) = out["cpu"], out["cuda"]
    assert ((loss_g - loss_c).abs() / loss_c.abs()).item() <= 5e-2
    assert ((grad_g - grad_c).norm() / grad_c.norm()).item() <= 5e-2
    before = [m.clone() for m in tr.masters]
    reset_launch_counts()
    tr.apply_updates()
    counts = launch_counts()
    assert counts["adamw_norm"] == counts["adamw_fp16_apply"] == 1 and counts["adamw_stats"] == 0
    assert all(m.dtype == torch.float32 and not torch.equal(m, b) for m, b in zip(tr.masters, before))
    assert all(torch.equal(p.detach(), m.to(torch.bfloat16)) for (_, p), m in zip(tr.params, tr.masters))


# ------------------------------------------------------------ int8 weights and adapter swaps

def _small_unet(dev, dtype=torch.bfloat16):
    from uwudiff_tpu_torch.models import UNet2DConditionModel

    torch.manual_seed(0)
    return UNet2DConditionModel.from_config("tiny_sdxl", device=dev, dtype=dtype, block_out_channels=(64, 128),
                                            cross_attention_dim=256, projection_class_embeddings_input_dim=128 + 48)


def test_int8_quantize_and_dequantize_on_the_card_match_the_cpu_bitwise(dev):
    """``quantize_tree`` of the same bf16 weights on the card and on the CPU:
    int8 values and scales bitwise; the dequantized bf16 weights, and each
    weight a module quantized in place reads on the card, bitwise the CPU's."""
    import copy

    from uwudiff_tpu_torch.ops.quantize import dequantize_tree, quantize_module_, quantize_tree

    cpu = _small_unet("cpu")
    gpu = copy.deepcopy(cpu).to(dev)
    qc, qg = quantize_tree(cpu), quantize_tree(gpu)
    names = [name for name, v in qc.items() if isinstance(v, dict)]
    assert names and names == [name for name, v in qg.items() if isinstance(v, dict)]
    for name in names:
        assert torch.equal(qg[name]["__q8__"].cpu(), qc[name]["__q8__"]), name
        assert torch.equal(qg[name]["scale"].cpu(), qc[name]["scale"]), name
    want = dequantize_tree(qc)
    got = dequantize_tree(qg)
    assert all(torch.equal(got[name].cpu(), want[name]) for name in names)
    quantize_module_(gpu)
    for name in names:
        owner, _, attr = name.rpartition(".")
        assert torch.equal(getattr(gpu.get_submodule(owner), attr).cpu(), want[name]), name


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_adapter_swaps_on_the_card_keep_pointers_and_restore_bitwise(dev, quantize):
    """``set_adapter`` on the card: after a swap the denoiser holds ``merge``
    of the base on the card (under int8 its ``quantize_tree``), bitwise;
    every parameter and buffer keeps its ``data_ptr``; ``None`` restores
    every tensor bitwise; under int8 no quantized weight's bf16 tensor
    outlives the construction."""
    import gc
    import weakref

    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.ops.quantize import quantize_tree
    from uwudiff_tpu_torch.serving import Txt2ImgPipeline
    from uwudiff_tpu_torch.training import LycorisAdapter, build_adapter_config

    unet = _small_unet(dev)
    base = {k: v.detach().clone() for k, v in unet.named_parameters()}
    adapters = []
    for seed, cfg in ((1, "configs/lycoris/sdxl-adapters.toml"),
                      (2, {"targets": [{"pattern": r".*kernel$", "dim": 8}], "enable_conv": True})):
        adapter = LycorisAdapter.create(unet, build_adapter_config(cfg), torch.Generator().manual_seed(seed))
        for leaves in adapter.params.values():  # the zero factor redrawn: a real delta
            for k, v in leaves.items():
                leaves[k] = torch.randn(v.shape, generator=torch.Generator().manual_seed(seed)) * 0.05
        adapters.append(adapter)
    weights = [weakref.ref(p) for p in unet.parameters()]
    pipe = Txt2ImgPipeline(unet, None, None, NoiseSchedule.sdxl(), device=dev, quantize_weights=quantize)
    gc.collect()
    # under int8 the card holds no bf16 copy: every quantized weight's tensor is gone
    assert sum(w() is None for w in weights) == len(pipe._quantized) and (len(pipe._quantized) > 0) == quantize

    def tensors():
        return {**dict(unet.named_parameters()), **dict(unet.named_buffers())}

    ptrs = {k: v.data_ptr() for k, v in tensors().items()}
    start = {k: v.clone() for k, v in tensors().items()}
    pipe.register_adapter("a", adapters[0]).register_adapter("b", adapters[1])
    for served, used in (("a", adapters[:1]), (["a", "b"], adapters), ("b", adapters[1:])):
        pipe.set_adapter(served)
        merged = base
        for adapter in used:
            merged = adapter.merge(merged)
        want = quantize_tree(unet, merged) if quantize else merged
        held = tensors()
        for name, v in want.items():
            if isinstance(v, dict):
                assert torch.equal(held[name + "_q8"], v["__q8__"]) and torch.equal(held[name + "_scale"], v["scale"])
            else:
                assert torch.equal(held[name], v), name
        assert {k: v.data_ptr() for k, v in held.items()} == ptrs
    pipe.set_adapter(None)
    assert all(torch.equal(v, start[k]) for k, v in tensors().items())
    assert {k: v.data_ptr() for k, v in tensors().items()} == ptrs


# ------------------------------------------- the training CLI's path: fit, resume, remat

CONFIG_DIR = __import__("os").path.join(__import__("os").path.dirname(__file__), "..", "configs")


def _small_fit_config():
    """The repo's tiny latent config widened to head dim 64 (the tiny
    presets' 16 is not among the kernels' head dims) in the SDXL overlay's
    recipe: bf16 UNet and CLIP, ``adamw_factored`` with no global clip, the
    UNet's blocks recomputed; caption dropout and a weight EMA on."""
    import os

    from uwudiff_tpu_torch.config import load_config_files, merge_configs

    small = {
        "seed": 5,
        "data": {"dataset_config": {"sample_size": [16, 16, 4], "n_samples": 6},
                 "dataloader_config": {"batch_size": 2}},
        "trainer": {
            "param_dtype": "bfloat16", "optimizer": "adamw_factored", "opt_config": {"weight_decay": 0.01},
            "grad_clip": None, "caption_dropout": 0.5, "ema_weights_decay": 0.99, "use_warm_up": False,
            "lr": 1e-4,
            "model_config": {
                "unet": {"block_out_channels": [128, 128], "cross_attention_dim": 128, "dtype": "bfloat16",
                         "gradient_checkpointing": True},
                "te": {"_load_config_": {"param_dtype": "bfloat16"},
                       "text_model_and_configs": [[{"model_type": "clip", "preset": "tiny", "hidden_size": 128,
                                                    "num_heads": 2}, {"use_pooled": False, "layer_idx": -2}]]},
            },
        },
    }
    return merge_configs(load_config_files([os.path.join(CONFIG_DIR, "demo_training_latent.yaml")]), small)


def _live(state: dict) -> dict:
    """The state's tensors that the trainer holds (not the 0-dim step,
    count and EMA loss made for the dict)."""
    return {k: t for k, t in state.items() if k.startswith(("params/", "masters/", "ema_params/"))
            or (k.startswith("opt_state/") and k != "opt_state/count")}


def test_fit_resumes_bitwise_on_the_card(dev, tmp_path):
    """4 steps unbroken against 2 steps and a fresh trainer that resumes to 4
    (3 batches an epoch): the whole state bitwise, and no tensor of the
    resumed trainer moved (the fused update's leaf table points at them)."""
    from uwudiff_tpu_torch.train import build

    torch.backends.cudnn.deterministic = True

    def leg(name, steps, resume):
        trainer, dm, _ = build(_small_fit_config(), "cuda")
        trainer.setup()
        ptrs = {k: t.data_ptr() for k, t in _live(trainer.state_dict()).items()}
        trainer.fit(dm, max_steps=steps, log_every=100, ckpt_dir=str(tmp_path / name), ckpt_every=2,
                    resume_from=resume)
        moved = [k for k, t in _live(trainer.state_dict()).items() if t.data_ptr() != ptrs[k]]
        return trainer, moved

    whole, _ = leg("whole", 4, False)
    leg("split", 2, False)
    resumed, moved = leg("split", 4, True)
    assert not moved, moved[:4]
    want, got = whole.state_dict(), resumed.state_dict()
    assert want.keys() == got.keys() and resumed.step == 4
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert all(bool(torch.isfinite(t.float()).all()) for t in got.values())


def test_remat_launches_the_checkpointed_forwards_twice(dev):
    """With gradient_checkpointing every ResnetBlock2D and Transformer2DModel
    runs its forward again in the backward: twice the flash forwards (all
    inside transformers) and twice the GroupNorm forwards inside those
    blocks, once conv_norm_out's; the backward kernels once each, and the
    loss and gradients bitwise those without remat."""
    from uwudiff_tpu_torch.models import UNet2DConditionModel
    from uwudiff_tpu_torch.models.layers import GroupNorm
    from uwudiff_tpu_torch.models.transformer import BasicTransformerBlock

    torch.manual_seed(0)
    kw = dict(device=dev, dtype=torch.bfloat16, block_out_channels=(128, 128), cross_attention_dim=128)
    plain = UNet2DConditionModel.from_config("tiny", **kw).train()
    remat = UNet2DConditionModel.from_config("tiny", gradient_checkpointing=True, **kw).train()
    remat.load_state_dict(plain.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 16, 16, 4), generator=gen, device=dev)
    ctx = torch.randn((2, 77, 128), generator=gen, device=dev)
    t = torch.tensor([10.0, 600.0], device=dev)
    attn = sum(2 if m.has_cross else 1 for m in plain.modules() if isinstance(m, BasicTransformerBlock))
    norms = [n for n, m in plain.named_modules() if isinstance(m, GroupNorm)]
    inside = sum(1 for n in norms if n != "conv_norm_out")
    out = {}
    for name, model in (("plain", plain), ("remat", remat)):
        reset_launch_counts()
        loss = model(x, t, ctx).square().mean()
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (launch_counts(), loss.detach(), [p.grad for p in model.parameters()])
    (pc, ploss, pgrads), (rc, rloss, rgrads) = out["plain"], out["remat"]
    assert pc["flash_fwd"] == attn and rc["flash_fwd"] == 2 * attn
    assert pc["flash_fwd_sm90"] == pc["flash_fwd"] and rc["flash_fwd_sm90"] == rc["flash_fwd"]
    assert pc["flash_bwd_dq"] == rc["flash_bwd_dq"] == pc["flash_bwd_dkv"] == rc["flash_bwd_dkv"] == attn
    fwd = {k: c["gn_silu_fused"] + c["gn_stats"] for k, c in (("plain", pc), ("remat", rc))}  # either route
    bwd = {k: c["gn_silu_bwd_fused"] + c["gn_bwd_partials"] for k, c in (("plain", pc), ("remat", rc))}
    assert fwd == {"plain": len(norms), "remat": len(norms) + inside}
    assert bwd == {"plain": len(norms), "remat": len(norms)}
    assert torch.equal(rloss, ploss)
    assert all(torch.equal(r, p) for r, p in zip(rgrads, pgrads))
