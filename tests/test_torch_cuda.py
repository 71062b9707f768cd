"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Every test is marked ``cuda`` and skips where no GPU is visible. This
file imports torch and the port only, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are bf16 ones: the kernels round their outputs (and flash
attention its P and dS tiles) to bf16 once, the plain versions compute
in fp32. The Hopper kernels (D = 64) and the backward kernels are also
held to bitwise reproducibility.
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
# run (B, Sq, Sk, H, bias kind, scale), and a ragged one with a key mask
_PATH_CASES = [
    (8, 4096, 4096, 10, "none", None),  # SDXL level 1 self-attention, serving (128^2 latents)
    (8, 1024, 1024, 20, "none", None),  # level 2, serving
    (8, 4096, 77, 10, "none", None),  # cross-attention over the 77 text tokens
    (8, 1024, 77, 20, "none", None),
    (8, 1024, 1024, 10, "none", None),  # the training step at 64^2 latents
    (8, 256, 256, 20, "none", None),
    (8, 1024, 77, 10, "none", None),
    (8, 256, 77, 20, "none", None),
    (8, 77, 77, 20, "full", None),  # CLIP-bigG, causal + padding
    (8, 77, 77, 12, "full", None),  # CLIP-L
    (8, 256, 256, 64, "full", 1.0),  # T5-XXL: learned bias, no 1/sqrt(d)
    (8, 1357, 1357, 24, "key", None),  # the SD3 MMDiT's joint attention with the text mask
    (2, 200, 200, 4, "key", None),
]


@pytest.mark.parametrize("b,sq,sk,h,kind,scale", _PATH_CASES)
def test_hopper_forward_matches_plain_at_the_path_shapes(dev, b, sq, sk, h, kind, scale):
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((b, s, h, 64), generator=gen, device=dev, dtype=torch.bfloat16)
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


def test_hopper_forward_takes_fused_qkv_head_views(dev):
    """q/k/v as [B, S, H, D] views of one [B, S, 3, H, D] projection go
    into the tensor maps with their own strides, uncopied."""
    gen = torch.Generator(device=dev).manual_seed(8)
    qkv = torch.randn((2, 300, 3, 4, 64), generator=gen, device=dev, dtype=torch.bfloat16)
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


@pytest.mark.parametrize("d,kernel", [(64, "flash_fwd_sm90"), (40, "flash_fwd_mma"), (80, "flash_fwd_mma"),
                                      (160, "flash_fwd_mma")])
def test_forward_dispatches_on_the_head_dim(dev, d, kernel):
    q = torch.randn((1, 130, 2, d), device=dev, dtype=torch.bfloat16)
    reset_launch_counts()
    out, _ = flash_fwd(q, q, q)
    counts = launch_counts()
    assert counts[kernel] == counts["flash_fwd"] == 1
    _assert_flash_close(out, flash_attention_reference(q, q, q)[0])
    with pytest.raises(ValueError, match="head dim"):
        (flash_fwd_mma if kernel == "flash_fwd_sm90" else flash_fwd_sm90)(q, q, q)


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
    """D = 160 runs forward (SD1.5's level 3) but has no backward build."""
    from uwudiff_tpu_torch.ops.flash_attention import flash_bwd

    q = torch.randn((1, 64, 2, 160), device=dev, dtype=torch.bfloat16)
    out, lse = flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(q, q, q, None, out, lse, torch.ones_like(out))


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


def test_hopper_backward_takes_fused_qkv_head_views(dev):
    """q/k/v/dO as [B, S, H, D] views of one [B, S, 4, H, D] tensor go into
    the tensor maps with their own strides, uncopied."""
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd_dkv_sm90,
        flash_bwd_dq_sm90,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn((2, 300, 4, 3, 64), generator=gen, device=dev, dtype=torch.bfloat16)
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


@pytest.mark.parametrize("d,suffix", [(64, "_sm90"), (40, "_mma"), (80, "_mma")])
def test_backward_dispatches_on_the_head_dim(dev, d, suffix):
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd,
        flash_bwd_dkv_mma,
        flash_bwd_dkv_sm90,
    )

    q, k, v, bias, out, lse, dout, delta = _bwd_inputs(1, 130, 200, 2, "none", None, seed=14, d=d)
    reset_launch_counts()
    got = flash_bwd(q, k, v, None, out, lse, dout)
    counts = launch_counts()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name + suffix] == counts[name] == 1
    for g, r in zip(got[:3], flash_attention_backward_reference(q, k, v, None, out, lse, dout)[:3]):
        _assert_flash_close(g, r)
    with pytest.raises(ValueError, match="head dim"):
        (flash_bwd_dkv_mma if suffix == "_sm90" else flash_bwd_dkv_sm90)(q, k, v, dout, lse, delta)


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
    # both outputs bitwise reproducible; dQ is the mma.sync K4's, bitwise,
    # where K4 is that kernel (D = 40/80) and within the flash bound of the
    # Hopper K4 at D = 64 (other products, summed in another order)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq2, db2 = flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale)
    assert torch.equal(dq, dq2) and torch.equal(dbias.reshape(b * h, s, s), db2)
    dq_k4 = flash_bwd(q, k, v, bias, out, lse, dout, scale)[0]
    if d == 64:
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


def test_flash_dbias_raises_for_a_head_dim_it_was_not_built_for(dev):
    from uwudiff_tpu_torch.ops.flash_attention import flash_bwd

    q = torch.randn((1, 64, 2, 160), device=dev, dtype=torch.bfloat16)
    bias = torch.zeros((1, 2, 64, 64), device=dev)
    out, lse = flash_fwd(q, q, q, bias)
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(q, q, q, bias, out, lse, torch.ones_like(out), bias_grad=True)
