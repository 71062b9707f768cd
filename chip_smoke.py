#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uwudiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every hand-written kernel (csrc/*.cu, nvcc, sm_90a)
  2. kernels - each kernel against its plain PyTorch version on the card,
               in bf16: the forward and backward kernels at the serving,
               training and textual-inversion paths' shapes (CLIP-L/bigG,
               T5-XXL, the MMDiT's joint attention), each twice for bitwise
               reproducibility, the dQ + dBias kernel at T5-XXL's; every
               GroupNorm shape on the route plan_gn gives it (the fused
               single-pass kernel or the chunked stats + apply pair), with
               wall and device ms beside F.group_norm+F.silu, and the
               training path's GroupNorm backward (and a 1024^2 one) on the
               route plan_gn_bwd gives it (the fused single-pass kernel or
               K7 + K8), beside F.group_norm+F.silu's backward; the
               Hopper forward and backward (D = 64) also on strided head
               views of one fused tensor, and raising on a view TMA cannot
               take; the Hopper backward reading CLIP's broadcast bias in
               place; median ms of the kernel, the plain version and one
               library call, the profiler's device time, the card's lower
               bound for the same work and the exp2 floor. Then
               small SDXL- and SD3-shaped models, bf16 on the card through
               the kernels, against the same weights in fp32 on the CPU:
               forwards, one SDXL training step's loss and gradients, and
               one textual-inversion step's loss and row gradients
  3. serve   - SDXL at full width (random weights from a fixed seed, bf16):
               BatchingServer -> clip_l + clip_bigg -> CFG 5.0
               Euler-ancestral UNet -> VAE decode, 1024x1024 requests: a
               batch of 4 with distinct seeds, then a lone request. Checks
               the images, seed-lane isolation and that every forward kernel
               was launched by that run, every flash forward on the Hopper
               kernel, and each GroupNorm call on the route plan_gn gives
               its shape (fused, or the chunked pair).
  4. train   - the SDXL full fine-tune step at full width
               (training/bench_setup.py: batch 8, 64x64 latents, bf16
               params with stochastic rounding, adamw_factored): one
               warm-up step and 5 timed steps. Checks finite losses and
               grad norms, that every parameter took an update, and that
               each step launched every kernel exactly as often as the
               UNet's plan says (each GroupNorm's forward and backward on
               the routes plan_gn and plan_gn_bwd give its shape), every
               flash forward, dQ and dK/dV on the Hopper kernels.
  5. ti      - SD3-medium textual inversion at full width
               (training/bench_setup.py: MMDiT + CLIP-L + CLIP-bigG +
               T5-XXL at 256 tokens, batch 8, 64x64x16 latents, bf16
               frozen weights, two placeholder vectors per encoder): one
               warm-up step and 5 timed steps. Checks finite losses,
               non-zero grad norms, that every row table moved, that no
               frozen leaf changed (per-leaf fp64 checksums) and each
               step's launches against the plan from the modules (K4 in
               every T5 layer, whose learned bias is frozen here, so no K5;
               every flash forward, dQ and dK/dV on the Hopper kernels).
Prints the card's name and power limit, a {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Exits non-zero, with no result, when CUDA is
unavailable or the package is missing. A full report goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
STEPS = 4
CFG = 5.0
RES = 1024

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_BF16 = 989e12  # tensor cores, flop/s
PEAK_FP32 = 67e12  # CUDA cores, flop/s
EXP2_PER_CLOCK = 16  # SFU exp2 results a clock per SM
SM_CLOCK_HZ = None  # nvidia-smi's clocks.max.sm, read in main()


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=20, warmup=2, runs=3):
    """Device time of one call: CUDA events around a run of ``reps``
    back-to-back calls, over the count; the median of ``runs`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def profiled_ms(fn, family=None, reps=10, tries=3):
    """Device time of one call from torch.profiler over ``reps`` calls:
    (the kernels of ``family``, as profile_serving names them; every other
    kernel or copy the call puts on the device), or with no ``family`` the
    sum of every kernel and copy. A trace that caught no device activity
    (it happens) is taken again; after ``tries`` empty traces the sum is
    None, and a family the profiler never saw raises."""
    from torch.profiler import ProfilerActivity, profile

    from uwudiff_tpu_torch.profile_serving import _family

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = other = 0.0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if family is not None and _family(ev.name) == family:
                    mine += ev.time_range.elapsed_us() / 1e3
                else:
                    other += ev.time_range.elapsed_us() / 1e3
        if mine + other > 0:
            break
    if family is None:
        return other / reps if other > 0 else None
    if mine == 0.0:
        raise RuntimeError(f"the profiler saw no {family} kernel")
    return mine / reps, other / reps


def _ms(t):
    return "n/a" if t is None else f"{t:.4f}"


def exp_floor_ms(b, h, sq, sk):
    """The SFU floor of the whole flash-forward function: one exp2 per
    query-key pair, every one on the SFU, at its rate over every SM at the
    card's maximum SM clock. Computed, not measured; flash_fwd_sm90 sends
    one n8-tile in eight to the FMA pipe, so its own SFU work is 7/8 of
    this."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * sq * sk / (EXP2_PER_CLOCK * sms * SM_CLOCK_HZ) * 1e3


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels


# the textual-inversion path's attentions: CLIP-L/bigG causal over 77
# tokens, T5-XXL over 256 (scale 1.0, learned bias), the MMDiT's joint
# attention over 77 + 256 text and 1024 image tokens with the text mask
TI_CONTEXT = (77, 256)


def flash_cases():
    # (name, B, Sq, Sk, H, D, bias kind, scale; None is 1/sqrt(D))
    return [
        ("sdxl_l1_self", 8, 4096, 4096, 10, 64, "none", None),
        ("sdxl_l2_self", 8, 1024, 1024, 20, 64, "none", None),
        ("sdxl_l1_cross", 8, 4096, 77, 10, 64, "none", None),
        ("sdxl_l2_cross", 8, 1024, 77, 20, 64, "none", None),
        # the SDXL training path's at 64x64 latents (levels 1 and 2)
        ("train_l1_self", 8, 1024, 1024, 10, 64, "none", None),
        ("train_l2_self", 8, 256, 256, 20, 64, "none", None),
        ("train_l1_cross", 8, 1024, 77, 10, 64, "none", None),
        ("train_l2_cross", 8, 256, 77, 20, 64, "none", None),
        ("clip_bigg_causal", 8, 77, 77, 20, 64, "full", None),
        ("clip_l_causal", 8, 77, 77, 12, 64, "full", None),
        ("t5_xxl", 8, 256, 256, 64, 64, "t5", 1.0),
        ("mmdit_joint", 8, 1357, 1357, 24, 64, "joint", None),
        ("ragged_keymask", 2, 200, 200, 4, 64, "key", None),
        ("sd15_d40", 4, 4096, 4096, 8, 40, "none", None),
        ("sd15_d80", 4, 1024, 1024, 8, 80, "none", None),
        ("sd15_d160", 4, 256, 256, 8, 160, "none", None),
    ]


def make_bias(kind, b, h, sq, sk, dev, gen):
    if kind == "none":
        return None
    if kind == "t5":
        return t5_bias(b, h, sq, dev, gen)
    neg = torch.finfo(torch.float32).min
    if kind == "key":
        mask = torch.ones(b, sk, device=dev)
        mask[:, sk - 37:] = 0
        return torch.where(mask.bool(), 0.0, neg)[:, None, None, :]
    if kind == "joint":  # [CLIP pair's 77 | T5's 256 | image]: each prompt's T5 tokens padded after its length
        keys = torch.arange(sk, device=dev)[None, :]
        t5_len = (torch.arange(b, device=dev) * 53) % TI_CONTEXT[1] + 7
        masked = (keys >= TI_CONTEXT[0] + t5_len[:, None]) & (keys < sum(TI_CONTEXT))
        return torch.where(masked, neg, 0.0)[:, None, None, :]
    # CLIP: causal + padding, finfo.min added twice -> -inf
    causal = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
    lengths = (torch.arange(b, device=dev) * 37) % sk + 1  # tokens kept per prompt
    pad = torch.arange(sk, device=dev)[None, :] < lengths[:, None]
    return torch.where(causal, 0.0, neg)[None, None] + torch.where(pad, 0.0, neg)[:, None, None, :]


def bias_bytes(bias):
    """Bias bytes the function must read: the bias as it is given, read
    once (CLIP's [B, 1, Sq, Sk] once for every head, T5's [B, H, Sq, Sk]
    whole, a key bias [B, 1, 1, Sk] once for every query row)."""
    return 0 if bias is None else bias.numel() * bias.element_size()


def check_flash(results, failures):
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_reference, forward_kernel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, b, sq, sk, h, d, kind, scale in flash_cases():
        fwd = forward_kernel(d)  # flash_fwd_sm90 at D = 64, flash_fwd_mma at 40/80/160
        q, k, v = (
            torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for s in (sq, sk, sk)
        )
        bias = make_bias(kind, b, h, sq, sk, dev, gen)
        out, lse = fwd(q, k, v, bias, scale)
        torch.cuda.synchronize()
        out2, lse2 = fwd(q, k, v, bias, scale)
        bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
        del out2, lse2
        ref, ref_lse = flash_attention_reference(q, k, v, bias, scale)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
        # out and ref are both rounded to bf16 and may differ by one bf16 step
        # (2**-7 relative at most) per element: the largest error is held to
        # one step of the largest output plus 2**-10 for the P tile's bf16
        # rounding, the RMS error to one step of the RMS output (a lost K/V
        # tile, ~1/n_tiles of every row, exceeds that many times over)
        ref_max = ref.float().abs().max().item()
        ref_rms = ref.float().pow(2).mean().sqrt().item()
        rms_err = (out.float() - ref.float()).pow(2).mean().sqrt().item()
        tol, rms_tol, lse_tol = 2.0**-7 * ref_max + 2.0**-10, 2.0**-7 * ref_rms, 1e-3
        ok = finite and bitwise and err <= tol and rms_err <= rms_tol and lse_err <= lse_tol
        ms = time_ms(lambda: fwd(q, k, v, bias, scale))
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, bias, scale), reps=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.clamp_min(NEG_INF).to(torch.bfloat16)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)  # noqa: E731
        library_ms = time_ms(library)
        flops = 4.0 * b * h * sq * sk * d
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq + bias_bytes(bias)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16)
        row = dict(kernel=fwd.__name__, case=name, shape=[b, sq, sk, h, d], bias=kind, scale=scale,
                   max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, ref_max_abs=ref_max,
                   rms_err=rms_err, rms_tol=rms_tol, bitwise=bitwise, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   exp_ms=exp_floor_ms(b, h, sq, sk), tflops=flops / ms / 1e9)
        # device time alone, from the profiler (the wrapper's bias copy included
        # where it makes one); at the small shapes the host time of a call is
        # most of ms
        row["kernel_device_ms"] = profiled_ms(lambda: fwd(q, k, v, bias, scale))
        row["library_device_ms"] = profiled_ms(library)
        results.append(row)
        log(f"  {fwd.__name__} {name:18s} err {err:.2e} (tol {tol:.1e}) rms {rms_err:.1e} (tol {rms_tol:.1e})"
            f" lse {lse_err:.1e} bitwise {bitwise} {'ok' if ok else 'FAIL'}"
            f" | {ms:.4f} ms ({row['tflops']:.0f} TF/s) plain {plain_ms:.2f} sdpa {library_ms:.4f}"
            f" bound {bound_ms:.3f} ({bound_by}) SFU floor {row['exp_ms']:.3f};"
            f" device {_ms(row['kernel_device_ms'])} vs sdpa {_ms(row['library_device_ms'])}")
        if not ok:
            failures.append(f"{fwd.__name__} {name}: err {err} (tol {tol}) rms {rms_err} (tol {rms_tol})"
                            f" lse_err {lse_err} finite {finite} bitwise {bitwise}")
        del q, k, v, out, lse, ref, ref_lse, mask
        torch.cuda.empty_cache()
    check_flash_views(failures)


def check_flash_views(failures):
    """The Hopper forward on q/k/v cut as strided head views from one fused
    [B, S, 3, H, D] projection (taken uncopied by TMA), and refusing a view
    TMA cannot take (k expanded over heads, stride 0): it raises, it does
    not copy."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_reference, flash_fwd_sm90

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    qkv = torch.randn((8, 1024, 3, 10, 64), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    ok, err, rms_err, tol = close_enough(flash_fwd_sm90(q, k, v)[0], flash_attention_reference(q, k, v)[0])
    log(f"  flash_fwd_sm90 fused-qkv views {tuple(q.stride())}: err {err:.2e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_fwd_sm90 on fused-qkv views: err {err} rms {rms_err} (tol {tol})")
    k_shared = k[:, :, :1].expand(k.shape)
    reset_launch_counts()
    try:
        flash_fwd_sm90(q, k_shared, k_shared)
        failures.append("flash_fwd_sm90 took a view with a zero head stride")
    except ValueError as e:
        log(f"  flash_fwd_sm90 refuses a stride-0 head view: {e}")
    if launch_counts()["flash_fwd"] != 0:
        failures.append("a refused view still launched a forward kernel")


def gn_cases():
    cases = [(8, hw, c) for c in (320, 640, 960, 1280, 1920, 2560) for hw in (1024, 4096, 16384)]
    # the VAE decoder's norms: one image, and the served batch of 4 at
    # every resolution of the decoder (128^2 mid ... 1024^2 last up block)
    vae = [(1, 1048576, 128), (1, 262144, 256)]
    vae += [(4, 16384, 512), (4, 65536, 512), (4, 262144, 512), (4, 262144, 256),
            (4, 1048576, 256), (4, 1048576, 128)]
    return cases + vae


def check_gn(results, failures):
    """Every gn_cases() shape on the route plan_gn gives it: the fused
    kernel (K2) or the chunked pair (K3 + the apply), against the plain
    version (y within one bf16 step of the largest output + 1e-3, the saved
    statistics within 1e-4 relative, bitwise over two runs); wall ms (CUDA
    events) and the profiler's device ms beside F.group_norm+F.silu (and
    torch.var_mean for K3) and the route's bound: 2 passes over x fused, 3
    chunked."""
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import gn_silu_apply, gn_silu_fused, gn_stats, plan_gn
    from uwudiff_tpu_torch.ops.groupnorm_silu import (
        gn_silu_apply_reference,
        gn_stats_reference,
        group_norm_silu_reference,
    )

    family = "groupnorm (K2/K3)"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    groups, eps = 32, 1e-5
    for n, hw, c in gn_cases():
        x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        # the models' affine dtype: the kernels read gamma/beta as bf16
        gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).bfloat16()
        beta = (torch.randn(c, generator=gen, device=dev) * 0.1).bfloat16()
        plan = plan_gn(n, hw, c, groups, torch.bfloat16)
        fused = plan.route == "fused"
        if fused:
            y, stats = gn_silu_fused(x, gamma, beta, groups, eps, with_stats=True)
            bitwise = torch.equal(y, gn_silu_fused(x, gamma, beta, groups, eps))
        else:
            stats = gn_stats(x, gamma, beta, groups, eps, with_group_stats=True)
            y = gn_silu_apply(x, stats[0], stats[1])
            again = gn_stats(x, gamma, beta, groups, eps, with_group_stats=True)
            bitwise = all(torch.equal(a, b) for a, b in zip(stats, again)) and torch.equal(
                y, gn_silu_apply(x, again[0], again[1]))
        torch.cuda.synchronize()
        # scale, mean and inv relative; shift = beta - mean*scale, which cancels, absolute
        ref_stats = gn_stats_reference(x, gamma, beta, groups, eps, with_group_stats=True)
        stats_err = max([((a - r).abs() / r.abs().clamp_min(1e-3)).max().item()
                         for i, (a, r) in enumerate(zip(stats, ref_stats)) if i != 1]
                        + [(stats[1] - ref_stats[1]).abs().max().item()])
        yr = group_norm_silu_reference(x, gamma, beta, groups, eps)
        err = (y.float() - yr.float()).abs().max().item()
        # one bf16 ulp at the largest output, plus fp32 stats noise
        tol = yr.float().abs().max().item() * 2.0**-7 + 1e-3
        ok = bool(torch.isfinite(y).all()) and err <= tol and stats_err <= 1e-4 and bitwise
        # the library on the layout a user would hand it: contiguous NCHW (its
        # native one; the copy is made outside the timing)
        side = int(round(hw**0.5))
        x_nchw = x.transpose(1, 2).reshape(n, c, side, side).contiguous()

        def library():
            return F.silu(F.group_norm(x_nchw, groups, gamma, beta, eps))

        library_ms, library_dev = time_ms(library), profiled_ms(library)
        del x_nchw
        elems = n * hw * c
        common = dict(shape=[n, hw, c], route=plan.route, plan=plan._asdict(), max_abs_err=err, tol=tol,
                      stats_rel_err=stats_err, bitwise=bitwise, ok=ok, pair_library_ms=library_ms,
                      pair_library_device_ms=library_dev, library_computes="F.group_norm + F.silu, NCHW")
        if fused:
            ms = time_ms(lambda: gn_silu_fused(x, gamma, beta, groups, eps))
            dev_ms, other = profiled_ms(lambda: gn_silu_fused(x, gamma, beta, groups, eps), family)
            plain = time_ms(lambda: group_norm_silu_reference(x, gamma, beta, groups, eps), reps=3)
            fb, fby = bound(4 * elems + 4 * c, 8.0 * elems, PEAK_FP32)  # x read once, y written once
            results.append(dict(kernel="gn_silu_fused", case=f"{n}x{hw}x{c}", ms=ms, device_ms=dev_ms,
                                other_device_ms=other, plain_ms=plain, library_ms=library_ms, bound_ms=fb,
                                bound_by=fby, **common))
            log(f"  gn [{n},{hw},{c}] fused c{plan.cluster} err {err:.2e} (tol {tol:.1e}) stats {stats_err:.1e}"
                f" bitwise {bitwise} {'ok' if ok else 'FAIL'} | {ms:.4f} ms, device {_ms(dev_ms)} vs"
                f" F.group_norm+silu {library_ms:.4f} (device {_ms(library_dev)}); bound {fb:.4f}; plain {plain:.2f}")
        else:
            scale, shift = stats[0], stats[1]
            x_g = x.view(n, hw, groups, c // groups)

            def var_mean():
                return torch.var_mean(x_g, dim=(1, 3), correction=0)

            ms_stats = time_ms(lambda: gn_stats(x, gamma, beta, groups, eps))
            ms_apply = time_ms(lambda: gn_silu_apply(x, scale, shift))
            dev_stats, _ = profiled_ms(lambda: gn_stats(x, gamma, beta, groups, eps), family)
            dev_apply, _ = profiled_ms(lambda: gn_silu_apply(x, scale, shift), family)
            plain_stats = time_ms(lambda: gn_stats_reference(x, gamma, beta, groups, eps), reps=3)
            plain_apply = time_ms(lambda: gn_silu_apply_reference(x, scale, shift), reps=3)
            stats_library_ms, stats_library_dev = time_ms(var_mean), profiled_ms(var_mean)
            sb, sby = bound(2 * elems + 4 * c + 8 * n * c, 3.0 * elems, PEAK_FP32)
            ab, aby = bound(4 * elems + 8 * n * c, 5.0 * elems, PEAK_FP32)
            apply_err = (y.float() - gn_silu_apply_reference(x, scale, shift).float()).abs().max().item()
            common.update(pair_ms=ms_stats + ms_apply, pair_device_ms=dev_stats + dev_apply)
            results.append(dict(kernel="gn_stats", case=f"{n}x{hw}x{c}", ms=ms_stats, device_ms=dev_stats,
                                plain_ms=plain_stats, library_ms=stats_library_ms,
                                library_device_ms=stats_library_dev,
                                stats_library_computes="torch.var_mean over the groups",
                                bound_ms=sb, bound_by=sby, **common))
            results.append(dict(kernel="gn_silu_apply", case=f"{n}x{hw}x{c}", ms=ms_apply, device_ms=dev_apply,
                                plain_ms=plain_apply, library_ms=None, bound_ms=ab, bound_by=aby,
                                bound_share=ab / dev_apply, apply_err=apply_err, **common))
            log(f"  gn [{n},{hw},{c}] chunked err {err:.2e} (tol {tol:.1e}) stats {stats_err:.1e}"
                f" bitwise {bitwise} {'ok' if ok else 'FAIL'} | stats {ms_stats:.4f} (device {dev_stats:.4f})"
                f" apply {ms_apply:.4f} (device {dev_apply:.4f}, {100 * ab / dev_apply:.0f} % of its bound)"
                f" vs F.group_norm+silu {library_ms:.4f} (device {_ms(library_dev)}), stats vs var_mean"
                f" {stats_library_ms:.4f}; bound {sb + ab:.4f}; plain {plain_stats + plain_apply:.2f}")
            del x_g
        if not ok:
            failures.append(f"gn {n}x{hw}x{c} {plan.route}: err {err} stats {stats_err} bitwise {bitwise}")
        del x, y, yr
        torch.cuda.empty_cache()


def close_enough(got, ref):
    """The flash check's bound, per output: max error <= 2^-7 max|ref| +
    2^-10, RMS error <= 2^-7 RMS(ref). Returns (ok, max_err, rms_err, tol)."""
    diff, ref = got.float() - ref.float(), ref.float()
    err, rms_err = diff.abs().max().item(), diff.pow(2).mean().sqrt().item()
    tol = 2.0**-7 * ref.abs().max().item() + 2.0**-10
    ok = bool(torch.isfinite(got).all()) and err <= tol and rms_err <= 2.0**-7 * ref.pow(2).mean().sqrt().item()
    return ok, err, rms_err, tol


def flash_bwd_cases():
    # (name, B, Sq, Sk, H, D, bias kind, scale): the SDXL training path's
    # attentions at 64x64 latents (level 1: 32x32 tokens, 10 heads; level 2:
    # 16x16, 20) and the textual-inversion path's (CLIP-bigG as
    # "full_bias", CLIP-L, T5-XXL, whose dQ pass there is K5, and the
    # MMDiT's joint attention), all at D = 64 on the Hopper kernels
    return [
        ("train_l1_self", 8, 1024, 1024, 10, 64, "none", None),
        ("train_l1_cross", 8, 1024, 77, 10, 64, "none", None),
        ("train_l2_self", 8, 256, 256, 20, 64, "none", None),
        ("train_l2_cross", 8, 256, 77, 20, 64, "none", None),
        ("ragged_keymask", 2, 200, 77, 4, 64, "key", None),
        ("full_bias", 8, 77, 77, 20, 64, "full", None),
        ("clip_l_causal", 8, 77, 77, 12, 64, "full", None),
        ("t5_xxl", 8, 256, 256, 64, 64, "t5", 1.0),
        ("mmdit_joint", 8, 1357, 1357, 24, 64, "joint", None),
        # SD1.5's head dims, on the mma.sync kernels (on no path yet)
        ("sd15_d40", 4, 1024, 1024, 8, 40, "none", None),
        ("sd15_d80", 4, 256, 256, 8, 80, "none", None),
    ]


def check_flash_bwd(results, failures):
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import (
        NEG_INF,
        backward_kernels,
        flash_attention_backward_reference,
        flash_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for name, b, sq, sk, h, d, kind, scale in flash_bwd_cases():
        bwd_dq, bwd_dkv = backward_kernels(d)  # the _sm90 pair at D = 64, the _mma pair at 40/80
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
                   for s in (sq, sk, sk))
        bias = make_bias(kind, b, h, sq, sk, dev, gen)
        out, lse = flash_fwd(q, k, v, bias, scale)
        dout = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        reset_launch_counts()
        dq = bwd_dq(q, k, v, dout, lse, delta, bias, scale)
        dk, dv = bwd_dkv(q, k, v, dout, lse, delta, bias, scale)
        torch.cuda.synchronize()
        counts = launch_counts()
        routed = counts[bwd_dq.__name__] == counts[bwd_dkv.__name__] == 1
        bitwise = (torch.equal(dq, bwd_dq(q, k, v, dout, lse, delta, bias, scale))
                   and all(torch.equal(a, b_) for a, b_ in
                           zip((dk, dv), bwd_dkv(q, k, v, dout, lse, delta, bias, scale))))
        refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale)[:3]
        checks = {o: close_enough(g, r) for o, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        ok = routed and bitwise and all(c[0] for c in checks.values())
        ms_dq = time_ms(lambda: bwd_dq(q, k, v, dout, lse, delta, bias, scale))
        ms_dkv = time_ms(lambda: bwd_dkv(q, k, v, dout, lse, delta, bias, scale))
        dev_dq = profiled_ms(lambda: bwd_dq(q, k, v, dout, lse, delta, bias, scale))
        dev_dkv = profiled_ms(lambda: bwd_dkv(q, k, v, dout, lse, delta, bias, scale))
        plain_ms = time_ms(lambda: flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale),
                           reps=2, warmup=1)
        # the library: SDPA's backward alone (retain_graph), dq, dk and dv together
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = None if bias is None else bias.clamp_min(NEG_INF).to(torch.bfloat16)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
        dout_t = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t, retain_graph=True)  # noqa: E731
        library_ms = time_ms(library)
        library_dev = profiled_ms(library)
        del lib_out, qt, kt, vt, mask
        # q, dO, k, v; lse, delta; the bias
        io = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 8 * b * h * sq + bias_bytes(bias)
        mm = b * h * sq * sk * d
        exp_ms = exp_floor_ms(b, h, sq, sk)  # each kernel recomputes one exp2 per query-key pair
        for kernel, ms, dev_ms, flops, nbytes, outs in (
            (bwd_dq.__name__, ms_dq, dev_dq, 6.0 * mm, io + 2 * b * sq * h * d, ("dq",)),
            (bwd_dkv.__name__, ms_dkv, dev_dkv, 8.0 * mm, io + 4 * b * sk * h * d, ("dk", "dv")),
        ):
            bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16)
            results.append(dict(
                kernel=kernel, case=name, shape=[b, sq, sk, h, d], bias=kind, scale=scale, ok=ok, bitwise=bitwise,
                routed=routed, max_abs_err=max(checks[o][1] for o in outs), rms_err={o: checks[o][2] for o in outs},
                tol={o: checks[o][3] for o in outs}, ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_dev,
                library_computes="dq, dk and dv (SDPA backward)", pair_ms=ms_dq + ms_dkv,
                bound_ms=bound_ms, bound_by=bound_by, exp_ms=exp_ms, tflops=flops / ms / 1e9))
        errs = " ".join(f"{o} {c[1]:.1e}/{c[3]:.1e}" for o, c in checks.items())
        log(f"  flash_bwd {name:15s} {errs} bitwise {bitwise} {'ok' if ok else 'FAIL'}"
            f" | {bwd_dq.__name__} {ms_dq:.4f} {bwd_dkv.__name__} {ms_dkv:.4f} ms (pair {ms_dq + ms_dkv:.4f})"
            f" sdpa bwd {library_ms:.4f}; device {_ms(dev_dq)} + {_ms(dev_dkv)} vs sdpa {_ms(library_dev)};"
            f" SFU floor {exp_ms:.4f} each; plain {plain_ms:.2f}")
        if not ok:
            failures.append(f"flash_bwd {name}: {checks} bitwise {bitwise} launches {counts}")
        del q, k, v, out, lse, dout, dq, dk, dv, refs
        torch.cuda.empty_cache()
    check_flash_bwd_views(failures)


def check_flash_bwd_views(failures):
    """The Hopper backward on q/k/v/dO cut as strided head views (taken
    uncopied by TMA), refusing a stride-0 view (it raises, it does not
    copy), and reading CLIP's [B, 1, Sq, Sk] bias in place: the kernels
    allocate their outputs and nothing else, no [B*H, Sq, Sk] copy."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd_dkv_sm90,
        flash_bwd_dq_sm90,
        flash_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    qkv = torch.randn((8, 1024, 4, 10, 64), generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v, dout = qkv.unbind(2)  # dO as a head view too
    out, lse = flash_fwd(q, k, v)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = (flash_bwd_dq_sm90(q, k, v, dout, lse, delta),) + flash_bwd_dkv_sm90(q, k, v, dout, lse, delta)
    refs = flash_attention_backward_reference(q, k, v, None, out, lse, dout)[:3]
    for o, g, r in zip(("dq", "dk", "dv"), got, refs):
        ok, err, rms_err, tol = close_enough(g, r)
        log(f"  flash_bwd_sm90 fused-qkv views {o}: err {err:.2e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_bwd_sm90 on fused-qkv views: {o} err {err} rms {rms_err} (tol {tol})")
    k_shared = k[:, :, :1].expand(k.shape)
    reset_launch_counts()
    for fn in (flash_bwd_dq_sm90, flash_bwd_dkv_sm90):
        try:
            fn(q, k_shared, k_shared, dout, lse, delta)
            failures.append(f"{fn.__name__} took a view with a zero head stride")
        except ValueError as e:
            log(f"  {fn.__name__} refuses a stride-0 head view: {e}")
    if launch_counts()["flash_bwd_dq"] + launch_counts()["flash_bwd_dkv"] != 0:
        failures.append("a refused view still launched a backward kernel")
    del qkv, q, k, v, dout, out, lse, delta, got, refs
    # CLIP-bigG's causal + padding bias, one per prompt, broadcast over the heads
    b, s, h = 8, 77, 20
    q, k, v, dout = (torch.randn((b, s, h, 64), generator=gen, device="cuda", dtype=torch.bfloat16)
                     for _ in range(4))
    bias = make_bias("full", b, h, s, s, "cuda", gen)
    out, lse = flash_fwd(q, k, v, bias)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for fn, out_bytes in ((flash_bwd_dq_sm90, q.numel() * 2), (flash_bwd_dkv_sm90, 2 * k.numel() * 2)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = fn(q, k, v, dout, lse, delta, bias)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        # the caching allocator rounds each block up to 512 bytes
        in_place = extra <= out_bytes + 1024
        log(f"  {fn.__name__} CLIP bias {tuple(bias.shape)}: {extra} bytes allocated for {out_bytes} of output"
            f" (an expanded copy would add {b * h * s * s * 4}) {'ok' if in_place else 'FAIL'}")
        if not in_place:
            failures.append(f"{fn.__name__} allocated {extra} bytes with CLIP's bias, outputs {out_bytes}")
        del res


def flash_dbias_cases():
    # (name, B, S, H, D, scale): T5-XXL's attention at 256 tokens (no
    # 1/sqrt(d) scale), a ragged case and another head dim
    return [("t5_xxl", 8, 256, 64, 64, 1.0), ("ragged", 2, 200, 4, 64, 1.0), ("d80", 2, 256, 8, 80, None)]


def t5_bias(b, h, s, dev, gen):
    """T5's bias, built as T5EncoderModel builds it (contiguous, fp32): a
    [32, H] table at the relative-position buckets, plus key padding (each
    prompt keeps a different number of tokens)."""
    from uwudiff_tpu_torch.models.t5 import relative_position_bucket

    pos = torch.arange(s, device=dev)
    table = torch.randn((32, h), generator=gen, device=dev)
    rel = table[relative_position_bucket(pos[None, :] - pos[:, None]).long()].permute(2, 0, 1).contiguous()[None]
    keep = pos[None, :] < ((torch.arange(b, device=dev) * 53) % s + 7)[:, None]
    return rel + torch.where(keep, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]


def check_flash_dbias(results, failures):
    """K5: dq within the flash bound; dBias (dS itself, no sum to average
    rounding out) within 2^-12 of max|dS| and of RMS(dS)."""
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import flash_bwd_dq_dbias, flash_fwd
    from uwudiff_tpu_torch.ops.flash_attention import NEG_INF, flash_attention_backward_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for name, b, s, h, d, scale in flash_dbias_cases():
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
        bias = t5_bias(b, h, s, dev, gen)
        out, lse = flash_fwd(q, k, v, bias, scale)
        dout = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dbias = flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale)
        torch.cuda.synchronize()
        dq2, dbias2 = flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale)
        bitwise = torch.equal(dq, dq2) and torch.equal(dbias, dbias2)
        del dq2, dbias2
        rq, _, _, rds = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale)
        dq_ok, dq_err, dq_rms, dq_tol = close_enough(dq, rq)
        diff = dbias.view(rds.shape) - rds
        db_err, db_rms = diff.abs().max().item(), diff.pow(2).mean().sqrt().item()
        db_tol, db_rms_tol = 2.0**-12 * rds.abs().max().item(), 2.0**-12 * rds.pow(2).mean().sqrt().item()
        db_ok = bool(torch.isfinite(dbias).all()) and db_err <= db_tol and db_rms <= db_rms_tol
        del diff
        ok = bitwise and dq_ok and db_ok
        ms = time_ms(lambda: flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale))
        # the kernel alone, and whatever else the wrapper puts on the device
        # (nothing, for a bias that is already fp32, full and contiguous)
        kernel_ms, wrapper_other_ms = profiled_ms(
            lambda: flash_bwd_dq_dbias(q, k, v, dout, lse, delta, bias, scale), "flash_bwd_dq_dbias (K5)")
        plain_ms = time_ms(lambda: flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale),
                           reps=2, warmup=1)
        # the library: SDPA's backward with a bias that requires a gradient (dq, dk, dv, dbias)
        library_ms, library_note = None, "dq, dk, dv and dbias (SDPA backward, bf16 bias requiring grad)"
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = bias.clamp_min(NEG_INF).expand(b, h, s, s).to(torch.bfloat16).contiguous().requires_grad_()
        try:
            lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
            dout_t = dout.transpose(1, 2)
            library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt, mask), dout_t, retain_graph=True))
            del lib_out
        except RuntimeError as e:  # the yardstick only; no kernel of the port is involved
            library_note = f"no SDPA backend gives this bias gradient: {str(e).splitlines()[0][:200]}"
        del qt, kt, vt, mask
        mm = b * h * s * s * d
        # q, k, v, dO and dq in bf16; lse, delta; the fp32 bias read and dBias write
        nbytes = 2 * 5 * b * s * h * d + 8 * b * h * s + 8 * b * h * s * s
        bound_ms, bound_by = bound(nbytes, 6.0 * mm, PEAK_BF16)
        results.append(dict(
            kernel="flash_bwd_dq_dbias", case=name, shape=[b, s, s, h, d], bias="full", scale=scale, ok=ok,
            bitwise=bitwise, max_abs_err=max(dq_err, db_err), dq_err=dq_err, dq_rms_err=dq_rms, dq_tol=dq_tol,
            dbias_err=db_err, dbias_tol=db_tol, dbias_rms_err=db_rms, dbias_rms_tol=db_rms_tol, ms=ms,
            kernel_ms=kernel_ms, wrapper_other_device_ms=wrapper_other_ms,
            plain_ms=plain_ms, library_ms=library_ms, library_computes=library_note, bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, gb_per_s=nbytes / ms / 1e6))
        log(f"  flash_dq_dbias {name:8s} dq {dq_err:.1e}/{dq_tol:.1e} dbias {db_err:.1e}/{db_tol:.1e}"
            f" rms {db_rms:.1e}/{db_rms_tol:.1e} bitwise {bitwise} {'ok' if ok else 'FAIL'}"
            f" | {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s; kernel alone {kernel_ms:.3f},"
            f" other device work {wrapper_other_ms:.3f}) bound {bound_ms:.3f} ({bound_by})"
            f" sdpa bwd {library_ms if library_ms is None else round(library_ms, 3)} plain {plain_ms:.2f}")
        if library_ms is None:
            log(f"    {library_note}")
        if not ok:
            failures.append(f"flash_dq_dbias {name}: dq {dq_err}/{dq_tol} dbias {db_err}/{db_tol}"
                            f" rms {db_rms}/{db_rms_tol} bitwise {bitwise}")
        del q, k, v, out, lse, dout, delta, dq, dbias, rq, rds
        torch.cuda.empty_cache()


def gn_bwd_cases():
    # the training path's GroupNorms at 64x64 latents (level 0 at 4096
    # tokens, 1 at 1024, 2 at 256; the up path's concatenations widen C),
    # and level 0 of a 1024^2 training step (128x128 latents)
    return [(8, hw, c, silu) for hw, c in ((4096, 320), (4096, 960), (1024, 640), (256, 1280), (256, 2560),
                                           (16384, 320))
            for silu in (True, False)]


def gn_saved_stats(x, gamma, beta, groups, eps):
    """What the forward saves for the backward: fp32 (scale, shift) [N, C]
    and (mean, inv) [N, G], from the route plan_gn gives the shape."""
    from uwudiff_tpu_torch.ops import gn_silu_fused, gn_stats, plan_gn

    if plan_gn(*x.shape, groups, x.dtype).route == "fused":
        return gn_silu_fused(x, gamma, beta, groups, eps, with_stats=True)[1]
    return gn_stats(x, gamma, beta, groups, eps, with_group_stats=True)


def device_ops(fn, tries=3):
    """The names of the device kernels and copies of one call of ``fn``,
    from torch.profiler (a trace that caught nothing is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def check_gn_bwd(results, failures):
    """Every gn_bwd_cases() shape on the route plan_gn_bwd gives it: the
    fused kernel (one launch) or the pair (K7, then K8), from the forward's
    saved statistics, against the plain versions (close_enough per output:
    dx, t = (t1, t2) and, for the pair, K8's coefficients; bitwise over two
    runs), and the whole backward through autograd against autograd of the
    fp32 plain forward (dx, dgamma, dbeta), whose device work is the route's
    kernels, the sum over samples and the two casts to the bf16 parameters'
    dtype, nothing else (no glue). Wall ms (CUDA events) and the profiler's
    device ms beside F.group_norm+F.silu's backward and the route's bound;
    on the fused route the pair is timed beside it."""
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import gn_bwd_dx, gn_bwd_partials, gn_silu_bwd_fused, group_norm_silu, plan_gn_bwd
    from uwudiff_tpu_torch.ops.groupnorm_silu import (
        gn_bwd_dx_reference,
        gn_bwd_partials_reference,
        gn_silu_bwd_fused_reference,
        group_norm_silu_reference,
    )

    family = "groupnorm bwd (K7/K8)"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    groups, eps = 32, 1e-5
    for n, hw, c, silu in gn_bwd_cases():
        x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        g = torch.randn((n, hw, c), generator=gen, device=dev).to(torch.bfloat16)
        # the models' affine dtype: the kernels read gamma as bf16
        gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).bfloat16()
        beta = (torch.randn(c, generator=gen, device=dev) * 0.1).bfloat16()
        saved = (gamma, *gn_saved_stats(x, gamma, beta, groups, eps))
        plan = plan_gn_bwd(n, hw, c, groups, torch.bfloat16)
        fused = plan.route == "fused"
        dx_ref, t_ref = gn_silu_bwd_fused_reference(x, g, *saved, silu)

        def pair():
            t, coef = gn_bwd_partials(x, g, *saved, silu)
            return gn_bwd_dx(x, g, coef, silu), t, coef

        if fused:
            dx, t = gn_silu_bwd_fused(x, g, *saved, silu)
            again = gn_silu_bwd_fused(x, g, *saved, silu)
            bitwise = torch.equal(dx, again[0]) and torch.equal(t, again[1])
            checks = {"dx_kernel": close_enough(dx, dx_ref), "t": close_enough(t, t_ref)}
        else:
            dx, t, coef = pair()
            again = pair()
            bitwise = all(torch.equal(a, b) for a, b in zip((dx, t, coef), again))
            t_pair, coef_ref = gn_bwd_partials_reference(x, g, *saved, silu)
            checks = {"t": close_enough(t, t_pair), "coef": close_enough(coef, coef_ref),
                      "dx_kernel": close_enough(dx, gn_bwd_dx_reference(x, g, coef, silu)),
                      "dx_plain": close_enough(dx, dx_ref)}
        torch.cuda.synchronize()
        # the whole backward through autograd against autograd of the fp32 plain forward
        gamma_p = gamma.float().requires_grad_()
        beta_p = beta.float().requires_grad_()
        xg = x.detach().requires_grad_()
        got = torch.autograd.grad(group_norm_silu(xg, gamma_p, beta_p, groups, eps, silu), (xg, gamma_p, beta_p), g)
        xr = x.float().requires_grad_()
        ref = torch.autograd.grad(group_norm_silu_reference(xr, gamma_p, beta_p, groups, eps, silu),
                                  (xr, gamma_p, beta_p), g.float())
        checks.update({o: close_enough(a, r) for o, a, r in zip(("dx", "dgamma", "dbeta"), got, ref)})
        # the backward's device work with the models' bf16 parameters: the
        # route's kernels (1 fused, 2 pair), t.sum(0) and the two casts
        gamma_b, beta_b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        y = group_norm_silu(xg, gamma_b, beta_b, groups, eps, silu)
        ops = device_ops(lambda: torch.autograd.grad(y, (xg, gamma_b, beta_b), g, retain_graph=True))
        ok = bitwise and all(v[0] for v in checks.values()) and len(ops) == (4 if fused else 5)
        del got, ref, xg, xr, gamma_p, beta_p, y
        # the library: F.group_norm + F.silu's backward alone, contiguous NCHW
        side = int(round(hw**0.5))
        x_nchw = x.transpose(1, 2).reshape(n, c, side, side).contiguous().requires_grad_()
        gb, bb = (p.detach().clone().requires_grad_() for p in (gamma, beta))
        y_lib = F.group_norm(x_nchw, groups, gb, bb, eps)
        y_lib = F.silu(y_lib) if silu else y_lib
        g_nchw = g.transpose(1, 2).reshape(n, c, side, side).contiguous()
        library_ms = time_ms(lambda: torch.autograd.grad(y_lib, (x_nchw, gb, bb), g_nchw, retain_graph=True))
        del y_lib, x_nchw, g_nchw
        elems = n * hw * c
        small = 8 * n * c + 8 * n * groups + 2 * c  # scale/shift, mean/inv, gamma
        # dz (silu: z, the sigmoid, the product: 11 flops; 0 without), t1, xhat and t2 (5), dx (4)
        dz_ops = 11.0 if silu else 0.0
        fb, fby = bound(6 * elems + small + 8 * n * c, (dz_ops + 9.0) * elems, PEAK_FP32)
        tb, tby = bound(4 * elems + small + 24 * n * c, (dz_ops + 5.0) * elems, PEAK_FP32)  # t, coef out
        xb, xby = bound(6 * elems + 16 * n * c, (dz_ops + 4.0) * elems, PEAK_FP32)
        ms_t = time_ms(lambda: gn_bwd_partials(x, g, *saved, silu))
        coef = gn_bwd_partials(x, g, *saved, silu)[1]
        ms_dx = time_ms(lambda: gn_bwd_dx(x, g, coef, silu))
        dev_t, _ = profiled_ms(lambda: gn_bwd_partials(x, g, *saved, silu), family)
        dev_dx, _ = profiled_ms(lambda: gn_bwd_dx(x, g, coef, silu), family)
        plain_t = time_ms(lambda: gn_bwd_partials_reference(x, g, *saved, silu), reps=3)
        plain_dx = time_ms(lambda: gn_bwd_dx_reference(x, g, coef, silu), reps=3)
        case = f"{n}x{hw}x{c}{'' if silu else '-nosilu'}"
        common = dict(shape=[n, hw, c], silu=silu, route=plan.route, plan=plan._asdict(), ok=ok, bitwise=bitwise,
                      backward_device_ops=ops,
                      tol={o: v[3] for o, v in checks.items()}, errs={o: v[1] for o, v in checks.items()},
                      pair_ms=ms_t + ms_dx, pair_device_ms=dev_t + dev_dx, library_ms=library_ms,
                      library_computes="dx, dgamma and dbeta (F.group_norm+F.silu backward, NCHW)")
        line = (f"  gn_bwd [{n},{hw},{c}] silu={silu} {plan.route}"
                + (f" c{plan.cluster}" if fused else "") + " "
                + " ".join(f"{o} {v[1]:.1e}/{v[3]:.1e}" for o, v in checks.items())
                + f" bitwise {bitwise}; autograd's device ops {len(ops)} {'ok' if ok else 'FAIL'} |")
        if fused:
            ms = time_ms(lambda: gn_silu_bwd_fused(x, g, *saved, silu))
            dev_ms, _ = profiled_ms(lambda: gn_silu_bwd_fused(x, g, *saved, silu), family)
            plain = time_ms(lambda: gn_silu_bwd_fused_reference(x, g, *saved, silu), reps=3)
            results.append(dict(kernel="gn_silu_bwd_fused", case=case, ms=ms, device_ms=dev_ms, plain_ms=plain,
                                bound_ms=fb, bound_by=fby, max_abs_err=checks["dx_kernel"][1], **common))
            line += (f" fused {ms:.4f} ms (device {_ms(dev_ms)}, {100 * fb / dev_ms:.0f} % of its bound {fb:.4f});"
                     f" pair {ms_t + ms_dx:.4f} (device {dev_t + dev_dx:.4f})")
        else:
            results.append(dict(kernel="gn_bwd_partials", case=case, ms=ms_t, device_ms=dev_t, plain_ms=plain_t,
                                bound_ms=tb, bound_by=tby, max_abs_err=checks["t"][1], **common))
            results.append(dict(kernel="gn_bwd_dx", case=case, ms=ms_dx, device_ms=dev_dx, plain_ms=plain_dx,
                                bound_ms=xb, bound_by=xby, bound_share=xb / dev_dx,
                                max_abs_err=checks["dx_kernel"][1], **common))
            line += (f" partials {ms_t:.4f} (device {dev_t:.4f}, {100 * tb / dev_t:.0f} %) dx {ms_dx:.4f}"
                     f" (device {dev_dx:.4f}, {100 * xb / dev_dx:.0f} %) ms")
        log(line + f" vs F.group_norm+silu bwd {library_ms:.4f}; plain {plain_t + plain_dx:.2f}")
        if not ok:
            failures.append(f"gn_bwd {case}: {checks} bitwise {bitwise} device ops {ops}")
        del x, g, dx, t, coef, again, saved
        torch.cuda.empty_cache()


def small_unet(device, dtype):
    """A small SDXL-shaped UNet with head dim 64 (the tiny presets' 16 and
    32 are not among the flash kernels' head dims)."""
    from uwudiff_tpu_torch.models import UNet2DConditionModel

    return UNet2DConditionModel.from_config(
        "tiny_sdxl", device=device, dtype=dtype, block_out_channels=(64, 128), cross_attention_dim=256,
        projection_class_embeddings_input_dim=128 + 48)


def check_train_vs_cpu(failures):
    """One training step's loss and gradients of a small SDXL-shaped UNet:
    bf16 on the card through the kernels against the same weights in fp32
    on the CPU through the plain versions (which the CPU tests hold
    against the JAX package), the same noise and timesteps."""
    import copy

    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.training import DMTrainer

    torch.manual_seed(SEED + 6)
    cpu = small_unet("cpu", torch.float32)
    gpu = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 7)
    batch = {"sample": torch.randn((2, 32, 32, 4), generator=gen), "ctx": torch.randn((2, 77, 256), generator=gen),
             "pooled": torch.randn((2, 128), generator=gen),
             "added_cond": {"time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2)}}
    noise = torch.randn((2, 32, 32, 4), generator=gen)
    timesteps = torch.tensor([37, 712])
    losses, grads = {}, {}
    for dev, unet, pdt in (("cpu", cpu, None), ("cuda", gpu, "bfloat16")):
        tr = DMTrainer({"unet": unet}, loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()),
                       param_dtype=pdt, device=dev)
        loss, _ = tr.forward_backward(batch, noise, timesteps)
        losses[dev] = loss.float().cpu()
        grads[dev] = torch.cat([p.grad.float().cpu().flatten() for _, p in tr.params])
    loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).item()
    grad_err = ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    tol = 5e-2  # bf16 weights, activations and gradients through a few dozen layers
    log(f"  training step, card bf16 vs CPU fp32 plain: loss rel err {loss_err:.2e},"
        f" grad |d|/|ref| {grad_err:.2e} (tol {tol})")
    if not (loss_err <= tol and grad_err <= tol):
        failures.append(f"training step card vs CPU: loss {loss_err} grad {grad_err} > {tol}")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "tol": tol}


def small_ti_trainer(device, dtype):
    """A small SD3-shaped textual-inversion stack, head dim 64 everywhere:
    two 128-wide CLIPs (bucket 0, pooled), a 128-wide T5 at 256 tokens
    (bucket 1, masked), a 2-block MMDiT with SD3's switches on."""
    from uwudiff_tpu_torch.diffusion import NoiseSchedule, RectifiedFlowLoss
    from uwudiff_tpu_torch.models import ConcatTextEncoders, MMDiT, SimpleTokenizer
    from uwudiff_tpu_torch.training import TextualInversionTrainer
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    clip = {"model_type": "clip", "preset": "tiny", "hidden_size": 128, "num_heads": 2}
    t5 = {"model_type": "t5", "preset": "tiny", "d_model": 128, "num_heads": 2, "d_kv": 64, "d_ff": 256}
    te = ConcatTextEncoders.from_config(
        [(clip, {"use_pooled": True, "layer_idx": -2}), (clip, {"use_pooled": True, "layer_idx": -2}),
         (t5, {"concat_bucket": 1, "need_mask": True})],
        device=device, dtype=dtype, zero_for_padding=False, pad_context_to=256)
    mmdit = fill_zero_initialised(MMDiT.from_config(
        "tiny", device=device, dtype=dtype, hidden_size=128, depth=2, context_dim=256, pooled_dim=256,
        context_pre_only=True, pos_embed_max_size=16, pos_embed_base_size=8))
    return TextualInversionTrainer(
        {"unet": mmdit, "te": te, "tokenizers": [SimpleTokenizer(), SimpleTokenizer(),
                                                 SimpleTokenizer(model_max_length=256)]},
        lr=5e-3, optimizer="adamw", use_warm_up=False, num_vectors=2, seed=SEED, device=device,
        loss_config=RectifiedFlowLoss(schedule=NoiseSchedule.sdxl(), time_sampling_type="logit_normal"))


def check_ti_vs_cpu(failures):
    """One textual-inversion step's loss and row gradients of the small
    SD3-shaped stack: bf16 on the card through the kernels (K4 in the T5
    layers, whose learned bias is frozen: no K5) against the same weights in fp32 on the CPU through the plain
    versions, which the CPU tests hold against the JAX package; the same
    noise and logit-normal draws."""
    torch.manual_seed(SEED + 9)
    cpu = small_ti_trainer("cpu", torch.float32)
    gpu = small_ti_trainer("cuda", torch.bfloat16)
    for name in ("te", "unet"):  # the CPU weights; the card keeps its own dtypes (T5's fp32 norms)
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    rng = torch.Generator().manual_seed(SEED + 10)
    batch = {"latent": torch.randn((2, 16, 16, 4), generator=rng),
             "tokenizer_outputs": [tok(["a photo of <concept>", "<concept> by a lake at dawn, oil on canvas"])
                                   for tok in cpu.tokenizers]}
    noise, z = torch.randn((2, 16, 16, 4), generator=rng), torch.randn((2,), generator=rng)
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts

    losses, grads = {}, {}
    for dev, tr in (("cpu", cpu), ("cuda", gpu)):
        reset_launch_counts()
        loss, _ = tr.forward_backward(batch, noise=noise, time_draws=z)
        losses[dev] = loss.float().cpu()
        grads[dev] = torch.cat([p.grad.float().cpu().flatten() for _, p in tr.params])
    k5 = launch_counts()["flash_bwd_dq_dbias"]
    loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).item()
    grad_err = ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    tol = 5e-2  # bf16 weights, activations and gradients through three encoders and the MMDiT
    log(f"  textual-inversion step, card bf16 vs CPU fp32 plain: loss rel err {loss_err:.2e},"
        f" row grad |d|/|ref| {grad_err:.2e} (tol {tol}); |grad| {grads['cpu'].norm():.3e}; K5 launches {k5}")
    if not (loss_err <= tol and grad_err <= tol and grads["cpu"].norm() > 0 and k5 == 0):
        failures.append(f"TI step card vs CPU: loss {loss_err} grad {grad_err} > {tol} or K5 launches {k5} != 0")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "tol": tol, "grad_norm": grads["cpu"].norm().item()}


def check_models_vs_cpu(failures):
    """Small SDXL-shaped models (head dim 64: the tiny presets' 16 and 32
    are not among the flash kernel's head dims): the card's bf16 forward
    through the kernels against the same weights' fp32 forward on the CPU
    through the plain versions, which the CPU tests hold against the JAX
    package."""
    import copy

    from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders

    torch.manual_seed(SEED + 2)
    clip = {"preset": "tiny", "hidden_size": 128, "num_heads": 2}
    cpu = {
        "te": ConcatTextEncoders.from_config(
            [(clip, {"layer_idx": -2}), (clip, {"use_pooled": True, "layer_idx": -2})], device="cpu"),
        "unet": small_unet("cpu", torch.float32),
        "vae": AutoencoderKL.from_config("tiny", device="cpu", block_out_channels=(32, 64)),
    }
    gpu = {k: copy.deepcopy(m).to(device="cuda", dtype=torch.bfloat16) for k, m in cpu.items()}
    gen = torch.Generator().manual_seed(SEED + 3)
    ids = torch.randint(3, 1024, (2, 77), generator=gen)
    mask = (torch.arange(77)[None, :] < torch.tensor([[9], [77]])).int()
    toks = [{"input_ids": ids, "attention_mask": mask}] * 2
    x = torch.randn((2, 32, 32, 4), generator=gen)
    t = torch.tensor([10.5, 731.25])
    errs = {}

    def rel(a, b):
        return ((a.float().cpu() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-6)).item()

    with torch.inference_mode():
        ref_ctx, _, ref_pool, _ = cpu["te"](toks)
        ctx, _, pool, _ = gpu["te"]([{k: v.cuda() for k, v in d.items()} for d in toks])
        errs["text_encoders"] = max(rel(ctx, ref_ctx), rel(pool, ref_pool))
        added = {"time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2), "text_embeds": ref_pool}
        ref = cpu["unet"](x, t, ref_ctx, None, added)
        out = gpu["unet"](x.cuda(), t.cuda(), ref_ctx.cuda(), None, {k: v.cuda() for k, v in added.items()})
        errs["unet"] = rel(out, ref)
        errs["vae_decode"] = rel(gpu["vae"].decode(x.cuda()), cpu["vae"].decode(x))
    # bf16 weights and activations through a few dozen layers
    tol = 5e-2
    log(f"  card bf16 vs CPU fp32 plain, relative to the output's max: {errs} (tol {tol})")
    for name, err in errs.items():
        if not err <= tol:
            failures.append(f"{name}: card vs CPU reference rel err {err} > {tol}")
    return errs


def check_forward_route(counts, phase, failures):
    """Every flash forward of a path ran the Hopper kernel (all its
    attentions have head dim 64) and none the mma.sync one."""
    if counts["flash_fwd_mma"] != 0 or counts["flash_fwd_sm90"] != counts["flash_fwd"] or counts["flash_fwd"] == 0:
        failures.append(f"{phase}: flash forward launches sm90 {counts['flash_fwd_sm90']},"
                        f" mma {counts['flash_fwd_mma']}; every one should be on flash_fwd_sm90")


def check_backward_route(counts, phase, failures):
    """Every dQ (but K5's) and every dK/dV launch of a training path ran
    the Hopper kernels and none the mma.sync ones."""
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name + "_mma"] != 0 or counts[name + "_sm90"] != counts[name] or counts[name] == 0:
            failures.append(f"{phase}: {name} launches sm90 {counts[name + '_sm90']}, mma {counts[name + '_mma']};"
                            f" every one should be on {name}_sm90")


# ------------------------------------------------------------------ serve


def phase_times(pipe, n):
    """One request batch of n, phase by phase with a sync after each."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.sampling import KDiffusionDenoiser, build_cfg_fn, encode_cfg_inputs

    dev = pipe.device
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode_cfg_inputs(["a phase probe"] * n, [""] * n, RES, RES, pipe.te)
        torch.cuda.synchronize()
        out["encode_s"] = time.perf_counter() - t0
        x = torch.randn((n, RES // 8, RES // 8, 4), device=dev)
        sigma = torch.full((n,), 10.0, device=dev)
        cfg_fn = build_cfg_fn(KDiffusionDenoiser(model_fn=pipe.unet, schedule=pipe.schedule), enc, CFG)
        cfg_fn(x, sigma)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        cfg_fn(x, sigma)
        torch.cuda.synchronize()
        out["unet_step_s"] = time.perf_counter() - t0
        out["launches_per_unet_forward"] = launch_counts()
        t0 = time.perf_counter()
        pipe.vae.decode(x)
        torch.cuda.synchronize()
        out["vae_decode_s"] = time.perf_counter() - t0
    return out


def serve(report, failures):
    from uwudiff_tpu_torch.ops import FORWARD_KERNELS, launch_counts, plan_gn, reset_launch_counts
    from uwudiff_tpu_torch.serving import BatchingServer, Request, sdxl_pipeline

    t0 = time.perf_counter()
    pipe = sdxl_pipeline("cuda", torch.bfloat16, SEED)
    torch.cuda.synchronize()
    report["model_build_s"] = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", pipe.unet), ("text_encoders", pipe.te.module),
                                ("vae_decoder", pipe.vae))}
    report["params"] = n_params
    log(f"  built sdxl unet + clip_l/clip_bigg + sdxl vae in {report['model_build_s']:.1f} s: {n_params}")

    gn_calls: list = []  # the shape of every GroupNorm call of the main run, for the routes plan_gn gives them
    server = BatchingServer(pipe, buckets=[(RES, RES)], max_batch=4, max_wait_s=0.05)
    t0 = time.perf_counter()
    server.start(warmup_steps=1)  # one pass per batch size of the ladder (1, 4)
    torch.cuda.synchronize()
    report["warmup_s"] = time.perf_counter() - t0
    try:
        prompts = ["a lighthouse at dusk, oil painting", "a red fox in snow",
                   "a bowl of ramen, studio photo", "an astronaut riding a horse"]
        seeds = [11, 12, 13, 14]
        torch.cuda.reset_peak_memory_stats()
        hooks = record_gn_calls([pipe.unet, pipe.vae], gn_calls)
        reset_launch_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        futs = [server.submit(Request(prompt=p, num_steps=STEPS, cfg_scale=CFG, seed=s,
                                      width=RES, height=RES)) for p, s in zip(prompts, seeds)]
        batch_imgs = [f.result(timeout=900) for f in futs]
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lone = server.submit(Request(prompt=prompts[1], num_steps=STEPS, cfg_scale=CFG,
                                     seed=seeds[1], width=RES, height=RES)).result(timeout=900)
        lone_s = time.perf_counter() - t0
        counts = launch_counts()  # the main path's run ends here
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        for h in hooks:
            h.remove()
    finally:
        server.stop()

    images = batch_imgs + [lone]
    for i, img in enumerate(images):
        if img.shape != (RES, RES, 3) or img.dtype.name != "uint8":
            failures.append(f"image {i}: shape {img.shape} dtype {img.dtype}")
    for name in FORWARD_KERNELS:
        if counts[name] == 0:
            failures.append(f"kernel {name} was not launched on the serving path")
    check_forward_route(counts, "serve", failures)
    routes = [plan_gn(*shape, torch.bfloat16).route for shape in gn_calls]
    gn_plan = {"gn_silu_fused": routes.count("fused"), "gn_stats": routes.count("chunked"),
               "gn_silu_apply": routes.count("chunked")}
    if any(counts[k] != v for k, v in gn_plan.items()):
        failures.append(f"serve: GroupNorm launches {[counts[k] for k in gn_plan]} against plan_gn's {gn_plan}"
                        f" over {len(gn_calls)} calls")
    img_diff = float(abs(lone.astype(int) - batch_imgs[1].astype(int)).mean())

    # seed-lane isolation on the latents: lane 1 of the batch vs the lone run
    lat_b, _ = pipe.sample_device(prompts, num_steps=STEPS, num_samples=4, cfg_scale=CFG,
                                  width=RES, height=RES, seed=seeds, return_latents=True)
    lat_1, _ = pipe.sample_device(prompts[1], num_steps=STEPS, num_samples=1, cfg_scale=CFG,
                                  width=RES, height=RES, seed=seeds[1], return_latents=True)
    finite = bool(torch.isfinite(lat_b).all()) and bool(torch.isfinite(lat_1).all())
    d_same = (lat_1[0] - lat_b[1]).abs().max().item()
    d_other = (lat_b[0] - lat_b[1]).abs().max().item()
    rms_same = (lat_1[0] - lat_b[1]).pow(2).mean().sqrt().item()
    if not finite:
        failures.append("non-finite latents")
    # bf16 GEMMs may pick other algorithms at another batch size, so equal
    # seeds agree to rounding, far below what another seed changes
    if not d_same < 0.05 * d_other:
        failures.append(f"seed lane not isolated: same-seed diff {d_same} vs other-seed {d_other}")

    report["serve"] = dict(
        steps=STEPS, cfg=CFG, resolution=RES, batch_of_4_s=batch_s, imgs_per_s_batch=4 / batch_s,
        lone_request_latency_s=lone_s, peak_memory_gib=peak_gb, launches=counts, groupnorm_plan=gn_plan,
        lone_vs_lane_mean_abs_pixel_diff=img_diff, latents_same_seed_max_diff=d_same,
        latents_other_seed_max_diff=d_other, latents_same_seed_rms_diff=rms_same,
        latents_std=lat_b.float().std().item(),
    )
    log(f"  batch of 4: {batch_s:.2f} s ({4 / batch_s:.3f} imgs/s); lone request {lone_s:.2f} s;"
        f" peak {peak_gb:.1f} GiB; launches {counts}; GroupNorm routes by plan_gn {gn_plan}")
    log(f"  same seed alone vs in batch: latents max diff {d_same:.3e} (other seed {d_other:.3e});"
        f" mean pixel diff {img_diff:.3f}")
    report["phases"] = {f"batch_{n}": phase_times(pipe, n) for n in (1, 4)}
    log(f"  phases: {json.dumps(report['phases'])}")
    return counts


# ------------------------------------------------------------------ train

TRAIN_STEPS = 5


def plan_launches(unet, gn_calls) -> dict:
    """Each kernel's launches per training step, from the UNet's modules
    and the shapes of the step's GroupNorm calls: one flash forward (the sum
    over both forward kernels) and one dQ/dK-dV pair per attention; per
    GroupNorm call the forward's route by plan_gn (one fused launch, or the
    chunked pair) and the backward's by plan_gn_bwd (one fused launch, or
    K7 and K8; either reads the forward's statistics, so no stats pass)."""
    from uwudiff_tpu_torch.models.transformer import BasicTransformerBlock
    from uwudiff_tpu_torch.ops import plan_gn, plan_gn_bwd

    attn = sum(2 if m.has_cross else 1 for m in unet.modules() if isinstance(m, BasicTransformerBlock))
    fwd = [plan_gn(*shape, torch.bfloat16).route for shape in gn_calls]
    bwd = [plan_gn_bwd(*shape, torch.bfloat16).route for shape in gn_calls]
    return {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "gn_silu_fused": fwd.count("fused"), "gn_stats": fwd.count("chunked"),
            "gn_silu_apply": fwd.count("chunked"), "gn_silu_bwd_fused": bwd.count("fused"),
            "gn_bwd_partials": bwd.count("pair"), "gn_bwd_dx": bwd.count("pair")}


def record_gn_calls(modules, calls):
    """Forward pre-hooks that append (n, hw, c, groups) of every GroupNorm
    call under ``modules`` to ``calls``; returns the hooks."""
    from uwudiff_tpu_torch.models.layers import GroupNorm

    def record(module, args):
        x = args[0]
        c = module.weight.shape[0]
        calls.append((x.shape[0], x.numel() // (x.shape[0] * c), c, module.groups))

    return [m.register_forward_pre_hook(record) for part in modules for m in part.modules()
            if isinstance(m, GroupNorm)]


def train(report, failures):
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.groupnorm_silu import GroupNormSiLUFunction
    from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

    t0 = time.perf_counter()
    trainer, data = build_trainer_and_batch(batch=8, latent=64, seed=SEED)
    trainer.setup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = trainer.device
    batch = {"sample": torch.as_tensor(data["sample"], device=dev), "ctx": torch.as_tensor(data["ctx"], device=dev),
             "pooled": torch.as_tensor(data["pooled"], device=dev),
             "added_cond": {"time_ids": torch.as_tensor(data["added_cond"]["time_ids"], device=dev)}}
    n_params = sum(p.numel() for _, p in trainer.params)
    start = [p.detach().clone() for _, p in trainer.params]
    log(f"  built the sdxl trainer ({n_params / 1e9:.3f} G bf16 params, {len(start)} leaves) in {build_s:.1f} s")

    gn_calls: list = []  # the step's GroupNorm shapes, for the routes plan_gn(_bwd) give them
    hooks = record_gn_calls([trainer.unet], gn_calls)
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    torch.cuda.reset_peak_memory_stats()
    GroupNormSiLUFunction.grad_layout_copies = 0
    reset_launch_counts()  # the main path's run starts here
    steps = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        phases = trainer.step_phase_ms()
        steps.append(dict(step_s=time.perf_counter() - t0, loss=metrics["train/loss"].item(),
                          grad_norm=metrics["train/grad_norm"].item(), lr=metrics["train/lr"], **phases))
    counts = launch_counts()  # the main path's run ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    copies = GroupNormSiLUFunction.grad_layout_copies

    plan = plan_launches(trainer.unet, gn_calls)
    for name, per_step in plan.items():
        if counts[name] != per_step * TRAIN_STEPS:
            failures.append(f"{name}: {counts[name]} launches in {TRAIN_STEPS} steps, plan {per_step} a step")
    check_forward_route(counts, "train", failures)
    check_backward_route(counts, "train", failures)
    losses = [warm["train/loss"].item()] + [s["loss"] for s in steps]
    norms = [warm["train/grad_norm"].item()] + [s["grad_norm"] for s in steps]
    if not all(map(math.isfinite, losses + norms)):
        failures.append(f"non-finite training metrics: losses {losses} grad norms {norms}")
    # every leaf took an update: its momentum is finite and not all zero
    moments_ok = all(bool(torch.isfinite(st["mu"]).all()) and bool(st["mu"].any())
                     for st in trainer.opt_state.leaves)
    if not moments_ok or trainer.opt_state.count != TRAIN_STEPS + 1:
        failures.append(f"optimizer state: moments ok {moments_ok}, count {trainer.opt_state.count}")
    # and moved. Stochastic rounding moves an element by one bf16 step
    # (2^-8 just below 1.0) with probability |update| / step; at lr 1e-5 a
    # norm weight initialised to ones (update ~1e-6 a step) may keep every
    # value for many steps, so only those may stay unchanged; they are listed
    unchanged = [name for (name, p), p0 in zip(trainer.params, start) if torch.equal(p, p0)]
    moved_wrongly = [n for n in unchanged if not (n.endswith("weight") and "norm" in n.rsplit(".", 2)[-2])]
    if moved_wrongly:
        failures.append(f"{len(moved_wrongly)} parameter leaves unchanged after {TRAIN_STEPS + 1} steps:"
                        f" {moved_wrongly[:8]}")
    step_s = sorted(s["step_s"] for s in steps)[TRAIN_STEPS // 2]
    fb_ms = sorted(s["forward_backward_ms"] for s in steps)[TRAIN_STEPS // 2]
    opt_ms = sorted(s["optimizer_ms"] for s in steps)[TRAIN_STEPS // 2]
    report["train"] = dict(
        batch=8, latent=64, params=n_params, leaves=len(start), build_s=build_s, warmup_step_s=warmup_s,
        steps=steps, median_step_s=step_s, imgs_per_s=8 / step_s, median_forward_backward_ms=fb_ms,
        median_optimizer_ms=opt_ms, peak_memory_gib=peak_gib, launches=counts, plan_per_step=plan,
        gn_shapes=sorted(set(gn_calls)),
        gn_grad_layout_copies=copies, unchanged_leaves=unchanged, losses=losses, grad_norms=norms)
    log(f"  train: step {step_s:.3f} s ({8 / step_s:.2f} imgs/s), forward+backward {fb_ms:.1f} ms,"
        f" optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB; losses {[round(v, 4) for v in losses]},"
        f" grad norms {[round(v, 3) for v in norms]}; launches/step {plan}; GN grad copies {copies};"
        f" leaves unchanged {len(unchanged)} of {len(start)}, all unit-initialised norm weights:"
        f" {not moved_wrongly}")
    return counts


# --------------------------------------------------------------------- ti

TI_STEPS = 5


def plan_ti_launches(trainer) -> dict:
    """Each kernel's launches per textual-inversion step, from the modules:
    every attention (CLIP layers, MMDiT blocks, T5 layers) runs one flash
    forward, one dQ and one dK/dV pass. T5's learned bias is frozen here, so
    its dQ pass is K4 and K5 is not launched. The flash forward is the sum
    over both forward kernels. No GroupNorm on this path."""
    from uwudiff_tpu_torch.models.clip import _CLIPLayer
    from uwudiff_tpu_torch.models.mmdit import MMDiTBlock
    from uwudiff_tpu_torch.models.t5 import _T5Layer

    modules = list(trainer.te.modules()) + list(trainer.unet.modules())
    plain = sum(isinstance(m, (_CLIPLayer, MMDiTBlock)) for m in modules)
    t5 = sum(isinstance(m, _T5Layer) for m in modules)
    return {"flash_fwd": plain + t5, "flash_bwd_dq": plain + t5, "flash_bwd_dq_dbias": 0,
            "flash_bwd_dkv": plain + t5, "gn_silu_fused": 0, "gn_stats": 0, "gn_silu_apply": 0,
            "gn_silu_bwd_fused": 0, "gn_bwd_partials": 0, "gn_bwd_dx": 0}


def ti(report, failures):
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import build_ti_trainer_and_batch

    t0 = time.perf_counter()
    trainer, data = build_ti_trainer_and_batch(batch=8, latent=64, seed=SEED)
    trainer.setup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = trainer.device
    batch = {"latent": torch.as_tensor(data["latent"], device=dev),
             "tokenizer_outputs": [{k: torch.as_tensor(v, device=dev) for k, v in t.items()}
                                   for t in data["tokenizer_outputs"]]}
    frozen = [(f"{m}.{n}", p) for m in ("unet", "te") for n, p in getattr(trainer, m).named_parameters()]
    n_frozen = {m: sum(p.numel() for p in getattr(trainer, m).parameters()) for m in ("unet", "te")}
    n_frozen["te_models"] = [sum(p.numel() for p in getattr(trainer.te, n).parameters())
                             for n in trainer.te.model_names]

    def checksums():  # one fp64 sum per frozen leaf
        return torch.stack([torch.sum(p.detach(), dtype=torch.float64) for _, p in frozen]).cpu()

    sums0 = checksums()
    rows0 = [p.detach().clone() for _, p in trainer.params]
    log(f"  built sd3_medium + clip_l + clip_bigg + t5_xxl in {build_s:.1f} s: frozen params {n_frozen},"
        f" {len(frozen)} leaves; trainable {[tuple(p.shape) for _, p in trainer.params]}")
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the main path's run starts here
    steps = []
    for _ in range(TI_STEPS):
        t0 = time.perf_counter()
        metrics, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        phases = trainer.step_phase_ms()
        steps.append(dict(step_s=time.perf_counter() - t0, loss=metrics["train/loss"].item(),
                          grad_norm=metrics["train/grad_norm"].item(), lr=metrics["train/lr"], **phases))
    counts = launch_counts()  # the main path's run ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    plan = plan_ti_launches(trainer)
    for name, per_step in plan.items():
        if counts[name] != per_step * TI_STEPS:
            failures.append(f"ti {name}: {counts[name]} launches in {TI_STEPS} steps, plan {per_step} a step")
    check_forward_route(counts, "ti", failures)
    check_backward_route(counts, "ti", failures)
    losses = [warm["train/loss"].item()] + [s["loss"] for s in steps]
    norms = [warm["train/grad_norm"].item()] + [s["grad_norm"] for s in steps]
    if not all(map(math.isfinite, losses + norms)) or not all(n > 0 for n in norms):
        failures.append(f"ti metrics: losses {losses} grad norms {norms} (finite, norms > 0)")
    moved = [not torch.equal(p, p0) for (_, p), p0 in zip(trainer.params, rows0)]
    if not all(moved):
        failures.append(f"ti rows unchanged: {[n for (n, _), m in zip(trainer.params, moved) if not m]}")
    changed = [name for (name, _), a, b in zip(frozen, sums0, checksums()) if not torch.equal(a, b)]
    if changed:
        failures.append(f"ti frozen leaves changed: {changed[:8]}")
    step_s = sorted(s["step_s"] for s in steps)[TI_STEPS // 2]
    fb_ms = sorted(s["forward_backward_ms"] for s in steps)[TI_STEPS // 2]
    opt_ms = sorted(s["optimizer_ms"] for s in steps)[TI_STEPS // 2]
    ctx_len = sum(t["input_ids"].shape[1] for t in data["tokenizer_outputs"][1:])
    report["ti"] = dict(
        batch=8, latent=64, context_tokens=ctx_len, joint_tokens=ctx_len + (64 // 2) ** 2, params=n_frozen,
        frozen_leaves=len(frozen), build_s=build_s, warmup_step_s=warmup_s, steps=steps, median_step_s=step_s,
        imgs_per_s=8 / step_s, median_forward_backward_ms=fb_ms, median_optimizer_ms=opt_ms,
        peak_memory_gib=peak_gib, launches=counts, plan_per_step=plan, losses=losses, grad_norms=norms,
        rows_moved=moved, frozen_changed=changed)
    log(f"  ti ({report['card']}): step {step_s:.3f} s ({8 / step_s:.2f} imgs/s),"
        f" forward+backward {fb_ms:.1f} ms,"
        f" optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB; losses {[round(v, 4) for v in losses]},"
        f" grad norms {[float(f'{v:.3g}') for v in norms]}; launches/step {plan}; rows moved {moved};"
        f" frozen leaves changed {len(changed)} of {len(frozen)}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import uwudiff_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from uwudiff_tpu_torch.ops._build import build_all
    from uwudiff_tpu_torch.utils import resolve_device

    resolve_device("cuda")  # also sets the TF32 switches off
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    global SM_CLOCK_HZ
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    SM_CLOCK_HZ = float(clock) * 1e6
    report = {"card": smi, "sm_clock_max_mhz": float(clock), "torch": torch.__version__, "cuda": torch.version.cuda}
    failures: list[str] = []

    log("[1/5] build")
    built = build_all()
    report["build_s"] = built["seconds"]
    log(f"  built in {built['seconds']:.1f} s")
    for src, text in built["logs"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:  # C75xx: wgmma serialised
                log(f"  {src}: {line.strip()}")

    log("[2/5] kernels vs plain (bf16)")
    results: list[dict] = []
    check_flash(results, failures)
    check_gn(results, failures)
    check_flash_bwd(results, failures)
    check_flash_dbias(results, failures)
    check_gn_bwd(results, failures)
    report["kernel_checks"] = results
    report["models_vs_cpu_rel_err"] = check_models_vs_cpu(failures)
    report["train_step_vs_cpu"] = check_train_vs_cpu(failures)
    report["ti_step_vs_cpu"] = check_ti_vs_cpu(failures)

    log("[3/5] serve SDXL 1024x1024")
    serve_counts = serve(report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # the serving stack is gone before the trainer is built

    log("[4/5] train SDXL (full fine-tune, batch 8, 64x64 latents)")
    counts = train(report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the SDXL trainer before the SD3 one

    log("[5/5] textual inversion SD3-medium + CLIP-L + CLIP-bigG + T5-XXL (batch 8, 64x64x16 latents)")
    ti_counts = ti(report, failures)

    main_case = {"flash_fwd_sm90": "sdxl_l1_self", "flash_fwd_mma": "sd15_d40",
                 "flash_bwd_dq_sm90": "train_l1_self", "flash_bwd_dkv_sm90": "train_l1_self",
                 "flash_bwd_dq_mma": "sd15_d40", "flash_bwd_dkv_mma": "sd15_d40",
                 "flash_bwd_dq_dbias": "t5_xxl", "gn_silu_fused": "8x4096x320", "gn_stats": "8x16384x960",
                 "gn_silu_apply": "8x16384x960", "gn_silu_bwd_fused": "8x4096x320", "gn_bwd_partials": "8x4096x960",
                 "gn_bwd_dx": "8x4096x960"}
    csrc = "uwudiff_tpu_torch/csrc/"
    source = {"flash_fwd_sm90": csrc + "flash_fwd_sm90.cu", "flash_fwd_mma": csrc + "flash_fwd.cu",
              "flash_bwd_dq_sm90": csrc + "flash_bwd_sm90.cu", "flash_bwd_dkv_sm90": csrc + "flash_bwd_sm90.cu",
              "flash_bwd_dq_mma": csrc + "flash_bwd.cu", "flash_bwd_dkv_mma": csrc + "flash_bwd.cu",
              "flash_bwd_dq_dbias": csrc + "flash_bwd.cu", "gn_silu_fused": csrc + "groupnorm_silu_sm90.cu",
              "gn_silu_bwd_fused": csrc + "groupnorm_silu_bwd_sm90.cu"}
    replaces = {"flash_fwd_sm90": "uwudiff_tpu/ops/flash_attention.py:152",
                "flash_fwd_mma": "uwudiff_tpu/ops/flash_attention.py:152",
                "flash_bwd_dq_sm90": "uwudiff_tpu/ops/flash_attention.py:271",
                "flash_bwd_dq_mma": "uwudiff_tpu/ops/flash_attention.py:271",
                "flash_bwd_dq_dbias": "uwudiff_tpu/ops/flash_attention.py:312",
                "flash_bwd_dkv_sm90": "uwudiff_tpu/ops/flash_attention.py:365",
                "flash_bwd_dkv_mma": "uwudiff_tpu/ops/flash_attention.py:365",
                "gn_silu_fused": "uwudiff_tpu/ops/groupnorm_silu.py:118",
                "gn_stats": "uwudiff_tpu/ops/groupnorm_silu.py:171",
                "gn_silu_apply": "uwudiff_tpu/ops/groupnorm_silu.py:240",
                "gn_silu_bwd_fused": "uwudiff_tpu/ops/groupnorm_silu.py:321,349",
                "gn_bwd_partials": "uwudiff_tpu/ops/groupnorm_silu.py:321",
                "gn_bwd_dx": "uwudiff_tpu/ops/groupnorm_silu.py:349"}
    path_counts = {"flash_bwd_dq_dbias": ti_counts, "gn_stats": serve_counts, "gn_silu_apply": serve_counts}
    kernels = []
    for name, case in main_case.items():
        row = next(r for r in results if r["kernel"] == name and r["case"] == case)
        kernels.append(dict(
            name=name, route="cuda", source=source.get(name, csrc + "groupnorm_silu.cu"),
            replaces=replaces[name],
            # the count of the run whose path this row's shape is from: K5's is
            # the textual-inversion step's (0: no path trains an attention bias),
            # the chunked GroupNorm pair's the served batch's, the others' the
            # SDXL training step's
            launches=path_counts.get(name, counts)[name],
            max_abs_err=max(r["max_abs_err"] for r in results if r["kernel"] == name),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], device_ms=row.get("device_ms", row.get("kernel_device_ms")),
            shape=row["shape"],
            serving_launches=serve_counts[name],
            train_launches=counts[name], ti_launches=ti_counts[name],
        ))
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failures:
        for msg in failures:
            log(f"FAIL: {msg}")
        return 1
    log(f"total {report['total_s']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
