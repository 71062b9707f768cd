#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uwudiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every hand-written kernel (csrc/*.cu, nvcc, sm_90a)
  2. kernels - each kernel against its plain PyTorch version on the card,
               in bf16: the forward and backward kernels at the serving,
               training and textual-inversion paths' shapes (CLIP-L/bigG,
               the UNet's cross-attention over 2 and 4 prompt windows and
               bigG over a batch of 8 prompts' 4 windows,
               T5-XXL at 256 and at Flux's 512 tokens, the MMDiT's joint
               attention, and SD3-medium's at 1024^2: [8,4429,4429,24,64]
               for CFG over 4 requests and [4,4429,...] for the skip-layer
               pass, with the T5 key mask) and at every attention
               shape of the SD1.5 step (batch 16; head dims 40/80/160: the
               Hopper forward, timed beside the mma.sync one it replaced on
               the path, and at 160 the Hopper dQ and dK/dV beside the
               mma.sync pair they replaced) and at flux_dev's joint
               attention (D = 128 with the T5 mask: 1024^2 alone and in a
               batch of 4, 512^2; D = 128 with no bias at 512^2 and with a
               key bias at a ragged shape) and at the flux_1b training
               step's ([8,1101,1101,12,128]: the forward, and the Hopper dQ
               and dK/dV with no bias and with a T5 key mask, and ragged
               with a key bias), and at DiT-XL/2's D = 72 (CFG over 8
               labels at 256^2, a lone 512^2 request, the dit_xl_2
               training step's [64,256,256,16,72], ragged with a key
               bias: the forward, dQ and dK/dV), each twice for bitwise
               reproducibility, the dQ + dBias kernel at T5-XXL's and at
               D = 160 and 128; ptxas's registers and spills of every
               instance (a spill at D = 128 or 72 fails the run); every
               GroupNorm shape on the route plan_gn gives it (the fused
               single-pass kernel or the chunked stats + apply pair), with
               wall and device ms beside F.group_norm+F.silu, and the
               training path's GroupNorm backward (and a 1024^2 one) on the
               route plan_gn_bwd gives it (the fused single-pass kernel or
               K7 + K8), beside F.group_norm+F.silu's backward; the
               Hopper forward (D = 64, 40 and 72) and backward (D = 64,
               40, 160 and 72) also on
               strided head views of one fused tensor, and raising on a view
               TMA cannot take; the Hopper backward reading CLIP's broadcast
               bias in place; median ms of the kernel, the plain version and one
               library call, the profiler's device time, the card's lower
               bound for the same work (the larger of the bytes, the tensor
               operations and, for the forward, the softmax's exp2 on the
               SFU and the FMA pipe; the SFU-only floor beside it). The fused
               parameter update (adamw_factored, csrc/adamw_factored.cu)
               against its plain version at SDXL leaf shapes, three steps
               with and without the global-norm clip, the weight EMA on,
               drawn and given rounding bits, two runs bitwise. Then
               small SDXL-, SD1.5- and SD3-shaped models, bf16 on the card
               through the kernels, against the same weights in fp32 on the
               CPU: forwards, one SDXL training step's loss and gradients,
               one SD1.5-recipe step's (fp32 masters under bf16 compute,
               head dims 40/80/160, adamw_fp16), one textual-inversion
               step's loss and row gradients, and one step of a 1 + 1
               block Flux at flux_1b's width (12 heads of 128, blocks
               recomputed in the backward; bf16 params) against fp32 on the
               CPU, without and with a T5 key mask: the loss and every
               leaf's gradient
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
               flash forward, dQ and dK/dV on the Hopper kernels, and
               the parameter update's kernels as plan_optimizer says (4 a
               step, whatever the leaf count). Then, over the step's
               1,680 leaves, each update kernel's time against its byte
               bound, the plain update's and torch.optim.AdamW(fused=True)'s
               (another function, for scale).
  5. sd15    - the SD1.5 full fine-tune step at full width
               (training/bench_setup.py, model="sd15": batch 16, 64x64
               latents, fp32 masters under bf16 compute, adamw_fp16, global
               clip 1.0): one warm-up step and 5 timed steps. Checks finite
               and moving losses, that every master moved and the module
               holds their bf16 rounding, each step's launches against the
               UNet's plan (every flash forward, dQ and dK/dV on the Hopper
               kernels, none on the mma.sync ones, split by head dim as the
               modules say: 10, 10 and 12 of each at D = 40, 80 and 160; the
               update as adamw_norm + adamw_fp16_apply). Then
               the update over the step's 686 leaves against its plain
               version, bitwise, with and without the clip, and each O2
               kernel's time against its byte bound.
  6. ti      - SD3-medium textual inversion at full width
               (training/bench_setup.py: MMDiT + CLIP-L + CLIP-bigG +
               T5-XXL at 256 tokens, batch 8, 64x64x16 latents, bf16
               frozen weights, two placeholder vectors per encoder): one
               warm-up step and 5 timed steps. Checks finite losses,
               non-zero grad norms, that every row table moved, that no
               frozen leaf changed (per-leaf fp64 checksums) and each
               step's launches against the plan from the modules (K4 in
               every T5 layer, whose learned bias is frozen here, so no K5;
               every flash forward, dQ and dK/dV on the Hopper kernels).
  7. flux    - Flux txt2img at flux_dev's full width and depth (19 double
               and 38 single blocks, 24 heads of 128; random bf16 weights,
               the zero-initialised leaves drawn) with CLIP-L pooled-only,
               T5-XXL at 512 tokens with its key mask and the 16-channel
               decoder, through sampling.diffusion_sampling (RFDenoiser,
               cfg 1, the dynamic-shift RF ladder, Euler-ancestral):
               first a 2 + 2 block Flux at that width on the card against
               the same weights on the CPU, then a lone 1024x1024 request
               and a batch of 4, 4 steps each. Checks that each run launched
               flash_fwd_sm90 57 x 4 times at D = 128 and every flash
               forward on it, the images (1024x1024 uint8, not constant),
               finite latents, each new GroupNorm call of the decode; prints
               per-step ms, the encode / step / decode phases, the card's
               busy share over a step and the peak GiB.
  8. train_flux - bench.py's flux_1b full fine-tune step at full width
               (training/bench_setup.py, model="flux_1b": 6 double and 12
               single blocks at width 1536, 12 heads of 128, every block
               recomputed in the backward, batch 8, 64x64x16 latents, 77
               tokens of 4096-wide context, bf16 params with stochastic
               rounding, adamw_factored): one warm-up step and 5 timed
               steps. Checks finite and moving losses, non-zero grad norms,
               that every parameter took an update, and each step's
               launches: 36 flash forwards (18 and 18 recomputed), 18 dQ and
               18 dK/dV, all at D = 128 on the Hopper kernels, and the
               update's kernels as plan_optimizer says; prints the step's
               ms split into forward+backward and optimizer, the peak GiB
               and the card's busy share over a traced step.
  9. sampling - SDXL at full width (random bf16 weights, the VAE with its
               encoder): first img2img on a small SDXL-layout stack, card
               bf16 against CPU fp32 (DPM++ 2M, injected draws); then (a)
               each of the 12 samplers of sampling/ through
               Txt2ImgPipeline(sampler=...).sample_device (the served
               path), 1024x1024, batch 2, 6 steps on
               the Karras ladder (LCM: LCMDenoiser, cfg 1, 4 steps on
               get_sigmas_lcm), each run's UNet calls held to the count its
               gates give and its K1 launches to 140 a call plus the text
               encoders' 44, all at D = 64; (b) img2img, a batch of 4
               synthetic 1024x1024 images from the seed through the VAE
               encoder, DPM++ 2M SDE on Karras, 12 of 20 steps, decoded:
               encode / sample / decode seconds, peak GiB, the launches and
               the GroupNorm routes by plan_gn; then inpainting of the
               right half, the kept half bitwise the init latents; (c)
               tiled decode (64 latents, overlap 16) and encode (512
               pixels, overlap 128) against untiled: time, peak above the
               weights, the largest difference, one tile bitwise the
               untiled call; (d) inversion image -> noise -> image
               (euler_latent_sampling, 10 steps each way); (f) each
               GroupNorm call of (b) and (c) phase 2 did not hold.
 10. dit     - DiT-XL/2 class-conditional sampling at full width (28
               blocks, 16 heads of 72; random bf16 weights, the
               zero-initialised leaves drawn) with the sd15 VAE, through
               sampling.class_conditional_sampling: first a 2-block DiT at
               that width on the card against the same weights on the CPU,
               then 8 labels at 256x256 (CFG 4.0 over [labels, null],
               Euler-ancestral, 16 steps), a lone label at 256x256 and a
               lone 512x512 request. Checks each run's model calls (one a
               step on the doubled batch) and 28 K1 launches a call, all at
               D = 72 on flash_fwd_sm90, the images (uint8, not constant),
               finite latents, each new GroupNorm call of the decode;
               prints per-step ms, the runs' seconds, peak GiB and the
               card's busy share over a step.
 11. train_dit - bench.py's dit_xl_2 training step at full width
               (training/bench_setup.py, model="dit_xl_2": batch 64, 32x32x4
               latents, class labels with dropout 0.1, fp32 masters under
               bf16 compute, adamw, global clip 1.0): first one step of a
               2-block DiT at that width on the card against fp32 on the
               CPU (the loss and every leaf's gradient), then one warm-up
               step and 5 timed steps. Checks finite and moving losses,
               non-zero grad norms, that every master moved and the module
               holds their bf16 rounding, and each step's launches: 28 K1,
               28 K4 and 28 K6, all at D = 72 on the Hopper kernels, and no
               other kernel; prints the step's ms split into
               forward+backward and optimizer, the peak GiB and the busy
               share.
 12. checkpoint - SDXL served from one single-file checkpoint: first a
               small SDXL-layout stack written as one fp32 file, loaded
               through loader.apply_load_config on the card (bf16) and on
               the CPU (fp32), a weighted 4-window prompt through 3 CFG
               Euler-ancestral steps with the draws given (tolerance 5e-2);
               then the full-width stack's random bf16 weights rounded
               through fp16, exported (export_params, diffusers_to_ldm,
               OpenCLIP naming for bigG) into one fp16 .safetensors in the
               checkout (removed after), CLIP-size vocab.json/merges.txt
               from the seed, sdxl_pipeline(ckpt_path=, tokenizer_files=).
               Checks every file key consumed, every leaf bitwise the
               rounded source, a plain request's latents bitwise the source
               stack's, the weighted context against the weights applied by
               hand, a long prompt's pooled vector against its first
               window's, and a burst of two weighted, two long (2 and 4+
               windows) and one plain request through
               BatchingServer(max_batch=4) at 1024x1024: one group per
               (prompt_weighting, long_prompt), 44 + 140 x 4 K1 launches a
               group at D = 64, uint8 images that are not constant; prints
               the write, read, name-mapping and copy seconds, each group's
               encode / sample / decode seconds, the BPE host ms and the
               peak GiB.
 13. sd3     - SD3-medium served from its component files: first a small
               SD3 stack (4 MMDiT blocks, 2-layer CLIP-L/bigG/T5-XXL, full
               widths) through skip-layer guidance, card bf16 against CPU
               fp32 (draws given, tolerance 5e-2); then the full-width
               sd3_pipeline's random bf16 weights rounded through fp16,
               each component exported (export_params and its map) into a
               diffusers-layout fp16 .safetensors in the checkout (removed
               after), CLIP-size vocab files and a SentencePiece model of
               T5's 32,100 pieces from the seed,
               sd3_pipeline(component_files=, tokenizer_files=). Checks
               every key consumed and every leaf bitwise, T5's prompts at
               256 tokens; a burst of 4 through BatchingServer(max_batch=4)
               at 1024x1024 (8 steps, CFG 5, one group of 8 CFG rows, 68 +
               24 x 8 K1 launches, uint8 images not constant); a lone
               request with skip-layer guidance (blocks 7-9 skipped, scale
               2.5, over the first 20 % of the steps: 68 + 45 x 8 K1
               launches), the same plain and with slg_scale 0 (bitwise the
               plain latents); then flux_dev's width at 2 + 2 blocks read
               from files (its transformer's, and SD3's CLIP-L, T5-XXL and
               VAE files): every leaf bitwise, one 4-step 1024x1024 request
               (16 K1 launches at D = 128). Prints the write, read,
               name-mapping and copy seconds, the group's encode / sample /
               decode seconds, T5's SentencePiece host ms and the peak GiB.
 14. adapters - SDXL served with hot-swapped adapters and int8 weights:
               first the small SDXL-layout UNet with adapter "a" merged and
               int8 weights, card bf16 against CPU fp32 (tolerance 5e-2);
               then the full-width sdxl_pipeline with adapter "a" (the
               LyCORIS preset configs/lycoris/sdxl-adapters.toml: LoKr on
               attention and feed-forward, LoRA elsewhere) and "b" (a rank-32
               LoRA on every kohya-addressable Linear, written as a kohya
               .safetensors in the checkout, removed after, and read back
               bitwise), each zero factor redrawn so the delta is real.
               Swaps to "a", "b", ["a", "b"], None and "a": each touched
               weight bitwise the adapters' merge of the base on the card,
               every other the base, None every weight, no tensor moved (its
               data_ptr); "a" again writes nothing, an adapter object
               re-merges; each swap timed (CUDA events, median of 3). A burst
               of two base requests, two with "a", one with "b", one with
               ("a", "b") and one with an unknown adapter through
               BatchingServer(max_batch=4) at 1024x1024 (4 Euler-a steps, CFG
               5): one group per adapter key, 44 + 140 x 4 K1 launches each,
               only the unknown one's future failing. A lone request plain,
               with "b" and in int8 (median of 3, peak GiB), and one UNet
               call of 2 CFG rows, bf16 against int8 (ms, device kernels).
               Then sdxl_pipeline(quantize_weights=True): the int8 bytes,
               the card memory held after construction against the bf16
               pipeline's, a request's latents against bf16 (mean |diff| over
               mean |bf16| < 0.15), swaps to "b" and ["a", "b"] bitwise
               quantize_tree of the merge, None restoring every tensor,
               no tensor moved, each swap timed.
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
import re
import subprocess
import sys
import time

import numpy as np
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
EXP2_FMA_OPS = 6  # FP32-pipe operations of one exp2 off the SFU (exp2_fma: 3 FADD, 3 FFMA)
SOFTMAX_FMA_OPS = 2  # the softmax's own a query-key pair: the exponent's FFMA, the row sum's FADD
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


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: no call that is traced launches it


def traced_device_events(fn, reps, cpu=False):
    """The device events (kernels, copies) of ``reps`` calls of ``fn`` from
    one torch.profiler session: ``reps`` calls that warm the session up, a
    marker kernel (MARKER) between two synchronisations, then the ``reps``
    calls whose events (those that start after the marker ends) are
    returned. A session can drop its first kernels (a trace of ten one-kernel
    calls held seven to nine of them, fresh or after a scheduled warm-up
    step, on an H100); the warm-up half takes that loss. [] if the marker
    was lost. With ``cpu`` the host's activity is traced too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda ev: ev.time_range.start)
    marks = [ev.time_range.end for ev in events if MARKER in ev.name]
    return [ev for ev in events if ev.time_range.start >= marks[-1]] if marks else []


def whole_trace(fn, reps, tries=8, cpu=False):
    """The device events of ``reps`` calls of ``fn`` (traced_device_events)
    from the first of ``tries`` traces in which every kernel and copy
    appears a multiple of ``reps`` times: each call puts the same work on
    the device, so a trace that dropped launches fails that. None if no
    trace did."""
    from collections import Counter

    for _ in range(tries):
        events = traced_device_events(fn, reps, cpu)
        counts = Counter(ev.name for ev in events)
        if counts and all(n % reps == 0 for n in counts.values()):
            return events
    return None


UNMEASURED: list[str] = []  # the device readings no whole trace gave, for the report


def profiled_ms(fn, family=None, reps=10, per_launch=False):
    """Device time of one call over ``reps`` calls (whole_trace): (the
    kernels of ``family``, as profile_serving names them; every other
    kernel or copy the call puts on the device), or with no ``family`` the
    sum of every kernel and copy. With ``per_launch`` the family's time is
    the mean of its launches (for a call that launches one kernel). A
    reading no whole trace gave is None (not measured; its CUDA-event time
    stands beside it), and so is a family the trace does not hold."""
    from uwudiff_tpu_torch.profile_serving import _family

    fn()
    torch.cuda.synchronize()
    events = whole_trace(fn, reps, cpu=True)
    if events is None:
        UNMEASURED.append(family or getattr(fn, "__name__", "call"))
        log(f"  (no whole trace of {family or 'the call'} in 8 tries: its device time is not measured)")
        return None if family is None else (None, None)
    mine = other = 0.0
    caught = 0
    for ev in events:
        if family is not None and _family(ev.name) == family:
            mine += ev.time_range.elapsed_us() / 1e3
            caught += 1
        else:
            other += ev.time_range.elapsed_us() / 1e3
    if family is None:
        return other / reps if other > 0 else None
    if caught == 0:
        UNMEASURED.append(family)
        log(f"  (a whole trace held no {family} kernel: its device time is not measured)")
        return None, other / reps
    return mine / (caught if per_launch else reps), other / reps


def share(bound_ms, dev_ms):
    """The share of its bound, in %, that a device reading implies ("n/a"
    where the reading is missing)."""
    return "n/a" if dev_ms is None else f"{100 * bound_ms / dev_ms:.0f} %"


def add(*readings):
    """The sum of device readings, None where one is missing."""
    return None if any(r is None for r in readings) else sum(readings)


def _ms(t):
    return "n/a" if t is None else f"{t:.4f}"


def check_device_readings(rows, failures):
    """Every device reading of ``rows`` (``device_ms``, else
    ``kernel_device_ms``) at or above its ``bound_ms``: a reading under the
    least time the card could take (a share of the bound above 100 %)
    comes from a trace that missed launches, and fails the run."""
    for row in rows:
        dev = row.get("device_ms", row.get("kernel_device_ms"))
        bound_ms = row.get("bound_ms")
        if isinstance(dev, (int, float)) and isinstance(bound_ms, (int, float)) and dev < bound_ms:
            failures.append(f"{row.get('name', row.get('kernel'))} {row.get('case')}: device reading {dev} ms under"
                            f" its bound {bound_ms} ms ({100 * bound_ms / dev:.0f} % of the bound)")


def sfu_floor_ms(b, h, sq, sk):
    """The time of one exp2 per query-key pair with every one on the SFU, at
    its rate over every SM at the card's maximum SM clock: a diagnostic,
    not a bound (exp2 can run on the FMA pipe too, as exp2_fma does)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * sq * sk / (EXP2_PER_CLOCK * sms * SM_CLOCK_HZ) * 1e3


def exp_floor_ms(b, h, sq, sk):
    """The least time of the flash forward's softmax: one exp2 per
    query-key pair, a share x of them on the FMA pipe (EXP2_FMA_OPS each,
    as exp2_fma) and the rest on the SFU, beside the softmax's own
    SOFTMAX_FMA_OPS a pair on the FMA pipe (fp32 operations at PEAK_FP32 /
    2 a second), with x chosen so that both pipes finish together.
    Computed, not measured."""
    sfu = EXP2_PER_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * SM_CLOCK_HZ
    fma = PEAK_FP32 / 2
    # (1 - x) / sfu = (SOFTMAX_FMA_OPS + EXP2_FMA_OPS * x) / fma
    x = min(max((fma - SOFTMAX_FMA_OPS * sfu) / (fma + EXP2_FMA_OPS * sfu), 0.0), 1.0)
    return b * h * sq * sk * max((1 - x) / sfu, (SOFTMAX_FMA_OPS + EXP2_FMA_OPS * x) / fma) * 1e3


def kernel_instance(line):
    """A kernel's name and template arguments from ptxas's "Compiling entry
    function '<mangled name>'" line: flash_fwd_sm90_kernel<40,0,1> for
    _ZN...21flash_fwd_sm90_kernelILi40ELi0ELb1EEEv... (the name is the
    length-prefixed identifier that ends in _kernel)."""
    for m in re.finditer(r"(\d+)[A-Za-z_]", line):
        name = line[m.start() + len(m.group(1)):m.start() + len(m.group(1)) + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"I((?:L[a-z]\d+E)+)E", line[m.end() - 1 + len(name):])
            return f"{name}<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>" if args else name
    return "?"


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
        # long prompts: cross-attention over 2 and 4 windows of 77 keys (the
        # last key tile partial) and bigG over a batch of 8 prompts' 4 windows
        ("sdxl_l1_cross_154", 8, 4096, 154, 10, 64, "none", None),
        ("sdxl_l1_cross_308", 8, 4096, 308, 10, 64, "none", None),
        ("sdxl_l2_cross_154", 8, 1024, 154, 20, 64, "none", None),
        ("sdxl_l2_cross_308", 8, 1024, 308, 20, 64, "none", None),
        ("clip_bigg_causal_x4", 32, 77, 77, 20, 64, "full", None),
        ("t5_xxl", 8, 256, 256, 64, 64, "t5", 1.0),
        ("t5_xxl_512", 8, 512, 512, 64, 64, "t5", 1.0),  # the Flux stack's T5-XXL at 512 tokens
        ("mmdit_joint", 8, 1357, 1357, 24, 64, "joint", None),
        ("ragged_keymask", 2, 200, 200, 4, 64, "key", None),
    ] + SD3_ATTENTION + SD15_ATTENTION + FLUX_ATTENTION + DIT_ATTENTION


# SD3-medium served at 1024^2 (phase 13): the MMDiT's joint attention over the
# CLIP pair's 77, T5's 256 (masked after each prompt's length: a key bias) and
# 4096 image tokens, CFG over a batch of 4 (8 rows) and the skip-layer pass
# (one row each); its T5-XXL at 256 tokens and CLIP-L are t5_xxl and
# clip_l_causal above
SD3_ATTENTION = [
    ("sd3_joint_cfg4", 8, 4429, 4429, 24, 64, "joint", None),
    ("sd3_joint_skip4", 4, 4429, 4429, 24, 64, "joint", None),
]


# DiT-XL/2's attention (16 heads of 72): CFG over 8 labels at 256^2 (the
# doubled batch of 16 over 256 tokens), a lone 512^2 request (CFG's 2 over
# 1024 tokens), bench.py's dit_xl_2 training step (batch 64 on 32x32
# latents) and a ragged key-bias shape (partial tiles, the key bias)
DIT_ATTENTION = [
    ("dit_cfg8_256", 16, 256, 256, 16, 72, "none", None),
    ("dit_512_b1", 2, 1024, 1024, 16, 72, "none", None),
    ("dit_xl_2_train", 64, 256, 256, 16, 72, "none", None),
    ("ragged_key_d72", 2, 130, 300, 2, 72, "key", None),
]


# flux_dev's joint attention (24 heads of 128) over 512 T5 tokens, masked
# after each prompt's length (a key bias), and the image's tokens: a served
# 1024^2 step alone and in a batch of 4, and a 512^2 request; then the
# D = 128 instance with no bias, a ragged key-bias shape (partial tiles),
# and the flux_1b training step's: 77 text and 1024 image tokens, batch 8,
# no mask (bench.py's batch has none)
FLUX_ATTENTION = [
    ("flux_1024_b1", 1, 4608, 4608, 24, 128, "flux", None),
    ("flux_1024_b4", 4, 4608, 4608, 24, 128, "flux", None),
    ("flux_512_b2", 2, 1536, 1536, 24, 128, "flux", None),
    ("flux_512_b2_nobias", 2, 1536, 1536, 24, 128, "none", None),
    ("ragged_key_d128", 2, 130, 300, 2, 128, "key", None),
    ("flux_1b_train", 8, 1101, 1101, 12, 128, "none", None),  # the flux_1b training step (12 heads of 128)
]


# the SD1.5 training step's attentions at batch 16 and 64x64 latents: each
# level's self- and cross-attention (8 heads). The forward, dQ and dK/dV are
# the Hopper kernels at every one (the mma.sync ones are timed beside them,
# the forward at D = 40/80/160, dQ and dK/dV at 160)
SD15_ATTENTION = [
    (f"sd15_{level}_{kind}", 16, s, s if kind == "self" else 77, 8, d, "none", None)
    for level, s, d in (("l0", 4096, 40), ("l1", 1024, 80), ("l2", 256, 160), ("mid", 64, 160))
    for kind in ("self", "cross")
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
    if kind == "flux":  # [T5's 512 | image]: each prompt's T5 tokens padded after its length
        t5_len = (torch.arange(b, device=dev) * 53) % 512 + 7
        keys = torch.arange(sk, device=dev)[None, :]
        masked = (keys >= t5_len[:, None]) & (keys < 512)
        return torch.where(masked, neg, 0.0)[:, None, None, :]
    if kind == "flux_77":  # [text's 77 | image]: each prompt's T5 tokens padded after its length
        t5_len = (torch.arange(b, device=dev) * 53) % 77 + 7
        keys = torch.arange(sk, device=dev)[None, :]
        masked = (keys >= t5_len[:, None]) & (keys < 77)
        return torch.where(masked, neg, 0.0)[:, None, None, :]
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

    from uwudiff_tpu_torch.ops.flash_attention import (
        MMA_HEAD_DIMS,
        NEG_INF,
        flash_attention_reference,
        flash_fwd_mma,
        forward_kernel,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, b, sq, sk, h, d, kind, scale in flash_cases():
        # the path's kernel (flash_fwd_sm90 at every head dim) and, at SD1.5's
        # head dims, the mma.sync kernel it replaced there, on no path: the
        # yardstick, held to the same checks
        routed = forward_kernel(d)
        kernels = [routed] + ([flash_fwd_mma] if d in MMA_HEAD_DIMS else [])
        q, k, v = (
            torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for s in (sq, sk, sk)
        )
        bias = make_bias(kind, b, h, sq, sk, dev, gen)
        ref, ref_lse = flash_attention_reference(q, k, v, bias, scale)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, bias, scale), reps=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.clamp_min(NEG_INF).to(torch.bfloat16)
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)  # noqa: E731
        library_ms = time_ms(library)
        library_device_ms = profiled_ms(library)
        flops = 4.0 * b * h * sq * sk * d
        nbytes = 2 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4 * b * h * sq + bias_bytes(bias)
        ops_ms = flops / PEAK_BF16 * 1e3
        exp_ms = exp_floor_ms(b, h, sq, sk)
        sfu_ms = sfu_floor_ms(b, h, sq, sk)
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16)
        if exp_ms > bound_ms:  # the softmax's exp2, on the SFU and the FMA pipe, is the longer share of the operations
            bound_ms, bound_by = exp_ms, "operations"
        # out and ref are both rounded to bf16 and may differ by one bf16 step
        # (2**-7 relative at most) per element: the largest error is held to
        # one step of the largest output plus 2**-10 for the P tile's bf16
        # rounding, the RMS error to one step of the RMS output (a lost K/V
        # tile, ~1/n_tiles of every row, exceeds that many times over)
        ref_max = ref.float().abs().max().item()
        ref_rms = ref.float().pow(2).mean().sqrt().item()
        tol, rms_tol, lse_tol = 2.0**-7 * ref_max + 2.0**-10, 2.0**-7 * ref_rms, 1e-3
        for fwd in kernels:
            out, lse = fwd(q, k, v, bias, scale)
            torch.cuda.synchronize()
            out2, lse2 = fwd(q, k, v, bias, scale)
            bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
            del out2, lse2
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
            rms_err = (out.float() - ref.float()).pow(2).mean().sqrt().item()
            ok = finite and bitwise and err <= tol and rms_err <= rms_tol and lse_err <= lse_tol
            ms = time_ms(lambda: fwd(q, k, v, bias, scale))
            row = dict(kernel=fwd.__name__, case=name, shape=[b, sq, sk, h, d], bias=kind, scale=scale,
                       max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, ref_max_abs=ref_max,
                       rms_err=rms_err, rms_tol=rms_tol, bitwise=bitwise, ok=ok, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       ops_ms=ops_ms, exp_ms=exp_ms, sfu_ms=sfu_ms, tflops=flops / ms / 1e9, on_path=fwd is routed)
            # device time alone, from the profiler (the wrapper's bias copy
            # included where it makes one); at the small shapes the host time
            # of a call is most of ms
            row["kernel_device_ms"] = profiled_ms(lambda: fwd(q, k, v, bias, scale))
            row["library_device_ms"] = library_device_ms
            results.append(row)
            log(f"  {fwd.__name__} {name:18s} err {err:.2e} (tol {tol:.1e}) rms {rms_err:.1e} (tol {rms_tol:.1e})"
                f" lse {lse_err:.1e} bitwise {bitwise} {'ok' if ok else 'FAIL'}"
                f" | {ms:.4f} ms ({row['tflops']:.0f} TF/s) plain {plain_ms:.2f} sdpa {library_ms:.4f}"
                f" bound {bound_ms:.3f} ({bound_by}: tensor {ops_ms:.3f}, exp2 {exp_ms:.3f}; SFU alone {sfu_ms:.3f});"
                f" device {_ms(row['kernel_device_ms'])} vs sdpa {_ms(library_device_ms)}")
            if not ok:
                failures.append(f"{fwd.__name__} {name}: err {err} (tol {tol}) rms {rms_err} (tol {rms_tol})"
                                f" lse_err {lse_err} finite {finite} bitwise {bitwise}")
            del out, lse
        del q, k, v, ref, ref_lse, mask
        torch.cuda.empty_cache()
    check_flash_views(failures)


def check_flash_views(failures):
    """The Hopper forward on q/k/v cut as strided head views from one fused
    [B, S, 3, H, D] projection (taken uncopied by TMA; SDXL's level 2 at
    D = 64, SD1.5's level 1 at D = 40, DiT-XL/2's CFG batch at D = 72, rows
    of 144 bytes), and refusing a view TMA cannot take
    (k expanded over heads, stride 0): it raises, it does not copy."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import flash_attention_reference, flash_fwd_sm90

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for shape in ((8, 1024, 3, 10, 64), (16, 1024, 3, 8, 40), (16, 256, 3, 16, 72)):
        qkv = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        q, k, v = qkv.unbind(2)
        ok, err, rms_err, tol = close_enough(flash_fwd_sm90(q, k, v)[0], flash_attention_reference(q, k, v)[0])
        log(f"  flash_fwd_sm90 fused-qkv views {tuple(q.shape)} {tuple(q.stride())}: err {err:.2e} (tol {tol:.1e})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_fwd_sm90 on fused-qkv views {tuple(q.shape)}: err {err} rms {rms_err} (tol {tol})")
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


def gn_fwd_check(x, gamma, beta, groups, eps, silu=True):
    """The forward on the route plan_gn gives x's shape, the fused kernel
    (K2) or the chunked pair (K3 + the apply), against the plain version: y
    within one bf16 step of the largest output + 1e-3, the saved statistics
    within 1e-4 relative, bitwise over two runs. Returns (plan, y, stats,
    err, tol, stats_err, bitwise, ok)."""
    from uwudiff_tpu_torch.ops import gn_silu_apply, gn_silu_fused, gn_stats, plan_gn
    from uwudiff_tpu_torch.ops.groupnorm_silu import gn_stats_reference, group_norm_silu_reference

    plan = plan_gn(*x.shape, groups, x.dtype)
    if plan.route == "fused":
        y, stats = gn_silu_fused(x, gamma, beta, groups, eps, silu, with_stats=True)
        bitwise = torch.equal(y, gn_silu_fused(x, gamma, beta, groups, eps, silu))
    else:
        stats = gn_stats(x, gamma, beta, groups, eps, with_group_stats=True)
        y = gn_silu_apply(x, stats[0], stats[1], silu)
        again = gn_stats(x, gamma, beta, groups, eps, with_group_stats=True)
        bitwise = all(torch.equal(a, b) for a, b in zip(stats, again)) and torch.equal(
            y, gn_silu_apply(x, again[0], again[1], silu))
    torch.cuda.synchronize()
    # scale, mean and inv relative; shift = beta - mean*scale, which cancels, absolute
    ref_stats = gn_stats_reference(x, gamma, beta, groups, eps, with_group_stats=True)
    stats_err = max([((a - r).abs() / r.abs().clamp_min(1e-3)).max().item()
                     for i, (a, r) in enumerate(zip(stats, ref_stats)) if i != 1]
                    + [(stats[1] - ref_stats[1]).abs().max().item()])
    yr = group_norm_silu_reference(x, gamma, beta, groups, eps, silu)
    err = (y.float() - yr.float()).abs().max().item()
    # one bf16 ulp at the largest output, plus fp32 stats noise
    tol = yr.float().abs().max().item() * 2.0**-7 + 1e-3
    ok = bool(torch.isfinite(y).all()) and err <= tol and stats_err <= 1e-4 and bitwise
    return plan, y, stats, err, tol, stats_err, bitwise, ok


def check_gn(results, failures):
    """Every gn_cases() shape on the route plan_gn gives it, held against
    the plain version by gn_fwd_check; wall ms (CUDA events) and the
    profiler's device ms beside F.group_norm+F.silu (and torch.var_mean for
    K3) and the route's bound: 2 passes over x fused, 3 chunked."""
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import gn_silu_apply, gn_silu_fused, gn_stats
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
        plan, y, stats, err, tol, stats_err, bitwise, ok = gn_fwd_check(x, gamma, beta, groups, eps)
        fused = plan.route == "fused"
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
            common.update(pair_ms=ms_stats + ms_apply, pair_device_ms=add(dev_stats, dev_apply))
            results.append(dict(kernel="gn_stats", case=f"{n}x{hw}x{c}", ms=ms_stats, device_ms=dev_stats,
                                plain_ms=plain_stats, library_ms=stats_library_ms,
                                library_device_ms=stats_library_dev,
                                stats_library_computes="torch.var_mean over the groups",
                                bound_ms=sb, bound_by=sby, **common))
            results.append(dict(kernel="gn_silu_apply", case=f"{n}x{hw}x{c}", ms=ms_apply, device_ms=dev_apply,
                                plain_ms=plain_apply, library_ms=None, bound_ms=ab, bound_by=aby,
                                bound_share=None if dev_apply is None else ab / dev_apply, apply_err=apply_err, **common))
            log(f"  gn [{n},{hw},{c}] chunked err {err:.2e} (tol {tol:.1e}) stats {stats_err:.1e}"
                f" bitwise {bitwise} {'ok' if ok else 'FAIL'} | stats {ms_stats:.4f} (device {_ms(dev_stats)})"
                f" apply {ms_apply:.4f} (device {_ms(dev_apply)}, {share(ab, dev_apply)} of its bound)"
                f" vs F.group_norm+silu {library_ms:.4f} (device {_ms(library_dev)}), stats vs var_mean"
                f" {stats_library_ms:.4f}; bound {sb + ab:.4f}; plain {plain_stats + plain_apply:.2f}")
            del x_g
        if not ok:
            failures.append(f"gn {n}x{hw}x{c} {plan.route}: err {err} stats {stats_err} bitwise {bitwise}")
        del x, y
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
    # MMDiT's joint attention), all at D = 64, and the SD1.5, flux_1b and
    # dit_xl_2 steps' at D = 40/80/160, 128 and 72 (with the DiT's serving
    # shapes), all on the Hopper kernels
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
        # the Hopper kernels at SD1.5's D = 40 and 160: ragged with a key
        # bias, and a full bias read in place
        ("ragged_key_d40", 2, 130, 300, 2, 40, "key", None),
        ("full_bias_d40", 8, 77, 77, 8, 40, "full", None),
        ("ragged_key_d160", 2, 130, 300, 2, 160, "key", None),
        ("full_bias_d160", 8, 77, 77, 8, 160, "full", None),
        # Flux's D = 128: the flux_1b step's joint attention, without a mask
        # (bench.py's batch) and with a T5 key mask over its 77 text tokens
        # (demo_training_flux.yaml's need_mask), and ragged with a key bias
        ("flux_1b_train", 8, 1101, 1101, 12, 128, "none", None),
        ("flux_1b_t5_mask", 8, 1101, 1101, 12, 128, "flux_77", None),
        ("ragged_key_d128", 2, 130, 300, 2, 128, "key", None),
    ] + SD15_ATTENTION + DIT_ATTENTION  # SD1.5's head dims 40/80/160, DiT-XL/2's 72


def check_flash_bwd(results, failures):
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import (
        MMA_BWD_HEAD_DIMS,
        NEG_INF,
        backward_kernels,
        flash_attention_backward_reference,
        flash_bwd_dkv_mma,
        flash_bwd_dq_mma,
        flash_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for name, b, sq, sk, h, d, kind, scale in flash_bwd_cases():
        # the path's pair (the _sm90 one at every head dim) and, at D = 160,
        # the mma.sync pair it replaced there, on no path: the yardstick, held
        # to the same checks
        routed = backward_kernels(d)
        pairs = [routed] + ([(flash_bwd_dq_mma, flash_bwd_dkv_mma)] if d in MMA_BWD_HEAD_DIMS else [])
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
                   for s in (sq, sk, sk))
        bias = make_bias(kind, b, h, sq, sk, dev, gen)
        out, lse = flash_fwd(q, k, v, bias, scale)
        dout = torch.randn(out.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        refs = flash_attention_backward_reference(q, k, v, bias, out, lse, dout, scale)[:3]
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
        exp_ms = sfu_floor_ms(b, h, sq, sk)  # each kernel recomputes one exp2 per query-key pair
        for bwd_dq, bwd_dkv in pairs:
            reset_launch_counts()
            dq = bwd_dq(q, k, v, dout, lse, delta, bias, scale)
            dk, dv = bwd_dkv(q, k, v, dout, lse, delta, bias, scale)
            torch.cuda.synchronize()
            counts = launch_counts()
            launched = counts[bwd_dq.__name__] == counts[bwd_dkv.__name__] == 1
            bitwise = (torch.equal(dq, bwd_dq(q, k, v, dout, lse, delta, bias, scale))
                       and all(torch.equal(a, b_) for a, b_ in
                               zip((dk, dv), bwd_dkv(q, k, v, dout, lse, delta, bias, scale))))
            checks = {o: close_enough(g, r) for o, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
            ok = launched and bitwise and all(c[0] for c in checks.values())
            ms_dq = time_ms(lambda: bwd_dq(q, k, v, dout, lse, delta, bias, scale))
            ms_dkv = time_ms(lambda: bwd_dkv(q, k, v, dout, lse, delta, bias, scale))
            dev_dq = profiled_ms(lambda: bwd_dq(q, k, v, dout, lse, delta, bias, scale))
            dev_dkv = profiled_ms(lambda: bwd_dkv(q, k, v, dout, lse, delta, bias, scale))
            for kernel, ms, dev_ms, flops, nbytes, outs in (
                (bwd_dq.__name__, ms_dq, dev_dq, 6.0 * mm, io + 2 * b * sq * h * d, ("dq",)),
                (bwd_dkv.__name__, ms_dkv, dev_dkv, 8.0 * mm, io + 4 * b * sk * h * d, ("dk", "dv")),
            ):
                bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16)
                results.append(dict(
                    kernel=kernel, case=name, shape=[b, sq, sk, h, d], bias=kind, scale=scale, ok=ok,
                    bitwise=bitwise, routed=launched, max_abs_err=max(checks[o][1] for o in outs),
                    rms_err={o: checks[o][2] for o in outs}, tol={o: checks[o][3] for o in outs}, ms=ms,
                    kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                    library_device_ms=library_dev, library_computes="dq, dk and dv (SDPA backward)",
                    pair_ms=ms_dq + ms_dkv, bound_ms=bound_ms, bound_by=bound_by, exp_ms=exp_ms, tflops=flops / ms / 1e9,
                    on_path=(bwd_dq, bwd_dkv) == routed))
            errs = " ".join(f"{o} {c[1]:.1e}/{c[3]:.1e}" for o, c in checks.items())
            log(f"  flash_bwd {name:15s} {errs} bitwise {bitwise} {'ok' if ok else 'FAIL'}"
                f" | {bwd_dq.__name__} {ms_dq:.4f} {bwd_dkv.__name__} {ms_dkv:.4f} ms (pair {ms_dq + ms_dkv:.4f})"
                f" sdpa bwd {library_ms:.4f}; device {_ms(dev_dq)} + {_ms(dev_dkv)} vs sdpa {_ms(library_dev)};"
                f" SFU floor {exp_ms:.4f} each; plain {plain_ms:.2f}")
            if not ok:
                failures.append(f"flash_bwd {name} {bwd_dq.__name__}/{bwd_dkv.__name__}: {checks} bitwise {bitwise}"
                                f" launches {counts}")
            del dq, dk, dv
        del q, k, v, out, lse, dout, refs
        torch.cuda.empty_cache()
    check_flash_bwd_views(failures)


def check_flash_bwd_views(failures):
    """The Hopper backward on q/k/v/dO cut as strided head views (taken
    uncopied by TMA) at D = 64, at SD1.5's D = 40 and 160 and at DiT-XL/2's
    72, refusing a stride-0
    view (it raises, it does not copy), and reading CLIP's [B, 1, Sq, Sk]
    bias in place: the kernels allocate their outputs and nothing else, no
    [B*H, Sq, Sk] copy."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference,
        flash_bwd_dkv_sm90,
        flash_bwd_dq_sm90,
        flash_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for b, s, h, d in ((2, 1024, 8, 40), (2, 256, 8, 160), (16, 256, 16, 72), (8, 1024, 10, 64)):
        qkv = torch.randn((b, s, 4, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        q, k, v, dout = qkv.unbind(2)  # dO as a head view too
        out, lse = flash_fwd(q, k, v)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        got = (flash_bwd_dq_sm90(q, k, v, dout, lse, delta),) + flash_bwd_dkv_sm90(q, k, v, dout, lse, delta)
        refs = flash_attention_backward_reference(q, k, v, None, out, lse, dout)[:3]
        for o, g, r in zip(("dq", "dk", "dv"), got, refs):
            ok, err, rms_err, tol = close_enough(g, r)
            log(f"  flash_bwd_sm90 fused-qkv views D={d} {o} {tuple(q.stride())}: err {err:.2e} (tol {tol:.1e})"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"flash_bwd_sm90 on fused-qkv views, D={d}: {o} err {err} rms {rms_err} (tol {tol})")
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
    # 1/sqrt(d) scale), a ragged case and other head dims (160 at the SD1.5
    # step's level-2 shape, 128 at the flux_1b step's joint attention; no
    # path trains an attention bias there)
    return [("t5_xxl", 8, 256, 64, 64, 1.0), ("ragged", 2, 200, 4, 64, 1.0), ("d80", 2, 256, 8, 80, None),
            ("d160", 16, 256, 8, 160, None), ("d128", 8, 1101, 12, 128, None)]


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
            f" | {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s; kernel alone {_ms(kernel_ms)},"
            f" other device work {_ms(wrapper_other_ms)}) bound {bound_ms:.3f} ({bound_by})"
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


def check_gn_calls(gn_calls, failures, backward) -> list:
    """Each distinct GroupNorm call of a path's run (N, HW, C, groups, SiLU,
    eps) that phase 2 did not hold at those values: on random inputs of its
    shape, the forward by gn_fwd_check and, with ``backward``, the backward
    by gn_bwd_check, on the routes the plans give it, with phase 2's bounds
    and bitwise check. Returns each call's numbers."""
    held_fwd = {(n, hw, c, 32, True, 1e-5) for n, hw, c in gn_cases()}
    held_bwd = {(n, hw, c, 32, silu, 1e-5) for n, hw, c, silu in gn_bwd_cases()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = []
    for call in sorted(set(gn_calls)):
        if call in held_fwd and (not backward or call in held_bwd):
            continue
        n, hw, c, groups, silu, eps = call
        x = (torch.randn((n, hw, c), generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        gamma = (torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0).bfloat16()
        beta = (torch.randn(c, generator=gen, device=dev) * 0.1).bfloat16()
        plan, y, stats, err, tol, stats_err, bitwise, ok = gn_fwd_check(x, gamma, beta, groups, eps, silu)
        row = dict(shape=[n, hw, c], groups=groups, silu=silu, eps=eps, route=plan.route, max_abs_err=err, tol=tol,
                   stats_rel_err=stats_err, bitwise=bitwise)
        line = (f"  gn [{n},{hw},{c}]/{groups} silu={silu} eps={eps:g} {plan.route} err {err:.1e}/{tol:.1e}"
                f" stats {stats_err:.1e}")
        del y
        if backward:
            g = torch.randn((n, hw, c), generator=gen, device=dev).to(torch.bfloat16)
            bplan, checks, b_bitwise, b_out = gn_bwd_check(x, g, (gamma, *stats), silu, groups)
            ok = ok and b_bitwise and all(v[0] for v in checks.values())
            row.update(bwd_route=bplan.route, bwd_errs={o: v[1] for o, v in checks.items()},
                       bwd_tol={o: v[3] for o, v in checks.items()}, bwd_bitwise=b_bitwise)
            line += (f"; bwd {bplan.route} " + " ".join(f"{o} {v[1]:.1e}/{v[3]:.1e}" for o, v in checks.items())
                     + f" bitwise {b_bitwise}")
            del g, b_out
        row["ok"] = ok
        out.append(row)
        log(line + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"gn call {call}: {row}")
        del x, stats
    torch.cuda.empty_cache()
    return out


def device_ops(fn):
    """The names of the device kernels and copies of one call of ``fn``,
    from a whole trace of two (whole_trace); [] if none was."""
    from collections import Counter

    fn()
    torch.cuda.synchronize()
    counts = Counter(ev.name for ev in whole_trace(fn, 2) or [])
    return [name for name, n in counts.items() for _ in range(n // 2)]


def gn_bwd_check(x, g, saved, silu, groups):
    """The backward's kernels on the route plan_gn_bwd gives x's shape, from
    the forward's saved statistics: the fused kernel (one launch) or the
    pair (K7, then K8), against the plain versions (close_enough per output:
    dx, t = (t1, t2) and, for the pair, K8's coefficients; bitwise over two
    runs). Returns (plan, checks, bitwise, outputs of the first run)."""
    from uwudiff_tpu_torch.ops import gn_bwd_dx, gn_bwd_partials, gn_silu_bwd_fused, plan_gn_bwd
    from uwudiff_tpu_torch.ops.groupnorm_silu import (
        gn_bwd_dx_reference,
        gn_bwd_partials_reference,
        gn_silu_bwd_fused_reference,
    )

    plan = plan_gn_bwd(*x.shape, groups, x.dtype)
    dx_ref, t_ref = gn_silu_bwd_fused_reference(x, g, *saved, silu)

    def pair():
        t, coef = gn_bwd_partials(x, g, *saved, silu)
        return gn_bwd_dx(x, g, coef, silu), t, coef

    if plan.route == "fused":
        out = gn_silu_bwd_fused(x, g, *saved, silu)
        again = gn_silu_bwd_fused(x, g, *saved, silu)
        checks = {"dx_kernel": close_enough(out[0], dx_ref), "t": close_enough(out[1], t_ref)}
    else:
        out, again = pair(), pair()
        t_pair, coef_ref = gn_bwd_partials_reference(x, g, *saved, silu)
        checks = {"t": close_enough(out[1], t_pair), "coef": close_enough(out[2], coef_ref),
                  "dx_kernel": close_enough(out[0], gn_bwd_dx_reference(x, g, out[2], silu)),
                  "dx_plain": close_enough(out[0], dx_ref)}
    bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
    torch.cuda.synchronize()
    return plan, checks, bitwise, out


def check_gn_bwd(results, failures):
    """Every gn_bwd_cases() shape held against the plain versions by
    gn_bwd_check, and the whole backward through autograd against autograd
    of the fp32 plain forward (dx, dgamma, dbeta), whose device work is the
    route's kernels, the sum over samples and the two casts to the bf16
    parameters' dtype, nothing else (no glue). Wall ms (CUDA events) and the
    profiler's device ms beside F.group_norm+F.silu's backward and the
    route's bound; on the fused route the pair is timed beside it."""
    import torch.nn.functional as F

    from uwudiff_tpu_torch.ops import gn_bwd_dx, gn_bwd_partials, gn_silu_bwd_fused, group_norm_silu
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
        plan, checks, bitwise, out = gn_bwd_check(x, g, saved, silu, groups)
        fused = plan.route == "fused"
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
                      pair_ms=ms_t + ms_dx, pair_device_ms=add(dev_t, dev_dx), library_ms=library_ms,
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
            line += (f" fused {ms:.4f} ms (device {_ms(dev_ms)}, {share(fb, dev_ms)} of its bound {fb:.4f});"
                     f" pair {ms_t + ms_dx:.4f} (device {_ms(add(dev_t, dev_dx))})")
        else:
            results.append(dict(kernel="gn_bwd_partials", case=case, ms=ms_t, device_ms=dev_t, plain_ms=plain_t,
                                bound_ms=tb, bound_by=tby, max_abs_err=checks["t"][1], **common))
            results.append(dict(kernel="gn_bwd_dx", case=case, ms=ms_dx, device_ms=dev_dx, plain_ms=plain_dx,
                                bound_ms=xb, bound_by=xby, bound_share=None if dev_dx is None else xb / dev_dx,
                                max_abs_err=checks["dx_kernel"][1], **common))
            line += (f" partials {ms_t:.4f} (device {_ms(dev_t)}, {share(tb, dev_t)}) dx {ms_dx:.4f}"
                     f" (device {_ms(dev_dx)}, {share(xb, dev_dx)}) ms")
        log(line + f" vs F.group_norm+silu bwd {library_ms:.4f}; plain {plain_t + plain_dx:.2f}")
        if not ok:
            failures.append(f"gn_bwd {case}: {checks} bitwise {bitwise} device ops {ops}")
        del x, g, out, coef, saved
        torch.cuda.empty_cache()


# ------------------------------------------------------------ optimizer

# SDXL leaves of every kind the update walks: the largest 3x3 conv
# (channels_last; columns contiguous), a GEGLU projection (its contiguous
# axis is the factored rows), an attention projection, a mid-size conv, a
# bias and a norm weight (dense)
OPT_SHAPES = ((1280, 2560, 3, 3), (10240, 1280), (1280, 1280), (640, 640, 3, 3), (320,), (1280,))
OPT_STEPS = 3
OPT_EMA = 0.999


def opt_leaves(gen, scale, like=None):
    """bf16 tensors of OPT_SHAPES (4-D ones channels_last), N(0, scale^2),
    or in the layouts of ``like``."""
    dev = torch.device("cuda")
    shapes = OPT_SHAPES if like is None else [p.shape for p in like]
    out = []
    for i, shape in enumerate(shapes):
        x = (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
        if like is not None:
            out.append(torch.empty_like(like[i]).copy_(x))
        else:
            out.append(x.contiguous(memory_format=torch.channels_last) if len(shape) == 4 else x)
    return out


def opt_view(plan, i, field, state, axis=None):
    """Leaf i's slice of one of the plan's fp32 buffers ([K, R] row factors,
    [K, C] column factors or [K] row means, K over the leaf's other axes
    merged in order), viewed in the logical layout of its v_row (``axis``
    d1), its v_col (d0) or, with no ``axis``, its row means (v_row's shape
    with the row axis of size 1)."""
    from uwudiff_tpu_torch.ops.fused_optim import LEAF_FIELDS

    buf = getattr(plan, field)
    shape = state.leaves[i]["mu"].shape
    d1, d0 = state.dims[i]
    rest = [a for a in range(len(shape)) if a not in (d1, d0)]
    inner = [shape[axis]] if axis is not None else [1]
    off = (int(plan.geometry[i, LEAF_FIELDS.index(field)]) - buf.data_ptr()) // 4
    t = buf[off:off + math.prod(shape[a] for a in rest) * inner[0]].view([shape[a] for a in rest] + inner)
    return t.movedim(-1, sum(a < (d1 if axis is None else axis) for a in rest))


def opt_step_and_compare(tx, params, ema, state, grads, kw):
    """One bf16 step of ``params`` (EMA ``ema``) through the kernels
    (``tx.step_`` with ``kw``) and, from clones of the same state, through
    the plain version (apply_update_), then held to each other. The
    elementwise stage is checked exactly, the reductions within the
    rounding of a sum taken in another order:

    - elementwise: the kernels' momentum, parameters and EMA bitwise the
      plain version's elementwise stage (AdamWFactored.scaled and
      momentum_step, stochastic_round_add, ema_update_, the same bits)
      applied to the kernels' own norm, factors and RMS denominators;
    - the kernels' factors bitwise 1/sqrt of their own statistics (over
      their own row means for the row factors), rounded; their row means
      within one bf16 step (2^-7 relative) of torch's mean of their v_row,
      their RMS denominators within 1e-5 relative of torch's RMS of their
      u (fp32 sums of up to 29.5 M terms in another order; a tile of the
      largest leaf left out would move it by 5e-4);
    - against the plain version: the global norm within 1e-6 relative;
      every statistic within two steps of the larger of its two values
      and its new term (1 - b2) * mean, which is a one-step flip of the
      rounded mean after the EMA plus the rounding of either side;
      >= 99.9 % of the statistics and >= 99.9 % of the momentum bitwise
      (a statistic a step apart moves a row or column of the momentum);
      the parameters and the EMA bitwise at every element whose momentum
      is.

    Returns (ok, the worst numbers, (kernel norm, plain norm))."""
    import copy

    from uwudiff_tpu_torch.training.optimizers import (EMA_STREAM, PARAM_STREAM, apply_update_, draw_sr_bits,
                                                       ema_update_, stochastic_round_add)

    clip, seed, step = kw.get("grad_clip"), kw.get("seed", 0), kw.get("step", 0)
    count = state.count
    p_ref, e_ref, s_ref = [p.clone() for p in params], [e.clone() for e in ema], copy.deepcopy(state)
    p_old, e_old = [p.clone() for p in params], [e.clone() for e in ema]
    mu_old = [st["mu"].clone() for st in state.leaves]
    stat_old = [{k: v.clone() for k, v in st.items() if k != "mu"} for st in state.leaves]
    n_k = tx.step_(params, grads, state, ema_params=ema, **kw)
    n_p = apply_update_(tx, p_ref, grads, s_ref, ema_params=e_ref, **kw)
    plan = state.fused
    b2, lr = tx.scalars(count)
    w = dict(elementwise_mismatch=0, factor_mismatch=0, row_mean_beyond=0, stats_beyond=0, p_ema_mismatch=0,
             denom_max_rel=0.0, stats_max_steps=0.0, max_abs_err=0.0)
    shares = {"mu": [0, 0], "stats": [0, 0]}
    norms = (n_k.item(), n_p.item())
    ok = abs(norms[0] - norms[1]) <= 1e-6 * abs(norms[1])
    for i, g in enumerate(grads):
        st_k, st_p, dims, dtype = state.leaves[i], s_ref.leaves[i], state.dims[i], g.dtype
        # the statistics against the plain version's
        for key, old in stat_old[i].items():
            a, b = st_k[key].float(), st_p[key].float()
            scale = torch.maximum(torch.maximum(a.abs(), b.abs()), (b - b2 * old.float()).abs())
            ratio = torch.nan_to_num((a - b).abs() / (2.0**-7 * scale))
            w["stats_beyond"] += int((ratio > 2.0).sum())
            w["stats_max_steps"] = max(w["stats_max_steps"], ratio.max().item())
            shares["stats"][0] += int((st_k[key].view(torch.int16) == st_p[key].view(torch.int16)).sum())
            shares["stats"][1] += a.numel()
        # the kernels' factors from their own statistics
        if dims is None:
            factors = (1.0 / st_k["v"].float().sqrt(),)
        else:
            d1, d0 = dims
            vr, vc = st_k["v_row"].float(), st_k["v_col"].float()
            rm = opt_view(plan, i, "row_mean", state)
            rm_t = vr.mean(dim=d1 - (d1 > d0), keepdim=True).to(dtype).float()
            w["row_mean_beyond"] += int(((rm - rm_t).abs() > 2.0**-7 * torch.maximum(rm.abs(), rm_t.abs())).sum())
            rf, cf = opt_view(plan, i, "rf", state, d1), opt_view(plan, i, "cf", state, d0)
            w["factor_mismatch"] += int((rf != (1.0 / (vr / rm).sqrt()).to(dtype).float()).sum())
            w["factor_mismatch"] += int((cf != (1.0 / vc.sqrt()).to(dtype).float()).sum())
            factors = (rf.unsqueeze(d0), cf.unsqueeze(d1))
        # the elementwise stage, exactly, from the kernels' own norm, factors
        # and RMS denominator, the latter against the RMS of their own u
        gc = torch.where(n_k < clip, g, g / n_k.to(dtype) * clip) if clip else g
        u = tx.scaled(gc, factors, dtype)
        denom = None
        if tx.clipping_threshold is not None:
            denom = plan.leaf_denom[i]
            ref = torch.clamp(u.float().square().mean().sqrt() / tx.clipping_threshold, min=1.0)
            w["denom_max_rel"] = max(w["denom_max_rel"], ((denom - ref).abs() / ref).item())
        mu = {"mu": mu_old[i].clone()}
        d = tx.momentum_step(u, denom, mu, p_old[i], lr)
        given = kw.get("sr_bits")
        bits = given[i] if given is not None else draw_sr_bits(p_old[i], seed, step, i, PARAM_STREAM)
        p_new = stochastic_round_add(p_old[i], d, bits)
        e_new = e_old[i].clone()
        given = kw.get("ema_bits")
        bits = given[i] if given is not None else draw_sr_bits(e_new, seed, step, i, EMA_STREAM)
        ema_update_([e_new], [p_new], kw["ema_decay"], bits=[bits])
        for got, want in ((st_k["mu"], mu["mu"]), (params[i], p_new), (ema[i], e_new)):
            w["elementwise_mismatch"] += int((got.view(torch.int16) != want.view(torch.int16)).sum())
        # the momentum, parameters and EMA against the plain version's
        same = st_k["mu"].view(torch.int16) == st_p["mu"].view(torch.int16)
        shares["mu"][0] += int(same.sum())
        shares["mu"][1] += same.numel()
        for t_k, t_p in ((params[i], p_ref[i]), (ema[i], e_ref[i])):
            w["max_abs_err"] = max(w["max_abs_err"], (t_k.float() - t_p.float()).abs().max().item())
            w["p_ema_mismatch"] += int(((t_k.view(torch.int16) != t_p.view(torch.int16)) & same).sum())
    for kind, (n_same, n) in shares.items():
        w[f"{kind}_bitwise_share"] = n_same / n
        ok &= n_same >= 0.999 * n
    ok &= w["denom_max_rel"] <= 1e-5
    ok &= not any(w[k] for k in ("elementwise_mismatch", "factor_mismatch", "row_mean_beyond", "stats_beyond",
                                 "p_ema_mismatch"))
    return bool(ok), w, norms


def opt_summary(w) -> str:
    return ", ".join(f"{k} {v:.7g}" if isinstance(v, float) else f"{k} {v}" for k, v in w.items())


def check_optimizer(results, failures):
    """The fused update (ops/fused_optim.py, the kernels of
    csrc/adamw_factored.cu) against its plain version
    (training/optimizers.py::apply_update_) on the card, bf16, at SDXL leaf
    shapes: OPT_STEPS steps with and without the global-norm clip, the
    weight EMA on, with drawn and with given rounding bits; each step from
    the same state on both sides (opt_step_and_compare's bounds); two runs of the
    kernels bitwise equal; the wall time of one update beside the plain
    version's."""
    from uwudiff_tpu_torch.training.optimizers import apply_update_

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params0 = opt_leaves(gen, 0.02)
    params0[-1] = torch.ones_like(params0[-1])  # the norm weight, at its initial value
    grads = [opt_leaves(gen, 1e-3, like=params0) for _ in range(OPT_STEPS)]  # global norm ~7
    runs = {}
    for clip in (None, 1.0):
        for given in (False, True):
            tx = adamw_factored_tx()
            params = [p.clone() for p in params0]
            ema = [p.clone() for p in params0]
            state = tx.init(params)
            ok_all, worst_all, norms_all = True, [], []
            for step in range(OPT_STEPS):
                d_w = float(min(np.float32(1 + step) / np.float32(10 + step), np.float32(OPT_EMA)))
                bits = ([torch.randint(0, 1 << 16, p.shape, generator=gen, device="cuda", dtype=torch.int32)
                         for p in params] if given else None)
                ebits = [b.flip(0) for b in bits] if given else None
                kw = dict(grad_clip=clip, seed=SEED, step=step, sr_bits=bits, ema_decay=d_w, ema_bits=ebits)
                ok, worst, norms = opt_step_and_compare(tx, params, ema, state, grads[step], kw)
                ok_all &= ok
                worst_all.append(worst)
                norms_all.append(norms)
            runs[(clip, given)] = (params, ema, state)
            case = f"clip={clip} bits={'given' if given else 'drawn'}"
            log(f"  optimizer {case}: {'ok' if ok_all else 'FAIL'}; per step "
                + "; ".join(f"norm {k:.6f}/{p:.6f} {opt_summary(w)}" for (k, p), w in zip(norms_all, worst_all)))
            results.append(dict(kernel="adamw_factored", case=case, ok=ok_all, steps=worst_all, norms=norms_all,
                                max_abs_err=max(w["max_abs_err"] for w in worst_all)))
            if not ok_all:
                failures.append(f"optimizer {case}: {worst_all} norms {norms_all}")
    # two runs of the kernels from the same state are bitwise equal
    tx = adamw_factored_tx()
    params = [p.clone() for p in params0]
    ema = [p.clone() for p in params0]
    state = tx.init(params)
    for step in range(OPT_STEPS):
        d_w = float(min(np.float32(1 + step) / np.float32(10 + step), np.float32(OPT_EMA)))
        tx.step_(params, grads[step], state, grad_clip=1.0, seed=SEED, step=step, ema_params=ema, ema_decay=d_w)
    first_p, first_e, first_s = runs[(1.0, False)]
    bitwise = (all(map(torch.equal, params + ema, first_p + first_e))
               and all(torch.equal(st[k], fst[k]) for st, fst in zip(state.leaves, first_s.leaves) for k in st))
    log(f"  optimizer: two runs bitwise {bitwise}")
    if not bitwise:
        failures.append("optimizer: two runs of the kernels differ")
    # one update of these leaves (no clip, no EMA: the bench's), kernels and plain
    state = tx.init(params)
    kernel_ms = time_ms(lambda: tx.step_(params, grads[0], state, seed=SEED))
    plain_ms = time_ms(lambda: apply_update_(tx, params, grads[0], state, seed=SEED), reps=3)
    log(f"  optimizer over {len(params)} SDXL leaves ({sum(p.numel() for p in params) / 1e6:.1f} M params):"
        f" fused {kernel_ms:.3f} ms, plain {plain_ms:.2f} ms")
    results.append(dict(kernel="adamw_factored", case="6 SDXL leaves", ms=kernel_ms, plain_ms=plain_ms,
                        bitwise_two_runs=bitwise, shapes=[list(s) for s in OPT_SHAPES]))
    del runs, grads, params, ema, state
    torch.cuda.empty_cache()


def adamw_factored_tx():
    """The bench's optimizer (training/bench_setup.py) at a constant lr of
    1e-4: wd 0.01, update-RMS clip 1.0."""
    from uwudiff_tpu_torch.training.optimizers import adamw_factored

    return adamw_factored(1e-4, weight_decay=0.01, clipping_threshold=1.0)


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


def small_sd15_unet(device):
    """A small SD1.5-layout UNet (four levels, 1x1-conv projections, no
    addition embedding) whose head dims are SD1.5's 40/80/160: 80/160/320
    channels over 2 heads. fp32 weights."""
    from uwudiff_tpu_torch.models import UNet2DConditionModel

    return UNet2DConditionModel.from_config("sd15", device=device, block_out_channels=(80, 160, 320, 320),
                                            num_attention_heads=2, cross_attention_dim=64, norm_num_groups=16)


def check_sd15_train_vs_cpu(failures):
    """One SD1.5-recipe step of the small SD1.5-layout UNet: on the card the
    fp32 masters under bf16 compute through the flash kernels at D =
    40/80/160 (the forward, dQ and dK/dV Hopper at every one) and
    adamw_fp16's kernels (O2), against the same weights
    in fp32 on the CPU through the plain versions, the same noise and
    timesteps: the loss and the gradients within the bf16 bound of
    check_train_vs_cpu; then the card's update moves every master and
    leaves the module's weights their bf16 rounding."""
    import copy

    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training import DMTrainer

    torch.manual_seed(SEED + 13)
    cpu = small_sd15_unet("cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 14)
    batch = {"sample": torch.randn((2, 32, 32, 4), generator=gen), "ctx": torch.randn((2, 77, 64), generator=gen)}
    noise = torch.randn((2, 32, 32, 4), generator=gen)
    timesteps = torch.tensor([37, 712])
    losses, grads, trainers = {}, {}, {}
    for dev, unet, compute in (("cpu", cpu, None), ("cuda", gpu, "bfloat16")):
        tr = DMTrainer({"unet": unet}, optimizer="adamw_fp16", use_warm_up=False, grad_clip=1.0,
                       loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), compute_dtype=compute, device=dev)
        reset_launch_counts()
        loss, _ = tr.forward_backward(batch, noise, timesteps)
        losses[dev] = loss.float().cpu()
        grads[dev] = torch.cat([p.grad.float().cpu().flatten() for _, p in tr.params])
        trainers[dev] = tr
    by_dim = launches_by_head_dim()
    loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).item()
    grad_err = ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    tr = trainers["cuda"]
    before = [m.clone() for m in tr.masters]
    tr.apply_updates()
    torch.cuda.synchronize()
    o2 = launch_counts()["adamw_fp16_apply"]
    moved = all(not torch.equal(a, b) for a, b in zip(before, tr.masters))
    rounded = all(torch.equal(p.detach(), m.to(torch.bfloat16)) for (_, p), m in zip(tr.params, tr.masters))
    tol = 5e-2  # bf16 weights, activations and gradients through a few dozen layers
    dims_ok = all(set(by_dim[name]) == set(dims) for name, dims in SD15_ROUTES.items())
    log(f"  SD1.5-layout step, card (fp32 masters, bf16 compute) vs CPU fp32 plain: loss rel err {loss_err:.2e},"
        f" grad |d|/|ref| {grad_err:.2e} (tol {tol}); launches by head dim {by_dim}; O2 launches {o2};"
        f" masters moved {moved}, module = bf16(masters) {rounded}")
    if not (loss_err <= tol and grad_err <= tol and dims_ok and o2 == 1 and moved and rounded):
        failures.append(f"SD1.5-layout step card vs CPU: loss {loss_err} grad {grad_err} (tol {tol}), head dims"
                        f" {by_dim}, O2 launches {o2}, masters moved {moved}, module rounded {rounded}")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "tol": tol,
            "launches_by_head_dim": {k: {str(d): n for d, n in v.items()} for k, v in by_dim.items()}}


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
    """Every flash forward of a path ran the Hopper kernel, at every head
    dim; the mma.sync one ran on none."""
    if counts["flash_fwd_mma"] != 0 or counts["flash_fwd_sm90"] != counts["flash_fwd"] or counts["flash_fwd"] == 0:
        failures.append(f"{phase}: flash forward launches sm90 {counts['flash_fwd_sm90']},"
                        f" mma {counts['flash_fwd_mma']}; every one should be on flash_fwd_sm90")


def check_backward_route(counts, phase, failures):
    """Every dQ (but K5's) and every dK/dV launch of a training path ran
    the Hopper kernels, at every head dim; the mma.sync ones ran on none."""
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        if counts[f"{name}_mma"] != 0 or counts[f"{name}_sm90"] != counts[name] or counts[name] == 0:
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
                                ("vae", pipe.vae))}
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
    routes = [plan_gn(*call[:4], torch.bfloat16).route for call in gn_calls]
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

    gn_checks = check_gn_calls(gn_calls, failures, backward=False)
    report["serve"] = dict(
        steps=STEPS, cfg=CFG, resolution=RES, batch_of_4_s=batch_s, imgs_per_s_batch=4 / batch_s,
        lone_request_latency_s=lone_s, peak_memory_gib=peak_gb, launches=counts, groupnorm_plan=gn_plan,
        lone_vs_lane_mean_abs_pixel_diff=img_diff, latents_same_seed_max_diff=d_same,
        latents_other_seed_max_diff=d_other, latents_same_seed_rms_diff=rms_same,
        latents_std=lat_b.float().std().item(), gn_call_checks=gn_checks,
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
    fwd = [plan_gn(*call[:4], torch.bfloat16).route for call in gn_calls]
    bwd = [plan_gn_bwd(*call[:4], torch.bfloat16).route for call in gn_calls]
    return {"flash_fwd": attn, "flash_bwd_dq": attn, "flash_bwd_dkv": attn,
            "gn_silu_fused": fwd.count("fused"), "gn_stats": fwd.count("chunked"),
            "gn_silu_apply": fwd.count("chunked"), "gn_silu_bwd_fused": bwd.count("fused"),
            "gn_bwd_partials": bwd.count("pair"), "gn_bwd_dx": bwd.count("pair")}


def plan_optimizer(trainer) -> dict:
    """The update's launches per step (ops/fused_optim.py): the statistics,
    their merge and the apply, the global norm first with a global-norm
    clip, the update-RMS pass with adamw_factored's clipping_threshold."""
    return {"adamw_norm": int(bool(trainer.grad_clip)), "adamw_stats": 1, "adamw_finish": 1,
            "adamw_rms": int(trainer.tx.clipping_threshold is not None), "adamw_apply": 1}


def check_full_update(trainer, grads, failures) -> list:
    """One update of the SDXL step's own leaves through the kernels
    (tx.step_ on the trainer's parameters and state, whose plan the main
    path built) against the plain version from the same state
    (opt_step_and_compare), with drawn rounding bits and the weight EMA on,
    once with the global-norm clip and once without. The gradients' norm
    is ~50.7 (std 1e-3 over 2.567 G params): a clip of 25 halves them, and
    both steps' gradients outweigh the main path's in the statistics, so
    that a sum's rounding shows there. Returns each case's numbers."""
    tx, state = trainer.tx, trainer.opt_state
    params = [p for _, p in trainer.params]
    d_w = float(min(np.float32(1 + trainer.step) / np.float32(10 + trainer.step), np.float32(OPT_EMA)))
    out = []
    for clip in (25.0, None):
        kw = dict(grad_clip=clip, seed=SEED, step=trainer.step, ema_decay=d_w)
        ok, worst, norms = opt_step_and_compare(tx, params, [p.clone() for p in params], state, grads, kw)
        case = f"{len(params)} SDXL leaves, clip={clip}"
        log(f"  optimizer {case}: {'ok' if ok else 'FAIL'}; norm {norms[0]:.7f}/{norms[1]:.7f} {opt_summary(worst)}")
        out.append(dict(case=case, ok=ok, norms=norms, **worst))
        if not ok:
            failures.append(f"optimizer {case}: {worst} norms {norms}")
        torch.cuda.empty_cache()
    return out


def time_optimizer(trainer, failures) -> dict:
    """The update over the SDXL step's leaves, after the main path's run
    (it overwrites the trained parameters): check_full_update first, then
    each kernel's wall ms (CUDA events over back-to-back launches of its
    wrapper) and device ms (the profiler), its byte bound, the whole
    update's wall time (host work included), the plain version's over the
    same leaves and, for scale only, torch.optim.AdamW(fused=True) over the
    same bf16 leaves (another function: a full second moment, no
    rounding), each with random gradients (std 1e-3) in the parameters'
    layouts."""
    from uwudiff_tpu_torch.ops import OPTIMIZER_KERNELS
    from uwudiff_tpu_torch.ops import fused_optim as fo
    from uwudiff_tpu_torch.training.optimizers import apply_update_

    tx, state = trainer.tx, trainer.opt_state
    params = [p for _, p in trainer.params]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    grads = [torch.empty_like(p).normal_(0.0, 1e-3, generator=gen) for p in params]
    checks = check_full_update(trainer, grads, failures)
    plan = state.fused
    plan.prepare(tx, grads, state.count, seed=SEED, step=trainer.step)  # the bench's: no clip, no EMA
    wrappers = [getattr(fo, name) for name in OPTIMIZER_KERNELS]
    wall = {w.__name__: time_ms(lambda w=w: w(plan), reps=10) for w in wrappers}
    device = {w.__name__: profiled_ms(lambda w=w: w(plan), "optimizer (O1)", per_launch=True)[0] for w in wrappers}
    update_ms = time_ms(lambda: tx.step_(params, grads, state, seed=SEED, step=trainer.step), reps=5)
    plain_ms = time_ms(lambda: apply_update_(tx, params, grads, state, seed=SEED, step=trainer.step),
                       reps=1, warmup=1, runs=2)
    for p, g in zip(params, grads):
        p.grad = g
    adamw = torch.optim.AdamW(params, lr=1e-5, weight_decay=0.01, fused=True)
    adamw_ms = time_ms(adamw.step, reps=5)
    for p in params:
        p.grad = None
    del adamw
    # bytes each kernel must move (bf16 leaves; fp32 partials, factors and tile sums)
    g = plan.geometry
    col = {k: i for i, k in enumerate(fo.LEAF_FIELDS)}
    fact = g[:, col["factored"]] == 1
    n = int(g[:, col["numel"]].sum())
    dense = int(g[~fact, col["numel"]].sum())
    stats = int((g[fact, col["K"]] * (g[fact, col["R"]] + g[fact, col["C"]])).sum())
    parts = plan.sizes["part_f"] + plan.sizes["part_s"]
    tiles = plan.n_tiles
    nbytes = {"adamw_norm": 2 * n + 4 * tiles, "adamw_stats": 2 * n + 4 * parts + 4 * dense + 4 * tiles,
              "adamw_finish": 4 * parts + 8 * stats + 4 * tiles, "adamw_rms": 2 * n + 2 * dense + 4 * stats,
              "adamw_apply": 10 * n + 2 * dense + 4 * stats}
    bounds = {k: bound(v, 0.0, PEAK_FP32)[0] for k, v in nbytes.items()}
    whole = sum(bounds[k] for k in ("adamw_stats", "adamw_finish", "adamw_rms", "adamw_apply"))
    out = dict(leaves=len(params), params=n, dense_params=dense, tiles=tiles, stat_tiles=plan.n_stat_tiles,
               full_checks=checks, max_abs_err=max(c["max_abs_err"] for c in checks),
               kernel_ms=wall, kernel_device_ms=device, bound_ms=bounds,
               update_bound_ms=whole, update_ms=update_ms, plain_ms=plain_ms, adamw_fused_ms=adamw_ms,
               adamw_fused_computes="torch.optim.AdamW(fused=True): full second moment, no rounding, no clip")
    log(f"  optimizer over {len(params)} leaves ({n / 1e9:.3f} G params, {tiles} tiles): "
        + ", ".join(f"{k} {wall[k]:.3f} ms (device {_ms(device[k])}, bound {bounds[k]:.3f})" for k in wall)
        + f"; update {update_ms:.2f} ms (bound {whole:.2f}), plain {plain_ms:.1f} ms,"
        f" AdamW(fused) {adamw_ms:.2f} ms (another function)")
    del grads
    return out


# ------------------------------------------------------------------- flux

FLUX_STEPS = 4
FLUX_PROMPTS = ["a lighthouse at dusk, oil painting", "a red fox in snow", "a bowl of ramen, studio photo",
                "an astronaut riding a horse"]
FLUX_SEEDS = [21, 22, 23, 24]


def check_flux_vs_cpu(failures):
    """A Flux of 2 double and 2 single blocks at flux_dev's width (head dim
    128, the zero-initialised leaves drawn): the card's bf16 forward through
    the kernels against the same weights' fp32 forward on the CPU through
    the plain versions, which the CPU tests hold against the JAX package;
    256 image tokens and 64 text tokens with the T5 mask, as a key bias."""
    import copy

    from uwudiff_tpu_torch.models import Flux
    from uwudiff_tpu_torch.ops import launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    torch.manual_seed(SEED + 5)
    cpu = fill_zero_initialised(Flux.from_config("flux_dev", device="cuda", depth=2, depth_single=2)).cpu()
    gpu = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 6)
    x = torch.randn((2, 32, 32, 16), generator=gen)
    t = torch.tensor([10.5, 731.25])
    ctx = torch.randn((2, 64, 4096), generator=gen)
    mask = (torch.arange(64)[None, :] < torch.tensor([[9], [64]])).int()
    pooled = torch.randn((2, 768), generator=gen)
    with torch.inference_mode():
        ref = cpu(x, t, ctx, mask, {"text_embeds": pooled})
        reset_launch_counts()
        out = gpu(*(a.cuda() for a in (x, t, ctx, mask)), {"text_embeds": pooled.cuda()})
        launches = launches_by_head_dim()["flash_fwd_sm90"].get(128, 0)
    err = ((out.float().cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()
    finite = bool(torch.isfinite(out).all())
    tol = 5e-2  # bf16 weights and activations through four blocks, as check_models_vs_cpu
    log(f"  flux (2 + 2 blocks, width 3072) card bf16 vs CPU fp32 plain: rel err {err:.2e} (tol {tol});"
        f" |ref| max {ref.abs().max().item():.3e}; flash_fwd_sm90 at D = 128: {launches} launches")
    if not (finite and err <= tol and ref.abs().max() > 0 and launches == 4):
        failures.append(f"flux card vs CPU: rel err {err} (tol {tol}), finite {finite}, D = 128 launches {launches}"
                        " (4 expected)")
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"rel_err": err, "tol": tol, "flash_fwd_d128_launches": launches}


def check_flux_train_vs_cpu(failures):
    """One training step of a Flux at flux_1b's width (1536, 12 heads of
    128) with one block of each kind, the zero-initialised leaves drawn:
    bf16 parameters on the card through the kernels, every block recomputed
    in the backward (the recipe's gradient_checkpointing), against the same
    weights in fp32 on the CPU through the plain versions, which the CPU
    tests hold against the JAX package's step; the same noise and
    timesteps, without and with a T5 key mask. Checks the loss and every
    leaf's gradient, and the card's launches: K1 twice a block (the forward
    and its recompute), K4 and K6 once, all at D = 128."""
    import copy

    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.models import Flux
    from uwudiff_tpu_torch.ops import launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training import DMTrainer
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    torch.manual_seed(SEED + 13)
    cpu = fill_zero_initialised(Flux.from_config("flux_1b", device="cuda", depth=1, depth_single=1)).cpu()
    gpu = copy.deepcopy(cpu).to(device="cuda")
    gpu.gradient_checkpointing = True
    gen = torch.Generator().manual_seed(SEED + 14)
    batch = {"sample": torch.randn((2, 32, 32, 16), generator=gen), "ctx": torch.randn((2, 77, 4096), generator=gen),
             "pooled": torch.randn((2, 768), generator=gen)}
    noise = torch.randn((2, 32, 32, 16), generator=gen)
    timesteps = torch.tensor([37, 712])
    # bf16 weights, activations and gradients through two blocks; a leaf's
    # gradient is held in norm, against its own size
    tol, leaf_tol = 5e-2, 1e-1
    out = {}
    for masked in (False, True):
        data = dict(batch, ctx_mask=(torch.arange(77)[None, :] < torch.tensor([[9], [77]])).int()) if masked else batch
        losses, grads = {}, {}
        for dev, unet, pdt in (("cpu", cpu, None), ("cuda", gpu, "bfloat16")):
            tr = DMTrainer({"unet": unet}, loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()),
                           param_dtype=pdt, device=dev)
            reset_launch_counts()
            loss, _ = tr.forward_backward(data, noise, timesteps)
            by_dim = launches_by_head_dim()
            losses[dev] = loss.float().cpu()
            grads[dev] = {n: p.grad.float().cpu() for n, p in tr.params}
        launches = {k: by_dim[k] for k in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")}
        loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).item()
        flat = {dev: torch.cat([g.flatten() for g in grads[dev].values()]) for dev in grads}
        grad_err = ((flat["cuda"] - flat["cpu"]).norm() / flat["cpu"].norm()).item()
        leaf_errs = {n: ((grads["cuda"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                     for n, g in grads["cpu"].items()}
        worst = max(leaf_errs, key=leaf_errs.get)
        case = "t5 mask" if masked else "no mask"
        log(f"  flux_1b width (1 + 1 blocks) training step, {case}, card bf16 vs CPU fp32 plain: loss rel err"
            f" {loss_err:.2e}, grads |d|/|ref| {grad_err:.2e} (tol {tol}), worst leaf {worst} {leaf_errs[worst]:.2e}"
            f" (tol {leaf_tol}); launches {launches}")
        want = {"flash_fwd_sm90": {128: 4}, "flash_bwd_dq_sm90": {128: 2}, "flash_bwd_dkv_sm90": {128: 2}}
        if not (loss_err <= tol and grad_err <= tol and leaf_errs[worst] <= leaf_tol and launches == want):
            failures.append(f"flux_1b-width training step card vs CPU, {case}: loss {loss_err} grads {grad_err}"
                            f" (tol {tol}), {worst} {leaf_errs[worst]} (tol {leaf_tol}), launches {launches}")
        out[case] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err, worst_leaf=worst,
                         worst_leaf_rel_err=leaf_errs[worst], launches=launches)
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, tol=tol, leaf_tol=leaf_tol)


def flux_phases(pipe, n):
    """One request batch of n, phase by phase with a sync after each: the
    text encode, one denoiser step (CUDA events, the median of 3), the
    decode; and the card's busy share over one step (torch.profiler: device
    time over the traced wall time)."""
    from torch.profiler import ProfilerActivity, profile

    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.sampling import RFDenoiser, build_cfg_fn, encode_cfg_inputs

    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode_cfg_inputs(FLUX_PROMPTS[:n], [""] * n, RES, RES, pipe.te)
        torch.cuda.synchronize()
        out["encode_s"] = time.perf_counter() - t0
        den = RFDenoiser(model_fn=pipe.model, schedule=NoiseSchedule.sdxl().to("cuda"))
        step = build_cfg_fn(den, enc, 1.0)
        x = torch.randn((n, RES // 8, RES // 8, 16), device="cuda")
        sigma = torch.full((n,), 5.0, device="cuda")
        out["step_ms"] = time_ms(lambda: step(x, sigma), reps=1, warmup=1, runs=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(x, sigma)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(ev.time_range.elapsed_us() for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out.update(traced_step_window_ms=window_ms, traced_step_busy_ms=busy_ms, busy_share=busy_ms / window_ms)
        t0 = time.perf_counter()
        pipe.vae.decode(x)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
    return out


def flux(report, failures):
    """flux_dev txt2img at 1024x1024 through diffusion_sampling: a lone
    request and a batch of 4, FLUX_STEPS steps each."""
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.serving import flux_txt2img
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    report["flux_vs_cpu"] = check_flux_vs_cpu(failures)
    t0 = time.perf_counter()
    pipe = flux_txt2img("cuda", torch.bfloat16, SEED)
    fill_zero_initialised(pipe.model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("flux", pipe.model), ("text_encoders", pipe.te.module), ("vae", pipe.vae))}
    log(f"  built flux_dev + clip_l + t5_xxl + 16-channel vae in {build_s:.1f} s: {n_params};"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    t0 = time.perf_counter()
    for n in (1, 4):  # one pass per batch size
        pipe(FLUX_PROMPTS[:n], num_steps=1, num_samples=n, seed=FLUX_SEEDS[:n], width=RES, height=RES)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    gn_calls: list = []
    hooks = record_gn_calls([pipe.vae], gn_calls)
    runs, counts_total = {}, None
    torch.cuda.reset_peak_memory_stats()
    for n in (1, 4):
        reset_launch_counts()  # the main path's run starts here (the count of each batch size)
        t0 = time.perf_counter()
        images = pipe(FLUX_PROMPTS[:n], num_steps=FLUX_STEPS, num_samples=n, seed=FLUX_SEEDS[:n], width=RES,
                      height=RES)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, by_dim = launch_counts(), launches_by_head_dim()  # and ends here
        counts_total = counts if counts_total is None else {k: counts_total[k] + v for k, v in counts.items()}
        d128 = by_dim["flash_fwd_sm90"].get(128, 0)
        check_forward_route(counts, f"flux batch {n}", failures)
        if d128 != 57 * FLUX_STEPS:
            failures.append(f"flux batch {n}: flash_fwd_sm90 ran {d128} times at D = 128, 57 x {FLUX_STEPS} expected")
        stds = [float(img.astype(np.float32).std()) for img in images]
        if len(images) != n or any(img.shape != (RES, RES, 3) or img.dtype != np.uint8 for img in images) or \
                not all(sd > 0 for sd in stds):
            failures.append(f"flux batch {n}: {len(images)} images, shapes {[i.shape for i in images]}, stds {stds}")
        runs[n] = dict(wall_s=wall_s, imgs_per_s=n / wall_s, launches=counts, launches_by_head_dim=by_dim,
                       flash_fwd_d128=d128, image_stds=stds)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    lat = pipe(FLUX_PROMPTS[1], num_steps=FLUX_STEPS, num_samples=1, seed=FLUX_SEEDS[1], width=RES, height=RES,
               return_latents=True)
    lat_std = lat.float().std().item()
    if not (bool(torch.isfinite(lat).all()) and lat_std > 0):
        failures.append(f"flux latents: finite {bool(torch.isfinite(lat).all())}, std {lat_std}")
    phases = {f"batch_{n}": flux_phases(pipe, n) for n in (1, 4)}
    gn_checks = check_gn_calls(gn_calls, failures, backward=False)
    report["flux"] = dict(
        model="flux_dev", steps=FLUX_STEPS, resolution=RES, t5_tokens=512, joint_tokens=512 + (RES // 16) ** 2,
        params=n_params, build_s=build_s, warmup_s=warmup_s, runs=runs, peak_memory_gib=peak_gib,
        latents_std=lat_std, phases=phases, gn_call_checks=gn_checks)
    log(f"  flux_dev ({report['card']}): lone request {runs[1]['wall_s']:.2f} s, batch of 4 {runs[4]['wall_s']:.2f} s"
        f" ({runs[4]['imgs_per_s']:.3f} imgs/s); peak {peak_gib:.1f} GiB; D = 128 launches"
        f" {runs[1]['flash_fwd_d128']} + {runs[4]['flash_fwd_d128']}; latents std {lat_std:.3f}")
    log(f"  flux phases: {json.dumps(phases)}")
    return counts_total, runs[1]["flash_fwd_d128"] + runs[4]["flash_fwd_d128"]


def record_gn_calls(modules, calls):
    """Forward pre-hooks that append (n, hw, c, groups, silu, eps) of every
    GroupNorm call under ``modules`` to ``calls`` (its first four are what
    plan_gn and plan_gn_bwd take); returns the hooks."""
    from uwudiff_tpu_torch.models.layers import GroupNorm

    def record(module, args):
        x = args[0]
        c = module.weight.shape[0]
        calls.append((x.shape[0], x.numel() // (x.shape[0] * c), c, module.groups, module.silu, module.eps))

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
    plan.update(plan_optimizer(trainer))
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
    opt = time_optimizer(trainer, failures)
    gn_checks = check_gn_calls(gn_calls, failures, backward=True)
    step_s = sorted(s["step_s"] for s in steps)[TRAIN_STEPS // 2]
    fb_ms = sorted(s["forward_backward_ms"] for s in steps)[TRAIN_STEPS // 2]
    opt_ms = sorted(s["optimizer_ms"] for s in steps)[TRAIN_STEPS // 2]
    report["train"] = dict(
        batch=8, latent=64, params=n_params, leaves=len(start), build_s=build_s, warmup_step_s=warmup_s,
        steps=steps, median_step_s=step_s, imgs_per_s=8 / step_s, median_forward_backward_ms=fb_ms,
        median_optimizer_ms=opt_ms, peak_memory_gib=peak_gib, launches=counts, plan_per_step=plan,
        gn_shapes=sorted({call[:4] for call in gn_calls}), gn_call_checks=gn_checks,
        gn_grad_layout_copies=copies, unchanged_leaves=unchanged, losses=losses, grad_norms=norms, optimizer=opt)
    log(f"  train: step {step_s:.3f} s ({8 / step_s:.2f} imgs/s), forward+backward {fb_ms:.1f} ms,"
        f" optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB; losses {[round(v, 4) for v in losses]},"
        f" grad norms {[round(v, 3) for v in norms]}; launches/step {plan}; GN grad copies {copies};"
        f" leaves unchanged {len(unchanged)} of {len(start)}, all unit-initialised norm weights:"
        f" {not moved_wrongly}")
    return counts


# -------------------------------------------------------------- train SD1.5

SD15_STEPS = 5


def plan_fp16_optimizer() -> dict:
    """adamw_fp16's launches per step (ops/fused_optim.py, O2): the global
    norm, then the elementwise pass; none of O1's."""
    from uwudiff_tpu_torch.ops import OPTIMIZER_KERNELS

    return {**{name: 0 for name in OPTIMIZER_KERNELS}, "adamw_norm": 1, "adamw_fp16_apply": 1}


# the head dims each flash kernel serves on the SD1.5 step: the forward, dQ
# and dK/dV are the Hopper kernels throughout; the mma.sync dQ and dK/dV
# (D = 160) serve none
SD15_ROUTES = {"flash_fwd_sm90": (40, 80, 160), "flash_bwd_dq_sm90": (40, 80, 160),
               "flash_bwd_dkv_sm90": (40, 80, 160), "flash_bwd_dq_mma": (), "flash_bwd_dkv_mma": ()}


def sd15_head_dim_plan(unet) -> dict:
    """Attention calls per step by head dim, from the modules: a block's
    self-attention, and its cross-attention."""
    from uwudiff_tpu_torch.models.transformer import BasicTransformerBlock

    plan: dict = {}
    for m in unet.modules():
        if isinstance(m, BasicTransformerBlock):
            d = m.attn1.head_dim
            plan[d] = plan.get(d, 0) + (2 if m.has_cross else 1)
    return dict(sorted(plan.items()))


def check_fp16_update(trainer, grads, failures) -> list:
    """One update of the SD1.5 step's own leaves through O2 (tx.step_ on
    clones of the trainer's masters, working copies and state) against the
    plain version (apply_update_) from the same state, fed the gradients O2
    clipped with its own norm (g / norm * clip in fp32, as the kernel does):
    the masters, the working copies and both moments bitwise, the decay
    accumulators equal, and O2's norm within 1e-6 of torch's norm of the
    same gradients. With the recipe's clip at 1.0 (these gradients' norm is
    ~4-6, so they are clipped) and without. Returns each case's numbers."""
    import copy

    from uwudiff_tpu_torch.training.optimizers import apply_update_

    tx = trainer.tx
    out = []
    ref_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                                     for g in grads])).item()
    for clip in (1.0, None):
        p_k, w_k = [m.clone() for m in trainer.masters], [p.detach().clone() for _, p in trainer.params]
        st_k = copy.deepcopy(trainer.opt_state)
        n_k = tx.step_(p_k, grads, st_k, grad_clip=clip, working=w_k)
        p_r, w_r = [m.clone() for m in trainer.masters], [p.detach().clone() for _, p in trainer.params]
        st_r = copy.deepcopy(trainer.opt_state)
        g_r = [g.float() for g in grads]
        if clip:
            g_r = [torch.where(n_k < clip, g, g / n_k * clip) for g in g_r]
        apply_update_(tx, p_r, g_r, st_r, working=w_r)
        del g_r
        mism = {name: sum(int((a.view(torch.int16 if a.element_size() == 2 else torch.int32)
                               != b.view(torch.int16 if b.element_size() == 2 else torch.int32)).sum())
                          for a, b in pairs)
                for name, pairs in (("master", zip(p_k, p_r)), ("working", zip(w_k, w_r)),
                                    ("exp_avg", ((a["exp_avg"], b["exp_avg"])
                                                 for a, b in zip(st_k.leaves, st_r.leaves))),
                                    ("exp_avg_sq", ((a["exp_avg_sq"], b["exp_avg_sq"])
                                                    for a, b in zip(st_k.leaves, st_r.leaves))))}
        max_abs = max((a - b).abs().max().item() for a, b in zip(p_k, p_r))
        norm_rel = abs(n_k.item() - ref_norm) / ref_norm
        decay_eq = bool(np.array_equal(st_k.decay, st_r.decay))
        ok = not any(mism.values()) and decay_eq and norm_rel <= 1e-6
        case = f"{len(p_k)} SD1.5 leaves, clip={clip}"
        log(f"  adamw_fp16 {case}: {'ok' if ok else 'FAIL'}; norm {n_k.item():.7f} vs torch {ref_norm:.7f}"
            f" (rel {norm_rel:.1e}); elements differing {mism}; decays equal {decay_eq}")
        out.append(dict(case=case, ok=ok, norm=n_k.item(), torch_norm=ref_norm, norm_rel_err=norm_rel,
                        mismatches=mism, decay_equal=decay_eq, max_abs_err=max_abs))
        if not ok:
            failures.append(f"adamw_fp16 {case}: mismatches {mism}, decay equal {decay_eq}, norm rel {norm_rel}")
        del p_k, w_k, st_k, p_r, w_r, st_r
        torch.cuda.empty_cache()
    return out


def time_fp16_optimizer(trainer, grads, failures) -> dict:
    """O2 over the SD1.5 step's leaves, after the main path's run:
    check_fp16_update first, then each kernel's wall ms (CUDA events over
    back-to-back launches of its wrapper on the prepared step) and device
    ms (the profiler), its byte bound (norm: the bf16 gradients read; apply:
    20 bytes a parameter), the whole update through step_, the plain
    version's and, for scale only, torch.optim.AdamW(fused=True) over the
    fp32 masters (another function: fp32 moments, no decay accumulator)."""
    from uwudiff_tpu_torch.ops import FP16_OPTIMIZER_KERNELS
    from uwudiff_tpu_torch.ops import fused_optim as fo
    from uwudiff_tpu_torch.training.optimizers import apply_update_

    checks = check_fp16_update(trainer, grads, failures)
    tx, state = trainer.tx, trainer.opt_state
    masters, working = trainer.masters, [p for _, p in trainer.params]
    plan = state.fused
    plan.prepare(tx, grads, state, grad_clip=trainer.grad_clip)
    wrappers = [getattr(fo, name) for name in FP16_OPTIMIZER_KERNELS]
    wall = {w.__name__: time_ms(lambda w=w: w(plan), reps=10) for w in wrappers}
    device = {w.__name__: profiled_ms(lambda w=w: w(plan), fam, per_launch=True)[0]
              for w, fam in zip(wrappers, ("optimizer (O1)", "optimizer (O2)"))}
    update_ms = time_ms(lambda: tx.step_(masters, grads, state, grad_clip=trainer.grad_clip, working=working),
                        reps=5)
    plain_ms = time_ms(lambda: apply_update_(tx, masters, grads, state, grad_clip=trainer.grad_clip,
                                             working=working), reps=1, warmup=1, runs=2)
    for m, g in zip(masters, grads):
        m.grad = g.float()
    adamw = torch.optim.AdamW(masters, lr=1e-5, weight_decay=0.01, fused=True)
    adamw_ms = time_ms(adamw.step, reps=5)
    for m in masters:
        m.grad = None
    del adamw
    n = sum(m.numel() for m in masters)
    nbytes = {"adamw_norm": 2 * n + 4 * plan.n_tiles, "adamw_fp16_apply": 20 * n + 4 * len(masters)}
    bounds = {k: bound(v, 0.0, PEAK_FP32)[0] for k, v in nbytes.items()}
    out = dict(leaves=len(masters), params=n, tiles=plan.n_tiles, full_checks=checks,
               max_abs_err=max(c["max_abs_err"] for c in checks), kernel_ms=wall, kernel_device_ms=device,
               bound_ms=bounds, update_bound_ms=sum(bounds.values()), update_ms=update_ms, plain_ms=plain_ms,
               adamw_fused_ms=adamw_ms,
               adamw_fused_computes="torch.optim.AdamW(fused=True) over the fp32 masters: fp32 moments, no decay"
                                    " accumulator, no working copy")
    log(f"  adamw_fp16 over {len(masters)} leaves ({n / 1e9:.3f} G params, {plan.n_tiles} tiles): "
        + ", ".join(f"{k} {wall[k]:.3f} ms (device {_ms(device[k])}, bound {bounds[k]:.3f})" for k in wall)
        + f"; update {update_ms:.2f} ms (bound {out['update_bound_ms']:.2f}), plain {plain_ms:.1f} ms,"
        f" AdamW(fused) {adamw_ms:.2f} ms (another function)")
    return out


def train_sd15(report, failures):
    """The SD1.5 full fine-tune step at full width (training/bench_setup.py,
    model="sd15": batch 16, 64x64 latents, fp32 masters under bf16 compute,
    adamw_fp16, global-norm clip 1.0): one warm-up step, SD15_STEPS timed."""
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, plan_gn, plan_gn_bwd, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

    t0 = time.perf_counter()
    trainer, data = build_trainer_and_batch(model="sd15", latent=64, seed=SEED)
    trainer.setup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bsz = len(data["sample"])
    dev = trainer.device
    batch = {"sample": torch.as_tensor(data["sample"], device=dev), "ctx": torch.as_tensor(data["ctx"], device=dev)}
    n_params = sum(m.numel() for m in trainer.masters)
    start = [m.cpu() for m in trainer.masters]  # in host memory: the peak below is the step's own
    log(f"  built the sd15 trainer ({n_params / 1e9:.3f} G fp32 masters under bf16 compute, {len(start)} leaves)"
        f" in {build_s:.1f} s")
    gn_calls: list = []
    hooks = record_gn_calls([trainer.unet], gn_calls)
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the main path's run starts here
    steps = []
    for _ in range(SD15_STEPS):
        t0 = time.perf_counter()
        metrics, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        phases = trainer.step_phase_ms()
        steps.append(dict(step_s=time.perf_counter() - t0, loss=metrics["train/loss"].item(),
                          grad_norm=metrics["train/grad_norm"].item(), lr=metrics["train/lr"], **phases))
    counts = launch_counts()  # the main path's run ends here
    by_dim = launches_by_head_dim()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    plan = plan_launches(trainer.unet, gn_calls)
    plan.update(plan_fp16_optimizer())
    for name, per_step in plan.items():
        if counts[name] != per_step * SD15_STEPS:
            failures.append(f"sd15 {name}: {counts[name]} launches in {SD15_STEPS} steps, plan {per_step} a step")
    check_forward_route(counts, "sd15", failures)
    check_backward_route(counts, "sd15", failures)
    dims = sd15_head_dim_plan(trainer.unet)
    for name, routed in SD15_ROUTES.items():  # each kernel at its head dims, as many times as the modules plan
        want = {d: n * SD15_STEPS for d, n in dims.items() if d in routed}
        if by_dim[name] != want or counts[name] != sum(want.values()):
            failures.append(f"sd15 {name}: {counts[name]} launches, by head dim {by_dim[name]}; plan {want}"
                            f" ({dims} attention calls a step)")
    losses = [warm["train/loss"].item()] + [s["loss"] for s in steps]
    norms = [warm["train/grad_norm"].item()] + [s["grad_norm"] for s in steps]
    if not all(map(math.isfinite, losses + norms)) or len(set(losses)) < 2:
        failures.append(f"sd15 metrics: losses {losses} grad norms {norms} (finite, the loss moving)")
    unmoved = [name for (name, _), m, m0 in zip(trainer.params, trainer.masters, start)
               if torch.equal(m, m0.to(m.device))]
    rounded = all(torch.equal(p.detach(), m.to(torch.bfloat16)) for (_, p), m in zip(trainer.params, trainer.masters))
    if unmoved or not rounded:
        failures.append(f"sd15: {len(unmoved)} masters unchanged ({unmoved[:8]}), module = bf16(masters) {rounded}")
    del start
    # the update over the step's own leaves, with one more batch's gradients
    trainer.forward_backward(batch)
    grads = [p.grad for _, p in trainer.params]
    for _, p in trainer.params:
        p.grad = None
    opt = time_fp16_optimizer(trainer, grads, failures)
    del grads
    gn_checks = check_gn_calls(gn_calls, failures, backward=True)
    med = lambda key: sorted(s[key] for s in steps)[SD15_STEPS // 2]  # noqa: E731
    step_s, fb_ms, opt_ms = med("step_s"), med("forward_backward_ms"), med("optimizer_ms")
    gn_routes = {f"{n}x{hw}x{c}/{g}": [plan_gn(n, hw, c, g, torch.bfloat16).route,
                                       plan_gn_bwd(n, hw, c, g, torch.bfloat16).route]
                 for n, hw, c, g in sorted({call[:4] for call in gn_calls})}
    report["train_sd15"] = dict(
        batch=bsz, latent=64, params=n_params, leaves=len(trainer.masters), build_s=build_s, warmup_step_s=warmup_s,
        steps=steps, median_step_s=step_s, imgs_per_s=bsz / step_s, median_forward_backward_ms=fb_ms,
        median_optimizer_ms=opt_ms, peak_memory_gib=peak_gib, launches=counts, plan_per_step=plan,
        launches_by_head_dim={k: {str(d): n for d, n in v.items()} for k, v in by_dim.items()},
        attention_head_dims_per_step={str(d): n for d, n in dims.items()}, gn_routes=gn_routes,
        gn_call_checks=gn_checks, losses=losses,
        grad_norms=norms, masters_unchanged=unmoved, module_is_bf16_of_masters=rounded, optimizer=opt)
    log(f"  sd15: step {step_s:.3f} s ({bsz / step_s:.2f} imgs/s), forward+backward {fb_ms:.1f} ms,"
        f" optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB; losses {[round(v, 4) for v in losses]},"
        f" grad norms {[round(v, 3) for v in norms]}; launches/step {plan}; attention calls by head dim a step"
        f" {dims}, launches by head dim {by_dim}; GroupNorm shapes [fwd, bwd route] {gn_routes};"
        f" masters unchanged {len(unmoved)} of {len(trainer.masters)}")
    return counts, by_dim


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


# ---------------------------------------------------------- train flux_1b

FLUX_1B_STEPS = 5


def plan_flux_launches(model) -> dict:
    """The flash kernels' launches per training step of a Flux, by head dim:
    one joint attention a block, its forward run again in the backward where
    the blocks are recomputed (gradient_checkpointing), one dQ and one dK/dV."""
    attn = len(model.block_names) + len(model.single_block_names)
    d = model.single_blocks_0.attn1.norm_q.weight.shape[0] if attn else None
    return {"flash_fwd_sm90": {d: attn * (2 if model.gradient_checkpointing else 1)},
            "flash_bwd_dq_sm90": {d: attn}, "flash_bwd_dkv_sm90": {d: attn}}


def expected_sr_moves(trainer, i, steps) -> float:
    """About how many values of bf16 leaf ``i`` stochastic rounding moved
    over ``steps`` steps of adamw_factored: a value moves by one bf16 step
    (its ulp) with probability |update| / ulp, and the update is the
    momentum (lr already in it: Adafactor's momentum of lr-scaled, RMS-
    clipped g / sqrt(v)) plus the weight decay, lr wd |p|. The last
    step's momentum stands for every step's (a bound: it grows from 0.1 of
    its steady value). Computed from the state, not measured."""
    _, p = trainer.params[i]
    tx = trainer.tx
    lr = float(trainer.lr_schedule(trainer.step))
    pf = p.detach().float()
    ulp = torch.ldexp(torch.ones_like(pf), torch.frexp(pf).exponent - 8)  # bf16: 8 significant bits
    update = trainer.opt_state.leaves[i]["mu"].float().abs() + lr * tx.weight_decay * pf.abs()
    return steps * (update / ulp).clamp(max=1.0).sum().item()


def step_busy_share(trainer, batch) -> dict:
    """One training step traced by torch.profiler: the device time of its
    kernels and copies over the traced wall time (the profiler's host
    overhead lengthens the window, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(ev.time_range.elapsed_us() for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(traced_window_ms=window_ms, traced_busy_ms=busy_ms, busy_share=busy_ms / window_ms)


def train_flux(report, failures):
    """bench.py's flux_1b training step at full width (training/bench_setup.py,
    model="flux_1b": 6 double and 12 single blocks at width 1536, 12 heads of
    128, every block recomputed in the backward, batch 8, 64x64x16 latents,
    77 tokens of 4096-wide context, bf16 params with stochastic rounding,
    adamw_factored): one warm-up step, FLUX_1B_STEPS timed."""
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

    t0 = time.perf_counter()
    trainer, data = build_trainer_and_batch(model="flux_1b", seed=SEED)
    trainer.setup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bsz = len(data["sample"])
    dev = trainer.device
    batch = {"sample": torch.as_tensor(data["sample"], device=dev), "ctx": torch.as_tensor(data["ctx"], device=dev),
             "pooled": torch.as_tensor(data["pooled"], device=dev)}
    n_params = sum(p.numel() for _, p in trainer.params)
    # in host memory: the peak below is the step's own
    start = [p.detach().to("cpu", copy=True) for _, p in trainer.params]
    log(f"  built the flux_1b trainer ({n_params / 1e9:.3f} G bf16 params, {len(start)} leaves) in {build_s:.1f} s")
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the main path's run starts here
    steps = []
    for _ in range(FLUX_1B_STEPS):
        t0 = time.perf_counter()
        metrics, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        phases = trainer.step_phase_ms()
        steps.append(dict(step_s=time.perf_counter() - t0, loss=metrics["train/loss"].item(),
                          grad_norm=metrics["train/grad_norm"].item(), lr=metrics["train/lr"], **phases))
    counts = launch_counts()  # the main path's run ends here
    by_dim = launches_by_head_dim()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # 36 K1 (18 forwards, 18 recomputed), 18 K4 and 18 K6 a step, all at
    # D = 128 on the Hopper kernels, and the update's kernels as planned
    flash_plan = plan_flux_launches(trainer.unet)
    for name, per_step in flash_plan.items():
        want = {d: n * FLUX_1B_STEPS for d, n in per_step.items()}
        if by_dim[name] != want or counts[name] != sum(want.values()):
            failures.append(f"flux_1b {name}: {by_dim[name]} by head dim in {FLUX_1B_STEPS} steps, {want} planned")
    opt_plan = plan_optimizer(trainer)
    for name, per_step in opt_plan.items():
        if counts[name] != per_step * FLUX_1B_STEPS:
            failures.append(f"flux_1b {name}: {counts[name]} launches in {FLUX_1B_STEPS} steps, plan {per_step} a step")
    check_forward_route(counts, "flux_1b", failures)
    check_backward_route(counts, "flux_1b", failures)
    losses = [warm["train/loss"].item()] + [st["loss"] for st in steps]
    norms = [warm["train/grad_norm"].item()] + [st["grad_norm"] for st in steps]
    if not all(map(math.isfinite, losses + norms)) or len(set(losses)) < 2 or not all(n > 0 for n in norms):
        failures.append(f"flux_1b training metrics: losses {losses} grad norms {norms}")
    moments_ok = all(bool(torch.isfinite(st["mu"]).all()) and bool(st["mu"].any())
                     for st in trainer.opt_state.leaves)
    if not moments_ok or trainer.opt_state.count != FLUX_1B_STEPS + 1:
        failures.append(f"flux_1b optimizer state: moments ok {moments_ok}, count {trainer.opt_state.count}")
    # every leaf took an update (its momentum, above), and moved, unless
    # stochastic rounding would rarely move it: a leaf whose gradients are
    # far below sqrt(eps) (1e-4: adamw_factored adds eps to g^2) takes
    # updates far below lr, each value a small chance a step to move by one
    # bf16 step (the text stream's biases), as do the norm scales
    # initialised to ones
    unchanged = {name: i for i, ((name, p), p0) in enumerate(zip(trainer.params, start)) if torch.equal(p.cpu(), p0)}
    expected = {name: expected_sr_moves(trainer, i, FLUX_1B_STEPS + 1) for name, i in unchanged.items()}
    moved_wrongly = [n for n, e in expected.items() if e >= 3.0]  # such a leaf keeps every value with p < e^-3
    if moved_wrongly:
        failures.append(f"flux_1b: {len(moved_wrongly)} parameter leaves unchanged after {FLUX_1B_STEPS + 1} steps"
                        f" where stochastic rounding should have moved ~3 values or more: "
                        f"{[(n, round(expected[n], 1)) for n in moved_wrongly[:8]]}")
    del start
    busy = step_busy_share(trainer, batch)
    mid = FLUX_1B_STEPS // 2
    step_s = sorted(st["step_s"] for st in steps)[mid]
    fb_ms = sorted(st["forward_backward_ms"] for st in steps)[mid]
    opt_ms = sorted(st["optimizer_ms"] for st in steps)[mid]
    report["train_flux_1b"] = dict(
        batch=bsz, latent=64, params=n_params, leaves=len(trainer.params), build_s=build_s, warmup_step_s=warmup_s,
        steps=steps, median_step_s=step_s, imgs_per_s=bsz / step_s, median_forward_backward_ms=fb_ms,
        median_optimizer_ms=opt_ms, peak_memory_gib=peak_gib, launches=counts, launches_by_head_dim=by_dim,
        flash_plan_per_step=flash_plan, optimizer_plan_per_step=opt_plan, unchanged_leaves=expected,
        losses=losses, grad_norms=norms, **busy)
    log(f"  flux_1b ({report['card']}): step {step_s * 1e3:.1f} ms ({bsz / step_s:.2f} imgs/s), forward+backward"
        f" {fb_ms:.1f} ms, optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB, busy {100 * busy['busy_share']:.1f} %"
        f" of a traced step; losses {[round(v, 4) for v in losses]}, grad norms {[round(v, 3) for v in norms]};"
        f" flash launches/step {flash_plan}, update {opt_plan}; leaves unchanged {len(unchanged)} of"
        f" {len(trainer.params)}, each expected to move fewer than 3 values: {not moved_wrongly}"
        f" (largest {max(expected.values(), default=0.0):.2f})")
    return counts, by_dim


# ------------------------------------------------------- sampling surface

SURFACE_STEPS = 6  # each sampler's run (LCM: 4)
SURFACE_PROMPTS = ["a lighthouse at dusk, oil painting", "a red fox in snow", "a bowl of ramen, studio photo",
                   "an astronaut riding a horse"]
IMG2IMG_STEPS, IMG2IMG_STRENGTH = 20, 0.6  # 12 steps run
INVERT_STEPS = 10
# the samplers whose second model call of a step is taken except on the step to 0
TWO_CALLS = ("heun", "dpm2", "dpm2_cfgpp", "dpmpp_sde", "dpmpp_2s_ancestral")


def expected_model_calls(name, sigmas) -> int:
    """The model calls a sampler of sampling/ makes over ``sigmas``, from its
    own gates: one a step, two for TWO_CALLS where the step does not end at
    0 (dpmpp_2s_ancestral: where its ancestral sigma_down is not 0)."""
    from uwudiff_tpu_torch.sampling import get_ancestral_step

    calls = 0
    for s, s_next in zip(sigmas[:-1], sigmas[1:]):
        end = get_ancestral_step(s, s_next)[0] if name == "dpmpp_2s_ancestral" else s_next
        calls += 1 + int(name in TWO_CALLS and end != 0)
    return calls


def synthetic_images(n, res, seed, device):
    """[n, res, res, 3] images in [-0.9, 0.9] made from ``seed``: a sum of
    random plane waves per channel, smooth where noise would not be."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ramp = torch.linspace(-math.pi, math.pi, res, device=device)
    yy, xx = torch.meshgrid(ramp, ramp, indexing="ij")
    f = torch.rand((n, 3, 3), generator=gen, device=device) * 6.0 + 1.0
    img = torch.sin(f[..., 0, None, None] * xx + f[..., 1, None, None] * yy + f[..., 2, None, None])
    return (0.9 * img).permute(0, 2, 3, 1).contiguous()


def small_sdxl_stack(device, dtype):
    """The small SDXL-layout text encoders, UNet and VAE at head dim 64 of
    check_models_vs_cpu, from one seed."""
    from uwudiff_tpu_torch.models import AutoencoderKL, ConcatTextEncoders, SimpleTokenizer, TextEncodingPipeline

    torch.manual_seed(SEED + 21)
    clip = {"preset": "tiny", "hidden_size": 128, "num_heads": 2}
    te = ConcatTextEncoders.from_config(
        [(clip, {"layer_idx": -2}), (clip, {"use_pooled": True, "layer_idx": -2})], device="cpu")
    unet, vae = small_unet("cpu", torch.float32), AutoencoderKL.from_config("tiny", device="cpu",
                                                                             block_out_channels=(32, 64))
    te, unet, vae = (m.to(device=device, dtype=dtype) for m in (te, unet, vae))
    return TextEncodingPipeline(te, [SimpleTokenizer(), SimpleTokenizer()], device=device), unet, vae


def check_img2img_vs_cpu(failures) -> float:
    """image_to_image_sampling (DPM++ 2M, strength 0.6 of 5 steps, CFG) on
    the small SDXL-layout stack: the card in bf16 through the kernels
    against the same weights in fp32 on the CPU, the encoder's draw and the
    start noise injected; the largest difference over the largest latent."""
    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.sampling import image_to_image_sampling, sample_dpmpp_2m

    gen = torch.Generator().manual_seed(SEED + 22)
    images = synthetic_images(2, 64, SEED + 23, "cpu")
    enc_noise, start = torch.randn((2, 2, 32, 32, 4), generator=gen)
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        te, unet, vae = small_sdxl_stack(device, dtype)
        out[device] = image_to_image_sampling(
            unet, te, images.to(device), SURFACE_PROMPTS[:2], ["blurry", ""],
            vae_encode=lambda img, g, vae=vae: vae.encode(img).sample(noise=enc_noise.to(img.device)),
            train_schedule=NoiseSchedule.sdxl(), strength=0.6, num_steps=5, cfg_scale=CFG, vae_std=1 / 0.18215,
            vae_downscale=2, internal_sampling_func=sample_dpmpp_2m, noise=start.to(device), return_latents=True)
    ref = out["cpu"]
    err = ((out["cuda"].float().cpu() - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # the script's card-vs-CPU bound: bf16 weights and activations through a few dozen layers
    log(f"  img2img, small SDXL layout, card bf16 vs CPU fp32: rel err {err:.2e} (tol {tol})")
    if not err <= tol:
        failures.append(f"img2img card vs CPU rel err {err} > {tol}")
    return err


def sync_s(fn, *args, **kwargs):
    """``fn``'s result and its wall seconds, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def peak_run(fn, *args, **kwargs):
    """``fn``'s result, wall seconds, peak GiB and the peak above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result, seconds = sync_s(fn, *args, **kwargs)
    peak = torch.cuda.max_memory_allocated()
    return result, seconds, peak / 2**30, (peak - base) / 2**30


def sampling_surface(report, failures):
    """SDXL at full width through every sampler, img2img and inpainting
    through the VAE encoder, tiled decode and encode, inversion; the
    counts of the img2img request are returned."""
    import functools

    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.models.transformer import BasicTransformerBlock
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, plan_gn, reset_launch_counts
    from uwudiff_tpu_torch.sampling import (
        SAMPLERS,
        LCMDenoiser,
        encode_cfg_inputs,
        euler_latent_sampling,
        get_sigmas_lcm,
        image_to_image_sampling,
        img2img_sigmas,
        karras_sigmas,
    )
    from uwudiff_tpu_torch.serving import Txt2ImgPipeline, sdxl_pipeline

    out = report["sampling"] = {"card": report["card"]}
    out["img2img_vs_cpu_rel_err"] = check_img2img_vs_cpu(failures)
    base, out["build_s"] = sync_s(sdxl_pipeline, "cuda", torch.bfloat16, SEED)
    sched = NoiseSchedule.sdxl()
    karras = functools.partial(karras_sigmas, sigma_min=float(sched.sigma_min), sigma_max=float(sched.sigma_max))
    unet_attn = sum(2 if m.has_cross else 1 for m in base.unet.modules() if isinstance(m, BasicTransformerBlock))
    calls = []

    def unet(*args, **kwargs):  # the UNet, its calls counted
        calls.append(1)
        return base.unet(*args, **kwargs)

    prompts, seeds = SURFACE_PROMPTS[:2], [31, 32]
    with torch.inference_mode():  # the text encoders' launches of one request: one a CLIP layer
        reset_launch_counts()
        sync_s(encode_cfg_inputs, prompts, [""] * 2, RES, RES, base.te)
        te_fwd = launch_counts()["flash_fwd"]
    Txt2ImgPipeline(unet, base.te, base.vae, sched, "cuda")(prompts, num_steps=1, num_samples=2, cfg_scale=CFG,
                                                            return_latents=True, seed=seeds)  # warm-up, 4 rows

    # (a) every sampler, 1024^2, batch 2, Karras (LCM: its own ladder and wrapper, cfg 1)
    runs = {}
    for name, sampler in SAMPLERS.items():
        lcm = name == "lcm"
        steps = 4 if lcm else SURFACE_STEPS
        ladder = functools.partial(get_sigmas_lcm, schedule=sched) if lcm else karras
        pipe = Txt2ImgPipeline(unet, base.te, base.vae, sched, "cuda", sampler=sampler,
                               denoiser_cls=LCMDenoiser if lcm else None)
        calls.clear()
        reset_launch_counts()  # the run starts here
        (lat, _), wall = sync_s(pipe.sample_device, prompts, num_steps=steps, num_samples=2,
                                cfg_scale=1.0 if lcm else CFG, width=RES, height=RES, seed=seeds,
                                return_latents=True, get_sigma_func=ladder)
        counts, by_dim = launch_counts(), launches_by_head_dim()  # and ends here
        want_calls = expected_model_calls(name, ladder(steps))
        want_k1 = te_fwd + unet_attn * len(calls)
        d64 = by_dim["flash_fwd_sm90"].get(64, 0)
        finite = bool(torch.isfinite(lat).all())
        runs[name] = dict(steps=steps, model_calls=len(calls), expected_model_calls=want_calls,
                          flash_fwd=counts["flash_fwd"], expected_flash_fwd=want_k1, flash_fwd_d64=d64, wall_s=wall,
                          ms_per_step=wall * 1e3 / steps, ms_per_model_call=wall * 1e3 / len(calls),
                          latents_std=lat.float().std().item(), finite=finite)
        check_forward_route(counts, f"sampler {name}", failures)
        if len(calls) != want_calls or counts["flash_fwd"] != want_k1 or d64 != want_k1 or not finite:
            failures.append(f"sampler {name}: {runs[name]}")
        log(f"  {name}: {steps} steps, {len(calls)} UNet calls (expected {want_calls}), K1 {counts['flash_fwd']}"
            f" = {te_fwd} + {unet_attn} x {len(calls)} at D = 64: {d64}; {wall:.2f} s,"
            f" {wall * 1e3 / steps:.1f} ms a step; latents finite {finite}")
    out["samplers"] = dict(resolution=RES, batch=2, cfg=CFG, ladder="karras", te_flash_fwd=te_fwd,
                           unet_flash_fwd=unet_attn, runs=runs)
    del lat

    # (b) img2img and inpainting, a batch of 4 through the encoder
    n, std = 4, 1.0 / base.vae.scaling_factor
    images = synthetic_images(n, RES, SEED, "cuda")
    parts = {}

    def encode(img, gen):
        z, parts["encode_s"] = sync_s(lambda: base.vae.encode(img).sample(gen))
        return z

    def decode(lat):
        img, parts["decode_s"] = sync_s(base.vae.decode, lat)
        return img

    i2i = functools.partial(image_to_image_sampling, base.unet, base.te, prompt=SURFACE_PROMPTS, neg_prompt=[""] * n,
                            train_schedule=sched, num_steps=IMG2IMG_STEPS, get_sigma_func=karras, cfg_scale=CFG,
                            seed=SEED, vae_std=std, vae_downscale=base.vae_downscale,
                            internal_sampling_func=SAMPLERS["dpmpp_2m_sde"])
    i2i(init_image=images, vae_encode=encode, vae_decode=decode, strength=0.05)  # warm-up: one step
    gn_calls: list = []
    hooks = record_gn_calls([base.unet, base.vae], gn_calls)
    reset_launch_counts()  # the main run of the phase starts here
    imgs, total_s, peak, above = peak_run(i2i, init_image=images, vae_encode=encode, vae_decode=decode,
                                          strength=IMG2IMG_STRENGTH)
    i2i_counts = launch_counts()  # and ends here
    for h in hooks:
        h.remove()
    steps_run = len(img2img_sigmas(sched, IMG2IMG_STEPS, IMG2IMG_STRENGTH, karras)) - 1
    routes = [plan_gn(*call[:4], torch.bfloat16).route for call in gn_calls]
    gn_plan = {"gn_silu_fused": routes.count("fused"), "gn_stats": routes.count("chunked"),
               "gn_silu_apply": routes.count("chunked")}
    want_k1 = te_fwd + unet_attn * steps_run
    ok_imgs = len(imgs) == n and all(i.shape == (RES, RES, 3) and i.dtype == np.uint8 for i in imgs)
    if not ok_imgs or i2i_counts["flash_fwd"] != want_k1 or any(i2i_counts[k] != v for k, v in gn_plan.items()):
        failures.append(f"img2img: images ok {ok_imgs}, K1 {i2i_counts['flash_fwd']} (expected {want_k1}),"
                        f" GroupNorm {[i2i_counts[k] for k in gn_plan]} against plan_gn's {gn_plan}")
    check_forward_route(i2i_counts, "img2img", failures)
    out["img2img"] = dict(batch=n, steps=IMG2IMG_STEPS, strength=IMG2IMG_STRENGTH, steps_run=steps_run,
                          sampler="dpmpp_2m_sde", ladder="karras", request_s=total_s, encode_s=parts["encode_s"],
                          decode_s=parts["decode_s"], sample_s=total_s - parts["encode_s"] - parts["decode_s"],
                          peak_memory_gib=peak, peak_above_weights_gib=above, launches=i2i_counts,
                          groupnorm_plan=gn_plan, image_stds=[float(i.astype(np.float32).std()) for i in imgs])
    log(f"  img2img ({report['card']}): batch {n} at {RES}^2, {steps_run} of {IMG2IMG_STEPS} steps: {total_s:.2f} s"
        f" (encode {parts['encode_s']:.2f}, sample {out['img2img']['sample_s']:.2f}, decode {parts['decode_s']:.2f});"
        f" peak {peak:.1f} GiB ({above:.1f} above the weights); K1 {i2i_counts['flash_fwd']}, K2"
        f" {i2i_counts['gn_silu_fused']}, K3 {i2i_counts['gn_stats']} + apply {i2i_counts['gn_silu_apply']}")
    with torch.inference_mode():
        init_latent = base.vae.encode(images).sample(torch.Generator(device="cuda").manual_seed(SEED)) / std
    mask = torch.zeros((n, RES // 8, RES // 8, 1), device="cuda")
    mask[:, :, RES // 16:] = 1.0  # the right half repainted, the left kept
    inpainted, inpaint_s = sync_s(i2i, init_image=None, init_latent=init_latent, inpaint_mask=mask,
                                  strength=IMG2IMG_STRENGTH, return_latents=True)
    keep = (mask == 0).expand_as(inpainted)
    kept_exact = bool(torch.equal(inpainted[keep], (init_latent * std + 0.0)[keep]))
    moved = (inpainted[~keep] - (init_latent * std)[~keep]).abs().max().item()
    if not kept_exact or not bool(torch.isfinite(inpainted).all()) or not moved > 0:
        failures.append(f"inpaint: kept half exact {kept_exact}, repainted half moved {moved}")
    out["inpaint"] = dict(request_s=inpaint_s, kept_half_bitwise=kept_exact, repainted_max_move=moved)
    log(f"  inpaint: {inpaint_s:.2f} s; kept half bitwise the init latents {kept_exact}; repainted moved {moved:.3f}")

    # (c) tiled decode and encode at 1024^2: 64-latent / 512-pixel tiles
    lat = init_latent * std
    tile_calls: list = []
    hooks = record_gn_calls([base.vae], tile_calls)
    with torch.inference_mode():
        whole, dec_s, dec_peak, dec_above = peak_run(base.vae.decode, lat)
        tiled, tdec_s, tdec_peak, tdec_above = peak_run(base.vae.decode_tiled, lat, tile=64, overlap=16)
        single_dec = bool(torch.equal(base.vae.decode_tiled(lat, tile=RES // 8), whole))
        dec_diff = (tiled - whole).abs().max().item()
        del whole, tiled
        ewhole, enc_s, enc_peak, enc_above = peak_run(base.vae.encode, images)
        etiled, tenc_s, tenc_peak, tenc_above = peak_run(base.vae.encode_tiled, images, tile=512, overlap=128)
        esingle = base.vae.encode_tiled(images, tile=RES)
        single_enc = bool(torch.equal(esingle.mean, ewhole.mean) and torch.equal(esingle.logvar, ewhole.logvar))
        enc_diff = (etiled.mean - ewhole.mean).abs().max().item()
    for h in hooks:
        h.remove()
    if not (single_dec and single_enc) or not math.isfinite(dec_diff + enc_diff):
        failures.append(f"tiles: single-tile decode bitwise {single_dec}, encode {single_enc};"
                        f" diffs {dec_diff}, {enc_diff}")
    out["tiles"] = dict(batch=n, decode=dict(untiled_s=dec_s, tiled_s=tdec_s, untiled_peak_gib=dec_peak,
                                             tiled_peak_gib=tdec_peak, untiled_above_gib=dec_above,
                                             tiled_above_gib=tdec_above, max_abs_diff=dec_diff,
                                             single_tile_bitwise=single_dec, tile=64, overlap=16),
                        encode=dict(untiled_s=enc_s, tiled_s=tenc_s, untiled_peak_gib=enc_peak,
                                    tiled_peak_gib=tenc_peak, untiled_above_gib=enc_above,
                                    tiled_above_gib=tenc_above, mean_max_abs_diff=enc_diff,
                                    single_tile_bitwise=single_enc, tile=512, overlap=128))
    log(f"  tiles ({report['card']}): decode untiled {dec_s:.2f} s / {dec_above:.1f} GiB above the weights, 3x3 tiles"
        f" {tdec_s:.2f} s / {tdec_above:.1f} GiB, max diff {dec_diff:.3f}; encode untiled {enc_s:.2f} s /"
        f" {enc_above:.1f} GiB, tiled {tenc_s:.2f} s / {tenc_above:.1f} GiB, mean max diff {enc_diff:.3f};"
        f" one tile bitwise: decode {single_dec}, encode {single_enc}")

    # (d) inversion: image -> noise -> image, batch 2, Euler (eta 0), the conditional pass
    x0 = init_latent[:2]
    inv_runs = {}
    latents = x0
    for direction in ("image_to_noise", "noise_to_image"):
        reset_launch_counts()
        latents, wall = sync_s(euler_latent_sampling, latents, base.unet, base.te, sched, prompts, ["", ""],
                               image_to_noise=direction == "image_to_noise", cfg_scale=1.0, num_steps=INVERT_STEPS,
                               seed=SEED)
        k1 = launch_counts()["flash_fwd"]
        inv_runs[direction] = dict(wall_s=wall, flash_fwd=k1, latents_std=latents.float().std().item())
        if k1 != te_fwd + unet_attn * INVERT_STEPS or not bool(torch.isfinite(latents).all()):
            failures.append(f"inversion {direction}: K1 {k1}, expected {te_fwd + unet_attn * INVERT_STEPS}")
    rel_rms = ((latents - x0).pow(2).mean().sqrt() / x0.pow(2).mean().sqrt()).item()
    out["inversion"] = dict(batch=2, steps=INVERT_STEPS, cfg=1.0, runs=inv_runs, reconstruction_rel_rms=rel_rms)
    log(f"  inversion: {INVERT_STEPS} steps each way, {inv_runs['image_to_noise']['wall_s']:.2f} +"
        f" {inv_runs['noise_to_image']['wall_s']:.2f} s; reconstruction rel RMS {rel_rms:.3f} (random weights)")

    # (f) the GroupNorm calls of (b) and (c) phase 2 did not hold
    out["gn_call_checks"] = check_gn_calls(gn_calls + tile_calls, failures, backward=False)
    return i2i_counts


# ------------------------------------------------------------------- DiT

DIT_STEPS = 16
DIT_CFG = 4.0
DIT_LABELS = [207, 360, 387, 974, 88, 979, 417, 279]  # ImageNet classes, one sample each
DIT_SEED = 31
DIT_TRAIN_STEPS = 5


def dit_vae():
    """The DiT family's VAE (SD1.x's, ``sd15``) in bf16 on the card, from the
    seed, and its latents' std (1 / scaling_factor)."""
    from uwudiff_tpu_torch.models import AutoencoderKL

    torch.manual_seed(SEED + 21)
    vae = AutoencoderKL.from_config("sd15", device="cuda", dtype=torch.bfloat16)
    return vae, 1.0 / vae.scaling_factor


def check_dit_vs_cpu(failures):
    """A 2-block DiT at dit_xl_2's width (1152, 16 heads of 72; the
    zero-initialised leaves drawn): the card's bf16 forward through the
    kernels against the same weights' fp32 forward on the CPU through the
    plain versions, which the CPU tests hold against the JAX package; 256
    tokens (32x32 latents), labels and the null class, learn_sigma off."""
    import copy

    from uwudiff_tpu_torch.models import DiT
    from uwudiff_tpu_torch.ops import launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    torch.manual_seed(SEED + 22)
    cpu = fill_zero_initialised(DiT.from_config("dit_xl_2", device="cuda", depth=2)).cpu()
    gpu = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 23)
    x = torch.randn((4, 32, 32, 4), generator=gen)
    t = torch.tensor([10.5, 731.25, 250.0, 999.0])
    labels = torch.tensor([1, 999, 1000, 417])
    with torch.inference_mode():
        ref = cpu(x, t, labels)
        reset_launch_counts()
        out = gpu(x.cuda(), t.cuda(), labels.cuda())
        launches = launches_by_head_dim()["flash_fwd_sm90"]
    err = ((out.float().cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()
    finite = bool(torch.isfinite(out).all())
    tol = 5e-2  # bf16 weights and activations through two blocks, as check_models_vs_cpu
    log(f"  dit (2 blocks, width 1152, 16 heads of 72) card bf16 vs CPU fp32 plain: rel err {err:.2e} (tol {tol});"
        f" |ref| max {ref.abs().max().item():.3e}; flash_fwd_sm90 launches by head dim {launches}")
    if not (finite and err <= tol and ref.abs().max() > 0 and launches == {72: 2}):
        failures.append(f"dit card vs CPU: rel err {err} (tol {tol}), finite {finite}, launches {launches}"
                        " ({72: 2} expected)")
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"rel_err": err, "tol": tol, "flash_fwd_launches_by_head_dim": {str(k): v for k, v in launches.items()}}


def dit_step_phases(model, vae, vae_std, n, res):
    """One request batch of n labels at res^2, phase by phase: one CFG
    step of the DiT on the doubled batch (CUDA events, the median of 3), the
    card's busy share over one step (torch.profiler: device time over the
    traced wall time), and the decode."""
    from torch.profiler import ProfilerActivity, profile

    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.sampling import KDiffusionDenoiser, build_class_cfg_fn

    out = {}
    with torch.inference_mode():
        den = KDiffusionDenoiser(model_fn=lambda x, t, class_labels=None: model(x, t, class_labels),
                                 schedule=NoiseSchedule.sd15().to("cuda"))
        step = build_class_cfg_fn(den, torch.tensor(DIT_LABELS[:n], device="cuda"), 1000, DIT_CFG)
        x = torch.randn((n, res // 8, res // 8, 4), device="cuda")
        sigma = torch.full((n,), 5.0, device="cuda")
        out["step_ms"] = time_ms(lambda: step(x, sigma), reps=1, warmup=1, runs=3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(x, sigma)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(ev.time_range.elapsed_us() for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out.update(traced_step_window_ms=window_ms, traced_step_busy_ms=busy_ms, busy_share=busy_ms / window_ms)
        t0 = time.perf_counter()
        vae.decode(x * vae_std)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
    return out


def dit(report, failures):
    """DiT-XL/2 class-conditional sampling at full width through
    sampling.class_conditional_sampling: 8 labels at 256x256 (CFG 4.0 over
    the doubled batch with the null class, Euler-ancestral, DIT_STEPS steps,
    the sd15 VAE's decode), then a lone label at 256x256 and a lone 512x512
    request (64x64 latents, 1024 tokens)."""
    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.models import DiT
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.sampling import class_conditional_sampling
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    report["dit_vs_cpu"] = check_dit_vs_cpu(failures)
    t0 = time.perf_counter()
    torch.manual_seed(SEED + 20)
    model = fill_zero_initialised(DiT.from_config("dit_xl_2", device="cuda", dtype=torch.bfloat16))
    vae, vae_std = dit_vae()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = {"dit": sum(p.numel() for p in model.parameters()), "vae": sum(p.numel() for p in vae.parameters())}
    log(f"  built dit_xl_2 + the sd15 vae in {build_s:.1f} s: {n_params}; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    schedule = NoiseSchedule.sd15().to("cuda")
    calls = []

    def unet_fn(x, t, labels):
        calls.append(x.shape[0])
        return model(x, t, labels)

    def run(labels, res, **kw):
        return class_conditional_sampling(unet_fn, schedule, labels, model.num_classes, vae_decode=vae.decode,
                                          num_steps=DIT_STEPS, cfg_scale=DIT_CFG, seed=DIT_SEED, width=res,
                                          height=res, vae_std=vae_std, device="cuda", **kw)

    t0 = time.perf_counter()
    for labels, res in ((DIT_LABELS, 256), (DIT_LABELS[:1], 512)):  # one pass per shape
        class_conditional_sampling(unet_fn, schedule, labels, model.num_classes, num_steps=1, cfg_scale=DIT_CFG,
                                   width=res, height=res, device="cuda")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    gn_calls: list = []
    hooks = record_gn_calls([vae], gn_calls)
    runs, counts_total, d72_total = {}, None, 0
    for name, labels, res in (("batch_8_256", DIT_LABELS, 256), ("lone_256", DIT_LABELS[:1], 256),
                              ("lone_512", DIT_LABELS[:1], 512)):
        calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        images = run(labels, res)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts, by_dim = launch_counts(), launches_by_head_dim()  # and ends here
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        counts_total = counts if counts_total is None else {k: counts_total[k] + v for k, v in counts.items()}
        n = len(labels)
        # Euler-ancestral: one model call a step on the doubled batch, 28 K1 a call, all at D = 72
        want = 28 * DIT_STEPS
        d72 = by_dim["flash_fwd_sm90"].get(72, 0)
        d72_total += d72
        check_forward_route(counts, f"dit {name}", failures)
        if calls != [2 * n] * DIT_STEPS or by_dim["flash_fwd_sm90"] != {72: want}:
            failures.append(f"dit {name}: model calls {calls} ({DIT_STEPS} of {2 * n} expected), flash_fwd_sm90 by"
                            f" head dim {by_dim['flash_fwd_sm90']} ({{72: {want}}} expected)")
        stds = [float(img.astype(np.float32).std()) for img in images]
        if len(images) != n or any(img.shape != (res, res, 3) or img.dtype != np.uint8 for img in images) or \
                not all(sd > 0 for sd in stds):
            failures.append(f"dit {name}: {len(images)} images, shapes {[i.shape for i in images]}, stds {stds}")
        runs[name] = dict(labels=n, resolution=res, tokens=(res // 16) ** 2, wall_s=wall_s, imgs_per_s=n / wall_s,
                          step_ms_wall=wall_s * 1e3 / DIT_STEPS, peak_memory_gib=peak_gib, launches=counts,
                          flash_fwd_d72=d72, model_calls=list(calls), image_stds=stds)
    for h in hooks:
        h.remove()
    lat = run(DIT_LABELS[:2], 256, return_latents=True)
    lat_std = lat.float().std().item()
    if not (bool(torch.isfinite(lat).all()) and lat_std > 0 and lat.shape == (2, 32, 32, 4)):
        failures.append(f"dit latents: finite {bool(torch.isfinite(lat).all())}, std {lat_std}, {tuple(lat.shape)}")
    phases = {f"batch_{n}_{res}": dit_step_phases(model, vae, vae_std, n, res) for n, res in ((8, 256), (1, 512))}
    gn_checks = check_gn_calls(gn_calls, failures, backward=False)
    report["dit"] = dict(model="dit_xl_2", steps=DIT_STEPS, cfg=DIT_CFG, params=n_params, build_s=build_s,
                         warmup_s=warmup_s, runs=runs, latents_std=lat_std, phases=phases, gn_call_checks=gn_checks)
    log(f"  dit_xl_2 ({report['card']}): " + "; ".join(
        f"{k} {r['wall_s']:.2f} s ({r['step_ms_wall']:.1f} ms a step, {r['imgs_per_s']:.2f} imgs/s,"
        f" peak {r['peak_memory_gib']:.1f} GiB, D = 72 launches {r['flash_fwd_d72']})" for k, r in runs.items())
        + f"; latents std {lat_std:.3f}")
    log(f"  dit phases: {json.dumps(phases)}")
    del model, vae
    return counts_total, d72_total


def check_dit_train_vs_cpu(failures):
    """One training step of a 2-block DiT at dit_xl_2's width (1152, 16
    heads of 72), the zero-initialised leaves drawn: bf16 compute over fp32
    masters on the card through the kernels (the recipe's precision),
    against the same weights in fp32 on the CPU through the plain versions,
    which the CPU tests hold against the JAX package's step; the same
    noise, timesteps and label-drop mask. Checks the loss and every leaf's
    gradient, and the card's launches: K1, K4 and K6 once a block, at
    D = 72."""
    import copy

    from uwudiff_tpu_torch.diffusion import DiffusionLoss, NoiseSchedule
    from uwudiff_tpu_torch.models import DiT
    from uwudiff_tpu_torch.ops import launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training import DMTrainer
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    torch.manual_seed(SEED + 24)
    cpu = fill_zero_initialised(DiT.from_config("dit_xl_2", device="cuda", depth=2)).cpu()
    gpu = copy.deepcopy(cpu).to(device="cuda")
    gen = torch.Generator().manual_seed(SEED + 25)
    batch = {"sample": torch.randn((4, 32, 32, 4), generator=gen), "class_labels": torch.tensor([3, 207, 999, 1])}
    noise = torch.randn((4, 32, 32, 4), generator=gen)
    timesteps = torch.tensor([37, 712, 250, 999])
    drop = torch.tensor([False, True, False, False])
    tol, leaf_tol = 5e-2, 1e-1  # bf16 weights, activations and gradients through two blocks, as for Flux
    losses, grads = {}, {}
    for dev, unet, cdt in (("cpu", cpu, None), ("cuda", gpu, "bfloat16")):
        tr = DMTrainer({"unet": unet}, loss_config=DiffusionLoss(schedule=NoiseSchedule.sd15()), optimizer="adamw",
                       compute_dtype=cdt, device=dev)
        reset_launch_counts()
        loss, _ = tr.forward_backward(batch, noise, timesteps, drop_mask=drop)
        by_dim = launches_by_head_dim()
        losses[dev] = loss.float().cpu()
        grads[dev] = {n: p.grad.float().cpu() for n, p in tr.params}
    launches = {k: by_dim[k] for k in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")}
    loss_err = ((losses["cuda"] - losses["cpu"]).abs() / losses["cpu"].abs()).item()
    flat = {dev: torch.cat([g.flatten() for g in grads[dev].values()]) for dev in grads}
    grad_err = ((flat["cuda"] - flat["cpu"]).norm() / flat["cpu"].norm()).item()
    # the k projection's bias has a zero gradient in exact arithmetic (softmax
    # ignores a shift of a row's logits): held against the tree's largest
    scale = max(g.norm() for g in grads["cpu"].values())
    leaf_errs = {n: ((grads["cuda"][n] - g).norm() / (g.norm() if not n.endswith("k.bias") else scale)).item()
                 for n, g in grads["cpu"].items()}
    worst = max(leaf_errs, key=leaf_errs.get)
    log(f"  dit_xl_2 width (2 blocks) training step, card bf16 over fp32 masters vs CPU fp32 plain: loss rel err"
        f" {loss_err:.2e}, grads |d|/|ref| {grad_err:.2e} (tol {tol}), worst leaf {worst} {leaf_errs[worst]:.2e}"
        f" (tol {leaf_tol}); launches {launches}")
    want = {"flash_fwd_sm90": {72: 2}, "flash_bwd_dq_sm90": {72: 2}, "flash_bwd_dkv_sm90": {72: 2}}
    if not (loss_err <= tol and grad_err <= tol and leaf_errs[worst] <= leaf_tol and launches == want):
        failures.append(f"dit_xl_2-width training step card vs CPU: loss {loss_err} grads {grad_err} (tol {tol}),"
                        f" {worst} {leaf_errs[worst]} (tol {leaf_tol}), launches {launches}")
    del cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err, worst_leaf=worst, worst_leaf_rel_err=leaf_errs[worst],
                launches={k: {str(d): n for d, n in v.items()} for k, v in launches.items()}, tol=tol,
                leaf_tol=leaf_tol)


def train_dit(report, failures):
    """bench.py's dit_xl_2 training step at full width
    (training/bench_setup.py, model="dit_xl_2": 28 blocks at width 1152, 16
    heads of 72, batch 64, 32x32x4 latents, class labels with dropout 0.1,
    fp32 masters under bf16 compute, adamw, global clip 1.0): one warm-up
    step, DIT_TRAIN_STEPS timed."""
    from uwudiff_tpu_torch.ops import launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

    report["dit_train_step_vs_cpu"] = check_dit_train_vs_cpu(failures)
    t0 = time.perf_counter()
    trainer, data = build_trainer_and_batch(model="dit_xl_2", seed=SEED)
    trainer.setup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bsz = len(data["sample"])
    dev = trainer.device
    batch = {"sample": torch.as_tensor(data["sample"], device=dev),
             "class_labels": torch.as_tensor(data["class_labels"], device=dev)}
    n_params = sum(m.numel() for m in trainer.masters)
    start = [m.cpu() for m in trainer.masters]  # in host memory: the peak below is the step's own
    log(f"  built the dit_xl_2 trainer ({n_params / 1e9:.3f} G fp32 masters under bf16 compute, {len(start)} leaves)"
        f" in {build_s:.1f} s")
    t0 = time.perf_counter()
    warm, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the main path's run starts here
    steps = []
    for _ in range(DIT_TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics, _ = trainer.train_step(batch)
        torch.cuda.synchronize()
        phases = trainer.step_phase_ms()
        steps.append(dict(step_s=time.perf_counter() - t0, loss=metrics["train/loss"].item(),
                          grad_norm=metrics["train/grad_norm"].item(), lr=metrics["train/lr"], **phases))
    counts = launch_counts()  # the main path's run ends here
    by_dim = launches_by_head_dim()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # 28 K1, 28 K4 and 28 K6 a step, all at D = 72 on the Hopper kernels;
    # the update is eager (optax's adamw was XLA): no kernel of the repo's
    blocks = len(trainer.unet.block_names)
    for name in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
        want = {72: blocks * DIT_TRAIN_STEPS}
        if by_dim[name] != want or counts[name] != sum(want.values()):
            failures.append(f"dit_xl_2 {name}: {by_dim[name]} by head dim in {DIT_TRAIN_STEPS} steps, {want} planned")
    check_forward_route(counts, "dit_xl_2", failures)
    check_backward_route(counts, "dit_xl_2", failures)
    other = {k: v for k, v in counts.items() if v and not k.startswith("flash_")}
    if other or counts["flash_bwd_dq_dbias"]:
        failures.append(f"dit_xl_2: launches of kernels the step does not run: {other}")
    losses = [warm["train/loss"].item()] + [st["loss"] for st in steps]
    norms = [warm["train/grad_norm"].item()] + [st["grad_norm"] for st in steps]
    if not all(map(math.isfinite, losses + norms)) or len(set(losses)) < 2 or not all(n > 0 for n in norms):
        failures.append(f"dit_xl_2 training metrics: losses {losses} grad norms {norms}")
    unmoved = [name for (name, _), m, m0 in zip(trainer.params, trainer.masters, start)
               if torch.equal(m, m0.to(m.device))]
    rounded = all(torch.equal(p.detach(), m.to(torch.bfloat16)) for (_, p), m in zip(trainer.params, trainer.masters))
    if unmoved or not rounded:
        failures.append(f"dit_xl_2: {len(unmoved)} masters unchanged ({unmoved[:8]}), module = bf16(masters) {rounded}")
    del start
    busy = step_busy_share(trainer, batch)
    mid = DIT_TRAIN_STEPS // 2
    step_s = sorted(st["step_s"] for st in steps)[mid]
    fb_ms = sorted(st["forward_backward_ms"] for st in steps)[mid]
    opt_ms = sorted(st["optimizer_ms"] for st in steps)[mid]
    report["train_dit"] = dict(
        batch=bsz, latent=32, params=n_params, leaves=len(trainer.params), build_s=build_s, warmup_step_s=warmup_s,
        steps=steps, median_step_s=step_s, imgs_per_s=bsz / step_s, median_forward_backward_ms=fb_ms,
        median_optimizer_ms=opt_ms, peak_memory_gib=peak_gib, launches=counts,
        launches_by_head_dim={k: {str(d): n for d, n in v.items()} for k, v in by_dim.items()},
        masters_unchanged=unmoved, module_is_bf16_of_masters=rounded, losses=losses, grad_norms=norms, **busy)
    log(f"  dit_xl_2 ({report['card']}): step {step_s * 1e3:.1f} ms ({bsz / step_s:.1f} imgs/s), forward+backward"
        f" {fb_ms:.1f} ms, optimizer {opt_ms:.1f} ms, peak {peak_gib:.1f} GiB, busy {100 * busy['busy_share']:.1f} %"
        f" of a traced step; losses {[round(v, 4) for v in losses]}, grad norms {[round(v, 3) for v in norms]};"
        f" flash launches by head dim {by_dim['flash_fwd_sm90']} / {by_dim['flash_bwd_dq_sm90']} /"
        f" {by_dim['flash_bwd_dkv_sm90']}; masters unchanged {len(unmoved)} of {len(trainer.masters)}")
    return counts, by_dim


# ------------------------------------------------------------- checkpoint

# the mixed burst of phase 12: two weighted prompts (nested emphasis), two long
# ones of ~150 and ~300 BPE tokens, one plain request
WEIGHTED_PROMPTS = ["a (red:1.3) car, [blurry]",
                    "a ((lighthouse)) at (dusk:1.2), [[oil painting]], (detailed:0.8) waves"]
LONG_PHRASES = ["a lighthouse on a rocky coast", "stormy sea at dusk", "oil painting", "dramatic light",
                "seagulls over the waves", "a small red boat", "wet rocks", "heavy clouds", "distant mountains",
                "foam and spray", "golden hour", "highly detailed"]
LONG_TOKENS = (138, 300)  # 2 and 4+ windows of at most 75 tokens, cut after a comma
PLAIN_PROMPT = "a red fox in snow"
CLIP_VOCAB = 49408  # CLIP's vocabulary: 512 byte symbols, 48,894 merges, two specials


def write_vocab(dirname, n_ids, seed):
    """A CLIP vocab.json / merges.txt pair of ``n_ids`` ids: the 256 byte
    symbols in CLIP's order ("!" at 0) and their ``</w>`` forms (ids 0-511),
    the merges in rank order, each product a new token at id 512 + rank, then
    ``<|startoftext|>`` and ``<|endoftext|>`` at the top. The merges: first
    ones drawn from ``seed`` over the non-ASCII byte symbols (no prompt here
    has them), then, last, the merges that spell this script's prompt words
    left to right, so the prompts' tokens are the table's top ids."""
    from uwudiff_tpu_torch.models.tokenizers import _byte_to_unicode

    rng = np.random.default_rng(seed)
    tokens = list(_byte_to_unicode().values())
    tokens += [t + "</w>" for t in tokens]
    known = set(tokens)
    words = sorted({w for text in WEIGHTED_PROMPTS + LONG_PHRASES + [PLAIN_PROMPT]
                    for w in re.findall(r"[a-z]+", text.lower())})
    spelled = []
    for w in words:
        for i in range(1, len(w)):
            end = "</w>" if i == len(w) - 1 else ""
            if w[: i + 1] + end not in known:
                spelled.append((w[:i], w[i] + end))
                known.add(w[: i + 1] + end)
    inner = [c for c in tokens[:256] if not c.isascii()]  # word-inner tokens: either side of a merge
    final = [c + "</w>" for c in inner]  # word-final ones: the right side only
    drawn = []
    while len(drawn) < n_ids - 514 - len(spelled):
        a = inner[min(int(rng.exponential(0.15 * len(inner))), len(inner) - 1)]  # the shorter, older tokens first
        pick = int(rng.integers(len(inner) + len(final)))
        b = inner[pick] if pick < len(inner) else final[pick - len(inner)]
        if a + b in known or len(a + b) > 16:
            continue
        drawn.append((a, b))
        known.add(a + b)
        (final if b.endswith("</w>") else inner).append(a + b)
    merges = drawn + spelled
    tokens += [a + b for a, b in merges] + ["<|startoftext|>", "<|endoftext|>"]
    assert len(tokens) == n_ids == len(set(tokens)), (len(tokens), n_ids)
    vocab, merges_path = os.path.join(dirname, "vocab.json"), os.path.join(dirname, "merges.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return vocab, merges_path


def sdxl_bundle(unet, te, vae, dtype):
    """One A1111-layout state dict of an SDXL-layout stack (OpenCLIP naming
    for the second tower), through the port's export and diffusers_to_ldm."""
    from uwudiff_tpu_torch.models import import_torch as it
    from uwudiff_tpu_torch.models.ldm_checkpoint import diffusers_to_ldm

    tes = [it.export_params(m, it.clip_text_key_map, dtype) for m in te.text_models]
    return diffusers_to_ldm(it.export_params(unet, it.unet_key_map, dtype),
                            it.export_params(vae, it.vae_key_map, dtype), tes, arch="sdxl")


def long_prompt(tok, target):
    """Comma-separated phrases until ``tok`` counts ``target`` tokens."""
    phrases, i = [], 0
    while len(tok.tokenize(", ".join(phrases))) < target:
        phrases.append(LONG_PHRASES[i % len(LONG_PHRASES)])
        i += 1
    return ", ".join(phrases)


def check_checkpoint_vs_cpu(tmp, failures) -> float:
    """The small SDXL-layout stack of check_img2img_vs_cpu written as one fp32
    single-file checkpoint, loaded through loader.apply_load_config on the
    CPU (fp32) and on the card (bf16), with CLIPBPETokenizers over a small
    vocabulary; a weighted long prompt with CFG through 3 Euler-ancestral
    steps, the init latents and step noise given; the largest difference over
    the largest latent."""
    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.loader import ModelLoadConfig, apply_load_config
    from uwudiff_tpu_torch.models import CLIPBPETokenizer, TextEncodingPipeline
    from uwudiff_tpu_torch.models.import_torch import write_safetensors
    from uwudiff_tpu_torch.sampling import KDiffusionDenoiser, build_cfg_fn, encode_cfg_inputs, sample_euler_ancestral

    te, unet, vae = small_sdxl_stack("cpu", torch.float32)
    path = os.path.join(tmp, "small.safetensors")
    write_safetensors(path, sdxl_bundle(unet, te.module, vae, None))
    vocab = write_vocab(tmp, 1024, SEED + 24)
    steps, sched = 3, NoiseSchedule.sdxl()
    sigmas = sched.sample_sigmas_descending(steps).numpy()
    gen = torch.Generator().manual_seed(SEED + 25)
    x0 = torch.randn((2, 32, 32, 4), generator=gen) * float(np.sqrt(1 + sigmas[0] ** 2))
    noise = torch.randn((steps, 2, 32, 32, 4), generator=gen)
    out, windows = {}, None
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        te, unet, vae = small_sdxl_stack(device, dtype)
        with torch.no_grad():  # nothing left of the drawn weights: all comes from the file
            for m in (te.module, unet, vae):
                for p in m.parameters():
                    p.zero_()
        for module, kw in ((unet, {}), (vae, {}), (te.module.text_models[0], {"te_index": 0}),
                           (te.module.text_models[1], {"te_index": 1})):
            apply_load_config(module, ModelLoadConfig(path, **kw))
        tok = CLIPBPETokenizer(*vocab)
        pipe = TextEncodingPipeline(te.module, [tok, CLIPBPETokenizer(*vocab, pad_token="!")], device=device)
        prompts = [WEIGHTED_PROMPTS[1] + ", (" + long_prompt(tok, 200) + ":1.1)", PLAIN_PROMPT]
        with torch.inference_mode():
            enc = encode_cfg_inputs(prompts, ["blurry", ""], 64, 64, pipe, prompt_weighting=True, long_prompt=True)
            windows = enc["ctx"].shape[1] // 77
            cfg_fn = build_cfg_fn(KDiffusionDenoiser(model_fn=unet, schedule=sched.to(device)), enc, CFG)
            draws = noise.to(device)
            out[device] = sample_euler_ancestral(
                cfg_fn, x0.to(device), sigmas,
                lambda shape, s, s_next: draws[int(np.argmin(np.abs(sigmas[:-1] - s)))]).float().cpu()
    ref = out["cpu"]
    err = ((out["cuda"] - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # phase 9's card-vs-CPU bound
    log(f"  small SDXL layout from one file, weighted long prompt ({windows} windows), card bf16 vs CPU fp32:"
        f" rel err {err:.2e} (tol {tol})")
    if not err <= tol or windows < 2:
        failures.append(f"checkpoint card vs CPU rel err {err} > {tol} (windows {windows})")
    return err


def decode_ids(tok, ids) -> str:
    """BPE ids back to the (lower-cased, space-collapsed) text."""
    from uwudiff_tpu_torch.models.tokenizers import _byte_to_unicode

    inv = {i: t for t, i in tok.encoder.items()}
    byte = {c: b for b, c in _byte_to_unicode().items()}
    text = "".join(inv[int(i)] for i in ids).replace("</w>", " ")
    return bytes(32 if c == " " else byte[c] for c in text).decode("utf-8").strip()


def check_prompt_conditioning(te, long_text, failures) -> dict:
    """The weighted and long-prompt conditioning of ``te`` (a
    TextEncodingPipeline over two CLIPBPETokenizers, bigG's pooled second),
    each held exactly against what it should equal, with controls that the
    check must tell apart from it.

    Weighted: the context of WEIGHTED_PROMPTS[0] equals the weights applied
    by hand, in the encoding's dtype, to the unweighted encoding of the
    prompt stripped of its emphasis (the same ids); controls: every weight
    1 (the unweighted encoding) and the weights one token late. Long: the
    pooled vector of ``long_text`` equals that of its first window encoded
    as a short prompt in a batch of as many rows as the long prompt has
    windows (the same shapes through bigG, so the same GEMMs); controls:
    the second window so encoded, and the first window in a batch of one
    (another GEMM shape: bf16 rounding apart)."""
    from uwudiff_tpu_torch.models.long_prompt import tokenize_long
    from uwudiff_tpu_torch.models.prompt_weights import parse_weighted_prompt, tokenize_with_weights

    tok_l, tok_g = te.tokenizers

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    with torch.inference_mode():
        got = te.encode([WEIGHTED_PROMPTS[0]], prompt_weighting=True)[0]
        stripped = "".join(frag for frag, _ in parse_weighted_prompt(WEIGHTED_PROMPTS[0]))
        (toks, w), plain = tokenize_with_weights(tok_l, [WEIGHTED_PROMPTS[0]]), tok_l([stripped])
        ids_same = bool((toks["input_ids"] == plain["input_ids"]).all())
        emb = te.encode([stripped])[0]

        def by_hand(weights):
            scaled = emb * torch.as_tensor(weights, device=emb.device).to(emb.dtype)[..., None]
            return scaled * (emb.mean(dim=(1, 2), keepdim=True) / scaled.mean(dim=(1, 2), keepdim=True))

        weighted = {"exact": torch.equal(got, by_hand(w)), "rel_err": rel(got, by_hand(w)),
                    "control_all_ones": rel(got, emb), "control_one_token_late": rel(got, by_hand(np.roll(w, 1, 1)))}

        windowed = tokenize_long(tok_g, [long_text])[0]
        ids, mask = windowed["input_ids"][0].reshape(-1, 77), windowed["attention_mask"][0].reshape(-1, 77)
        n = ids.shape[0]
        win = [decode_ids(tok_g, ids[k, 1:int(mask[k].sum()) - 1]) for k in range(2)]  # between BOS and EOS
        short = tok_g(win[0])
        first_same = bool((short["input_ids"][0] == ids[0]).all() and (short["attention_mask"][0] == mask[0]).all())
        pooled_long = te.encode([long_text], long_prompt=True)[2][0]
        first_n, second_n = (te.encode([text] * n)[2][0] for text in win)
        first_1 = te.encode([win[0]])[2][0]
        pooled = {"windows": n, "exact": torch.equal(pooled_long, first_n), "rel_err": rel(pooled_long, first_n),
                  "control_second_window": rel(pooled_long, second_n),
                  "control_batch_of_one": rel(pooled_long, first_1)}
    log(f"  weighted context vs the weights by hand on the unweighted encoding (same ids {ids_same}): bitwise"
        f" {weighted['exact']} (rel err {weighted['rel_err']:.2e}); controls: every weight 1"
        f" {weighted['control_all_ones']:.2e}, weights one token late {weighted['control_one_token_late']:.2e}")
    log(f"  long prompt's pooled vs its first window as a short prompt, batch {n} (re-tokenized to the same ids"
        f" {first_same}): bitwise {pooled['exact']} (rel err {pooled['rel_err']:.2e}); controls: the second"
        f" window {pooled['control_second_window']:.2e}, the first at batch 1 {pooled['control_batch_of_one']:.2e}")
    if not (ids_same and weighted["exact"] and first_same and pooled["exact"]):
        failures.append(f"checkpoint prompts: ids same {ids_same} first window same {first_same},"
                        f" weighted {weighted}, pooled {pooled}")
    if not (weighted["control_all_ones"] > 0 and weighted["control_one_token_late"] > 0
            and pooled["control_second_window"] > 0):
        failures.append(f"checkpoint prompts: a control equals the checked result: {weighted}, {pooled}")
    return {"weighted": weighted, "pooled": pooled, "ids_same": ids_same, "first_window_same": first_same}


def checkpoint(report, failures):
    """SDXL served from one single-file fp16 checkpoint and CLIP-size
    vocabulary files, with weighted and long prompts (phase 12)."""
    import shutil
    import tempfile

    from uwudiff_tpu_torch.models import CLIPBPETokenizer
    from uwudiff_tpu_torch.models.import_torch import load_torch_state_dict, write_safetensors
    from uwudiff_tpu_torch.models.ldm_checkpoint import ldm_to_diffusers, split_ldm_checkpoint
    from uwudiff_tpu_torch.models.long_prompt import required_chunks, tokenize_long
    from uwudiff_tpu_torch.ops import FORWARD_KERNELS, launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.serving import BatchingServer, Request, sdxl_pipeline

    out = report["checkpoint"] = {}
    tmp = tempfile.mkdtemp(prefix="chip_ckpt_", dir=ROOT)  # inside the checkout, git-ignored
    try:
        out["small_vs_cpu_rel_err"] = check_checkpoint_vs_cpu(tmp, failures)

        src, t_build = sync_s(sdxl_pipeline, "cuda", torch.bfloat16, SEED)
        modules = {"unet": src.unet, "vae": src.vae, "clip_l": src.te.module.text_models[0],
                   "clip_bigg": src.te.module.text_models[1]}
        with torch.no_grad():  # the weights rounded through fp16, in place
            for m in modules.values():
                for p in m.parameters():
                    p.copy_(p.half())
        bundle = sdxl_bundle(src.unet, src.te.module, src.vae, torch.float16)
        n_params = sum(t.numel() for t in bundle.values())
        need = sum(t.numel() * t.element_size() for t in bundle.values())
        free = shutil.disk_usage(tmp).free
        path = os.path.join(tmp, "sdxl_fp16.safetensors")
        log(f"  {len(bundle)} tensors, {n_params / 1e9:.3f} G params, {need / 2**30:.2f} GiB fp16;"
            f" {free / 2**30:.1f} GiB free in {tmp}")
        if free < need + 2**30:
            failures.append(f"checkpoint: {free} bytes free for a {need}-byte file")
            return None
        size, write_s = sync_s(write_safetensors, path, bundle)
        del bundle
        torch.cuda.empty_cache()
        vocab = write_vocab(tmp, CLIP_VOCAB, SEED + 27)
        log(f"  wrote {size / 2**30:.2f} GiB in {write_s:.1f} s; vocab {os.path.getsize(vocab[0])} +"
            f" merges {os.path.getsize(vocab[1])} bytes")

        timings = {}
        t0 = time.perf_counter()
        pipe = sdxl_pipeline("cuda", torch.bfloat16, SEED + 1, ckpt_path=path, tokenizer_files=[vocab, vocab],
                             load_timings=timings)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"  built from the files in {load_s:.1f} s (module build {load_s - sum(timings.values()):.1f},"
            f" read {timings['read']:.2f}, name mapping {timings['map']:.2f}, copy to the card {timings['copy']:.2f};"
            f" the file's pages warm from the write) vs a random-weight build {t_build:.1f} s")

        # every key of the file was consumed, every leaf is the rounded source's
        sd = load_torch_state_dict(path)
        parts, split = ldm_to_diffusers(sd), split_ldm_checkpoint(sd)
        covered = len(split["unet"]) + len(split["vae"]) + sum(len(p) for p, _ in split["text_encoders"])
        loaded = {"unet": pipe.unet, "vae": pipe.vae, "clip_l": pipe.te.module.text_models[0],
                  "clip_bigg": pipe.te.module.text_models[1]}
        want = {"unet": parts["unet"], "vae": parts["vae"], "clip_l": parts["text_encoders"][0],
                "clip_bigg": parts["text_encoders"][1]}
        leaves, unequal = {}, []
        for name, m in loaded.items():
            if m.loaded_keys != set(want[name]):
                failures.append(f"checkpoint {name}: consumed {len(m.loaded_keys)} of {len(want[name])} keys")
            pairs = list(zip(modules[name].state_dict().items(), m.state_dict().items(), strict=True))
            leaves[name] = len(pairs)
            unequal += [f"{name}.{k}" for (k, a), (_, b) in pairs if not torch.equal(a, b)]
        del sd, parts, split
        if covered != len(load_torch_state_dict(path)) or unequal:
            failures.append(f"checkpoint: {covered} file keys in components; leaves unequal: {unequal[:5]}")
        out.update(file_gib=size / 2**30, params=n_params, free_gib=free / 2**30, write_s=write_s, load_s=load_s,
                   load_timings=timings, random_build_s=t_build, leaves=leaves, leaves_unequal=len(unequal))
        log(f"  strict import: every file key consumed; leaves bitwise the rounded source: {leaves}"
            f" ({len(unequal)} unequal)")

        # a plain request on the source stack and the loaded one, same tokenizers and seed
        src.te.tokenizers = pipe.te.tokenizers
        kw = dict(num_steps=STEPS, num_samples=1, cfg_scale=CFG, width=RES, height=RES, seed=41, return_latents=True)
        lat_src = src.sample_device(PLAIN_PROMPT, **kw)[0]
        lat_file = pipe.sample_device(PLAIN_PROMPT, **kw)[0]
        bitwise = torch.equal(lat_src, lat_file)
        out["plain_request_bitwise"] = bitwise
        log(f"  plain request, loaded stack vs source stack: bitwise {bitwise}")
        if not bitwise:
            failures.append(f"checkpoint: loaded stack's latents differ from the source's by"
                            f" {(lat_src - lat_file).abs().max().item()}")
        del src, modules, lat_src, lat_file
        gc.collect()
        torch.cuda.empty_cache()

        tok_l, tok_g = pipe.te.tokenizers
        longs = [long_prompt(tok_l, n) for n in LONG_TOKENS]
        lens = [len(tok_l.tokenize(t)) for t in longs]
        windows = [required_chunks(pipe.te, t) for t in longs]
        host_ms = {}
        for name, text in (("77", WEIGHTED_PROMPTS[1]), (str(lens[1]), longs[1])):
            fresh = CLIPBPETokenizer(*vocab)  # an empty BPE cache
            t0 = time.perf_counter()
            fresh.tokenize(text)
            cold = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            fresh(text, padding="max_length", truncation=True)
            host_ms[name] = {"cold_ms": cold, "cached_ms": (time.perf_counter() - t0) * 1e3}
        t0 = time.perf_counter()
        tokenize_long(tok_g, longs, weighted=False)
        host_ms["tokenize_long_2_prompts_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"  long prompts: {lens} tokens, {windows} windows; BPE on the host: {json.dumps(host_ms)}")

        prompts = check_prompt_conditioning(pipe.te, longs[1], failures)
        if not (windows[0] == 2 and windows[1] >= 4):
            failures.append(f"checkpoint prompts: windows {windows}, want 2 and at least 4")

        # the mixed burst through the server, one group per (prompt_weighting, long_prompt)
        groups, inner = [], pipe.sample_device
        encode, decode = pipe.te.encode, pipe.decode

        def timed_encode(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = encode(*a, **k)
            torch.cuda.synchronize()
            groups[-1]["encode_s"] += time.perf_counter() - t0
            return r

        def timed_decode(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = decode(*a, **k)
            torch.cuda.synchronize()
            groups[-1]["decode_s"] += time.perf_counter() - t0
            return r

        def recording(**kw):
            groups.append({"key": [kw.get("prompt_weighting", False), kw.get("long_prompt", False)],
                           "requests": len(set(kw["prompt"])), "batch": kw["num_samples"], "encode_s": 0.0,
                           "decode_s": 0.0})
            before, before_d = launch_counts(), launches_by_head_dim()["flash_fwd_sm90"]
            t0 = time.perf_counter()
            result = inner(**kw)
            torch.cuda.synchronize()
            g = groups[-1]
            g["total_s"] = time.perf_counter() - t0
            g["sample_s"] = g["total_s"] - g["encode_s"] - g["decode_s"]
            after, after_d = launch_counts(), launches_by_head_dim()["flash_fwd_sm90"]
            g["k1"] = after["flash_fwd_sm90"] - before["flash_fwd_sm90"]
            g["k1_d64"] = after_d.get(64, 0) - before_d.get(64, 0)
            return result

        pipe.sample_device, pipe.te.encode, pipe.decode = recording, timed_encode, timed_decode
        server = BatchingServer(pipe, buckets=[(RES, RES)], max_batch=4, max_wait_s=0.5)
        burst = [Request(prompt=p, num_steps=STEPS, cfg_scale=CFG, seed=51 + i, width=RES, height=RES,
                         prompt_weighting=True) for i, p in enumerate(WEIGHTED_PROMPTS)]
        burst += [Request(prompt=p, num_steps=STEPS, cfg_scale=CFG, seed=53 + i, width=RES, height=RES,
                          long_prompt=True) for i, p in enumerate(longs)]
        burst.append(Request(prompt=PLAIN_PROMPT, num_steps=STEPS, cfg_scale=CFG, seed=55, width=RES, height=RES))
        server.start()
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            images = [f.result(timeout=900) for f in [server.submit(r) for r in burst]]
            burst_s = time.perf_counter() - t0
            counts = launch_counts()  # and ends here
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            server.stop()
            pipe.sample_device, pipe.te.encode, pipe.decode = inner, encode, decode
        keys = sorted(tuple(g["key"]) for g in groups)
        want_k1 = 44 + 140 * STEPS
        if keys != [(False, False), (False, True), (True, False)] or any(
                g["k1"] != want_k1 or g["k1_d64"] != want_k1 for g in groups):
            failures.append(f"checkpoint burst: groups {[(g['key'], g['k1'], g['k1_d64']) for g in groups]},"
                            f" want one per key with {want_k1} K1 launches at D = 64")
        for name in FORWARD_KERNELS:
            if counts[name] == 0:
                failures.append(f"checkpoint burst: kernel {name} was not launched")
        check_forward_route(counts, "checkpoint", failures)
        for i, img in enumerate(images):
            if img.shape != (RES, RES, 3) or img.dtype.name != "uint8" or int(img.max()) == int(img.min()):
                failures.append(f"checkpoint image {i}: shape {img.shape} dtype {img.dtype} range"
                                f" {img.min()}..{img.max()}")
        with torch.inference_mode():
            lat = pipe.sample_device(longs[1], num_steps=STEPS, num_samples=1, cfg_scale=CFG, width=RES, height=RES,
                                     seed=54, return_latents=True, long_prompt=True)[0]
        if not bool(torch.isfinite(lat).all()):
            failures.append("checkpoint: non-finite latents for the long prompt")
        out.update(long_prompt_tokens=lens, long_prompt_windows=windows, bpe_host=host_ms, prompts=prompts,
                   groups=groups, burst_s=burst_s, peak_memory_gib=peak, launches=counts)
        for g in groups:
            log(f"  group {g['key']} ({g['requests']} requests, batch {g['batch']}): encode {g['encode_s']:.3f} s,"
                f" sample {g['sample_s']:.2f} s, decode {g['decode_s']:.2f} s; K1 {g['k1']} (at D = 64: {g['k1_d64']})")
        log(f"  burst of {len(burst)} in {burst_s:.2f} s; peak {peak:.1f} GiB; launches {counts}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 13: SD3-medium served from its component files
SD3_STEPS = 8
SD3_SKIP = (7, 8, 9)  # Stability's sd3_infer.py SD3.5-medium recipe: blocks 7-9 skipped, scale 2.5
SD3_SLG = 2.5
SD3_SLG_STEPS = 0.2  # the recipe's window: the first 20 % of the steps
SD3_PROMPTS = ["a lighthouse on a rocky coast, golden hour", "a red fox in snow", "stormy sea at dusk, oil painting",
               "a small red boat, wet rocks, heavy clouds"]
SD3_SEEDS = [61, 62, 63, 64]
T5_VOCAB = 32100  # T5's SentencePiece vocabulary: 32,000 pieces and 100 <extra_id_N>


def write_spiece(path, seed):
    """A SentencePiece unigram model of T5's 32,100 pieces: <pad>, </s> and
    <unk> (ids 0-2), "▁" and the printable ASCII characters alone and after
    "▁", every word of this script's prompts as "▁word", then pieces of 2-8
    lower-case letters drawn from ``seed`` (half of them word-initial) to
    id 31,999, scored by a draw, and <extra_id_0..99> at the top."""
    from uwudiff_tpu_torch.models.spiece import serialize_sentencepiece_model

    normal, unknown, control, user = 1, 2, 3, 4
    rng = np.random.default_rng(seed)
    pieces = [("<pad>", 0.0, control), ("</s>", 0.0, control), ("<unk>", 0.0, unknown), ("\u2581", -3.0, normal)]
    chars = [chr(c) for c in range(33, 127)]
    pieces += [(c, -8.0, normal) for c in chars] + [("\u2581" + c, -7.0, normal) for c in chars]
    words = sorted({w for text in SD3_PROMPTS + LONG_PHRASES + WEIGHTED_PROMPTS + [PLAIN_PROMPT]
                    for w in re.findall(r"[a-z]+", text.lower())})
    pieces += [("\u2581" + w, -4.0, normal) for w in words]
    known = {p for p, _, _ in pieces}
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < T5_VOCAB - 100:
        piece = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        piece = ("\u2581" + piece) if rng.random() < 0.5 else piece
        if piece not in known:
            known.add(piece)
            pieces.append((piece, float(-rng.uniform(9.0, 16.0)), normal))
    pieces += [(f"<extra_id_{i}>", 0.0, user) for i in range(100)]
    with open(path, "wb") as f:
        f.write(serialize_sentencepiece_model(pieces))
    return path


def sd3_components(pipe):
    """name -> (module, key map) of an SD3 pipeline, by its diffusers folder."""
    import functools

    from uwudiff_tpu_torch.models import import_torch as it

    clip_l, clip_bigg, t5 = pipe.te.module.text_models
    return {"transformer": (pipe.unet, functools.partial(it.mmdit_key_map, depth=pipe.unet.depth)),
            "text_encoder": (clip_l, it.clip_text_key_map), "text_encoder_2": (clip_bigg, it.clip_text_key_map),
            "text_encoder_3": (t5, it.t5_key_map), "vae": (pipe.vae, it.vae_key_map)}


def write_components(tmp, components, files, sizes):
    """Each component exported in fp16 (export_params and its map) and
    written as a diffusers-layout .safetensors, one at a time; the seconds."""
    from uwudiff_tpu_torch.models import import_torch as it

    t0 = time.perf_counter()
    for name, (module, key_map) in components.items():
        path = files[name] = os.path.join(tmp, f"{name}.safetensors")
        sd = it.export_params(module, key_map, torch.float16)
        sizes[name] = it.write_safetensors(path, sd)
        del sd
        torch.cuda.empty_cache()
    return time.perf_counter() - t0


def unequal_leaves(want: dict, got: dict) -> list:
    """Names of the leaves that are not bitwise equal (or missing), over
    ``want``'s modules by name."""
    bad = []
    for name, module in want.items():
        other = got[name].state_dict()
        bad += [f"{name}.{k}" for k, v in module.state_dict().items() if k not in other or not torch.equal(v, other[k])]
    return bad


def small_sd3_stack(device, dtype):
    """SD3's whole layout at full width and reduced depth, from one seed:
    the sd3_medium MMDiT with 4 blocks (the last context_pre_only), CLIP-L,
    CLIP-bigG and T5-XXL with 2 layers each in SD3's buckets, the
    zero-initialised leaves drawn; built in fp32 on the CPU, then moved."""
    from uwudiff_tpu_torch.models import ConcatTextEncoders, MMDiT, SimpleTokenizer, TextEncodingPipeline
    from uwudiff_tpu_torch.training.bench_setup import SD3_TEXT_ENCODERS, fill_zero_initialised

    torch.manual_seed(SEED + 31)
    te = ConcatTextEncoders.from_config([({**m, "num_layers": 2}, extra) for m, extra in SD3_TEXT_ENCODERS],
                                        device="cpu", zero_for_padding=False, pad_context_to=4096)
    mmdit = fill_zero_initialised(MMDiT.from_config("sd3_medium", device="cpu", depth=4))
    te, mmdit = (m.to(device=device, dtype=dtype) for m in (te, mmdit))
    toks = [SimpleTokenizer(), SimpleTokenizer(), SimpleTokenizer(model_max_length=256)]
    return TextEncodingPipeline(te, toks, device=device), mmdit


def check_sd3_vs_cpu(failures) -> dict:
    """The small SD3 stack through skip-layer guidance (block 1 of 3 joint
    blocks skipped, scale 2.5, CFG 5, the window over the first step):
    2 prompts at 256x256, 3 Euler-ancestral steps on SD3's ladder with the
    init latents and step noise given, the card in bf16 through the kernels
    against the same weights in fp32 on the CPU through the plain versions
    (which the CPU tests hold against the JAX package); the largest
    difference over the largest latent."""
    import functools

    from uwudiff_tpu_torch.diffusion import NoiseSchedule
    from uwudiff_tpu_torch.sampling import RFDenoiser, build_slg_cfg_fn, encode_cfg_inputs, sample_euler_ancestral
    from uwudiff_tpu_torch.serving import sd3_sigmas

    steps, res = 3, 256
    sigmas = np.asarray(sd3_sigmas(steps), np.float32)
    window = (0.5 * float(sigmas[0] + sigmas[1]), float(sigmas[0]) + 1.0)
    gen = torch.Generator().manual_seed(SEED + 32)
    shape = (2, res // 8, res // 8, 16)
    x0 = torch.randn(shape, generator=gen) * float(np.sqrt(1 + sigmas[0] ** 2))
    noise = torch.randn((steps, *shape), generator=gen)
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        te, mmdit = small_sd3_stack(device, dtype)
        sched = NoiseSchedule.sdxl().to(device)
        with torch.inference_mode():
            enc = encode_cfg_inputs(SD3_PROMPTS[:2], ["blurry", ""], res, res, te)
            fn = build_slg_cfg_fn(RFDenoiser(model_fn=mmdit, schedule=sched),
                                  RFDenoiser(model_fn=functools.partial(mmdit, skip_layers=(1,)), schedule=sched),
                                  enc, CFG, SD3_SLG, slg_interval=window)
            draws = noise.to(device)
            out[device] = sample_euler_ancestral(
                fn, x0.to(device), sigmas,
                lambda shape_, s, s_next: draws[int(np.argmin(np.abs(sigmas[:-1] - s)))]).float().cpu()
        del te, mmdit
        gc.collect()
    ref = out["cpu"]
    err = ((out["cuda"] - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # the script's card-vs-CPU bound: bf16 weights and activations through a few dozen layers
    log(f"  small SD3 layout (4 MMDiT blocks, 2-layer towers, full widths), SLG, card bf16 vs CPU fp32:"
        f" rel err {err:.2e} (tol {tol})")
    if not (err <= tol and bool(torch.isfinite(out["cuda"]).all())):
        failures.append(f"sd3 card vs CPU rel err {err} > {tol}")
    torch.cuda.empty_cache()
    return {"rel_err": err, "tol": tol}


def t5_host_ms(tok, text) -> dict:
    """SentencePiece on the host: a prompt's Viterbi and its 256-token call."""
    t0 = time.perf_counter()
    n = len(tok.tokenize(text))
    viterbi = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tok([text], padding=True)
    return {"pieces": n, "tokenize_ms": viterbi, "call_ms": (time.perf_counter() - t0) * 1e3}


def sd3(report, failures):
    """SD3-medium served from its component files, with skip-layer guidance,
    and Flux read from files (phase 13)."""
    import functools
    import shutil
    import tempfile

    from uwudiff_tpu_torch.models import FLUX_PRESETS
    from uwudiff_tpu_torch.models import import_torch as it
    from uwudiff_tpu_torch.ops import FORWARD_KERNELS, launch_counts, launches_by_head_dim, reset_launch_counts
    from uwudiff_tpu_torch.serving import BatchingServer, Request, flux_txt2img, sd3_pipeline, sd3_sigmas
    from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

    out = report["sd3"] = {}
    out["small_vs_cpu"] = check_sd3_vs_cpu(failures)
    tmp = tempfile.mkdtemp(prefix="chip_sd3_", dir=ROOT)  # inside the checkout, git-ignored
    try:
        # (b) the full-width stack's random bf16 weights rounded through fp16, written and read back
        src, t_build = sync_s(sd3_pipeline, "cuda", torch.bfloat16, SEED)
        comps = sd3_components(src)
        with torch.no_grad():
            for module, _ in comps.values():
                for p in module.parameters():
                    p.copy_(p.half())
        n_params = {name: sum(p.numel() for p in m.parameters()) for name, (m, _) in comps.items()}
        need = 2 * sum(n_params.values())
        free = shutil.disk_usage(tmp).free
        log(f"  sd3_medium stack {sum(n_params.values()) / 1e9:.3f} G params {n_params}, built in {t_build:.1f} s;"
            f" {need / 2**30:.2f} GiB of fp16 files, {free / 2**30:.1f} GiB free in {tmp}")
        if free < need + 4 * 2**30:
            failures.append(f"sd3: {free} bytes free for {need} bytes of files")
            return None
        files, sizes = {}, {}
        write_s = write_components(tmp, comps, files, sizes)
        vocab = write_vocab(tmp, CLIP_VOCAB, SEED + 33)
        spm = write_spiece(os.path.join(tmp, "spiece.model"), SEED + 34)
        log(f"  wrote {sum(sizes.values()) / 2**30:.2f} GiB in {write_s:.1f} s ({json.dumps(sizes)});"
            f" spiece.model {os.path.getsize(spm)} bytes")
        timings = {}
        pipe, load_s = sync_s(sd3_pipeline, "cuda", torch.bfloat16, SEED + 1, component_files=files,
                              tokenizer_files=[vocab, vocab, spm], load_timings=timings)
        loaded = sd3_components(pipe)
        keys_bad = [name for name, (m, _) in loaded.items()
                    if m.loaded_keys != set(it.load_torch_state_dict(files[name]))]
        unequal = unequal_leaves({k: m for k, (m, _) in comps.items()}, {k: m for k, (m, _) in loaded.items()})
        leaves = {name: len(m.state_dict()) for name, (m, _) in loaded.items()}
        log(f"  built from the files in {load_s:.1f} s (read {timings['read']:.2f}, name mapping {timings['map']:.2f},"
            f" copy to the card {timings['copy']:.2f}; the files' pages warm from the write) vs a random-weight"
            f" build {t_build:.1f} s; leaves {leaves}, {len(unequal)} unequal, keys not all consumed: {keys_bad}")
        if unequal or keys_bad:
            failures.append(f"sd3 files: leaves unequal {unequal[:5]}, keys not consumed in {keys_bad}")
        out.update(params=n_params, free_gib=free / 2**30, file_bytes=sizes, write_s=write_s, load_s=load_s,
                   load_timings=timings, random_build_s=t_build, leaves=leaves, leaves_unequal=len(unequal))
        del src, comps
        gc.collect()
        torch.cuda.empty_cache()

        tok_t5 = pipe.te.tokenizers[2]
        long_t5 = ", ".join((LONG_PHRASES * 8))
        t5_ms = {"cold_77": t5_host_ms(tok_t5, SD3_PROMPTS[0]), "long": t5_host_ms(tok_t5, long_t5)}
        ids = tok_t5([SD3_PROMPTS[0], long_t5], padding=True)
        log(f"  T5 SentencePiece on the host: {json.dumps(t5_ms)}; ids {ids['input_ids'].shape}, lengths"
            f" {ids['attention_mask'].sum(1).tolist()}")
        if ids["input_ids"].shape != (2, 256) or int(ids["attention_mask"][1].sum()) != 256:
            failures.append(f"sd3 T5 tokens: shape {ids['input_ids'].shape}, long prompt's"
                            f" {int(ids['attention_mask'][1].sum())} (256 expected)")

        # (c) a burst of 4 through the server: one group, 8 CFG rows; then a lone SLG request
        per_encode = sum(len(m.layer_names) for m in pipe.te.module.text_models)
        joint = len(pipe.unet.block_names) + 1
        groups, inner = [], pipe.sample_device
        encode, decode = pipe.te.encode, pipe.decode

        def timed(fn, key):
            def wrapped(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                groups[-1][key] += time.perf_counter() - t0
                return r
            return wrapped

        def recording(**kw):
            groups.append({"requests": len(kw["prompt"]), "batch": kw["num_samples"], "encode_s": 0.0,
                           "decode_s": 0.0})
            before, before_d = launch_counts(), launches_by_head_dim()["flash_fwd_sm90"]
            t0 = time.perf_counter()
            result = inner(**kw)
            torch.cuda.synchronize()
            g = groups[-1]
            g["total_s"] = time.perf_counter() - t0
            g["sample_s"] = g["total_s"] - g["encode_s"] - g["decode_s"]
            after, after_d = launch_counts(), launches_by_head_dim()["flash_fwd_sm90"]
            g["k1"] = after["flash_fwd_sm90"] - before["flash_fwd_sm90"]
            g["k1_d64"] = after_d.get(64, 0) - before_d.get(64, 0)
            return result

        inner(SD3_PROMPTS, num_steps=1, num_samples=4, cfg_scale=CFG, width=RES, height=RES, seed=SD3_SEEDS)
        torch.cuda.synchronize()  # one warm-up pass at the burst's batch
        pipe.sample_device, pipe.te.encode, pipe.decode = recording, timed(encode, "encode_s"), timed(decode,
                                                                                                      "decode_s")
        server = BatchingServer(pipe, buckets=[(RES, RES)], max_batch=4, max_wait_s=0.5)
        burst = [Request(prompt=p, num_steps=SD3_STEPS, cfg_scale=CFG, seed=sd, width=RES, height=RES)
                 for p, sd in zip(SD3_PROMPTS, SD3_SEEDS)]
        server.start()
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            images = [f.result(timeout=900) for f in [server.submit(r) for r in burst]]
            burst_s = time.perf_counter() - t0
            counts = launch_counts()  # and ends here
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            server.stop()
            pipe.sample_device, pipe.te.encode, pipe.decode = inner, encode, decode
        want_k1 = per_encode + joint * SD3_STEPS
        if [(g["batch"], g["k1"], g["k1_d64"]) for g in groups] != [(4, want_k1, want_k1)] or per_encode != 68:
            failures.append(f"sd3 burst: groups {groups}, want one of batch 4 with {want_k1} K1 launches at D = 64"
                            f" (an encode {per_encode}, 68 expected)")
        for name in FORWARD_KERNELS:
            if counts[name] == 0:
                failures.append(f"sd3 burst: kernel {name} was not launched")
        check_forward_route(counts, "sd3", failures)
        for i, img in enumerate(images):
            if img.shape != (RES, RES, 3) or img.dtype.name != "uint8" or int(img.max()) == int(img.min()):
                failures.append(f"sd3 image {i}: shape {img.shape} dtype {img.dtype} range {img.min()}..{img.max()}")

        sigmas = np.asarray(sd3_sigmas(SD3_STEPS), np.float32)
        n_in = int(np.ceil(SD3_SLG_STEPS * SD3_STEPS))  # steps 0 .. n_in - 1
        window = (0.5 * float(sigmas[n_in - 1] + sigmas[n_in]), float(sigmas[0]) + 1.0)
        slg = dict(unet_skip_fn=functools.partial(pipe.unet, skip_layers=SD3_SKIP), slg_scale=SD3_SLG,
                   slg_interval=window)
        kw = dict(num_steps=SD3_STEPS, num_samples=1, cfg_scale=CFG, width=RES, height=RES, seed=71)
        lone = {}
        for name, extra in (("slg_image", dict(slg)), ("slg", dict(slg, return_latents=True)),
                            ("plain", dict(return_latents=True)),
                            ("slg_scale_0", dict(slg, slg_scale=0.0, return_latents=True))):
            reset_launch_counts()
            (res_, _), secs = sync_s(pipe.sample_device, SD3_PROMPTS[1], **kw, **extra)
            lone[name] = dict(seconds=secs, k1=launch_counts()["flash_fwd_sm90"], out=res_)
        want = {"slg_image": per_encode + (joint + joint - len(SD3_SKIP)) * SD3_STEPS,
                "plain": per_encode + joint * SD3_STEPS}
        want["slg"], want["slg_scale_0"] = want["slg_image"], want["plain"]
        img = lone["slg_image"]["out"]
        bitwise = torch.equal(lone["slg_scale_0"]["out"], lone["plain"]["out"])
        moved = (lone["slg"]["out"] - lone["plain"]["out"]).abs().max().item()
        finite = bool(torch.isfinite(lone["slg"]["out"]).all())
        log(f"  lone SLG request (skip {SD3_SKIP}, scale {SD3_SLG}, window {window} over {n_in} of {SD3_STEPS}"
            f" steps): " + ", ".join(f"{k} {v['seconds']:.2f} s K1 {v['k1']} (want {want[k]})" for k, v in lone.items())
            + f"; slg_scale 0 bitwise the plain request {bitwise}; SLG moved the latents by {moved:.3e}")
        if any(v["k1"] != want[k] for k, v in lone.items()) or not bitwise or not moved > 0 or not finite or \
                img.shape != (1, RES, RES, 3) or int(img.max()) == int(img.min()):
            failures.append(f"sd3 lone requests: K1 {[(k, v['k1'], want[k]) for k, v in lone.items()]},"
                            f" slg_scale 0 bitwise {bitwise}, moved {moved}, finite {finite}, image {tuple(img.shape)}")
        out.update(groups=groups, burst_s=burst_s, peak_memory_gib=peak, launches=counts, t5_host=t5_ms,
                   k1_per_encode=per_encode, k1_per_cfg_call=joint, k1_per_skip_pass=joint - len(SD3_SKIP),
                   lone={k: {"seconds": v["seconds"], "k1": v["k1"]} for k, v in lone.items()},
                   slg_window=window, slg_scale_0_bitwise=bitwise, slg_moved=moved)
        for g in groups:
            log(f"  group ({g['requests']} requests, batch {g['batch']}): encode {g['encode_s']:.3f} s,"
                f" sample {g['sample_s']:.2f} s, decode {g['decode_s']:.2f} s; K1 {g['k1']} (at D = 64: {g['k1_d64']})")
        log(f"  burst of {len(burst)} in {burst_s:.2f} s; peak {peak:.1f} GiB; launches {counts}")
        del lone

        # (d) Flux read from files: flux_dev's width at 2 + 2 blocks (to spare the disk), SD3's
        # CLIP-L, T5-XXL and 16-channel VAE files
        flux_cfg = {**FLUX_PRESETS["flux_dev"], "depth": 2, "depth_single": 2}
        fsrc = flux_txt2img("cuda", torch.bfloat16, SEED + 2, flux_config=flux_cfg)
        fill_zero_initialised(fsrc.model)
        with torch.no_grad():
            for p in fsrc.model.parameters():
                p.copy_(p.half())
        fsize = {}
        fwrite_s = write_components(tmp, {"flux": (fsrc.model, it.flux_key_map)}, files, fsize)
        ffiles = {"transformer": files["flux"], "text_encoder": files["text_encoder"],
                  "text_encoder_2": files["text_encoder_3"], "vae": files["vae"]}
        ftimings = {}
        fpipe, fload_s = sync_s(flux_txt2img, "cuda", torch.bfloat16, SEED + 3, component_files=ffiles,
                                tokenizer_files=[vocab, spm], load_timings=ftimings, flux_config=flux_cfg)
        fclip, ft5 = fpipe.te.module.text_models
        sd3_clip, _, sd3_t5 = pipe.te.module.text_models
        funequal = unequal_leaves({"transformer": fsrc.model, "text_encoder": sd3_clip, "text_encoder_2": sd3_t5,
                                   "vae": pipe.vae},
                                  {"transformer": fpipe.model, "text_encoder": fclip, "text_encoder_2": ft5,
                                   "vae": fpipe.vae})
        del fsrc
        gc.collect()
        reset_launch_counts()
        fimg, fserve_s = sync_s(fpipe, SD3_PROMPTS[0], num_steps=4, num_samples=1, seed=81, width=RES, height=RES)
        fcounts, fby = launch_counts(), launches_by_head_dim()["flash_fwd_sm90"]
        fd128 = fby.get(128, 0)
        log(f"  flux_dev width at 2 + 2 blocks from files: transformer {fsize['flux'] / 2**30:.2f} GiB written in"
            f" {fwrite_s:.1f} s, stack built in {fload_s:.1f} s ({json.dumps(ftimings)}); {len(funequal)} leaves"
            f" unequal; a 4-step 1024^2 request {fserve_s:.2f} s, K1 at D = 128 {fd128} (16 expected), at D = 64"
            f" {fby.get(64, 0)} (36 expected)")
        if funequal or fd128 != 16 or fby.get(64, 0) != 36 or len(fimg) != 1 or fimg[0].shape != (RES, RES, 3) \
                or int(fimg[0].max()) == int(fimg[0].min()):
            failures.append(f"flux from files: unequal {funequal[:5]}, D = 128 launches {fd128}, D = 64"
                            f" {fby.get(64, 0)}, images {[i.shape for i in fimg]}")
        out["flux_files"] = dict(depth=(2, 2), transformer_bytes=fsize["flux"], write_s=fwrite_s, load_s=fload_s,
                                 load_timings=ftimings, leaves_unequal=len(funequal), serve_s=fserve_s,
                                 k1_d128=fd128, k1_d64=fby.get(64, 0), launches=fcounts)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 14: SDXL served with hot-swapped adapters and int8 weights
ADAPTER_TOML = "configs/lycoris/sdxl-adapters.toml"  # adapter "a": LoKr on attention and feed-forward, LoRA elsewhere
KOHYA_RANK = 32  # adapter "b": a rank-32 LoRA (alpha 32) on every kohya-addressable UNet Linear
DELTA_RATIO = 0.1  # each redrawn delta's RMS over a default-initialised Linear weight's, 1 / sqrt(3 * fan_in)
ADAPTER_SEEDS = [71, 72, 73, 74, 75, 76, 77]
INT8_REL_TOL = 0.15  # tests/test_quantize.py: mean |int8 - bf16| over mean |bf16| of a request's latents


def give_delta(adapter, seed):
    """The adapter's zero factor (LoRA's ``lora_up``, LoKr's ``lokr_w2``)
    redrawn from ``seed`` so that each delta's RMS is DELTA_RATIO of a
    default-initialised Linear weight's: a LoRA delta's RMS is alpha * s /
    sqrt(rank * fan_in), a LoKr one's alpha * s / sqrt(i1)."""
    gen = torch.Generator().manual_seed(seed)
    for name, leaves in adapter.params.items():
        spec = adapter.specs[name]
        fan_in = math.prod(spec["shape"][:-1])
        if spec["algo"] == "lora":
            std = DELTA_RATIO * math.sqrt(spec["dim"] / 3) / spec["alpha"]
            key = "lora_up"
        else:
            std = DELTA_RATIO * math.sqrt(leaves["lokr_w1"].shape[0] / (3 * fan_in)) / spec["alpha"]
            key = "lokr_w2"
        leaves[key] = (torch.randn(leaves[key].shape, generator=gen) * std).to(leaves[key].device)
    return adapter


def adapter_a(unet, seed):
    from uwudiff_tpu_torch.training import LycorisAdapter, build_adapter_config

    cfg = build_adapter_config(os.path.join(ROOT, ADAPTER_TOML))
    return give_delta(LycorisAdapter.create(unet, cfg, torch.Generator().manual_seed(seed)), seed + 1)


def check_adapters_vs_cpu(failures) -> dict:
    """(a) The small SDXL-layout UNet of check_models_vs_cpu with adapter "a"
    merged and its weights int8 (Txt2ImgPipeline(quantize_weights=True),
    set_adapter): the card's bf16 forward through the kernels against the
    same in fp32 on the CPU; the largest difference over the largest output."""
    from uwudiff_tpu_torch.serving import Txt2ImgPipeline

    gen = torch.Generator().manual_seed(SEED + 41)
    x = torch.randn((2, 32, 32, 4), generator=gen)
    t = torch.tensor([10.5, 731.25])
    ctx = torch.randn((2, 77, 256), generator=gen)
    added = {"time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * 2), "text_embeds": torch.randn((2, 128))}
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        _, unet, _ = small_sdxl_stack(device, dtype)
        pipe = Txt2ImgPipeline(unet, None, None, None, device=device, quantize_weights=True)
        pipe.set_adapter(adapter_a(unet, SEED + 42))
        with torch.inference_mode():
            out[device] = unet(x.to(device), t.to(device), ctx.to(device, dtype), None,
                               {k: v.to(device, dtype) for k, v in added.items()}).float().cpu()
    ref = out["cpu"]
    err = ((out["cuda"] - ref).abs().max() / ref.abs().max()).item()
    tol = 5e-2  # the script's card-vs-CPU bound: bf16 weights and activations through a few dozen layers
    log(f"  small SDXL-layout UNet with adapter a, int8, card bf16 vs CPU fp32: rel err {err:.2e} (tol {tol})")
    if not err <= tol:
        failures.append(f"adapters: small UNet with adapter a, int8, card vs CPU rel err {err} > {tol}")
    return {"rel_err": err, "tol": tol}


def unet_tensors(unet) -> dict:
    return {**dict(unet.named_parameters()), **dict(unet.named_buffers())}


def held_as(unet, want: dict) -> list:
    """The names of ``want`` (parameter names -> tensors, or quantize_tree's
    int8 nodes) whose tensor in ``unet`` is not bitwise the wanted one."""
    held = unet_tensors(unet)
    bad = []
    for name, v in want.items():
        if isinstance(v, dict):
            if not (torch.equal(held[name + "_q8"], v["__q8__"]) and torch.equal(held[name + "_scale"], v["scale"])):
                bad.append(name)
        elif not torch.equal(held[name], v):
            bad.append(name)
    return bad


def swap_ms(pipe, sequence, reps=3) -> dict:
    """Each swap of ``sequence`` (set_adapter's arguments, in turn), ``reps``
    times over: CUDA events from before the call to after its last write;
    the median, and the host's wall ms."""
    times: dict = {}
    for _ in range(reps):
        for served in sequence:
            key = "none" if served is None else "+".join([served] if isinstance(served, str) else served)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            pipe.set_adapter(served)
            end.record()
            host = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            times.setdefault(key, []).append((start.elapsed_time(end), host))
    return {k: {"ms": sorted(e for e, _ in v)[len(v) // 2], "host_ms": sorted(h for _, h in v)[len(v) // 2]}
            for k, v in times.items()}


def lone_s(pipe, reps=3) -> tuple:
    """A lone 1024^2 request (uint8 image on the host), ``reps`` times: the
    median seconds, the peak GiB and the K1 launches of one."""
    from uwudiff_tpu_torch.ops import launch_counts, reset_launch_counts

    runs = []
    for _ in range(reps):
        reset_launch_counts()
        img, s, peak, _ = peak_run(pipe, PLAIN_PROMPT, num_steps=STEPS, cfg_scale=CFG, width=RES, height=RES, seed=91)
        runs.append((s, peak, launch_counts()["flash_fwd_sm90"], img[0]))
    runs.sort(key=lambda r: r[0])
    return runs[len(runs) // 2][0], max(r[1] for r in runs), runs[0][2], runs[0][3]


def adapters(report, failures):
    """SDXL served with hot-swapped LoRA/LoKr adapters, a kohya LoRA file and
    int8 weights (phase 14); the counts of the mixed burst are returned."""
    import shutil
    import tempfile

    from uwudiff_tpu_torch.ops import FORWARD_KERNELS, launch_counts, reset_launch_counts
    from uwudiff_tpu_torch.ops.quantize import quantize_tree, quantized_bytes
    from uwudiff_tpu_torch.serving import BatchingServer, Request, sdxl_pipeline
    from uwudiff_tpu_torch.training import LycorisAdapter, build_adapter_config
    from uwudiff_tpu_torch.training.adapters import port_name
    from uwudiff_tpu_torch.training.kohya_lora import _module_table, load_kohya_lora, save_kohya_lora

    out = report["adapters"] = {}
    out["small_vs_cpu"] = check_adapters_vs_cpu(failures)
    tmp = tempfile.mkdtemp(prefix="chip_lora_", dir=ROOT)  # inside the checkout, git-ignored
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pipe, build_s = sync_s(sdxl_pipeline, "cuda", torch.bfloat16, SEED)
        held_bf16 = torch.cuda.memory_allocated() - before
        unet = pipe.unet
        base = {k: v.detach().clone() for k, v in unet.named_parameters()}
        n_leaves = len(base)
        ptrs = {k: v.data_ptr() for k, v in unet_tensors(unet).items()}

        # adapter "a" from the LyCORIS preset; "b" through a kohya file and back
        a = adapter_a(unet, SEED + 43).to("cuda")
        linears = [path for path in _module_table(unet).values() if unet.get_parameter(port_name(path)).ndim == 2]
        pattern = "^(" + "|".join(re.escape(p) for p in linears) + ")$"
        made = give_delta(LycorisAdapter.create(unet, build_adapter_config(
            {"targets": [{"pattern": pattern, "dim": KOHYA_RANK, "alpha": float(KOHYA_RANK)}]}),
            torch.Generator().manual_seed(SEED + 44)), SEED + 45)
        path = os.path.join(tmp, "b.safetensors")
        _, save_s = sync_s(save_kohya_lora, made, unet, path)
        b, load_s = sync_s(load_kohya_lora, path, unet)
        unequal = [name for name, leaves in made.params.items() for k, v in leaves.items()
                   if not torch.equal(b.params[name][k], v)]
        if sorted(b.specs) != sorted(made.specs) or unequal or len(b.specs) != len(linears):
            failures.append(f"adapters: kohya file read back: {len(b.specs)} of {len(made.specs)} modules, unequal"
                            f" {unequal[:5]}")
        counts_ab = {"a": {"leaves": len(a.specs), "params": a.n_params(),
                           "lokr": sum(s["algo"] == "lokr" for s in a.specs.values())},
                     "b": {"leaves": len(b.specs), "params": b.n_params(), "file_bytes": os.path.getsize(path),
                           "save_s": save_s, "load_s": load_s, "unequal": len(unequal)}}
        log(f"  sdxl_pipeline in {build_s:.1f} s, {held_bf16 / 2**30:.2f} GiB on the card; adapters {counts_ab}")
        pipe.register_adapter("a", a).register_adapter("b", b)

        # (b) swaps: each the merge of the base, bitwise; None restores; the no-op writes nothing
        swaps = {}
        for i, (served, used) in enumerate((("a", [a]), ("b", [b]), (["a", "b"], [a, b]), (None, []), ("a", [a]))):
            _, s = sync_s(pipe.set_adapter, served)
            touched = set().union(*(ad.port_names for ad in used))
            want = {n: base[n] for n in touched}
            for ad in used:
                want = ad.merge(want)
            bad = held_as(unet, want)
            rest = held_as(unet, {n: v for n, v in base.items() if n not in touched})
            moved = [k for k, v in unet_tensors(unet).items() if v.data_ptr() != ptrs[k]]
            swaps[f"{i}: {served}"] = {"s": s, "touched": len(touched), "unequal": len(bad), "others_unequal": len(rest),
                                  "moved": len(moved)}
            if bad or rest or moved:
                failures.append(f"adapters: swap to {served}: {len(bad)} touched weights not the merge, {len(rest)}"
                                f" others not the base, {len(moved)} tensors moved")
            del want
        versions = {k: v._version for k, v in unet_tensors(unet).items()}
        pipe.set_adapter("a")  # the names already served
        noop_writes = sum(v._version != versions[k] for k, v in unet_tensors(unet).items())
        pipe.set_adapter(a)  # an adapter object always re-merges
        anon_bad = held_as(unet, a.merge({n: base[n] for n in a.port_names}))
        if noop_writes or anon_bad:
            failures.append(f"adapters: the no-op swap wrote {noop_writes} tensors; the object swap left"
                            f" {len(anon_bad)} weights off its merge")
        swaps["noop_writes"], swaps["object_unequal"] = noop_writes, len(anon_bad)
        swaps["ms"] = swap_ms(pipe, ["a", "b", ["a", "b"], None])
        log(f"  swaps (touched weights, bitwise the merge, none moved): {json.dumps(swaps)}")
        out["swaps"] = swaps

        # (d) the mixed burst, one group per adapter key
        groups, inner = [], pipe.sample_device

        def recording(**kw):
            before_c = launch_counts()
            g = {"adapter": list(pipe._active_adapter or ()), "requests": len(set(kw["seed"])),
                 "batch": kw["num_samples"]}
            result, g["s"] = sync_s(inner, **kw)
            after_c = launch_counts()
            g.update({k: after_c[k] - before_c[k] for k in FORWARD_KERNELS})
            groups.append(g)
            return result

        pipe.set_adapter(None)
        pipe.sample_device = recording
        keys = [None, None, "a", "a", "b", ("a", "b"), "no_such_adapter"]
        server = BatchingServer(pipe, buckets=[(RES, RES)], max_batch=4, max_wait_s=0.5)
        server.start()
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            futs = [server.submit(Request(prompt=PLAIN_PROMPT, num_steps=STEPS, cfg_scale=CFG, seed=s, width=RES,
                                          height=RES, adapter=k)) for k, s in zip(keys, ADAPTER_SEEDS)]
            errors = [f.exception(timeout=900) for f in futs]
            burst_s = time.perf_counter() - t0
            counts = launch_counts()  # and ends here
            burst_peak = torch.cuda.max_memory_allocated() / 2**30
            images = [f.result() for f, e in zip(futs, errors) if e is None]
        finally:
            server.stop()
            pipe.sample_device = inner
        served = sorted(str(g["adapter"]) for g in groups)
        want_k1 = 44 + 140 * STEPS
        if served != sorted(str(k) for k in ([], ["a"], ["b"], ["a", "b"])) or any(
                g["flash_fwd_sm90"] != want_k1 for g in groups):
            failures.append(f"adapters burst: groups {groups}, want one per adapter key with {want_k1} K1 launches")
        if not isinstance(errors[-1], KeyError) or any(e is not None for e in errors[:-1]):
            failures.append(f"adapters burst: errors {errors}; only the unknown adapter's request should fail")
        for name in FORWARD_KERNELS:
            if counts[name] == 0:
                failures.append(f"adapters burst: kernel {name} was not launched")
        check_forward_route(counts, "adapters", failures)
        for i, img in enumerate(images):
            if img.shape != (RES, RES, 3) or img.dtype.name != "uint8" or int(img.max()) == int(img.min()):
                failures.append(f"adapters image {i}: shape {img.shape} dtype {img.dtype}")
        for g in groups:
            log(f"  group {g['adapter']} ({g['requests']} requests, batch {g['batch']}): {g['s']:.2f} s; K1"
                f" {g['flash_fwd_sm90']}, K2 {g['gn_silu_fused']}, K3 {g['gn_stats']} (+ apply {g['gn_silu_apply']})")
        log(f"  burst of {len(keys)} in {burst_s:.2f} s, peak {burst_peak:.1f} GiB; launches {counts}")
        out.update(groups=groups, burst_s=burst_s, burst_peak_gib=burst_peak, launches=counts,
                   errors=[None if e is None else repr(e) for e in errors])

        # (e) a lone request plain and with "b" (bf16)
        pipe.set_adapter(None)
        plain_s, plain_peak, plain_k1, plain_img = lone_s(pipe)
        pipe.set_adapter("b")
        b_s, b_peak, b_k1, b_img = lone_s(pipe)
        pipe.set_adapter(None)
        b_moved = float(abs(b_img.astype(int) - plain_img.astype(int)).mean())
        with torch.inference_mode():
            lat_bf16 = pipe.sample_device(PLAIN_PROMPT, num_steps=STEPS, cfg_scale=CFG, width=RES, height=RES,
                                          seed=92, return_latents=True)[0].float()
        # one UNet call of a lone request's 2 CFG rows, on random inputs
        pooled = unet.add_embedding.linear_1.in_features - 6 * unet.addition_time_embed_dim
        x = torch.randn((1, RES // 8, RES // 8, 4), device="cuda")
        ctx = torch.randn((2, 77, unet.cross_attention_dim), device="cuda", dtype=torch.bfloat16)
        added = {"time_ids": torch.tensor([[RES, RES, 0, 0, RES, RES]] * 2, device="cuda", dtype=torch.bfloat16),
                 "text_embeds": torch.randn((2, pooled), device="cuda", dtype=torch.bfloat16)}
        t = torch.tensor([500.0, 500.0], device="cuda")

        def unet_call(m):
            return lambda: m(x.expand(2, -1, -1, -1), t, ctx, None, added)

        with torch.inference_mode():
            call_bf16 = time_ms(unet_call(unet), reps=5, warmup=1)
            ops_bf16 = len(device_ops(unet_call(unet)))
        del base, a, b, made
        gc.collect()
        torch.cuda.empty_cache()

        # (c) int8: the resident bytes, the card memory, a request against bf16, a swap requantized
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pipe8, build8_s = sync_s(sdxl_pipeline, "cuda", torch.bfloat16, SEED, quantize_weights=True)
        held_int8 = torch.cuda.memory_allocated() - before
        build8_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        unet8 = pipe8.unet
        q_bytes, all_bytes = quantized_bytes(unet8)
        bf16_bytes = sum(p.numel() * p.element_size() for p in unet.parameters())
        n_q = len(pipe8._quantized)
        ptrs8 = {k: v.data_ptr() for k, v in unet_tensors(unet8).items()}
        start8 = {k: v.clone() for k, v in unet_tensors(unet8).items()}
        with torch.inference_mode():
            lat_int8 = pipe8.sample_device(PLAIN_PROMPT, num_steps=STEPS, cfg_scale=CFG, width=RES, height=RES,
                                           seed=92, return_latents=True)[0].float()
        rel = ((lat_int8 - lat_bf16).abs().mean() / lat_bf16.abs().mean()).item()
        finite = bool(torch.isfinite(lat_int8).all())
        log(f"  int8 pipeline in {build8_s:.1f} s: {n_q} of {n_leaves} UNet leaves int8, {q_bytes / 2**30:.3f}"
            f" GiB of int8 values, {all_bytes / 2**30:.3f} GiB with the scales and the other leaves, against"
            f" {bf16_bytes / 2**30:.3f} GiB in bf16; card memory after construction"
            f" {held_int8 / 2**30:.2f} GiB (bf16 pipeline {held_bf16 / 2**30:.2f}), construction peak"
            f" {build8_peak:.2f} GiB above; latents vs bf16 mean |diff| / mean |bf16| {rel:.4f} (tol {INT8_REL_TOL})")
        if not (q_bytes > 0 and finite and rel < INT8_REL_TOL):
            failures.append(f"adapters int8: int8 bytes {q_bytes}, finite {finite}, latents rel {rel} >="
                            f" {INT8_REL_TOL}")
        # the card holds the int8 form alone: the saving is the UNet's bf16 bytes less its int8 leaves'
        if not held_bf16 - held_int8 >= 0.99 * (bf16_bytes - all_bytes):
            failures.append(f"adapters int8: the pipeline holds {held_int8} bytes against bf16's {held_bf16}; want"
                            f" {bf16_bytes - all_bytes} fewer")
        b8 = load_kohya_lora(path, unet8)
        a8 = adapter_a(unet8, SEED + 43)
        pipe8.register_adapter("a", a8).register_adapter("b", b8)
        base8 = {n: pipe8._base[n].to("cuda") for n in pipe8._quantized}
        base8.update({n: p.detach().clone() for n, p in unet8.named_parameters()})
        swaps8 = {}
        for served, used in (("b", [b8]), (["a", "b"], [a8, b8])):
            _, s = sync_s(pipe8.set_adapter, served)
            touched = set().union(*(ad.port_names for ad in used))
            want = {n: base8[n] for n in touched}
            for ad in used:
                want = ad.merge(want)
            bad = held_as(unet8, quantize_tree(unet8, want))
            del want
            moved = [k for k, v in unet_tensors(unet8).items() if v.data_ptr() != ptrs8[k]]
            swaps8[str(served)] = {"s": s, "touched": len(touched), "unequal": len(bad), "moved": len(moved)}
            if bad or moved:
                failures.append(f"adapters int8: swap to {served}: {len(bad)} weights not quantize_tree(merge(base)),"
                                f" {len(moved)} tensors moved")
        pipe8.set_adapter(None)
        restored = sum(not torch.equal(v, start8[k]) for k, v in unet_tensors(unet8).items())
        if restored:
            failures.append(f"adapters int8: None left {restored} tensors off their state at construction")
        swaps8["none_unequal"] = restored
        swaps8["ms"] = swap_ms(pipe8, ["b", ["a", "b"], None])
        log(f"  int8 swaps (requantized, bitwise quantize_tree(merge(base))): {json.dumps(swaps8)}")
        int8_s, int8_peak, int8_k1, _ = lone_s(pipe8)
        with torch.inference_mode():
            call_int8 = time_ms(unet_call(unet8), reps=5, warmup=1)
            ops_int8 = len(device_ops(unet_call(unet8)))
        if not (plain_k1 == b_k1 == int8_k1 == want_k1):
            failures.append(f"adapters lone requests: K1 {plain_k1}, {b_k1}, {int8_k1}; want {want_k1}")
        lone = {"plain_s": plain_s, "b_s": b_s, "int8_s": int8_s, "plain_peak_gib": plain_peak,
                "b_peak_gib": b_peak, "int8_peak_gib": int8_peak, "b_vs_plain_mean_abs_pixel_diff": b_moved,
                "unet_call_ms": {"bf16": call_bf16, "int8": call_int8},
                "device_ops_per_unet_call": {"bf16": ops_bf16, "int8": ops_int8}}
        log(f"  lone request (median of 3): plain {plain_s:.3f} s, with b {b_s:.3f} s (mean pixel change"
            f" {b_moved:.1f}), int8 {int8_s:.3f} s; peak {plain_peak:.1f} / {b_peak:.1f} / {int8_peak:.1f} GiB; a UNet"
            f" call of 2 CFG rows {call_bf16:.1f} ms bf16, {call_int8:.1f} ms int8; device kernels a call {ops_bf16}"
            f" bf16, {ops_int8} int8 ({ops_int8 - ops_bf16} added, {n_q} int8 leaves)")
        out.update(held_bf16_gib=held_bf16 / 2**30, held_int8_gib=held_int8 / 2**30, int8_build_s=build8_s,
                   int8_build_peak_gib=build8_peak, int8_leaves=n_q, unet_leaves=n_leaves,
                   quantized_bytes=[q_bytes, all_bytes], bf16_unet_bytes=bf16_bytes, int8_latents_rel=rel,
                   int8_swaps=swaps8, lone=lone, adapters=counts_ab)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import uwudiff_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from uwudiff_tpu_torch.ops import FP16_OPTIMIZER_KERNELS, OPTIMIZER_KERNELS
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

    log("[1/14] build")
    built = build_all()
    report["build_s"] = built["seconds"]
    log(f"  built in {built['seconds']:.1f} s")
    for src, text in built["logs"].items():
        instance = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                instance = kernel_instance(line)
            if "registers" in line or "spill" in line or "(C75" in line:  # C75xx: wgmma serialised
                log(f"  {src} {instance}: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            # Flux's and DiT-XL/2's head dims
            if spills and ("<128," in instance or "<72," in instance) and int(spills[1]) + int(spills[2]) > 0:
                failures.append(f"{src} {instance} spills: {line.strip()}")

    seconds = report["seconds"] = {"build": time.perf_counter() - t_start}

    def timed(key, fn, *args):  # the wall seconds of one part of the run, into report["seconds"]
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[key] = time.perf_counter() - t0
        return out

    log("[2/14] kernels vs plain (bf16)")
    results: list[dict] = []
    for check in (check_flash, check_gn, check_flash_bwd, check_flash_dbias, check_gn_bwd, check_optimizer):
        timed(check.__name__, check, results, failures)
    report["kernel_checks"] = results
    report["models_vs_cpu_rel_err"] = timed("check_models_vs_cpu", check_models_vs_cpu, failures)
    report["train_step_vs_cpu"] = timed("check_train_vs_cpu", check_train_vs_cpu, failures)
    report["sd15_train_step_vs_cpu"] = timed("check_sd15_train_vs_cpu", check_sd15_train_vs_cpu, failures)
    report["ti_step_vs_cpu"] = timed("check_ti_vs_cpu", check_ti_vs_cpu, failures)
    report["flux_train_step_vs_cpu"] = timed("check_flux_train_vs_cpu", check_flux_train_vs_cpu, failures)

    log("[3/14] serve SDXL 1024x1024")
    serve_counts = timed("serve", serve, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # the serving stack is gone before the trainer is built

    log("[4/14] train SDXL (full fine-tune, batch 8, 64x64 latents)")
    counts = timed("train", train, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the SDXL trainer before the SD1.5 one

    log("[5/14] train SD1.5 (full fine-tune, batch 16, 64x64 latents)")
    sd15_counts, sd15_by_dim = timed("train_sd15", train_sd15, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the SD1.5 trainer before the SD3 one

    log("[6/14] textual inversion SD3-medium + CLIP-L + CLIP-bigG + T5-XXL (batch 8, 64x64x16 latents)")
    ti_counts = timed("ti", ti, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the SD3 trainer before the Flux stack

    log("[7/14] serve Flux (flux_dev + CLIP-L + T5-XXL at 512 tokens) 1024x1024")
    flux_counts, flux_d128 = timed("flux", flux, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the Flux serving stack before the flux_1b trainer

    log("[8/14] train flux_1b (full fine-tune, batch 8, 64x64x16 latents, blocks recomputed in the backward)")
    flux1b_counts, flux1b_by_dim = timed("train_flux", train_flux, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the flux_1b trainer before the SDXL stack with its encoder

    log("[9/14] sampling surface: SDXL 1024x1024 through every sampler, img2img and inpainting, VAE tiles, inversion")
    sampling_counts = timed("sampling", sampling_surface, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the SDXL stack before the DiT

    log("[10/14] serve DiT-XL/2 (class-conditional, CFG 4.0) at 256x256 and 512x512")
    dit_counts, dit_d72 = timed("dit", dit, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the DiT serving stack before its trainer

    log("[11/14] train dit_xl_2 (full fine-tune, batch 64, 32x32 latents, fp32 masters under bf16 compute)")
    dit_train_counts, dit_train_by_dim = timed("train_dit", train_dit, report, failures)
    gc.collect()
    torch.cuda.empty_cache()  # and the DiT trainer before the SDXL stacks

    log("[12/14] checkpoint: SDXL from one single-file fp16 checkpoint and CLIP-size vocab files,"
        " weighted and long prompts")
    ckpt_counts = timed("checkpoint", checkpoint, report, failures) or {}
    gc.collect()
    torch.cuda.empty_cache()  # and the SDXL stacks before SD3's

    log("[13/14] sd3: SD3-medium from its component files at 1024x1024 (a burst of 4, a skip-layer-guided request),"
        " Flux from files")
    sd3_counts = timed("sd3", sd3, report, failures) or {}
    gc.collect()
    torch.cuda.empty_cache()  # and the SD3 stacks before the SDXL ones

    log("[14/14] adapters and int8: SDXL 1024x1024 with hot-swapped LoRA/LoKr adapters, a kohya LoRA file,"
        " int8 weights")
    adapter_counts = timed("adapters", adapters, report, failures) or {}

    # (kernel, the case of its row's numbers): the kernels serving SD1.5 at
    # its level-0 self-attention (D = 40) and at level 2 (D = 160): the
    # Hopper forward, dQ and dK/dV, also at D = 64 and at the flux_1b step's
    # D = 128 (the forward also at flux_dev's served step); and the mma.sync
    # forward, dQ and dK/dV, on no path since the Hopper ones took SD1.5's
    # head dims, the forward at level 0, dQ and dK/dV at level 2; K5 at D =
    # 64 and 128
    main_case = [("flash_fwd_sm90", "sdxl_l1_self"), ("flash_fwd_sm90", "sd15_l0_self"),
                 ("flash_fwd_sm90", "sd15_l2_self"), ("flash_fwd_sm90", "flux_1024_b1"),
                 ("flash_fwd_sm90", "flux_1b_train"), ("flash_fwd_mma", "sd15_l0_self"),
                 ("flash_bwd_dq_sm90", "train_l1_self"),
                 ("flash_bwd_dkv_sm90", "train_l1_self"), ("flash_bwd_dq_sm90", "sd15_l0_self"),
                 ("flash_bwd_dkv_sm90", "sd15_l0_self"), ("flash_bwd_dq_sm90", "sd15_l2_self"),
                 ("flash_bwd_dkv_sm90", "sd15_l2_self"), ("flash_bwd_dq_sm90", "flux_1b_train"),
                 ("flash_bwd_dkv_sm90", "flux_1b_train"), ("flash_bwd_dq_mma", "sd15_l2_self"),
                 ("flash_bwd_dkv_mma", "sd15_l2_self"), ("flash_bwd_dq_dbias", "t5_xxl"),
                 ("flash_bwd_dq_dbias", "d128"), ("flash_fwd_sm90", "dit_cfg8_256"),
                 ("flash_fwd_sm90", "sd3_joint_cfg4"),
                 ("flash_fwd_sm90", "dit_xl_2_train"), ("flash_bwd_dq_sm90", "dit_xl_2_train"),
                 ("flash_bwd_dkv_sm90", "dit_xl_2_train"),
                 ("gn_silu_fused", "8x4096x320"), ("gn_stats", "8x16384x960"), ("gn_silu_apply", "8x16384x960"),
                 ("gn_silu_bwd_fused", "8x4096x320"), ("gn_bwd_partials", "8x4096x960"), ("gn_bwd_dx", "8x4096x960")]
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
    # the count of the run whose path the row's shape is from: K5's is the
    # textual-inversion step's (0: no path trains an attention bias), the
    # chunked GroupNorm pair's the served batch's, a flash kernel's at
    # SD1.5's head dims the SD1.5 step's at the row's head dim, at the
    # flux_1b step's shape that step's at D = 128, the forward's at flux_dev's
    # the Flux runs' (a lone request and a batch of 4), at DiT-XL/2's D = 72
    # the DiT serving runs' (the forward) or the dit_xl_2 step's, at SD3's
    # joint attention the SD3 burst's (phase 13), the others' the SDXL
    # training step's
    path_counts = {"flash_bwd_dq_dbias": ti_counts, "gn_stats": serve_counts, "gn_silu_apply": serve_counts}
    kernels = []
    for name, case in main_case:
        row = next(r for r in results if r["kernel"] == name and r["case"] == case)
        by_dim = name in sd15_by_dim
        d = row["shape"][-1]
        sd15 = by_dim and d in (40, 80, 160)
        if case == "flux_1b_train":
            launches = flux1b_by_dim[name].get(128, 0)
        elif case == "dit_xl_2_train":
            launches = dit_train_by_dim[name].get(72, 0)
        elif case == "dit_cfg8_256":
            launches = dit_d72
        elif case == "sd3_joint_cfg4":
            launches = sd3_counts.get(name, 0)
        elif name == "flash_fwd_sm90" and d == 128:
            launches = flux_d128
        else:
            launches = sd15_by_dim[name].get(d, 0) if sd15 else path_counts.get(name, counts)[name]
        kernels.append(dict(
            name=name, route="cuda", source=source.get(name, csrc + "groupnorm_silu.cu"),
            replaces=replaces[name], launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in results if r["kernel"] == name
                            and (not by_dim or r["shape"][-1] == d)),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            device_ms=row.get("device_ms", row.get("kernel_device_ms", row.get("kernel_ms"))),
            shape=row["shape"], case=case,
            serving_launches=serve_counts[name], train_launches=counts[name], sd15_launches=sd15_counts[name],
            ti_launches=ti_counts[name], flux_launches=flux_counts[name], flux_1b_launches=flux1b_counts[name],
            img2img_launches=sampling_counts[name], dit_launches=dit_counts[name],
            dit_train_launches=dit_train_counts[name], checkpoint_launches=ckpt_counts.get(name, 0),
            sd3_launches=sd3_counts.get(name, 0), adapter_launches=adapter_counts.get(name, 0),
        ))
    # the update's kernels (no Pallas kernel stood there: optax through XLA),
    # checked and timed over the SDXL step's leaves (O1) and the SD1.5 step's
    # (O2); their plain version is the whole plain update of those leaves, no
    # PyTorch call computes the function
    for opt_key, names, replaced, run_counts, what in (
        ("train", OPTIMIZER_KERNELS, "uwudiff_tpu/training/optimizers.py:48", counts, "SDXL"),
        ("train_sd15", FP16_OPTIMIZER_KERNELS, "uwudiff_tpu/training/optimizers.py:136", sd15_counts, "SD1.5"),
    ):
        opt = report[opt_key]["optimizer"]
        for name in names:
            kernels.append(dict(
                name=name, route="cuda", source=csrc + "adamw_factored.cu", replaces=replaced,
                launches=run_counts[name], max_abs_err=opt["max_abs_err"], ms=opt["kernel_ms"][name],
                plain_ms=opt["plain_ms"], bound_ms=opt["bound_ms"][name], bound_by="bytes", library_ms=None,
                device_ms=opt["kernel_device_ms"][name],
                shape=f"{opt['leaves']} {what} leaves, {opt['params']} params",
                plain_is="the whole plain update of the leaves (training/optimizers.py::apply_update_)",
                serving_launches=serve_counts[name], train_launches=counts[name], sd15_launches=sd15_counts[name],
                ti_launches=ti_counts[name], flux_launches=flux_counts[name], flux_1b_launches=flux1b_counts[name],
                img2img_launches=sampling_counts[name], dit_launches=dit_counts[name],
                dit_train_launches=dit_train_counts[name], checkpoint_launches=ckpt_counts.get(name, 0),
                sd3_launches=sd3_counts.get(name, 0), adapter_launches=adapter_counts.get(name, 0),
            ))
    report["kernels"] = kernels
    report["device_readings_not_measured"] = UNMEASURED
    check_device_readings(results + kernels, failures)
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failures:
        for msg in failures:
            log(f"FAIL: {msg}")
        return 1
    log(f"total {report['total_s']:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
