"""Device-time breakdown of SDXL or Flux serving, or of one training step, on one GPU.

    python -m uwudiff_tpu_torch.profile_serving [--batch 4] [--steps 4]
    python -m uwudiff_tpu_torch.profile_serving --model flux_dev [--batch 4] [--steps 4]
    python -m uwudiff_tpu_torch.profile_serving --train [--model sdxl|sd15|flux_1b] [--batch 8]
    python -m uwudiff_tpu_torch.profile_serving --ti [--batch 8]

Serving: builds the SDXL serving stack at full width with random weights
(``serving.sdxl_pipeline``), warms it up, then traces one request batch
(1024x1024, CFG 5) with ``torch.profiler``; ``--model flux_dev``: the
Flux stack of ``serving.flux_txt2img`` (flux_dev, CLIP-L, T5-XXL at 512
tokens, the 16-channel decoder; the zero-initialised leaves drawn), one
request batch at 1024x1024 through ``diffusion_sampling``, cfg 1.
``--train``: builds the SDXL
full fine-tune step of ``training/bench_setup.py`` (64x64 latents, bf16
params, ``adamw_factored``; ``--model sd15``: the SD1.5 step, batch 16,
fp32 masters under bf16 compute, ``adamw_fp16``; ``--model flux_1b``: the
flux_1b step, batch 8, bf16 params, ``adamw_factored``, every block
recomputed in the backward), runs two warm-up steps, then traces one
step. ``--ti``: the same for the SD3-medium textual-inversion step
(``build_ti_trainer_and_batch``). Each reports the device time by kernel
family (the backward kernels as families of their own), the device's
busy share of the traced window, and the slowest kernels. The profiler's
host overhead lengthens the window, so the busy share is a lower bound;
and the peak device memory of the traced run. Writes the tables to
``chiprun_out/profile_serving.json`` (``profile_serving_flux_dev.json``,
``profile_train.json``, ``profile_train_sd15.json``,
``profile_train_flux_1b.json``, ``profile_ti.json``)
beside the checkout's root.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

# the models each mode takes: a training step's (training/bench_setup.py's
# recipes), a served stack's; the textual-inversion step takes none
MODELS = {"train": ("sdxl", "sd15", "flux_1b"), "serve": ("sdxl", "flux_dev"), "ti": ("sdxl",)}

# kernel-name fragments -> family, first match wins
_FAMILIES = (
    ("flash_fwd (K1)", ("flash_fwd_sm90_kernel", "flash_fwd_kernel")),
    ("flash_bwd_dq (K4)", ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_kernel")),
    ("flash_bwd_dkv (K6)", ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dkv_kernel")),
    ("groupnorm bwd (K7/K8)", ("gn_silu_bwd_fused_kernel", "gn_bwd_partial_kernel", "gn_bwd_dx_kernel")),
    ("groupnorm (K2/K3)", ("gn_silu_fused_kernel", "gn_stats_kernel", "gn_apply_kernel")),
    ("optimizer (O2)", ("adamw_fp16_apply_kernel",)),
    ("optimizer (O1)", ("adamw_norm_kernel", "adamw_stats_kernel", "adamw_finish_kernel", "adamw_rms_kernel",
                        "adamw_apply_kernel")),
    ("attention einsum/softmax", ("softmax",)),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "fprop", "nchw", "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "matmul", "gemv")),
    ("layernorm", ("layer_norm", "layernorm")),
    ("copy/cat", ("copy", "cat", "memcpy", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def _family(name: str) -> str:
    low = name.lower()
    if "flash_bwd_dq_kernel" in low and "true>" in low:  # the DBIAS instantiation
        return "flash_bwd_dq_dbias (K5)"
    for family, keys in _FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None, help="requests (serving, 4) or images (--train, 8)")
    ap.add_argument("--steps", type=int, default=4, help="sampler steps (serving)")
    ap.add_argument("--train", action="store_true", help="trace one training step")
    ap.add_argument("--model", default="sdxl", choices=("sdxl", "sd15", "flux_1b", "flux_dev"),
                    help="the training step's model (--train: sdxl, sd15 or flux_1b) or the served one"
                         " (sdxl or flux_dev)")
    ap.add_argument("--ti", action="store_true", help="trace one SD3-medium textual-inversion step")
    args = ap.parse_args()

    from torch.profiler import ProfilerActivity, profile

    mode = "ti" if args.ti else "train" if args.train else "serve"
    if args.model not in MODELS[mode]:
        ap.error(f"--model {args.model} does not go with {mode}")
    if args.ti:
        from uwudiff_tpu_torch.training.bench_setup import build_ti_trainer_and_batch

        batch = args.batch or 8
        trainer, data = build_ti_trainer_and_batch(batch=batch)
        run = lambda: trainer.train_step(data)  # noqa: E731
        out_name = "profile_ti.json"
    elif args.train:
        from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

        trainer, data = build_trainer_and_batch(batch=args.batch, model=args.model)
        batch = len(data["sample"])
        run = lambda: trainer.train_step(data)  # noqa: E731
        out_name = "profile_train.json" if args.model == "sdxl" else f"profile_train_{args.model}.json"
    elif args.model == "flux_dev":
        from uwudiff_tpu_torch.serving import flux_txt2img
        from uwudiff_tpu_torch.training.bench_setup import fill_zero_initialised

        batch = args.batch or 4
        pipe = flux_txt2img("cuda")
        fill_zero_initialised(pipe.model)
        run = lambda: pipe(["a red fox in snow"] * batch, num_steps=args.steps, num_samples=batch,  # noqa: E731
                           seed=list(range(batch)), width=1024, height=1024)
        out_name = "profile_serving_flux_dev.json"
    else:
        from uwudiff_tpu_torch.serving import sdxl_pipeline

        batch = args.batch or 4
        pipe = sdxl_pipeline("cuda")
        kw = dict(prompt=["a red fox in snow"] * batch, num_steps=args.steps,
                  num_samples=batch, cfg_scale=5.0, width=1024, height=1024,
                  seed=list(range(batch)))
        run = lambda: pipe.sample_device(**kw)  # noqa: E731
        out_name = "profile_serving.json"
    for _ in range(2):  # warm-up
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(ev.name, [0.0, 0])
        k[0] += ev.time_range.elapsed_us() / 1e3
        k[1] += 1
    busy_ms = sum(t for t, _ in kernels.values())
    families: dict[str, list] = {}
    for name, (t, n) in kernels.items():
        f = families.setdefault(_family(name), [0.0, 0])
        f[0] += t
        f[1] += n
    report = {
        "card": torch.cuda.get_device_name(0), "mode": mode, "model": None if args.ti else args.model,
        "batch": batch, "steps": args.steps if mode == "serve" else None, "window_ms": window_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / window_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "families": {f: {"ms": t, "launches": n, "share_of_busy": t / busy_ms}
                     for f, (t, n) in sorted(families.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": name[:120], "ms": t, "launches": n}
                        for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]],
    }
    print(f"{report['card']}: window {window_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / window_ms:.1f} %), peak {report['peak_memory_gib']:.1f} GiB")
    for f, v in report["families"].items():
        print(f"  {f:26s} {v['ms']:9.2f} ms {v['launches']:6d} launches {100 * v['share_of_busy']:5.1f} %")
    for k in report["top_kernels"][:12]:
        print(f"  {k['ms']:9.2f} ms x{k['launches']:<5d} {k['name'][:100]}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", out_name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
