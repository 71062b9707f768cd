"""Device-time breakdown of SDXL serving, or of one training step, on one GPU.

    python -m uwudiff_tpu_torch.profile_serving [--batch 4] [--steps 4]
    python -m uwudiff_tpu_torch.profile_serving --train [--batch 8]
    python -m uwudiff_tpu_torch.profile_serving --ti [--batch 8]

Serving: builds the SDXL serving stack at full width with random weights
(``serving.sdxl_pipeline``), warms it up, then traces one request batch
(1024x1024, CFG 5) with ``torch.profiler``. ``--train``: builds the SDXL
full fine-tune step of ``training/bench_setup.py`` (64x64 latents, bf16
params, ``adamw_factored``), runs two warm-up steps, then traces one
step. ``--ti``: the same for the SD3-medium textual-inversion step
(``build_ti_trainer_and_batch``). Each reports the device time by kernel
family (the backward kernels as families of their own), the device's
busy share of the traced window, and the slowest kernels. The profiler's
host overhead lengthens the window, so the busy share is a lower bound.
Writes the tables to ``chiprun_out/profile_serving.json``
(``profile_train.json``, ``profile_ti.json``) beside the checkout's root.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

# kernel-name fragments -> family, first match wins
_FAMILIES = (
    ("flash_fwd (K1)", ("flash_fwd_sm90_kernel", "flash_fwd_kernel")),
    ("flash_bwd_dq (K4)", ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_kernel")),
    ("flash_bwd_dkv (K6)", ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dkv_kernel")),
    ("groupnorm bwd (K7/K8)", ("gn_silu_bwd_fused_kernel", "gn_bwd_partial_kernel", "gn_bwd_dx_kernel")),
    ("groupnorm (K2/K3)", ("gn_silu_fused_kernel", "gn_stats_kernel", "gn_apply_kernel")),
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
    ap.add_argument("--train", action="store_true", help="trace one SDXL training step")
    ap.add_argument("--ti", action="store_true", help="trace one SD3-medium textual-inversion step")
    args = ap.parse_args()

    from torch.profiler import ProfilerActivity, profile

    mode = "ti" if args.ti else "train" if args.train else "serve"
    if args.ti:
        from uwudiff_tpu_torch.training.bench_setup import build_ti_trainer_and_batch

        batch = args.batch or 8
        trainer, data = build_ti_trainer_and_batch(batch=batch)
        run = lambda: trainer.train_step(data)  # noqa: E731
        out_name = "profile_ti.json"
    elif args.train:
        from uwudiff_tpu_torch.training.bench_setup import build_trainer_and_batch

        batch = args.batch or 8
        trainer, data = build_trainer_and_batch(batch=batch)
        run = lambda: trainer.train_step(data)  # noqa: E731
        out_name = "profile_train.json"
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
        "card": torch.cuda.get_device_name(0), "mode": mode,
        "batch": batch, "steps": args.steps if mode == "serve" else None, "window_ms": window_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / window_ms,
        "families": {f: {"ms": t, "launches": n, "share_of_busy": t / busy_ms}
                     for f, (t, n) in sorted(families.items(), key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": name[:120], "ms": t, "launches": n}
                        for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]],
    }
    print(f"window {window_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / window_ms:.1f} %)")
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
