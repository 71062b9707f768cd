"""Variants of the Hopper flash kernels, timed against the kernels as built.

    python flash_variants.py [name ...]

Each forward variant (``VARIANTS``) is ``csrc/flash_fwd_sm90.cu`` with one
choice of its ``Cfg`` changed (a textual substitution): the consumer
warpgroups, the share of exp2 on the FMA pipe, the Q buffers, the K/V
stages, the key tile (at Flux's D = 128). Each backward variant (``BWD_VARIANTS``) is
``csrc/flash_bwd_sm90.cu`` with one choice of the D = 128 or 160 design
changed: dK/dV's item buffers, its consumers split by role or not, dQ's
operands read from shared memory or held in registers. Each is built with
``nvcc`` into ``csrc/build/variants/``, its ptxas spills and serialised
``wgmma`` (C75xx) printed, held against the plain version in every bias
mode at two ragged shapes (bitwise from run to run too), then timed in
turns with the kernel as built and SDPA (its backward, for a backward
variant: dQ, dK and dV) at the SD1.5 and SDXL shapes its change touches:
CUDA events over 20 calls and the profiler's device time, two rounds in
opposite orders. Needs one GPU; run from the checkout's
root, writes ``chiprun_out/flash_variants.json`` there.
``tests/test_torch_flash_fwd_sm90.py`` and
``tests/test_torch_flash_bwd_sm90.py`` check, on the CPU, that each
substitution still finds its line once.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import os
import re
import subprocess
from pathlib import Path

import torch

from uwudiff_tpu_torch.ops import _build

fa = importlib.import_module("uwudiff_tpu_torch.ops.flash_attention")

L0, L0_CROSS = (16, 4096, 4096, 8, 40), (16, 4096, 77, 8, 40)  # SD1.5's shapes (B, Sq, Sk, H, D)
L1, L2, L2_CROSS = (16, 1024, 1024, 8, 80), (16, 256, 256, 8, 160), (16, 256, 77, 8, 160)
SDXL_L1, SDXL_L2 = (8, 4096, 4096, 10, 64), (8, 1024, 1024, 20, 64)
FLUX_1024, FLUX_512 = (1, 4608, 4608, 24, 128), (2, 1536, 1536, 24, 128)  # flux_dev's joint attention
FLUX_1B = (8, 1101, 1101, 12, 128)  # the flux_1b training step's joint attention (1024 image + 77 text tokens)

# name -> (what the committed line becomes, the forward's query rows and key
# rows it needs by head dim, the shapes to time)
VARIANTS = {
    "d40_two_consumers": (("CONSUMERS = D == 40 ? 3 : 2", "CONSUMERS = 2"), {40: 128}, {}, (L0, L0_CROSS)),
    "d64_three_consumers": (("CONSUMERS = D == 40 ? 3 : 2", "CONSUMERS = D <= 64 ? 3 : 2"), {64: 192}, {},
                            (SDXL_L1, SDXL_L2)),
    "d40_exp2_fma_one_in_4": (("EMU_EVERY = 8;", "EMU_EVERY = D == 40 ? 4 : 8;"), {}, {}, (L0, L0_CROSS)),
    "d40_exp2_fma_one_in_2": (("EMU_EVERY = 8;", "EMU_EVERY = D == 40 ? 2 : 8;"), {}, {}, (L0,)),
    "d80_exp2_fma_one_in_4": (("EMU_EVERY = 8;", "EMU_EVERY = D == 80 ? 4 : 8;"), {}, {}, (L1,)),
    "d80_d160_exp2_on_sfu": (("EMU_EVERY = 8;", "EMU_EVERY = D > 64 ? 0 : 8;"), {}, {}, (L1, L2)),
    "d80_two_q_buffers": (("Q_STAGES = D > 64 ? 1 : 2", "Q_STAGES = D == 160 ? 1 : 2"), {}, {}, (L1,)),
    "d160_two_q_buffers": (("Q_STAGES = D > 64 ? 1 : 2", "Q_STAGES = D == 80 ? 1 : 2"), {}, {}, (L2, L2_CROSS)),
    "four_stages": (("STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES", "STAGES = FIT < 4 ? FIT : 4"), {}, {},
                    (L0, SDXL_L1)),
    "d128_64_key_tiles": (("BLOCK_N = D > 128 ? 64 : 128", "BLOCK_N = D >= 128 ? 64 : 128"), {}, {128: 64},
                          (FLUX_1024, FLUX_512)),
    "d128_two_q_buffers": (("Q_STAGES = D > 64 ? 1 : 2", "Q_STAGES = D > 64 && D != 128 ? 1 : 2"), {}, {},
                           (FLUX_1024, FLUX_512)),
}
# name -> (what the committed line of flash_bwd_sm90.cu becomes, the dK/dV
# item rows it needs by head dim, the shapes to time): at D = 160, dK/dV
# with two item buffers and two ring stages in place of one and three; at
# 128, dK/dV unsplit (each consumer its own 64 of 128 keys, dK and dV both),
# one item buffer in each kernel (then 4 dQ and 5 dK/dV stages), and dQ
# holding Q and dO as register fragments
BWD_VARIANTS = {
    "d160_dkv_two_item_buffers": (("ITEM_BUFS = D > 128 ? 1 : 2", "ITEM_BUFS = !DKV && D > 128 ? 1 : 2"), {},
                                  (L2, L2_CROSS)),
    "d128_dkv_unsplit": (("SPLIT = DKV && D >= 128;", "SPLIT = DKV && D > 128;"), {128: 128}, (FLUX_1B,)),
    "d128_one_item_buffer": (("ITEM_BUFS = D > 128 ? 1 : 2", "ITEM_BUFS = D >= 128 ? 1 : 2"), {}, (FLUX_1B,)),
    "d128_dq_a_from_registers": (("A_SMEM = D > 64 && (DKV || D >= 128);", "A_SMEM = D > 64 && (DKV || D > 128);"),
                                 {}, (FLUX_1B,)),
}


def _build_variant(name, old, new, source="flash_fwd_sm90.cu"):
    """Start nvcc on the substituted source; returns (process, library path)."""
    src = (_build._CSRC / source).read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: '{old}' is not in {source} once")
    out = _build._BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{Path(source).stem}_{name}.cu"
    cu.write_text(src.replace(old, new))
    lib = cu.with_suffix(".so")
    cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC), "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


@contextlib.contextmanager
def _as_the_kernel(lib, q_rows, key_rows):
    """flash_fwd_sm90 launches the variant's library (and boxes q in the
    variant's work-item rows, k and v in its key tile) inside the block."""
    fn = ctypes.CDLL(str(lib)).uwu_flash_fwd_sm90
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    tables = ((fa.SM90_FWD_Q_ROWS, q_rows), (fa.SM90_FWD_KEY_ROWS, key_rows))
    saved_fn, saved = fa._fns.get("uwu_flash_fwd_sm90"), [dict(table) for table, _ in tables]
    fa._fns["uwu_flash_fwd_sm90"] = fn
    for table, rows in tables:
        table.update(rows)
    try:
        yield
    finally:
        fa._fns["uwu_flash_fwd_sm90"] = saved_fn
        for (table, _), rows in zip(tables, saved):
            table.clear()
            table.update(rows)


@contextlib.contextmanager
def _as_the_backward(lib, dkv_rows):
    """flash_bwd_dq_sm90 and flash_bwd_dkv_sm90 launch the variant's library
    (and box k and v for dK/dV in the variant's item rows) inside the block."""
    names = {"uwu_flash_bwd_dq_sm90": 8, "uwu_flash_bwd_dkv_sm90": 9}
    saved = {name: fa._fns.get(name) for name in names}
    saved_rows = dict(fa.SM90_BWD_DKV_ITEM_ROWS)
    fa.SM90_BWD_DKV_ITEM_ROWS.update(dkv_rows)
    for name, n_ptrs in names.items():
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float,
                                                                         ctypes.c_void_p]
        fa._fns[name] = fn
    try:
        yield
    finally:
        fa.SM90_BWD_DKV_ITEM_ROWS.clear()
        fa.SM90_BWD_DKV_ITEM_ROWS.update(saved_rows)
        for name, fn in saved.items():
            if fn is None:
                fa._fns.pop(name, None)
            else:
                fa._fns[name] = fn


def _inputs(b, sq, sk, h, d, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.bfloat16) for s in (sq, sk, sk)]


def _bias(kind, b, h, sq, sk):
    if kind == "none":
        return None
    if kind == "key":
        keep = torch.arange(sk, device="cuda")[None, :] < torch.tensor([sk // 3, sk] * b, device="cuda")[:b, None]
        return torch.where(keep, 0.0, float("-inf"))[:, None, None, :]
    return torch.randn((b, h, sq, sk), device="cuda").tril() - 1e30 * torch.ones(sq, sk, device="cuda").triu(1)


def _close(got, ref):
    """chip_smoke.py's flash tolerances: max error <= 2^-7 max|ref| + 2^-10,
    RMS error <= 2^-7 RMS(ref)."""
    diff, ref = got.float() - ref.float(), ref.float()
    return (diff.abs().max().item() <= 2.0**-7 * ref.abs().max().item() + 2.0**-10
            and diff.pow(2).mean().sqrt().item() <= 2.0**-7 * ref.pow(2).mean().sqrt().item())


def _check(b, sq, sk, h, d, kind):
    """The kernel as flash_fwd_sm90 now launches it against the plain version,
    with chip_smoke.py's tolerances; bitwise over two runs."""
    q, k, v = _inputs(b, sq, sk, h, d, seed=7)
    bias = _bias(kind, b, h, sq, sk)
    out, lse = fa.flash_fwd_sm90(q, k, v, bias)
    again = fa.flash_fwd_sm90(q, k, v, bias)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, bias)
    return (torch.equal(out, again[0]) and torch.equal(lse, again[1]) and _close(out, ref)
            and (lse - ref_lse).abs().max().item() <= 1e-3)


def _bwd_inputs(b, sq, sk, h, d, kind=None, seed=0):
    """q, k, v, dO, the bias, the forward's out and lse, and delta."""
    q, k, v = _inputs(b, sq, sk, h, d, seed)
    bias = None if kind is None else _bias(kind, b, h, sq, sk)
    out, lse = fa.flash_fwd_sm90(q, k, v, bias)
    dout = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda",
                       dtype=torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, bias, out, lse, delta


def _bwd_pair(q, k, v, dout, lse, delta, bias=None):
    return (fa.flash_bwd_dq_sm90(q, k, v, dout, lse, delta, bias),) + fa.flash_bwd_dkv_sm90(
        q, k, v, dout, lse, delta, bias)


def _check_bwd(b, sq, sk, h, d, kind):
    """dQ, dK and dV as the Hopper backward now launches them against the
    plain version; bitwise over two runs."""
    q, k, v, dout, bias, out, lse, delta = _bwd_inputs(b, sq, sk, h, d, kind, seed=7)
    got, again = _bwd_pair(q, k, v, dout, lse, delta, bias), _bwd_pair(q, k, v, dout, lse, delta, bias)
    refs = fa.flash_attention_backward_reference(q, k, v, bias, out, lse, dout)[:3]
    return all(torch.equal(a, b_) and _close(a, r) for a, b_, r in zip(got, again, refs))


def _event_ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=10, tries=3):
    """Device time of one call from torch.profiler; a trace that caught no
    device activity (it happens) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            break
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help=f"variants (default: all of {', '.join(list(VARIANTS) + list(BWD_VARIANTS))})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA device")
    names = args.names or list(VARIANTS) + list(BWD_VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {n: _build_variant(n, *VARIANTS[n][0]) if n in VARIANTS
              else _build_variant(n, *BWD_VARIANTS[n][0], source="flash_bwd_sm90.cu") for n in names}
    _build.build_all()
    report = {"card": card, "variants": {}}
    for name, (proc, lib) in builds.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}{err}")
        backward = name in BWD_VARIANTS
        if backward:
            (old, new), dkv_rows, shapes = BWD_VARIANTS[name]
            as_variant, check = (lambda: _as_the_backward(lib, dkv_rows)), _check_bwd  # noqa: E731
        else:
            (old, new), q_rows, key_rows, shapes = VARIANTS[name]
            as_variant, check = (lambda: _as_the_kernel(lib, q_rows, key_rows)), _check  # noqa: E731
        warnings = [ln.strip() for ln in (out + err).splitlines()
                    if "(C75" in ln or re.search(r"[1-9]\d* bytes spill stores", ln)]
        dims = sorted({s[-1] for s in shapes})
        with as_variant():
            ok = all(check(b, sq, sk, h, d, kind) for d in dims for kind in ("none", "key", "full")
                     for b, sq, sk, h in ((2, 130, 300, 2), (2, 400, 129, 3)))
        rows = []
        for shape in shapes:
            if backward:
                q, k, v, dout, _, out_, lse, delta = _bwd_inputs(*shape)
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                lib_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
                fns = {"built": lambda: _bwd_pair(q, k, v, dout, lse, delta),
                       "variant": lambda: _bwd_pair(q, k, v, dout, lse, delta),
                       "sdpa": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout.transpose(1, 2),
                                                           retain_graph=True)}
            else:
                q, k, v = _inputs(*shape)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                fns = {"built": lambda: fa.flash_fwd_sm90(q, k, v),
                       "variant": lambda: fa.flash_fwd_sm90(q, k, v),
                       "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)}
            for order in (list(fns), list(fns)[::-1]):
                row = {"shape": list(shape)}
                for key in order:
                    with as_variant() if key == "variant" else contextlib.nullcontext():
                        row[key] = {"ms": _event_ms(fns[key]), "device_ms": _device_ms(fns[key])}
                rows.append(row)
                print(f"  {name} {list(shape)}: " + "  ".join(
                    f"{key} {row[key]['ms']:.4f} (dev {row[key]['device_ms']:.4f})" for key in order), flush=True)
        report["variants"][name] = {"change": [old, new], "checks_ok": ok, "ptxas_warnings": warnings,
                                    "rows": rows}
        print(f"{name}: '{old}' -> '{new}'; checks {'ok' if ok else 'FAIL'}; ptxas {warnings or 'no spills'}",
              flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "flash_variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
