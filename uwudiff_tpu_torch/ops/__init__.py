"""Kernels of the port and the dispatch around them."""

from uwudiff_tpu_torch.ops.attention import (
    attention_bias_from_mask,
    attention_reference,
    dot_product_attention,
)
from uwudiff_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dkv_mma,
    flash_bwd_dkv_sm90,
    flash_bwd_dq,
    flash_bwd_dq_dbias,
    flash_bwd_dq_mma,
    flash_bwd_dq_sm90,
    flash_fwd,
    flash_fwd_mma,
    flash_fwd_sm90,
)
from uwudiff_tpu_torch.ops.fused_optim import (
    adamw_apply,
    adamw_finish,
    adamw_fp16_apply,
    adamw_norm,
    adamw_rms,
    adamw_stats,
)
from uwudiff_tpu_torch.ops.groupnorm_silu import (
    gn_bwd_dx,
    gn_bwd_partials,
    gn_silu_apply,
    gn_silu_bwd_fused,
    gn_silu_fused,
    gn_stats,
    group_norm_silu,
    plan_gn,
    plan_gn_bwd,
)

__all__ = [
    "FORWARD_KERNELS",
    "KERNELS",
    "FP16_OPTIMIZER_KERNELS",
    "OPTIMIZER_KERNELS",
    "attention_bias_from_mask",
    "attention_reference",
    "dot_product_attention",
    "flash_attention",
    "gn_silu_apply",
    "gn_silu_bwd_fused",
    "gn_silu_fused",
    "gn_stats",
    "group_norm_silu",
    "launch_counts",
    "launches_by_head_dim",
    "plan_gn",
    "plan_gn_bwd",
    "reset_launch_counts",
]

# every wrapper that launches a hand-written kernel; each keeps a plain
# integer ``launches`` that it raises by one per launch. The forward, dQ and
# dK/dV have two each (the Hopper kernel and the mma.sync one, by head dim:
# ops/flash_attention.py); launch_counts() also gives each pair's sum under
# the dispatcher's name ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").
KERNELS = {
    "flash_fwd_sm90": flash_fwd_sm90,
    "flash_fwd_mma": flash_fwd_mma,
    "flash_bwd_dq_sm90": flash_bwd_dq_sm90,
    "flash_bwd_dq_mma": flash_bwd_dq_mma,
    "flash_bwd_dq_dbias": flash_bwd_dq_dbias,
    "flash_bwd_dkv_sm90": flash_bwd_dkv_sm90,
    "flash_bwd_dkv_mma": flash_bwd_dkv_mma,
    "gn_silu_fused": gn_silu_fused,
    "gn_stats": gn_stats,
    "gn_silu_apply": gn_silu_apply,
    "gn_silu_bwd_fused": gn_silu_bwd_fused,
    "gn_bwd_partials": gn_bwd_partials,
    "gn_bwd_dx": gn_bwd_dx,
    "adamw_norm": adamw_norm,
    "adamw_stats": adamw_stats,
    "adamw_finish": adamw_finish,
    "adamw_rms": adamw_rms,
    "adamw_apply": adamw_apply,
    "adamw_fp16_apply": adamw_fp16_apply,
}
# what serving launches: every GroupNorm of the served UNet but one shape
# (and of the VAE decoder's 128^2 level) on the fused kernel, the rest on
# the chunked pair (ops/groupnorm_silu.py::plan_gn)
FORWARD_KERNELS = ("flash_fwd_sm90", "gn_silu_fused", "gn_stats", "gn_silu_apply")
# the training step's parameter update (ops/fused_optim.py): adamw_norm with a
# global-norm clip only, adamw_rms with adamw_factored's clipping_threshold only
OPTIMIZER_KERNELS = ("adamw_norm", "adamw_stats", "adamw_finish", "adamw_rms", "adamw_apply")
# the SD1.5 step's adamw_fp16 update (O2): the global norm, then one elementwise pass
FP16_OPTIMIZER_KERNELS = ("adamw_norm", "adamw_fp16_apply")


def launch_counts() -> dict[str, int]:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        counts[name] = counts[name + "_sm90"] + counts[name + "_mma"]
    return counts


def launches_by_head_dim() -> dict[str, dict[int, int]]:
    """The launches split by head dim of every kernel that counts them so:
    the Hopper forward (40/64/72/80/128/160) and the mma.sync one (SD1.5's
    40/80/160), the Hopper dQ and dK/dV (40/64/72/80/128/160) and the
    mma.sync ones (160)."""
    return {name: dict(sorted(fn.head_dims.items())) for name, fn in KERNELS.items() if hasattr(fn, "head_dims")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "head_dims"):
            fn.head_dims.clear()
