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
    "plan_gn",
    "plan_gn_bwd",
    "reset_launch_counts",
]

# every wrapper that launches a hand-written kernel; each keeps a plain
# integer ``launches`` that it raises by one per launch. The forward, dQ and
# dK/dV have two each (the Hopper kernel at D = 64, the mma.sync one at the
# other head dims); launch_counts() also gives each pair's sum under the
# dispatcher's name ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").
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
}
# what serving launches: every GroupNorm of the served UNet but one shape
# (and of the VAE decoder's 128^2 level) on the fused kernel, the rest on
# the chunked pair (ops/groupnorm_silu.py::plan_gn)
FORWARD_KERNELS = ("flash_fwd_sm90", "gn_silu_fused", "gn_stats", "gn_silu_apply")


def launch_counts() -> dict[str, int]:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        counts[name] = counts[name + "_sm90"] + counts[name + "_mma"]
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
