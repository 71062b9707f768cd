"""LoRA / LoKr adapters as transforms of a module's weights (``uwudiff_tpu/training/adapters.py``).

An adapter is a set of low-rank (LoRA) or Kronecker-product (LoKr)
factors for some of a model's Linear (and, with ``enable_conv``, Conv2d)
weights, and ``merge(base) -> base'`` is a pure function over tensors: it
writes into nothing, so a trainer can differentiate through it and a
server can merge into weights it already holds.

Names and layouts are the JAX package's, so one ``.npz`` serves both:
targets match the **flax path** of each weight (``import_torch.flax_path``:
a Linear's or Conv2d's ``weight`` is ``.../kernel``), an adapter's leaves are
``"{flax path}::lora_down"`` ``[in, r]``, ``lora_up`` ``[r, out]``,
``lokr_w1`` ``[i1, o1]`` and ``lokr_w2`` ``[i2, o2]``, and ``_delta`` is the
flax-layout delta (``[in, out]``; a conv's HWIO). The merge maps it to the
port's layout, ``[out, in]`` for a Linear and OIHW for a Conv2d.

``build_adapter_config`` reads the reference's LyCORIS TOML layout
(``configs/lycoris/sdxl-adapters.toml``: ``{config: {algo, linear_dim,
linear_alpha}, preset: {target_module, module_algo_map}}``), a dict of it,
or the native ``{"targets": [...]}``. Stacked (``scan_blocks``) kernels do
not occur in the port's models.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping

import numpy as np
import torch

from uwudiff_tpu_torch.models.import_torch import flax_path
from uwudiff_tpu_torch.ops.quantize import Q8_SUFFIX

__all__ = ["AdapterConfig", "AdapterTarget", "LycorisAdapter", "build_adapter_config", "kernel_leaves"]

# the reference's module-class names -> regexes over the flax paths
_MODULE_NAME_PATTERNS = {
    "Attention": r".*attn\d/(to_q|to_k|to_v|to_qkv|to_kv|to_out)/kernel$",
    "FeedForward": r".*/ff/(proj_in|proj_out)/kernel$",
    "Transformer2DModel": r".*(attn|blocks_|proj_in|proj_out).*kernel$",
}


@dataclasses.dataclass(frozen=True)
class AdapterTarget:
    pattern: str
    algo: str = "lora"  # "lora" | "lokr"
    dim: int = 4  # LoRA rank
    alpha: float = 1.0
    factor: int = -1  # LoKr's Kronecker factor (-1: nearest the square root)


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    targets: tuple[AdapterTarget, ...]
    multiplier: float = 1.0
    enable_conv: bool = False


def build_adapter_config(cfg: dict | str) -> AdapterConfig:
    """A LyCORIS-layout dict or TOML path, or a native ``{"targets": ...}`` dict."""
    if isinstance(cfg, str):
        import tomllib

        with open(cfg, "rb") as f:
            cfg = tomllib.load(f)
    if "targets" in cfg:
        targets = tuple(t if isinstance(t, AdapterTarget) else AdapterTarget(**t) for t in cfg["targets"])
        return AdapterConfig(targets=targets, multiplier=cfg.get("multiplier", 1.0),
                             enable_conv=cfg.get("enable_conv", False))
    conf = cfg.get("config", {})
    preset = cfg.get("preset", {})
    base_algo = conf.get("algo", "lora")
    dim = int(conf.get("linear_dim", 4))
    alpha = float(conf.get("linear_alpha", 1.0))
    targets: list[AdapterTarget] = []
    # the per-module-class overrides first: the first target that matches wins
    for mod_name, mod_cfg in preset.get("module_algo_map", {}).items():
        pattern = _MODULE_NAME_PATTERNS.get(mod_name, f".*{mod_name}.*kernel$")
        targets.append(AdapterTarget(pattern=pattern, algo=mod_cfg.get("algo", base_algo),
                                     dim=int(mod_cfg.get("dim", dim)), alpha=float(mod_cfg.get("alpha", alpha)),
                                     factor=int(mod_cfg.get("factor", -1))))
    for mod_name in preset.get("target_module", []) or [".*"]:
        pattern = _MODULE_NAME_PATTERNS.get(mod_name, f".*{mod_name}.*kernel$")
        targets.append(AdapterTarget(pattern=pattern, algo=base_algo, dim=dim, alpha=alpha))
    return AdapterConfig(targets=tuple(targets), multiplier=float(conf.get("multiplier", 1.0)),
                         enable_conv=bool(preset.get("enable_conv", False)))


def _factorization(n: int, factor: int = -1) -> tuple[int, int]:
    """LoKr's split n = a * b, a <= b (LyCORIS): nearest the square root,
    or ``factor`` where it divides n (else gcd(n, factor))."""
    if factor > 0:
        a = factor if n % factor == 0 else math.gcd(n, factor)
        return min(a, n // a), max(a, n // a)
    a = int(math.isqrt(n))
    while n % a != 0:
        a -= 1
    return min(a, n // a), max(a, n // a)


def _flax_shape(shape) -> tuple[int, ...]:
    """A port weight's shape in the flax layout: Linear ``[out, in]`` ->
    ``[in, out]``, Conv2d OIHW -> HWIO."""
    shape = tuple(shape)
    return shape[::-1] if len(shape) == 2 else (shape[2], shape[3], shape[1], shape[0])


def _to_port_layout(delta: torch.Tensor) -> torch.Tensor:
    """A flax-layout kernel delta in the port's layout (the inverse of ``_flax_shape``)."""
    return delta.t() if delta.ndim == 2 else delta.permute(3, 2, 0, 1)


def port_name(path: str) -> str:
    """The port's parameter name of a kernel's flax path (``a/b/kernel`` -> ``a.b.weight``)."""
    return path[: -len("kernel")].replace("/", ".") + "weight"


def kernel_leaves(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """{flax path: flax shape} of every Linear and Conv2d weight of ``module``,
    those held as int8 (``ops.quantize``) included."""
    weights = [(name, p.shape) for name, p in module.named_parameters()]
    weights += [(name[: -len(Q8_SUFFIX)], b.shape) for name, b in module.named_buffers() if name.endswith(Q8_SUFFIX)]
    out = {}
    for name, shape in weights:
        path = flax_path(module, name)
        if path.endswith("kernel"):
            out[path] = _flax_shape(shape)
    return out


class LycorisAdapter:
    """Per-target specs (keyed by flax path) and the adapter's fp32 factors."""

    def __init__(self, specs: dict[str, dict], params: dict[str, dict], multiplier: float = 1.0):
        self.specs = specs  # path -> {"algo", "alpha", "dim", "factor", "shape" (flax), "stack"}
        self.params = params  # path -> {leaf name: tensor}
        self.multiplier = multiplier
        self.port_names = {port_name(path): path for path in specs}

    @classmethod
    def create(cls, module: torch.nn.Module, config: AdapterConfig,
               generator: torch.Generator | None = None) -> "LycorisAdapter":
        """Adapters on every kernel of ``module`` a target matches (2-D, and
        4-D with ``enable_conv``), the first factor drawn from ``generator``
        (fan-in scaled normal, fp32, on the CPU) and the second zero, so a
        fresh adapter merges to the base."""
        specs, params = {}, {}
        for name, shape in kernel_leaves(module).items():
            if len(shape) == 2:
                in_dim, out_dim = shape
            elif len(shape) == 4 and config.enable_conv:
                kh, kw, cin, out_dim = shape
                in_dim = kh * kw * cin
            elif len(shape) == 3:
                raise NotImplementedError(f"{name}: stacked (scan_blocks) kernels are not ported (ROADMAP.md,"
                                          " Queue 1 item 15)")
            else:
                continue
            target = next((t for t in config.targets if re.match(t.pattern, name)), None)
            if target is None:
                continue
            specs[name] = {"algo": target.algo, "alpha": target.alpha, "dim": target.dim, "factor": target.factor,
                           "shape": shape, "stack": ()}
            if target.algo == "lora":
                down = torch.randn((in_dim, target.dim), generator=generator) * (1.0 / max(in_dim, 1)) ** 0.5
                params[name] = {"lora_down": down, "lora_up": torch.zeros((target.dim, out_dim))}
            elif target.algo == "lokr":
                i1, i2 = _factorization(in_dim, target.factor)
                o1, o2 = _factorization(out_dim, target.factor)
                w1 = torch.randn((i1, o1), generator=generator) * (1.0 / max(i1, 1)) ** 0.5
                params[name] = {"lokr_w1": w1, "lokr_w2": torch.zeros((i2, o2))}
            else:
                raise ValueError(f"Unknown adapter algo {target.algo!r}")
        return cls(specs, params, multiplier=config.multiplier)

    def to(self, device) -> "LycorisAdapter":
        """The adapter with its factors on ``device``."""
        params = {name: {k: v.to(device) for k, v in leaves.items()} for name, leaves in self.params.items()}
        return LycorisAdapter(self.specs, params, self.multiplier)

    def _delta(self, name: str, device=None) -> torch.Tensor:
        """The flax-layout delta of ``name`` (fp32, on ``device``)."""
        spec = self.specs[name]
        p = self.params[name] if device is None else {k: v.to(device) for k, v in self.params[name].items()}
        if spec["algo"] == "lora":
            delta = (p["lora_down"] @ p["lora_up"]) * (spec["alpha"] / spec["dim"])
        else:
            delta = torch.kron(p["lokr_w1"], p["lokr_w2"]) * spec["alpha"]
        return (delta * self.multiplier).reshape(spec["shape"])

    def merge(self, base_state: Mapping[str, torch.Tensor], adapter_params=None) -> dict[str, torch.Tensor]:
        """``base_state`` (parameter names -> tensors) with each adapted weight
        replaced by ``weight + delta`` in the weight's dtype, computed on its
        device; a new dict of new tensors, the input untouched."""
        adapter = self if adapter_params is None else LycorisAdapter(self.specs, adapter_params, self.multiplier)
        out = dict(base_state)
        for name, leaf in base_state.items():
            path = adapter.port_names.get(name)
            if path is not None:
                out[name] = leaf + _to_port_layout(adapter._delta(path, leaf.device)).to(leaf.dtype)
        return out

    def save(self, path: str):
        """The adapter's factors alone, as the JAX package writes them."""
        np.savez(path, **{f"{name}::{k}": v.detach().cpu().numpy()
                          for name, leaves in self.params.items() for k, v in leaves.items()})

    def load(self, path: str) -> "LycorisAdapter":
        """This adapter's specs with the factors of an ``.npz`` either package saved."""
        data = np.load(path)
        params = {name: dict(leaves) for name, leaves in self.params.items()}
        for key in data.files:
            name, k = key.split("::")
            params[name][k] = torch.from_numpy(np.array(data[key]))
        return LycorisAdapter(self.specs, params, self.multiplier)

    def n_params(self) -> int:
        return sum(v.numel() for leaves in self.params.values() for v in leaves.values())
