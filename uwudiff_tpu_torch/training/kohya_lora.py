"""kohya-ss / A1111 LoRA files in and out (``uwudiff_tpu/training/kohya_lora.py``).

Community LoRA files are one ``.safetensors`` whose keys follow kohya-ss
sd-scripts: the diffusers module path with dots as underscores under a
network prefix,

    lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q
        .lora_down.weight   [rank, in]   (a LoCon conv: [rank, cin, kh, kw])
        .lora_up.weight     [out, rank]  (a LoCon conv: [out, rank, 1, 1])
        .alpha              scalar (the delta's scale is alpha / rank)

(text towers under ``lora_te_``, ``lora_te1_``/``lora_te2_``). They convert
to and from :class:`~uwudiff_tpu_torch.training.adapters.LycorisAdapter`
through the importer's key maps (flax path -> diffusers key -> kohya
name), so a downloaded LoRA goes to ``Txt2ImgPipeline.register_adapter``.
Files are read and written by the port's own ``.safetensors`` reader and
writer (``models/import_torch.py``).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from uwudiff_tpu_torch.models.import_torch import (
    _t_conv,
    _t_linear,
    load_torch_state_dict,
    unet_key_map,
    write_safetensors,
)
from uwudiff_tpu_torch.training.adapters import LycorisAdapter, kernel_leaves

__all__ = ["export_kohya_lora", "import_kohya_lora", "kohya_module_name", "load_kohya_lora", "save_kohya_lora"]

# a kohya delta composes with the weight's layout only where the key map's
# transform is a plain Linear, a conv, or the 1x1-conv / Linear "proj"; any
# other (the MMDiT's swap-halves head) would carry its rows permuted, so
# those layers are not kohya-addressable and are skipped
_KOHYA_SAFE_TRANSFORMS = (_t_linear, _t_conv, "proj", None)


def kohya_module_name(diffusers_key: str, prefix: str = "lora_unet") -> str:
    """A diffusers weight key -> its kohya module name (``down_blocks.0...to_q.weight``
    -> ``lora_unet_down_blocks_0...to_q``; ``to_out.0`` keeps its index)."""
    mod = diffusers_key[: -len(".weight")] if diffusers_key.endswith(".weight") else diffusers_key
    return prefix + "_" + mod.replace(".", "_")


def _kohya_safe(tr) -> bool:
    if isinstance(tr, functools.partial):
        tr = tr.func
    return tr in _KOHYA_SAFE_TRANSFORMS


def _module_table(module: torch.nn.Module, key_map: Callable = unet_key_map,
                  prefix: str = "lora_unet") -> dict[str, str]:
    """{kohya module name: flax path} of every kernel of ``module`` the key
    map gives one torch key with a layout-keeping transform (fused
    projections have no kohya convention)."""
    table = {}
    for path in kernel_leaves(module):
        try:
            torch_key, tr = key_map(path)
        except KeyError:
            continue
        if isinstance(torch_key, (list, tuple)) or not _kohya_safe(tr):
            continue
        table[kohya_module_name(torch_key, prefix)] = path
    return table


def export_kohya_lora(adapter: LycorisAdapter, module: torch.nn.Module, key_map: Callable = unet_key_map,
                      prefix: str = "lora_unet", dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A LoRA adapter -> a kohya state dict (CPU tensors in ``dtype``): each
    ``lora_down [in, r]`` / ``lora_up [r, out]`` transposed to the torch
    layout, a conv's ``lora_down`` ``[kh*kw*cin, r]`` as ``[r, cin, kh,
    kw]``. LoKr targets have no kohya-LoRA encoding and raise."""
    inv = {path: mod for mod, path in _module_table(module, key_map, prefix).items()}
    out = {}
    for name, leaves in adapter.params.items():
        spec = adapter.specs[name]
        if spec["algo"] != "lora":
            raise ValueError(f"{name}: algo {spec['algo']!r} has no kohya-LoRA encoding"
                             " (export LyCORIS algos via their own format)")
        mod = inv.get(name)
        if mod is None:
            raise KeyError(f"no kohya name for {name}")
        down, up = (leaves[k].detach().float().cpu() for k in ("lora_down", "lora_up"))
        if len(spec["shape"]) == 4:
            kh, kw, cin, _ = spec["shape"]
            down = down.reshape(kh, kw, cin, -1).permute(3, 2, 0, 1)
            up = up.t()[:, :, None, None]
        else:
            down, up = down.t(), up.t()
        out[mod + ".lora_down.weight"] = down.to(dtype).contiguous()
        out[mod + ".lora_up.weight"] = up.to(dtype).contiguous()
        out[mod + ".alpha"] = torch.tensor(spec["alpha"], dtype=dtype)
    return out


def save_kohya_lora(adapter: LycorisAdapter, module: torch.nn.Module, path: str, **kw) -> None:
    """A kohya-format ``.safetensors`` LoRA file."""
    write_safetensors(path, export_kohya_lora(adapter, module, **kw))


def _float(v) -> torch.Tensor:
    return v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v, np.float32))


def import_kohya_lora(sd: dict, module: torch.nn.Module, key_map: Callable = unet_key_map, prefix: str = "lora_unet",
                      multiplier: float = 1.0, strict: bool = True) -> LycorisAdapter:
    """A kohya state dict (torch or numpy values) -> a LoRA adapter on
    ``module``'s kernels, rank and alpha from the file module by module.
    Keys outside ``prefix`` are ignored; a module of the file that matches no
    kernel raises, or with ``strict=False`` is skipped."""
    table = _module_table(module, key_map, prefix)
    shapes = kernel_leaves(module)
    modules: dict[str, dict] = {}
    for k, v in sd.items():
        if not k.startswith(prefix + "_"):
            continue
        mod, leaf = (k.rsplit(".", 1) if k.endswith(".alpha")
                     else (k.rsplit(".", 2)[0], ".".join(k.rsplit(".", 2)[1:])))
        modules.setdefault(mod, {})[leaf] = v
    specs, params = {}, {}
    for mod, leaves in sorted(modules.items()):
        name = table.get(mod)
        if name is None:
            if strict:
                raise KeyError(f"LoRA module {mod!r} matches no base layer")
            continue
        down, up = _float(leaves["lora_down.weight"]), _float(leaves["lora_up.weight"])
        rank = down.shape[0]
        alpha = float(_float(leaves["alpha"])) if "alpha" in leaves else float(rank)
        shape = shapes[name]
        if down.ndim == 4:  # LoCon: [r, cin, kh, kw] -> [kh*kw*cin, r]
            down = down.permute(2, 3, 1, 0).reshape(-1, rank)
            up = up.reshape(up.shape[0], rank).t()
        else:
            down, up = down.t(), up.t()
        if down.shape[0] != int(np.prod(shape[:-1])) or up.shape[1] != shape[-1]:
            raise ValueError(f"{mod}: LoRA shapes {tuple(down.shape)}/{tuple(up.shape)} do not fit base kernel"
                             f" {shape}")
        specs[name] = {"algo": "lora", "alpha": alpha, "dim": rank, "factor": -1, "shape": shape, "stack": ()}
        params[name] = {"lora_down": down.contiguous(), "lora_up": up.contiguous()}
    return LycorisAdapter(specs, params, multiplier=multiplier)


def load_kohya_lora(path: str, module: torch.nn.Module, **kw) -> LycorisAdapter:
    """A kohya ``.safetensors`` / ``.pt`` LoRA file -> an adapter on ``module``."""
    return import_kohya_lora(load_torch_state_dict(path), module, **kw)
