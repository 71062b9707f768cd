"""Weights from files into the port's modules (``uwudiff_tpu/loader.py``).

A :class:`ModelLoadConfig` names a local torch checkpoint
(``.safetensors``/``.pt``/``.bin``/``.ckpt``), optionally a sub-dict
(``state_dict_key``, ``state_dict_prefix``), the importer (``unet``,
``vae``, ``clip``, ``t5``, ``dit``, ``mmdit``, ``flux``; found from the
module's class when omitted; the JAX loader routes no ``t5``, whose map
both packages have), the text encoder a single-file checkpoint's
``te_index`` picks (SDXL: 0 CLIP-L, 1 OpenCLIP-bigG), ``strict`` and a
``param_dtype`` to cast to (``float16`` becomes ``bfloat16``, as in the
JAX package). :func:`apply_load_config` fills a module from it in place: a
single-file A1111/ComfyUI checkpoint is split and only the component the
module needs is renamed to diffusers naming (``models/ldm_checkpoint.py``),
then ``models/import_torch.py`` maps the names. :func:`read_single_file`
reads and splits such a file once for a caller that fills several modules
from it. The JAX config's ``to_freeze``, ``precision``, ``device`` and
``to_compile`` have no counterpart, and a node that sets one is refused:
the module's own ``requires_grad``, dtype and device say these here.

A ``.npz`` is a flat parameter export of the JAX package's
``save_params_npz`` (or the port's ``DMTrainer.export_params``): a
flax-layout tree read through ``convert.load_jax_params``. Orbax
directories, the JAX trainer's checkpoints, are not read (ROADMAP.md,
Queue 1 item 3e); the ControlNet importer is not ported (its modules are
not). :func:`load_any` instantiates a model node of a config and splits
off its ``_load_config_``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import torch

from uwudiff_tpu_torch.models import import_torch as it
from uwudiff_tpu_torch.models.ldm_checkpoint import is_ldm_checkpoint, ldm_to_diffusers

__all__ = ["ModelLoadConfig", "apply_load_config", "load_any", "read_single_file"]


@dataclasses.dataclass
class ModelLoadConfig:
    ckpt_path: str | None = None
    state_dict_key: str | None = None
    state_dict_prefix: str | None = None
    importer: str | None = None
    param_dtype: str | None = None
    # the text encoder of a single-file checkpoint this module loads
    te_index: int = 0
    # False keeps the module's values for parameters the checkpoint lacks
    strict: bool = True


def load_any(node, device=None):
    """(module, load config) of a model node: the node instantiated (on
    ``device``, see ``config.instantiate_any``) without its
    ``_load_config_``, which becomes a :class:`ModelLoadConfig`."""
    from uwudiff_tpu_torch.config import instantiate_any

    load_cfg = None
    if isinstance(node, dict) and "_load_config_" in node:
        node = dict(node)
        load_cfg = ModelLoadConfig(**node.pop("_load_config_"))
    return instantiate_any(node, device=device), load_cfg


def _auto_importer(module) -> str:
    from uwudiff_tpu_torch.models import (
        AutoencoderKL,
        CLIPTextModel,
        DiT,
        Flux,
        MMDiT,
        T5EncoderModel,
        UNet2DConditionModel,
    )

    for cls, name in ((UNet2DConditionModel, "unet"), (AutoencoderKL, "vae"), (CLIPTextModel, "clip"),
                      (T5EncoderModel, "t5"), (DiT, "dit"), (MMDiT, "mmdit"), (Flux, "flux")):
        if isinstance(module, cls):
            return name
    return "npz"


def _key_map(importer: str, module):
    if importer == "mmdit":  # final_block (context_pre_only) is torch's block depth - 1
        return functools.partial(it.mmdit_key_map, depth=getattr(module, "depth", None))
    maps = {"unet": it.unet_key_map, "vae": it.vae_key_map, "clip": it.clip_text_key_map,
            "t5": it.t5_key_map, "dit": it.dit_key_map, "flux": it.flux_key_map}
    if importer not in maps:
        raise NotImplementedError(f"importer {importer!r} is not ported (ROADMAP.md, Queue 1)")
    return maps[importer]


def _single_file_part(sd: dict, importer: str, te_index: int, path: str) -> dict:
    """The diffusers-named component of a single-file checkpoint that
    ``importer`` reads: only that component is converted."""
    part = {"unet": "unet", "vae": "vae", "clip": "text_encoders"}.get(importer)
    if part is None:
        raise ValueError(f"single-file LDM checkpoints carry unet/vae/clip components; importer {importer!r}"
                         " cannot load one")
    parts = ldm_to_diffusers(sd, only=part)
    if part == "text_encoders":
        tes = parts.get("text_encoders", [])
        if te_index >= len(tes):
            raise ValueError(f"checkpoint has {len(tes)} text encoder(s); te_index={te_index} out of range")
        return tes[te_index]
    if parts.get(part) is None:
        raise ValueError(f"single-file checkpoint {path!r} carries no {part} component (importer {importer!r})")
    return parts[part]


def read_single_file(path: str, timings: dict | None = None) -> dict:
    """A single-file A1111/ComfyUI checkpoint read once and split into its
    diffusers-named components (``unet``, ``vae``, ``text_encoders``), for
    a caller that fills several modules from one file; ``timings`` gains
    ``read`` and ``map`` seconds as in :func:`apply_load_config`."""
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    sd = it.load_torch_state_dict(path)
    t1 = time.perf_counter()
    timings["read"] = timings.get("read", 0.0) + t1 - t0
    if not is_ldm_checkpoint(sd):
        raise ValueError(f"{path!r} is not a single-file LDM checkpoint")
    parts = ldm_to_diffusers(sd)
    timings["map"] = timings.get("map", 0.0) + time.perf_counter() - t1
    return parts


def apply_load_config(module: torch.nn.Module, cfg: ModelLoadConfig | None,
                      timings: dict | None = None) -> torch.nn.Module:
    """Fill ``module`` in place from ``cfg`` and cast it to ``param_dtype``.
    Returns the module; ``module.loaded_keys`` holds the file keys the
    import consumed (after any sub-dict and single-file renaming).
    ``timings`` gains the seconds of reading the file (``read``), of the
    name mapping (``map``: the single-file split and the key maps) and of
    the copies into the module (``copy``)."""
    if cfg is None:
        return module
    timings = {} if timings is None else timings
    if cfg.ckpt_path:
        path = cfg.ckpt_path
        if os.path.isdir(path):
            raise NotImplementedError(f"{path!r}: Orbax directories are not read by the port"
                                      " (ROADMAP.md, Queue 1 item 3e)")
        if path.endswith(".npz") and (cfg.importer or "npz") == "npz":
            _load_npz(module, path, cfg.strict, timings)
            return _cast(module, cfg.param_dtype)
        t0 = time.perf_counter()
        sd = it.extract_state_dict(it.load_torch_state_dict(path), cfg.state_dict_key, cfg.state_dict_prefix)
        t1 = time.perf_counter()
        timings["read"] = timings.get("read", 0.0) + t1 - t0
        importer = cfg.importer or _auto_importer(module)
        if is_ldm_checkpoint(sd):
            sd = _single_file_part(sd, importer, cfg.te_index, path)
        timings["map"] = timings.get("map", 0.0) + time.perf_counter() - t1
        module.loaded_keys = it.import_params(module, sd, _key_map(importer, module), strict=cfg.strict,
                                              timings=timings)
    return _cast(module, cfg.param_dtype)


def _cast(module, dtype):
    if dtype:
        dtype = dtype.replace("torch.", "")
        module.to(getattr(torch, "bfloat16" if dtype == "float16" else dtype))
    return module


def _load_npz(module, path: str, strict: bool, timings: dict):
    """Fill ``module`` from a JAX ``.npz`` export: each of the module's
    leaves at its flax key; a leaf the file lacks raises, or with
    ``strict=False`` keeps the module's value; keys beyond the module's are
    ignored (the JAX ``load_params_npz``)."""
    from uwudiff_tpu_torch.convert import load_jax_params, to_jax_params
    from uwudiff_tpu_torch.training.checkpoint import load_params_npz

    t0 = time.perf_counter()
    tree = load_params_npz(path, to_jax_params(module), strict=strict)
    t1 = time.perf_counter()
    load_jax_params(module, tree)
    timings["read"] = timings.get("read", 0.0) + t1 - t0
    timings["copy"] = timings.get("copy", 0.0) + time.perf_counter() - t1
    module.loaded_keys = sorted(module.state_dict())
