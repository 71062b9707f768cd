"""Config files and object instantiation (``uwudiff_tpu/config/__init__.py``).

Multi-file YAML/TOML overlay merge plus the two instantiation formats:

1. hydra format: ``{"_target_": "pkg.mod.Cls", "_partial_": bool,
   "_recursive_": bool, "_args_": [...], **kwargs}``
2. custom format: ``{"class": "pkg.mod.Cls", "factory": "from_config",
   "args": [...], "kwargs": {...}}``

The port reads the repo's config files unchanged:

- A dotted path under ``uwudiff_tpu.`` resolves to the same path under
  ``uwudiff_tpu_torch.``; nothing is imported from the JAX package. A path
  the port lacks raises ``NotImplementedError`` naming the ROADMAP item.
- ``device``: :func:`instantiate_any` passes its ``device`` to every target
  whose signature takes one that the node does not set.
- ``dtype`` strings (``dtype: bfloat16``) become torch dtypes.
- YAML goes through the port's own reader of the subset the configs use
  (``config/_yaml.py``; the card's machine has no PyYAML), TOML through
  ``tomllib``.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from pathlib import Path
from typing import Any

import torch

__all__ = [
    "get_obj_from_str",
    "instantiate_class",
    "instantiate_hydra",
    "instantiate_any",
    "merge_configs",
    "load_config_file",
    "load_config_files",
]

_JAX_PACKAGE = "uwudiff_tpu"
_PORT_PACKAGE = "uwudiff_tpu_torch"
# where a JAX module the port lacks is queued (ROADMAP.md, Queue 1)
_ROADMAP_ITEMS = (
    ("uwudiff_tpu.data.", "item 13"),
    ("uwudiff_tpu.metrics", "item 16"),
    ("uwudiff_tpu.models.inception", "item 16"),
    ("uwudiff_tpu.parallel", "item 17"),
    ("uwudiff_tpu.training.adapters", "item 14"),
    ("uwudiff_tpu.training.", "item 15"),
    ("uwudiff_tpu.diffusion.", "item 12"),
    ("uwudiff_tpu.models.", "item 15"),
)


def _port_path(string: str) -> str:
    """``uwudiff_tpu.x.y`` -> ``uwudiff_tpu_torch.x.y``; other paths as they are."""
    head, _, rest = string.partition(".")
    if head == _JAX_PACKAGE:
        return f"{_PORT_PACKAGE}.{rest}" if rest else _PORT_PACKAGE
    return string


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """Resolve a dotted path ``pkg.mod.Attr`` (or ``pkg.mod.Cls.method``)
    to a Python object, a JAX-package path to the port's counterpart."""
    path = _port_path(string)
    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:i])
        try:
            module = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            # only a missing prefix moves on to a shorter one; a module that
            # exists and fails to import raises its own error
            if e.name is None or not module_name.startswith(e.name):
                raise
            continue
        if reload:
            module = importlib.reload(module)
        obj = module
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            break
        return obj
    if path != string:
        item = next((it for prefix, it in _ROADMAP_ITEMS if string.startswith(prefix)), "Queue 1")
        raise NotImplementedError(f"{string!r} is not ported yet (ROADMAP.md, Queue 1, {item})")
    raise ImportError(f"Could not resolve object path: {string!r}")


def _is_mapping(obj: Any) -> bool:
    return isinstance(obj, dict)


def _takes_device(factory) -> bool:
    try:
        return "device" in inspect.signature(factory).parameters
    except (TypeError, ValueError):  # builtins without a signature
        return False


def _dtype(value):
    """A dtype string (``bfloat16``, ``torch.float16``) -> the torch dtype."""
    if isinstance(value, str):
        dtype = getattr(torch, value.replace("torch.", ""), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {value!r}")
        return dtype
    return value


def instantiate_hydra(obj: dict, _recursive_: bool = True, device=None) -> Any:
    """Instantiate a hydra-format node (``_target_`` et al.). ``device``
    goes to a target that takes one and whose node sets none, and down
    to nested nodes when the node is recursive."""
    cfg = dict(obj)
    target = cfg.pop("_target_")
    partial = bool(cfg.pop("_partial_", False))
    recursive = bool(cfg.pop("_recursive_", _recursive_))
    pos_args = cfg.pop("_args_", [])

    factory = get_obj_from_str(target) if isinstance(target, str) else target

    if recursive:
        pos_args = [_instantiate_recursive(a, device) for a in pos_args]
        kwargs = {k: _instantiate_recursive(v, device) for k, v in cfg.items()}
    else:
        kwargs = cfg
    if "dtype" in kwargs:
        kwargs["dtype"] = _dtype(kwargs["dtype"])
    if device is not None and "device" not in kwargs and _takes_device(factory):
        kwargs["device"] = device

    if partial:
        return functools.partial(factory, *pos_args, **kwargs)
    return factory(*pos_args, **kwargs)


def _instantiate_recursive(obj: Any, device=None) -> Any:
    if _is_mapping(obj):
        if "_target_" in obj:
            return instantiate_hydra(obj, device=device)
        return {k: _instantiate_recursive(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_instantiate_recursive(v, device) for v in obj)
    return obj


def instantiate_class(obj: Any, device=None) -> Any:
    """Custom-format instantiation: ``{"class": path, "factory": name,
    "args": [...], "kwargs": {...}}``; a bare string resolves to the object
    itself; everything else passes through unchanged."""
    if _is_mapping(obj) and "class" in obj:
        cfg = dict(obj)
        obj_factory = instantiate_class(cfg.pop("class"))
        if "factory" in cfg:
            obj_factory = getattr(obj_factory, cfg.pop("factory"))
        if "args" in cfg or "kwargs" in cfg:
            args, kwargs = cfg.get("args", []), dict(cfg.get("kwargs", {}))
        else:
            args, kwargs = [], cfg
        if "dtype" in kwargs:
            kwargs["dtype"] = _dtype(kwargs["dtype"])
        if device is not None and "device" not in kwargs and _takes_device(obj_factory):
            kwargs["device"] = device
        return obj_factory(*args, **kwargs)
    if isinstance(obj, str):
        return get_obj_from_str(obj)
    return obj


def instantiate_any(obj: Any, device=None) -> Any:
    """Instantiate either config format; ``device`` as in
    :func:`instantiate_hydra`."""
    if _is_mapping(obj) and "_target_" in obj:
        return instantiate_hydra(obj, device=device)
    return instantiate_class(obj, device=device)


def merge_configs(*configs: dict) -> dict:
    """Deep-merge mappings left to right (later overrides earlier); lists
    are replaced, not concatenated (``OmegaConf.merge`` over plain dicts)."""
    result: dict = {}
    for cfg in configs:
        result = _merge_two(result, cfg)
    return result


def _merge_two(base: Any, override: Any) -> Any:
    if _is_mapping(base) and _is_mapping(override):
        out = dict(base)
        for k, v in override.items():
            out[k] = _merge_two(out[k], v) if k in out else v
        return out
    return override


def load_config_file(path: str | Path) -> dict:
    """Load one YAML or TOML config file into a plain dict."""
    path = Path(path)
    if path.suffix in (".yaml", ".yml"):
        from uwudiff_tpu_torch.config._yaml import load_yaml

        return load_yaml(path.read_text()) or {}
    if path.suffix == ".toml":
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    raise ValueError(f"Unsupported config format: {path}")


def load_config_files(paths: list[str | Path]) -> dict:
    """Load and overlay-merge several config files in order."""
    return merge_configs(*(load_config_file(p) for p in paths))
