"""Weight carry-over from the JAX package's flax parameter trees.

The port's modules use the flax module names as attribute names, so a
flax path ``a/b/kernel`` becomes the state-dict key ``a.b.weight`` and
only the leaf needs translating:

- Dense ``kernel [in, out]``        -> ``Linear.weight [out, in]`` (transposed)
- Conv ``kernel [kh, kw, in, out]`` -> ``Conv2d.weight [out, in, kh, kw]``
- norm ``scale``                    -> ``weight``
- ``Embed.embedding``               -> ``Embedding.weight``
- ``bias``, CLIP's ``position_embedding`` -> as they are.

A scanned block stack
(``scan_blocks=True``: one ``blocks`` subtree whose leaves carry a leading
layer axis, as the SD3 config trains the MMDiT; Flux scans ``blocks`` and
``single_blocks``) is unstacked into the port's ``blocks_{i}`` (and
``single_blocks_{i}``). Any other missing, extra or mis-shaped key raises.

:func:`to_jax_params` is the inverse: a module's state dict, or any
tensors named like it (its gradients), as a flax-named nested dict of
numpy arrays, so that tests compare the port with the JAX package leaf
by leaf.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "to_jax_params"]


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _jax_state_dict(params) -> dict[str, np.ndarray]:
    """A flax param tree (nested mappings of arrays) -> torch-named arrays."""
    out = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join([*mods, leaf])] = arr
    return out


def _unstack_scanned(module: torch.nn.Module, params):
    """Each subtree ``params[name]`` with a leading layer axis -> ``{name}_{i}``
    subtrees, where the module holds ``{name}_0``, ``{name}_1``, ... and no
    ``name`` of its own (``blocks``; Flux's ``single_blocks`` too)."""
    if not isinstance(params, Mapping):
        return params

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in tree.items()}

    children = [name for name, _ in module.named_children()]
    out = dict(params)
    for stack, tree in params.items():
        if not isinstance(tree, Mapping) or stack in children:
            continue
        n = sum(1 for name in children if re.fullmatch(rf"{re.escape(stack)}_\d+", name))
        if n == 0:
            continue
        depth = {np.shape(a)[0] for _, a in _flatten(tree)}
        if depth != {n}:
            raise ValueError(f"scanned {stack} have layer axes {sorted(depth)}, the module {n} blocks")
        del out[stack]
        out.update({f"{stack}_{i}": take(tree, i) for i in range(n)})
    return out


def load_jax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a flax param tree into ``module`` in place (dtype and device
    follow the module). Returns the module."""
    params = _unstack_scanned(module, params)
    src = _jax_state_dict(params)
    dst = module.state_dict()
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"param mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
    bad = [
        f"{k}: jax {src[k].shape} vs torch {tuple(t.shape)}"
        for k, t in dst.items() if src[k].shape != tuple(t.shape)
    ]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad[:8]))
    with torch.no_grad():
        for key, tensor in dst.items():
            tensor.copy_(torch.from_numpy(np.array(src[key], copy=True)))
    return module


def to_jax_params(module: torch.nn.Module, tensors: Mapping | None = None) -> dict:
    """``tensors`` (default: ``module.state_dict()``), keyed by the module's
    parameter names, -> a flax param tree of fp32 numpy arrays: Linear and
    Conv2d weights become transposed ``kernel`` leaves, norm weights
    ``scale``, Embedding weights ``embedding``."""
    tensors = module.state_dict() if tensors is None else tensors
    tree: dict = {}
    for name, t in tensors.items():
        *mods, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            owner = module.get_submodule(".".join(mods))
            if isinstance(owner, torch.nn.Linear):
                leaf, arr = "kernel", arr.T
            elif isinstance(owner, torch.nn.Conv2d):
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif isinstance(owner, torch.nn.Embedding):
                leaf = "embedding"
            elif arr.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"{name}: no flax name for a {type(owner).__name__} weight")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, copy=True, order="C")  # never a view of a live tensor
    return tree
