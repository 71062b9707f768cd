"""Int8 weight-only quantization for serving (``uwudiff_tpu/ops/quantize.py``).

Per-channel symmetric: a weight's scale is ``max|w| / 127`` over every axis
of its flax leaf but the last, so the scale runs over ``in`` for a Linear's
``[out, in]`` weight (one scale a row), over all axes but 0 for a Conv2d's
OIHW weight, and over axis 0 for an Embedding's ``[num, dim]`` table (one
scale a column). The arithmetic is the JAX function's step for step (fp32,
``absmax / 127.0``, a zero scale taken as 1, ``round`` half to even,
clipped to +-127), so both packages give the same bits.

:func:`quantize_tree` / :func:`dequantize_tree` are the pure functions over
a module's named tensors; :func:`quantize_module_` makes the int8 tensor and
its fp32 scale the resident form of each selected weight: the owner keeps
them as the buffers ``{attr}_q8`` and ``{attr}_scale``, and its ``attr``
becomes a property that dequantizes at the point of use (``torch.mul`` of
int8 by fp32, then one cast: two launches a weight and call), so no bf16
copy of the whole model is held. Dequantized values are bf16, as the JAX
serving program's ``dequantize_tree`` gives them, then cast to the weight's
own dtype where it differs. No Pallas kernel stood here: the JAX program
left the dequantize to XLA.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from uwudiff_tpu_torch.models.import_torch import flax_path

__all__ = ["dequantize", "dequantize_tree", "is_quantizable", "quantize_leaf", "quantize_module_", "quantize_tree",
           "quantized_bytes", "scale_dims"]

Q8_SUFFIX = "_q8"
SCALE_SUFFIX = "_scale"
_QKEY = "__q8__"
DEQUANT_DTYPE = torch.bfloat16  # the JAX dequantize_tree's default
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def is_quantizable(x: torch.Tensor, min_size: int = 4096) -> bool:
    return x.ndim >= 2 and x.numel() >= min_size and x.dtype in _FLOATS


def scale_dims(module: torch.nn.Module, name: str, ndim: int) -> tuple[int, ...]:
    """The axes of parameter ``name``'s port tensor that its scale runs over:
    those of its flax leaf but the last. A kernel is the flax one reversed
    (Linear) or HWIO -> OIHW (Conv2d), so all axes but 0; any other leaf
    (an Embedding's table) has the flax layout, so all axes but the last."""
    if flax_path(module, name).endswith("kernel"):
        return tuple(range(1, ndim))
    return tuple(range(ndim - 1))


def quantize_leaf(x: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale with ``dims`` kept as 1) of ``x``."""
    x = x.detach().float()
    absmax = x.abs().amax(dim=dims, keepdim=True)
    # by a device tensor: CUDA divides by a host scalar as a product with its
    # reciprocal, one ulp off the division (and off JAX's)
    scale = absmax / absmax.new_full((), 127.0)
    safe = torch.where(scale == 0, 1.0, scale)
    return torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=DEQUANT_DTYPE) -> torch.Tensor:
    # int8 x fp32 promotes to fp32 inside one launch; then the cast
    return torch.mul(q, scale).to(dtype)


def quantize_tree(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor] | None = None,
                  min_size: int = 4096) -> dict:
    """``tensors`` (parameter names of ``module`` -> tensors; default its
    parameters) with every float tensor of rank >= 2 and at least
    ``min_size`` elements replaced by ``{"__q8__": int8, "scale": fp32}``;
    the rest as they are. A pure function."""
    tensors = dict(module.named_parameters()) if tensors is None else tensors
    out = {}
    for name, x in tensors.items():
        if is_quantizable(x, min_size):
            q, scale = quantize_leaf(x, scale_dims(module, name, x.ndim))
            out[name] = {_QKEY: q, "scale": scale}
        else:
            out[name] = x
    return out


def dequantize_tree(qtree: Mapping, dtype=DEQUANT_DTYPE) -> dict:
    """The inverse of :func:`quantize_tree`, each int8 leaf as ``dtype``."""
    return {name: dequantize(v[_QKEY], v["scale"], dtype) if isinstance(v, Mapping) else v
            for name, v in qtree.items()}


def _dequantized(attr: str) -> property:
    def get(self):
        w = dequantize(getattr(self, attr + Q8_SUFFIX), getattr(self, attr + SCALE_SUFFIX))
        return w.to(self._q8_dtypes[attr])

    return property(get)


_CLASSES: dict[tuple, type] = {}  # (module class, its quantized attributes) -> the class with their properties


def quantize_module_(module: torch.nn.Module, min_size: int = 4096) -> list[str]:
    """Every parameter :func:`quantize_tree` selects held as int8 plus its
    fp32 scale from now on (the parameter is dropped; its owner's attribute
    dequantizes on each read); their names. A later ``.to(dtype)`` of the
    module would cast the scales too."""
    names = [name for name, p in module.named_parameters() if is_quantizable(p, min_size)]
    with torch.no_grad():
        for name in names:
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            param = owner._parameters.pop(attr)
            q, scale = quantize_leaf(param, scale_dims(module, name, param.ndim))
            owner.__dict__.setdefault("_q8_dtypes", {})[attr] = param.dtype
            del param  # the last reference: its memory goes back before the next weight's
            owner.register_buffer(attr + Q8_SUFFIX, q)
            owner.register_buffer(attr + SCALE_SUFFIX, scale)
            base = type(owner).__bases__[0] if type(owner) in _CLASSES.values() else type(owner)
            key = (base, tuple(sorted(owner._q8_dtypes)))
            if key not in _CLASSES:
                _CLASSES[key] = type(f"Q8{base.__name__}", (base,), {a: _dequantized(a) for a in key[1]})
            owner.__class__ = _CLASSES[key]
    return names


def quantized_bytes(tree) -> tuple[int, int]:
    """(int8 bytes, all bytes) of a :func:`quantize_tree` result, or of a
    module's parameters and its quantized weights' int8 values and scales."""
    if isinstance(tree, torch.nn.Module):
        buffers = dict(tree.named_buffers())
        q8 = [name[: -len(Q8_SUFFIX)] for name in buffers if name.endswith(Q8_SUFFIX)]
        leaves = list(tree.parameters()) + [buffers[n + s] for n in q8 for s in (Q8_SUFFIX, SCALE_SUFFIX)]
    else:
        leaves = [x for v in tree.values() for x in (v.values() if isinstance(v, Mapping) else [v])]
    total = sum(x.numel() * x.element_size() for x in leaves)
    return sum(x.numel() for x in leaves if x.dtype == torch.int8), total
