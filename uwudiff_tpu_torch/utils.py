"""Small helpers, kept here so the port shares no code with uwudiff_tpu."""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

__all__ = [
    "append_dims",
    "build_module",
    "resolve_device",
    "truncate_or_pad_to_length",
    "vae_image_postprocess",
]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without a usable
    GPU raises: the port never drifts to the CPU on its own.

    On CUDA it also sets both TF32 switches off, explicitly: matrix
    products and convolutions run in the tensors' own precision. The
    serving path is bf16, where TF32 does not apply; fp32 work stays
    exact fp32, as the JAX reference's CPU runs are."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def build_module(cls, config: dict, device, dtype, construct_in_dtype: bool = False):
    """Construct ``cls(**config)`` with its parameters allocated and
    initialised directly on ``device`` (from torch's seeded default
    generator), cast to ``dtype``, 4-D weights in channels-last memory,
    in eval mode. The ``from_config`` entry point of every model.

    The parameters are drawn in fp32 and cast, unless ``construct_in_dtype``
    (torch's default dtype is ``dtype`` while the constructor runs, so no
    fp32 copy is ever made: ``flux_dev`` would take 48 GB in fp32 beside
    its 24 GB in bf16). The other models keep the fp32 draw, which their
    seeded weights on the card and on the CPU were made from.

    On ``meta`` nothing is drawn: the module has its shapes, dtypes and
    strides without storage, for ``to_empty`` and an import from a file."""
    dev = torch.device(device) if torch.device(device).type == "meta" else resolve_device(device)
    saved = torch.get_default_dtype()
    if construct_in_dtype:
        torch.set_default_dtype(dtype)
    try:
        with dev:
            module = cls(**config)
    finally:
        torch.set_default_dtype(saved)
    return module.to(dtype=dtype, memory_format=torch.channels_last).eval()


def append_dims(x: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append trailing singleton dims."""
    dims_to_append = target_ndim - x.dim()
    if dims_to_append < 0:
        raise ValueError(f"input has {x.dim()} dims but target_ndim is {target_ndim}")
    return x[(...,) + (None,) * dims_to_append]


def truncate_or_pad_to_length(
    list_x: list,
    target_length: int,
    padding_mode: Literal["repeat_last", "cycling"],
) -> list:
    if len(list_x) >= target_length:
        return list_x[:target_length]
    if padding_mode == "repeat_last":
        return list_x + [list_x[-1]] * (target_length - len(list_x))
    if padding_mode == "cycling":
        return (
            list_x * (target_length // len(list_x))
            + list_x[: target_length % len(list_x)]
        )
    raise ValueError(f"Unknown padding mode {padding_mode!r}")


def vae_image_postprocess(image) -> np.ndarray:
    """[-1, 1] HWC float image (or an already-converted uint8 one) ->
    uint8 HWC numpy array. The JAX package returns a PIL image here; the
    port returns the array and leaves encoding to the caller."""
    arr = image.cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.dtype != np.uint8:
        arr = ((np.clip(arr, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
    return arr
