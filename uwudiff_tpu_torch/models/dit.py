"""The port's copy of ``uwudiff_tpu/models/dit.py::_2d_sincos_pos_embed``
(the DiT model itself is not ported)."""

from __future__ import annotations

import numpy as np


def _2d_sincos_pos_embed(dim: int, h: int, w: int, h_coords=None, w_coords=None) -> np.ndarray:
    """Fixed 2D sin-cos position embedding, ``[h*w, dim]``, with the public
    MAE/DiT/diffusers layout: ``np.meshgrid(w, h)`` puts the w-coordinates
    first, so it is [w-emb | h-emb]. Explicit coordinates give SD3's
    cropped-grid positions."""

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(h, dtype=np.float64) if h_coords is None else np.asarray(h_coords, np.float64)
    gw = np.arange(w, dtype=np.float64) if w_coords is None else np.asarray(w_coords, np.float64)
    grid = np.meshgrid(gw, gh)  # grid[0] = w-coords, grid[1] = h-coords
    emb_first = _1d(dim // 2, np.asarray(grid[0]).reshape(-1))
    emb_second = _1d(dim // 2, np.asarray(grid[1]).reshape(-1))
    return np.concatenate([emb_first, emb_second], axis=1)
