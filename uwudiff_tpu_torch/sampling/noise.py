"""Per-sample seed isolation for batched sampling (``uwudiff_tpu/sampling/noise.py``).

A served request's image must depend only on its own seed, never on the
requests that shared its batch or on its lane. Every draw therefore comes
from a per-lane ``torch.Generator`` on the device, seeded by a hash of
the lane's seed and a domain tag:

- lane ``j``'s init noise: tag 0;
- the step noise over ``(s, s_next)``: tag 1 plus the fp32 bit patterns
  of both endpoints, so a draw is a pure function of (seed, interval),
  and two draws of a step over intervals that share a left edge
  (dpmpp_sde's (s, s_mid) and (s, s_next), dpm2's churn over (s, s_hat))
  are distinct;
- samplers that draw without a ``noise_sampler``: one batch generator,
  tag 2 of the first lane's seed (:func:`batch_fallback_generator`), so
  the trajectory still follows the user's seed, though not lane by lane;
- ``image_to_image_sampling``'s encoder draw, start noise and sampler:
  three generators, tag 3 and then 0, 1, 2, of its one seed.

The generator's bits are not JAX's threefry bits; tests inject the same
draws into both packages instead.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

__all__ = [
    "batch_fallback_generator",
    "expand_seeds",
    "lane_seed",
    "make_per_sample_noise_sampler",
    "noise_source",
    "per_sample_init_noise",
    "seeded_generator",
    "supports_noise_sampler",
]


def expand_seeds(seed, num_samples: int) -> np.ndarray:
    """Scalar seed -> ``[seed, seed+1, ...]``; a sequence is padded to
    ``num_samples`` by repeating its last seed, and raises if longer."""
    if np.ndim(seed) == 0:
        return (np.int64(seed) + np.arange(num_samples)).astype(np.uint32)
    seeds = list(np.asarray(seed).reshape(-1))
    if not seeds:
        raise ValueError("empty seed sequence")
    if len(seeds) > num_samples:
        raise ValueError(f"got {len(seeds)} explicit seeds for {num_samples} samples")
    seeds = seeds + [seeds[-1]] * (num_samples - len(seeds))
    return np.asarray(seeds, np.int64).astype(np.uint32)


def _f32_bits(x) -> int:
    return struct.unpack("<I", struct.pack("<f", float(x)))[0]


def lane_seed(seed: int, *words: int) -> int:
    """63-bit generator seed from a lane seed and domain words."""
    data = struct.pack(f"<{1 + len(words)}Q", int(seed), *(int(w) for w in words))
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little") >> 1


def seeded_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _draw(seed: int, shape, device, dtype) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=seeded_generator(seed, device), device=device, dtype=dtype)


def per_sample_init_noise(seeds, sample_shape, device, dtype=torch.float32) -> torch.Tensor:
    """[B, *sample_shape]; lane j depends on seeds[j] only."""
    return torch.stack([_draw(lane_seed(s, 0), sample_shape, device, dtype) for s in seeds])


def make_per_sample_noise_sampler(seeds, device, dtype=torch.float32):
    """A sampler-API ``noise_sampler(shape, sigma, sigma_next)`` drawing
    lane j from seeds[j], keyed by both interval endpoints."""
    seeds = [int(s) for s in seeds]

    def noise_sampler(shape, sigma, sigma_next):
        words = (1, _f32_bits(sigma), _f32_bits(sigma_next))
        return torch.stack([_draw(lane_seed(s, *words), shape[1:], device, dtype) for s in seeds])

    return noise_sampler


def batch_fallback_generator(seeds, device) -> torch.Generator:
    """The generator of a sampler that draws noise but takes no
    ``noise_sampler``: batch-shaped draws from the first lane's seed."""
    return seeded_generator(lane_seed(int(seeds[0]), 2), device)


def supports_noise_sampler(sampler) -> bool:
    """Whether ``sampler`` takes a ``noise_sampler`` argument (the
    deterministic ones, Heun's and DPM2's without churn aside, draw nothing)."""
    import inspect

    try:
        return "noise_sampler" in inspect.signature(sampler).parameters
    except (TypeError, ValueError):
        return False


def noise_source(noise_sampler, generator, x):
    """A sampler's step draws, ``(shape, sigma, sigma_next) -> noise``:
    ``noise_sampler`` itself, else draws of x's dtype and device from
    ``generator`` (default: seeded with 0)."""
    if noise_sampler is not None:
        return noise_sampler
    gen = generator if generator is not None else seeded_generator(0, x.device)
    return lambda shape, sigma, sigma_next: torch.randn(tuple(shape), generator=gen, device=x.device, dtype=x.dtype)
