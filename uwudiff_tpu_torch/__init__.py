"""uwudiff_tpu_torch: the PyTorch/CUDA port of uwudiff_tpu for NVIDIA Hopper.

Two slices are ported. Serving: SDXL text-to-image, ``BatchingServer`` ->
dual-CLIP text encoding -> CFG Euler-ancestral sampling of the UNet -> VAE
decode (``serving``), with hot-swapped LoRA/LoKr adapters and kohya LoRA
files (``training/adapters.py``, ``training/kohya_lora.py``) and int8
weights (``ops/quantize.py``). Training: the SDXL full fine-tune step,
``training.DMTrainer(...).train_step(batch)`` -> ``DiffusionLoss`` -> the
UNet's forward and backward -> ``adamw_factored`` with bf16
stochastic-rounding updates (``training``, ``diffusion``). Weights load
from torch checkpoints, single-file A1111 ones included (``loader``,
``models/import_torch.py``, ``models/ldm_checkpoint.py``). The TPU's
Pallas kernels on those paths, forward and backward, are hand-written
CUDA kernels under ``csrc/`` (``ops/``), wired into autograd;
convolutions and matrix products are plain PyTorch, as the JAX package
left them to XLA. The package imports torch, numpy and the standard
library only; it shares no code with ``uwudiff_tpu``.

Entry points take ``device`` (default ``"cuda"``) and raise when CUDA is
absent unless the caller asks for ``device="cpu"``, where every kernel's
plain PyTorch version runs instead.
"""

__version__ = "0.2.0"
