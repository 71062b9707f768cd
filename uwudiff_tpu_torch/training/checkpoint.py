"""Checkpoints of a training run and ``.npz`` parameter exports
(``uwudiff_tpu/training/checkpoint.py``).

The JAX package writes Orbax directories; the port has a format of its
own, one directory a step::

    <directory>/<step>/state.safetensors   the trainer's state_dict()
    <directory>/<step>/data.json           the data loader's state
    <directory>/<step>/meta.json           the step and the state's keys

written through ``models/import_torch.py``'s safetensors writer (bf16
stays bf16) into a temporary directory that is renamed into place only
when whole: a process killed during a save leaves the earlier steps, each
complete. Saves are synchronous (the JAX package's Orbax saves run in
the background), so ``wait`` and ``close`` have nothing to do. Orbax
directories are not read (ROADMAP.md, Queue 1 item 3e).

``save_params_npz``/``load_params_npz`` read and write the JAX package's
flat ``.npz`` export: a flax-layout parameter tree keyed by
``jax.tree_util.keystr`` of each leaf's path (``['down_0']['conv']
['kernel']``), bf16 stored as fp32 as the JAX function stores it.
"""

from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping

import numpy as np
import torch

from uwudiff_tpu_torch.models.import_torch import read_safetensors, write_safetensors

__all__ = ["CheckpointManager", "save_params_npz", "load_params_npz"]

STATE_FILE = "state.safetensors"


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints of a run under ``directory``;
    ``should_save(step)`` every ``save_every_steps`` steps."""

    def __init__(self, directory: str, keep: int = 2, save_every_steps: int | None = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_every_steps = save_every_steps

    def should_save(self, step: int) -> bool:
        return self.save_every_steps is not None and step > 0 and step % self.save_every_steps == 0

    def all_steps(self) -> list[int]:
        """The steps with a whole checkpoint, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, "meta.json")):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, torch.Tensor], data_state: dict | None = None) -> bool:
        """Write ``state`` (name -> tensor) and the loader's ``data_state`` as
        step ``step``; a step already saved is left as it is (returns False).
        Then the oldest checkpoints past ``keep`` are removed."""
        step = int(step)
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            write_safetensors(os.path.join(tmp, STATE_FILE), dict(state))
            with open(os.path.join(tmp, "data.json"), "w") as f:
                json.dump(data_state, f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:  # written last: marks the step whole
                json.dump({"step": step, "keys": list(state)}, f)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.keep] if self.keep else ():
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: int | None = None) -> tuple[dict[str, torch.Tensor], dict | None]:
        """(state, data state) of ``step`` (default: the latest). The
        tensors are read-only views of the file, mapped copy-on-write: copy
        them into the live state (``DMTrainer.load_state_dict``)."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(step))
        state, _ = read_safetensors(os.path.join(path, STATE_FILE))
        with open(os.path.join(path, "data.json")) as f:
            data_state = json.load(f)
        return state, data_state

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open between saves."""


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def save_params_npz(path: str, params: Mapping):
    """Flat ``.npz`` of a flax-layout parameter tree (nested dicts of numpy
    arrays: ``convert.to_jax_params``), keyed as the JAX function keys it;
    leaves that are not numpy-native are stored as fp32."""

    def to_npz(v):
        a = np.asarray(v)
        return a.astype(np.float32) if a.dtype.kind not in "fiub" else a

    np.savez(path, **{_keystr(p): to_npz(v) for p, v in _flatten(params)})


def load_params_npz(path: str, target: Mapping, strict: bool = True) -> dict:
    """A flat ``.npz`` export read into the structure of ``target`` (a tree
    of the same layout), in its leaves' shapes and dtypes: a leaf the file
    lacks raises, or with ``strict=False`` keeps ``target``'s value; keys
    the file has beyond it are ignored, as the JAX function ignores them."""
    def fill(node, prefix):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = fill(v, prefix + (k,))
                continue
            key = _keystr(prefix + (k,))
            if key not in data.files:
                if strict:
                    raise KeyError(f"missing param {key} in {path}")
                out[k] = v
                continue
            tgt = np.asarray(v)
            out[k] = data[key].reshape(tgt.shape).astype(tgt.dtype)
        return out

    with np.load(path) as data:
        return fill(target, ())
