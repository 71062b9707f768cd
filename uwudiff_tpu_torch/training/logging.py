"""Training observability (``uwudiff_tpu/training/logging.py``).

Backends: a JSONL file (always available), stdout, and wandb where the
package is importable (imported when a ``WandbLogger`` is made). All
loggers share ``log_scalars(step, dict)`` / ``log_image(step, name,
array)``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

__all__ = ["JsonlLogger", "StdoutLogger", "WandbLogger", "MultiLogger", "build_logger"]


class JsonlLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a")

    def log_scalars(self, step: int, scalars: dict[str, Any]):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_image(self, step: int, name: str, image):
        # stored as .npy beside the jsonl
        import numpy as np

        d = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{name.replace('/', '_')}_{step}.npy"), image)

    def close(self):
        self._f.close()


class StdoutLogger:
    def __init__(self, every: int = 10):
        self.every = every

    def log_scalars(self, step: int, scalars: dict[str, Any]):
        if step % self.every == 0:
            msg = " ".join(f"{k}={float(v):.5g}" for k, v in scalars.items())
            print(f"[step {step}] {msg}", flush=True)

    def log_image(self, step: int, name: str, image):
        pass

    def close(self):
        pass


class WandbLogger:
    def __init__(self, **init_kwargs):
        import wandb

        self.run = wandb.init(**init_kwargs)
        self._wandb = wandb

    def log_scalars(self, step: int, scalars: dict[str, Any]):
        self.run.log({k: float(v) for k, v in scalars.items()}, step=int(step))

    def log_image(self, step: int, name: str, image):
        self.run.log({name: self._wandb.Image(image)}, step=int(step))

    def close(self):
        self.run.finish()


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log_scalars(self, step, scalars):
        for lg in self.loggers:
            lg.log_scalars(step, scalars)

    def log_image(self, step, name, image):
        for lg in self.loggers:
            lg.log_image(step, name, image)

    def close(self):
        for lg in self.loggers:
            lg.close()


def build_logger(log_dir: str | None, stdout_every: int = 10, use_wandb: bool = False,
                 wandb_kwargs: dict | None = None):
    loggers: list = [StdoutLogger(stdout_every)]
    if log_dir:
        loggers.append(JsonlLogger(log_dir))
    if use_wandb:
        try:
            loggers.append(WandbLogger(**(wandb_kwargs or {})))
        except ImportError:
            print("wandb not available; skipping wandb logger")
    return MultiLogger(loggers)
