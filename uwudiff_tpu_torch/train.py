"""The training CLI of the port (``scripts/train.py``).

    python -m uwudiff_tpu_torch.train --configs configs/demo_training_latent.yaml \\
        configs/demo_training_latent_sdxl.yaml [overlay.yaml ...] [--device cpu]

Later configs overlay earlier ones (OmegaConf merge semantics). The
``trainer`` and ``data`` nodes are instantiated through the port's config
system on ``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain
version, for the tiny configs), then ``DMTrainer.fit`` runs with the
``run_config`` keys as its arguments (passed as they are, as the JAX CLI
passes them: a ``callbacks`` entry is not instantiated). Ends with ``done at
step N``.
"""

from __future__ import annotations

import argparse

import torch

from uwudiff_tpu_torch.config import instantiate_any, load_config_files

__all__ = ["build", "main"]


def build(config: dict, device="cuda", fast_dev_run: bool = False, resume_from=None):
    """(trainer, data module, ``fit`` keyword arguments) of a merged config
    (``config.load_config_files``), as :func:`main` builds them. The
    modules' random weights are drawn from torch's generator seeded with the
    trainer's seed, as the JAX trainer draws its initial parameters from
    that seed."""
    run_cfg = dict(config.get("run_config", {}))
    trainer_cfg = dict(config["trainer"])
    trainer_cfg.setdefault("seed", config.get("seed", 42))
    torch.manual_seed(trainer_cfg["seed"])
    trainer = instantiate_any(trainer_cfg, device=device)
    data_module = instantiate_any(config["data"], device=device)
    run_cfg["fast_dev_run"] = fast_dev_run or run_cfg.pop("fast_dev_run", False)
    run_cfg["resume_from"] = resume_from or run_cfg.pop("resume_from", None)
    return trainer, data_module, run_cfg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--configs", nargs="+", required=True)
    parser.add_argument("--resume-from-checkpoint", default=None)
    parser.add_argument("--fast-dev-run", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    trainer, data_module, fit_kwargs = build(load_config_files(args.configs), args.device, args.fast_dev_run,
                                             args.resume_from_checkpoint)
    trainer.fit(data_module, **fit_kwargs)
    print(f"done at step {trainer.step}")


if __name__ == "__main__":
    main()
