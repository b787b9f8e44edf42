"""Training entry point of the port (the JAX package's root ``train.py``;
reference train.py:33-76).

    python -m deepglobalregistration_tpu_torch.train --dataset SyntheticPairDataset \\
        --feat_model ResUNetBN2C --feat_model_n_out 32 --feat_conv1_kernel_size 7 \\
        --voxel_size 0.05 --weights weights/fcgf_synthetic.pkl [--num_devices 2]

Runs on the card unless ``--device cpu`` (no card: raises). ``--resume_dir``
overlays that run's ``config.json`` and resumes from its ``checkpoint.pkl``.
``--num_devices N`` > 1 trains data-parallel on N ranks, one process each
(``parallel/data_parallel.spawn``): on ``cuda:0`` .. ``cuda:N-1`` through
NCCL (fewer cards raise), or with ``--device cpu`` on N CPU ranks through
gloo. ``--batch_size`` must divide by N.
"""

from __future__ import annotations

import json
import logging
import os.path as osp

import torch

from .config import get_config
from .core.trainer import WeightedProcrustesTrainer
from .data.factory import make_data_loader
from .parallel import data_parallel as dp


def _config(argv):
    config = get_config(argv)
    if config.resume_dir:  # reference train.py:63-68
        with open(osp.join(config.resume_dir, "config.json")) as f:
            saved = json.load(f)
        for k, v in saved.items():
            if k != "resume_dir" and hasattr(config, k):
                setattr(config, k, v)
        config.resume = osp.join(config.resume_dir, "checkpoint.pkl")
    return config


def main(argv=None):
    """Parse ``argv``, build the loaders and the trainer, train; returns the
    trainer when it trains in this process. With ``--num_devices N`` > 1
    the ranks' trainers live in their own processes and it returns None:
    the run's result is what rank 0 writes to ``--out_dir``."""
    config = _config(argv)
    n = int(config.num_devices or 1)
    if n == 1:
        return _train(config)
    if config.batch_size % n:
        raise ValueError(f"batch_size {config.batch_size} not divisible by "
                         f"num_devices {n}")
    devices = [config.device] * n if torch.device(config.device).type == "cpu" else None
    dp.spawn(_main_rank, n, argv, devices=devices)
    return None


def _train(config, mesh=None) -> WeightedProcrustesTrainer:
    logging.basicConfig(format="%(asctime)s %(message)s", datefmt="%m/%d %H:%M:%S",
                        level=logging.INFO)
    train_loader = make_data_loader(config, config.train_phase, config.batch_size,
                                    num_workers=config.train_num_workers)
    val_loader = None
    if config.test_valid:
        val_loader = make_data_loader(config, config.val_phase, config.val_batch_size,
                                      num_workers=config.val_num_workers)
    trainer = WeightedProcrustesTrainer(config=config, data_loader=train_loader,
                                        val_data_loader=val_loader, mesh=mesh)
    trainer.train()
    return trainer


def _main_rank(mesh, argv) -> None:
    """One rank of ``main``."""
    _train(_config(argv), mesh)


if __name__ == "__main__":
    main()
