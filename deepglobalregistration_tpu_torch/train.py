"""Training entry point of the port (the JAX package's root ``train.py``;
reference train.py:33-76).

    python -m deepglobalregistration_tpu_torch.train --dataset SyntheticPairDataset \\
        --feat_model ResUNetBN2C --feat_model_n_out 32 --feat_conv1_kernel_size 7 \\
        --voxel_size 0.05 --weights weights/fcgf_synthetic.pkl

Runs on the card unless ``--device cpu`` (no card: raises). ``--resume_dir``
overlays that run's ``config.json`` and resumes from its ``checkpoint.pkl``.
"""

from __future__ import annotations

import json
import logging
import os.path as osp

from .config import get_config
from .core.trainer import WeightedProcrustesTrainer
from .data.factory import make_data_loader


def main(argv=None) -> WeightedProcrustesTrainer:
    """Parse ``argv``, build the loaders and the trainer, train; returns the
    trainer."""
    logging.basicConfig(format="%(asctime)s %(message)s", datefmt="%m/%d %H:%M:%S",
                        level=logging.INFO)
    config = get_config(argv)
    if config.resume_dir:  # reference train.py:63-68
        with open(osp.join(config.resume_dir, "config.json")) as f:
            saved = json.load(f)
        for k, v in saved.items():
            if k != "resume_dir" and hasattr(config, k):
                setattr(config, k, v)
        config.resume = osp.join(config.resume_dir, "checkpoint.pkl")
    train_loader = make_data_loader(config, config.train_phase, config.batch_size,
                                    num_workers=config.train_num_workers)
    val_loader = None
    if config.test_valid:
        val_loader = make_data_loader(config, config.val_phase, config.val_batch_size,
                                      num_workers=config.val_num_workers)
    trainer = WeightedProcrustesTrainer(config=config, data_loader=train_loader,
                                        val_data_loader=val_loader)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
