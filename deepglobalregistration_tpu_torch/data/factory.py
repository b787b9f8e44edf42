"""Dataset registry + data-loader factory (the JAX package's
``data/factory.py``; reference dataloader/data_loaders.py:10-54,
dataloader/inf_sampler.py:11-38).

torch's host-side DataLoader (worker pool, collation) feeds numpy batches.
A KITTI dataset's ground-truth ICP runs on the card, which a forked worker
cannot use, so a loader with workers has every pose computed in this
process first (``KITTIPairDataset.prepare_gt``).
"""

from __future__ import annotations

import torch.utils.data

from .kitti import KITTINMPairDataset, KITTIPairDataset
from .synthetic import SyntheticLidarPairDataset, SyntheticPairDataset
from .threedmatch import (ThreeDMatchPairDataset03, ThreeDMatchPairDataset05,
                          ThreeDMatchPairDataset07)
from .collate import CollationFunctionFactory
from . import transforms as t

ALL_DATASETS = [ThreeDMatchPairDataset03, ThreeDMatchPairDataset05,
                ThreeDMatchPairDataset07, KITTIPairDataset, KITTINMPairDataset,
                SyntheticPairDataset, SyntheticLidarPairDataset]
dataset_str_mapping = {d.__name__: d for d in ALL_DATASETS}


class InfSampler(torch.utils.data.Sampler):
    """Infinite shuffled permutation sampler (inf_sampler.py:11-38); the
    permutations come from its own generator, seeded with 0."""

    def __init__(self, data_source, shuffle: bool = False):
        self.data_source = data_source
        self.shuffle = shuffle
        self.generator = torch.Generator().manual_seed(0)
        self.reset_permutation()

    def reset_permutation(self):
        perm = len(self.data_source)
        if self.shuffle:
            perm = torch.randperm(perm, generator=self.generator)
        else:
            perm = torch.arange(perm)
        self._perm = perm.tolist()

    def __iter__(self):
        return self

    def __next__(self):
        if len(self._perm) == 0:
            self.reset_permutation()
        return self._perm.pop()

    def __len__(self):
        return len(self.data_source)


def make_data_loader(config, phase, batch_size, num_workers: int = 0,
                     shuffle: bool | None = None, multiprocessing_context=None):
    """Phase-dependent augmentation policy + loader (data_loaders.py:17-54).
    ``multiprocessing_context`` (e.g. "spawn") starts the workers; a caller
    that has initialised CUDA must not let them fork."""
    assert phase in ["train", "trainval", "val", "test"]
    if shuffle is None:
        shuffle = phase != "test"

    if config.dataset not in dataset_str_mapping:
        raise ValueError(
            f"Dataset {config.dataset} not defined; options: {sorted(dataset_str_mapping)}")
    Dataset = dataset_str_mapping[config.dataset]

    use_random_scale = False
    use_random_rotation = False
    transforms = []
    if phase in ["train", "trainval"]:
        use_random_rotation = config.use_random_rotation
        use_random_scale = config.use_random_scale
        transforms = [t.Jitter()]

    dset = Dataset(phase,
                   transform=t.Compose(transforms) if transforms else None,
                   random_scale=use_random_scale,
                   random_rotation=use_random_rotation,
                   config=config)

    if num_workers > 0 and hasattr(dset, "prepare_gt"):
        dset.prepare_gt()

    collation_fn = CollationFunctionFactory(
        concat_correspondences=False, collation_type="collate_pair")

    return torch.utils.data.DataLoader(
        dset,
        batch_size=batch_size,
        collate_fn=collation_fn,
        num_workers=num_workers,
        multiprocessing_context=multiprocessing_context if num_workers > 0 else None,
        sampler=InfSampler(dset, shuffle) if shuffle else None,
        drop_last=False)
