"""Configuration fields of the registration pipeline.

A copy of the fields of the JAX package's ``config.py`` that
``DeepGlobalRegistration`` reads, with the same names and defaults, so a
configuration written for one package works for the other.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    feat_model: str = "SimpleNetBN2C"
    feat_model_n_out: int = 16
    feat_conv1_kernel_size: int = 3
    normalize_feature: bool = True
    inlier_model: str = "ResUNetBN2C"
    inlier_feature_type: str = "ones"
    inlier_conv1_kernel_size: int = 3
    voxel_size: float = 0.025
    clip_weight_thresh: float = 0.05
    weights: str | None = None
    point_buckets: str = "8192,16384,32768,65536,131072"
    ransac_hypotheses: int = 16384
    level_shrink: int = 2
    level_shrink_6d: int = 1
    bf16: bool = False
    dense_extent: str = ""
    icp_candidates: str = "auto"  # auto | on | off
    knn_search_method: str = "gpu"  # gpu (the 1-NN kernel) | cpu (host KD-tree)
    fold_bn: bool = True  # fold inference BatchNorm into the convs at load


# Keys of the JAX package's configuration that the port accepts and drops:
# split_register picks per-stage programs over one fused program there; the
# port runs eagerly and has one path.
_IGNORED = ("split_register",)


def default_config(**overrides) -> Config:
    """Defaults plus keyword overrides; an unknown key raises."""
    cfg = Config()
    for k, v in overrides.items():
        if k in _IGNORED:
            continue
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config key {k}")
        setattr(cfg, k, v)
    return cfg
