"""Fold inference-mode BatchNorm into the preceding conv (load-time fusion).

A copy of the JAX package's ``utils/fold_bn.py`` over numpy parameter trees:
``y = (x - m) * g / sqrt(v + eps) + b`` after a bias-free conv folds into
the conv kernel (scaled per output channel) plus a bias. Supported: the
conv{i}/norm{i} (+_tr) naming of the ResUNet family, including residual-block
conv1/norm1/conv2/norm2 subtrees, with norm_type 'BN'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

_EPS = 1e-5


def _fold_pair(conv: Dict[str, Any], norm_p: Dict[str, Any],
               norm_s: Dict[str, Any]) -> Dict[str, Any]:
    scale = np.asarray(norm_p["weight"]) / np.sqrt(np.asarray(norm_s["var"]) + _EPS)
    bias = np.asarray(norm_p["bias"]) - np.asarray(norm_s["mean"]) * scale
    kernel = np.asarray(conv["kernel"]) * scale[None, None, :]
    out = {"kernel": kernel.astype(np.float32)}
    if "bias" in conv:
        out["bias"] = (np.asarray(conv["bias"]) * scale + bias).astype(np.float32)
    else:
        out["bias"] = bias.astype(np.float32)
    return out


def _is_block(v) -> bool:
    return isinstance(v, dict) and "conv1" in v and "norm1" in v


def _fold_block(bp: Dict[str, Any], bs: Dict[str, Any]):
    new = dict(bp)
    for i in ("1", "2"):
        new[f"conv{i}"] = _fold_pair(bp[f"conv{i}"], bp[f"norm{i}"], bs[f"norm{i}"])
        new[f"norm{i}"] = {}
    return new


def fold_batch_norms(params: Dict[str, Any], state: Dict[str, Any], cfg
                     ) -> Tuple[Dict[str, Any], Dict[str, Any], Any]:
    """Returns (params', state', cfg') with BN folded and norm types 'NONE'
    (cfg unchanged unless norm_type and block_norm_type are 'BN')."""
    if getattr(cfg, "norm_type", None) != "BN" or \
            getattr(cfg, "block_norm_type", "BN") != "BN":
        return params, state, cfg

    new_p: Dict[str, Any] = {}
    for name, value in params.items():
        if name.startswith("conv"):
            norm_name = name.replace("conv", "norm")
            if norm_name in params and params[norm_name]:
                new_p[name] = _fold_pair(value, params[norm_name], state[norm_name])
            else:
                new_p[name] = value
        elif name.startswith("norm"):
            new_p[name] = {}
        elif _is_block(value):
            new_p[name] = _fold_block(value, state[name])
        else:
            new_p[name] = value
    fields = {"norm_type": "NONE"}
    if hasattr(cfg, "block_norm_type"):
        fields["block_norm_type"] = "NONE"
    return new_p, state, dataclasses.replace(cfg, **fields)
