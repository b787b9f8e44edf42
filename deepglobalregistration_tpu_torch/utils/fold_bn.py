"""Fold inference-mode BatchNorm into the preceding conv (load-time fusion).

Counterpart of the JAX package's ``utils/fold_bn.py`` over numpy parameter
trees: ``y = (x - m) * g / sqrt(v + eps) + b`` after a conv folds into the
conv kernel (scaled per output channel) plus a bias. A pair is a conv and
its norm side by side in one subtree: ``conv{s}`` / ``norm{s}`` (every
ResUNet and SimpleNet stage, the residual blocks' conv1 / norm1 and conv2 /
norm2, at any depth of the tree) or ``"0"`` / ``"1"`` (PyramidNet's
conv_norm_non Sequentials). Nets with IN or INBN norms pass through
unfolded. The JAX function folds only the first kind and still marks a
PyramidNet 'NONE', so its PyramidNet runs with no BN at all; here a net is
marked 'NONE' only once no BN is left unfolded.
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


def _norm_name(name: str) -> str | None:
    if name.startswith("conv"):
        return "norm" + name[len("conv"):]
    return "1" if name == "0" else None


def _fold_tree(params: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(params)
    for name, value in params.items():
        if not isinstance(value, dict):
            continue
        norm = _norm_name(name)
        if "kernel" in value:
            if norm in params and "weight" in params[norm]:
                out[name] = _fold_pair(value, params[norm], state[norm])
                out[norm] = {}
        elif "weight" not in value:
            out[name] = _fold_tree(value, state.get(name, {}))
    return out


def _has_bn(tree) -> bool:
    return isinstance(tree, dict) and (
        "weight" in tree or any(_has_bn(v) for v in tree.values()))


def fold_batch_norms(params: Dict[str, Any], state: Dict[str, Any], cfg
                     ) -> Tuple[Dict[str, Any], Dict[str, Any], Any]:
    """Returns (params', state', cfg') with every BN folded and the norm types
    'NONE' (unchanged unless norm_type and block_norm_type are 'BN'). The
    state tree is returned as it is: 'NONE' norms never read it."""
    if getattr(cfg, "norm_type", None) != "BN" or \
            getattr(cfg, "block_norm_type", "BN") != "BN":
        return params, state, cfg
    new_p = _fold_tree(params, state)
    if _has_bn(new_p):
        raise ValueError(f"{cfg.name}: a BatchNorm follows no conv and cannot fold")
    fields = {"norm_type": "NONE"}
    if hasattr(cfg, "block_norm_type"):
        fields["block_norm_type"] = "NONE"
    return new_p, state, dataclasses.replace(cfg, **fields)
