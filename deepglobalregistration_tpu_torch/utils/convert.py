"""Parameter trees (the JAX package's layout) <-> the port's modules.

The JAX package keeps parameters as nested dicts named after
MinkowskiEngine's state_dict ({"conv1": {"kernel"}, "norm1": {"weight",
"bias"}} with BN running statistics in a separate state tree {"norm1":
{"mean", "var"}}). The port's modules use the same names, so
``from_jax_params`` flattens the trees to a state_dict's dotted keys and
``to_jax_params`` nests a module's tensors back, for checkpoints. Accepts
folded trees (norm_type 'NONE': the state tree is then unused) and unfolded
ones.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            _flatten(value, key + ".", out)
        else:
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))


def from_jax_params(params: Dict[str, Any], state: Dict[str, Any], cfg
                    ) -> Dict[str, torch.Tensor]:
    """The port module's state_dict for numpy (or JAX) param/state trees."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(params, "", out)
    if getattr(cfg, "norm_type", "NONE") != "NONE":
        _flatten(state, "", out)
    return out


def _put(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def to_jax_params(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``from_jax_params``: (params, state) numpy trees of a
    registry net in the JAX package's layout. Every conv gives {"kernel"
    [, "bias"]} in params; every norm gives {"weight", "bias"} in params and
    {"mean", "var"} in state for BN and INBN, and empty dicts for IN and
    'NONE', as the JAX package's ``init_norm``."""
    from ..models.common import Conv, Norm

    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for name, m in module.named_modules():
        path = name.split(".")
        if isinstance(m, Conv):
            leaf = {"kernel": _np(m.kernel)}
            if m.bias is not None:
                leaf["bias"] = _np(m.bias)
            _put(params, path, leaf)
        elif isinstance(m, Norm):
            _put(params, path, {"weight": _np(m.weight), "bias": _np(m.bias)}
                 if m.batch else {})
            _put(state, path, {"mean": _np(m.mean), "var": _np(m.var)}
                 if m.batch else {})
    return params, state
