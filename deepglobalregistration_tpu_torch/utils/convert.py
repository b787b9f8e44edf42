"""Parameter trees (the JAX package's layout) -> the port's module state_dicts.

The JAX package keeps parameters as nested dicts named after
MinkowskiEngine's state_dict ({"conv1": {"kernel"}, "norm1": {"weight",
"bias"}} with BN running statistics in a separate state tree {"norm1":
{"mean", "var"}}). The port's modules use the same names, so conversion is a
flattening to dotted keys. Accepts folded trees (norm_type 'NONE': the state
tree is then unused) and unfolded ones.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
