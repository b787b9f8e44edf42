"""Checkpoint loading: the reference's torch ``.pth`` files and the native
checkpoints written by the JAX package.

Counterpart of the JAX package's ``utils/checkpoint.py``.

``.pth``: the reference saves {epoch, state_dict, state_dict_inlier,
optimizer, scheduler, config, best_val, ...} with MinkowskiEngine
state_dicts. ``convert_state_dict`` re-nests one into (params, state) trees
in the JAX package's layout, which the port's modules share::

    conv1.kernel            ->  params["conv1"]["kernel"]   [K, Cin, Cout]
    final.kernel [Cin, Cout] -> params["final"]["kernel"]   [1, Cin, Cout]
    norm1.bn.weight / bias  ->  params["norm1"]["weight" / "bias"]
    norm1.bn.running_mean   ->  state["norm1"]["mean"]   (running_var: "var")
    *.num_batches_tracked   ->  dropped

Native: a pickle (optionally zlib-deflated behind a ``DGRZ`` header) of numpy
trees with the same top-level schema. Arrays stored as
``ml_dtypes.bfloat16`` load WITHOUT ``ml_dtypes``: the unpickler rebuilds
every array from its raw bytes, reinterprets bfloat16 bits as
``torch.bfloat16`` and widens them to float32.
"""

from __future__ import annotations

import io
import pickle
import zlib
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_ZMAGIC = b"DGRZ"


def _set_nested(tree: Dict[str, Any], path: List[str], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_state_dict(sd: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A MinkowskiEngine state_dict as (params, state) numpy f32 trees."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for name, tensor in sd.items():
        arr = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") \
            else np.asarray(tensor)
        arr = arr.astype(np.float32)
        parts = name.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        if leaf == "kernel":
            _set_nested(params, parts, arr[None] if arr.ndim == 2 else arr)
        elif "bn" in parts:  # <scope>.bn.{weight, bias, running_mean, running_var}
            scope = parts[:-2]
            if leaf in ("weight", "bias"):
                _set_nested(params, scope + [leaf], arr)
            elif leaf in ("running_mean", "running_var"):
                _set_nested(state, scope + [leaf[len("running_"):]], arr)
        else:
            _set_nested(params, parts, arr)
    return params, state


def load_torch_checkpoint(path: str | Path) -> Dict[str, Any]:
    """A reference ``.pth`` checkpoint: the raw dict plus ``fcgf_params`` /
    ``fcgf_state`` (from ``state_dict``) and, where ``state_dict_inlier`` is
    not None, ``inlier_params`` / ``inlier_state``."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    out = dict(ckpt)
    if "state_dict" in ckpt:
        out["fcgf_params"], out["fcgf_state"] = convert_state_dict(ckpt["state_dict"])
    if ckpt.get("state_dict_inlier") is not None:
        out["inlier_params"], out["inlier_state"] = convert_state_dict(
            ckpt["state_dict_inlier"])
    return out


class _BF16:
    """Stand-in for the ``ml_dtypes.bfloat16`` scalar type."""


class _BF16Dtype:
    """Stand-in for ``np.dtype(bfloat16)``; absorbs the dtype's pickled state."""

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=False):
    if obj is _BF16:
        return _BF16Dtype()
    return np.dtype(obj, align, copy)


class _Array:
    """An ndarray rebuilt from its pickled state (shape, dtype, raw bytes)."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        order = "F" if fortran else "C"
        if isinstance(dtype, _BF16Dtype):
            bits = np.frombuffer(raw, np.int16).reshape(shape, order=order)
            self.value = torch.from_numpy(bits.copy()).view(torch.bfloat16) \
                .float().numpy()
        elif dtype.hasobject:
            self.value = np.array(raw, dtype=dtype).reshape(shape, order=order)
        else:
            self.value = np.frombuffer(raw, dtype).reshape(shape, order=order).copy()


def _reconstruct(cls, shape, typecode):
    return _Array()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module in ("numpy", "numpy.core", "numpy._core") and name == "dtype":
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return _reconstruct
        return super().find_class(module, name)


def _unwrap(tree):
    if isinstance(tree, _Array):
        return tree.value
    if isinstance(tree, dict):
        return {k: _unwrap(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unwrap(v) for v in tree)
    return tree


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The checkpoint's dict, with every array a numpy array (bf16 -> f32)."""
    blob = Path(path).read_bytes()
    if blob[:4] == _ZMAGIC:
        blob = zlib.decompress(blob[4:])
    return _unwrap(_Unpickler(io.BytesIO(blob)).load())
