"""Loader for the native checkpoints written by the JAX package.

Counterpart of the JAX package's ``utils/checkpoint.py:86-164``: a pickle
(optionally zlib-deflated behind a ``DGRZ`` header) of numpy trees with the
reference schema {epoch, state_dict, state_dict_inlier, optimizer, config,
...}. Arrays stored as ``ml_dtypes.bfloat16`` load WITHOUT ``ml_dtypes``:
the unpickler rebuilds every array from its raw bytes, reinterprets
bfloat16 bits as ``torch.bfloat16`` and widens them to float32.
"""

from __future__ import annotations

import io
import pickle
import zlib
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

_ZMAGIC = b"DGRZ"


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
