"""Read a native DGR checkpoint (``*.pkl``: a pickle of numpy trees, zlib
deflated behind a ``DGRZ`` header, bfloat16 arrays pickled as
``ml_dtypes.bfloat16``) without ``ml_dtypes``: every array is rebuilt from
its raw bytes, bfloat16 bits widened to float32."""

from __future__ import annotations

import io
import pickle
import zlib

import numpy as np
import torch


class _BF16:
    pass


class _BF16Dtype:
    def __setstate__(self, state):
        pass


class _Array:
    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        order = "F" if fortran else "C"
        if isinstance(dtype, _BF16Dtype):
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            self.value = bits.view(np.float32).reshape(shape, order=order).copy()
        elif dtype.hasobject:
            self.value = np.array(raw, dtype=dtype).reshape(shape, order=order)
        else:
            self.value = np.frombuffer(raw, dtype).reshape(shape, order=order).copy()


def _dtype(obj, align=False, copy=False):
    return _BF16Dtype() if obj is _BF16 else np.dtype(obj, align, copy)


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module in ("numpy", "numpy.core", "numpy._core") and name == "dtype":
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") \
                and name == "_reconstruct":
            return lambda *a: _Array()
        return super().find_class(module, name)


def _unwrap(t, device):
    if isinstance(t, _Array):
        return torch.as_tensor(np.asarray(t.value, np.float32), device=device) \
            if t.value.dtype != object else t.value
    if isinstance(t, dict):
        return {k: _unwrap(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_unwrap(v, device) for v in t)
    return t


def load(path: str, device="cpu") -> dict:
    """The checkpoint's dict, every array a float32 tensor on ``device``."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:4] == b"DGRZ":
        blob = zlib.decompress(blob[4:])
    return _unwrap(_Reader(io.BytesIO(blob)).load(), device)
