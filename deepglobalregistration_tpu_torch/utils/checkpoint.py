"""Checkpoints: loading the reference's torch ``.pth`` files, and loading and
writing the native checkpoints of the JAX package's schema.

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
``torch.bfloat16`` and widens them to float32. ``save_checkpoint`` writes
such arrays without ``ml_dtypes`` too: torch rounds the f32 leaves to
bfloat16 (round to nearest even, as ``ml_dtypes``), and the pickler emits
for each the records numpy's own pickling of an ``ml_dtypes.bfloat16``
array holds, so the JAX package's ``load_checkpoint`` reads the file as
one it wrote.
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


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

class _BF16Type:
    """Pickled as the global ``ml_dtypes.bfloat16`` (``_Writer.save_global``)."""


class _BF16Descr:
    """Pickled as ``np.dtype(ml_dtypes.bfloat16)``."""


_BF16_DESCR = _BF16Descr()
# numpy's pickled state of that dtype: version, byte order, no subarray,
# names or fields, item size 2, alignment 2, flags.
_BF16_DESCR_STATE = (3, "<", None, None, None, 2, 2, 64)
_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(1))[0]


class _BF16Array:
    """An f32 array stored as bfloat16 bits (int16, round to nearest even)."""

    def __init__(self, arr: np.ndarray):
        self.shape = arr.shape
        self.bits = torch.from_numpy(np.ascontiguousarray(arr, np.float32)) \
            .to(torch.bfloat16).view(torch.int16).numpy()


class _Writer(pickle._Pickler):
    """The pure-Python pickler (its ``save_global`` can be overridden),
    writing ``_BF16Array`` leaves as numpy pickles ``ml_dtypes.bfloat16``
    arrays."""

    def reducer_override(self, obj):
        if isinstance(obj, _BF16Array):
            return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, obj.shape, _BF16_DESCR, False, obj.bits.tobytes()))
        if obj is _BF16_DESCR:
            return (np.dtype, (_BF16Type, False, True), _BF16_DESCR_STATE)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is _BF16Type:
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _storage_cast(tree, dtype: str | None):
    """Numpy copies of a tree's tensors and arrays; with ``dtype`` 'bf16'
    every f32 array of rank >= 1 is stored as bfloat16. Integer, bool and
    scalar leaves pass through exactly."""
    if dtype not in (None, "f32", "float32", "bf16", "bfloat16"):
        raise ValueError(f"unknown checkpoint dtype {dtype!r}")
    bf16 = dtype in ("bf16", "bfloat16")

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        if isinstance(x, np.ndarray) and bf16 and x.dtype == np.float32 and x.ndim:
            return _BF16Array(x)
        return x

    return cast(tree)


def save_checkpoint(path: str | Path, *, epoch: int, params, state,
                    inlier_params=None, inlier_state=None, opt_state=None,
                    config: Dict[str, Any] | None = None, best_val: float = -1e8,
                    best_val_epoch: int = -1, best_val_metric: str = "succ_rate",
                    dtype: str | None = None, compress: bool = False) -> None:
    """Write a native checkpoint in the JAX package's schema
    (``utils/checkpoint.py:117-150`` there; reference trainer.py:527-549):
    {epoch, state_dict: {params, state} (the FCGF), state_dict_inlier,
    optimizer, config, best_val, best_val_epoch, best_val_metric}.

    Trees are numpy (``utils/convert.to_jax_params``) or torch. ``dtype``
    'bf16' stores f32 arrays as bfloat16 (``load_checkpoint`` of either
    package widens them back); ``compress`` deflates the pickle with zlib
    behind the ``DGRZ`` header. 'f32' without compression is lossless."""
    cast = lambda tree: _storage_cast(tree, dtype)
    payload = {
        "epoch": epoch,
        "state_dict": None if params is None else
            {"params": cast(params), "state": cast(state)},
        "state_dict_inlier": None if inlier_params is None else
            {"params": cast(inlier_params), "state": cast(inlier_state)},
        "optimizer": None if opt_state is None else cast(opt_state),
        "config": config,
        "best_val": best_val,
        "best_val_epoch": best_val_epoch,
        "best_val_metric": best_val_metric,
    }
    buf = io.BytesIO()
    _Writer(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    blob = buf.getvalue()
    if compress:
        blob = _ZMAGIC + zlib.compress(blob, level=1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)
