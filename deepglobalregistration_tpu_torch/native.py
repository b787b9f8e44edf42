"""ctypes binding of the native host engine (the repo's ``native/dgr_host.cpp``).

The data pipeline's host work: voxel dedup (``unique_rows``), voxelization
(``voxelize``), host kernel maps (``kernel_map``) and ground-truth radius
pairs (``radius_pairs``). The counterpart of the JAX package's
``native/__init__.py``, with two differences:

- the library is built from the same source, read only, with ``g++ -O3
  -march=native -shared -fPIC -fopenmp`` into ``_build/libdgr_host-<hash>.so``
  (the hash is of the source and the flags), written under a temporary name
  and renamed into place, so that processes building at once each find a
  whole library (within a process, a lock);
- a failed build or load raises. There is no quiet numpy path: the numpy
  versions (``*_plain``) are the plain versions the tests hold the library
  against.

Nothing is built at import; the first call builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .utils.pointcloud import get_matching_indices

SRC = Path(__file__).resolve().parent.parent / "native" / "dgr_host.cpp"
BUILD = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")

_lib = None
_lock = threading.Lock()


def _target() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD / f"libdgr_host-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path."""
    out = _target()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.dgr_unique_rows.restype = ctypes.c_int64
            lib.dgr_unique_rows.argtypes = [i32p, ctypes.c_int64, ctypes.c_int,
                                            i32p, i32p]
            lib.dgr_voxelize.restype = ctypes.c_int64
            lib.dgr_voxelize.argtypes = [f32p, ctypes.c_int64, ctypes.c_double,
                                         f32p, i32p]
            lib.dgr_kernel_map.restype = None
            lib.dgr_kernel_map.argtypes = [i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                                           ctypes.c_int, i32p, ctypes.c_int64,
                                           ctypes.c_int32, ctypes.c_int32, i32p]
            lib.dgr_radius_pairs.restype = ctypes.c_int64
            lib.dgr_radius_pairs.argtypes = [f32p, ctypes.c_int64, f32p,
                                             ctypes.c_int64, f32p, f32p,
                                             ctypes.c_double, i32p, ctypes.c_int64]
            _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _rows(a: np.ndarray, name: str, width: int | None = None) -> None:
    if a.ndim != 2 or (width is not None and a.shape[1] != width):
        raise ValueError(f"{name}: expected [N, {width or 'D'}], got {a.shape}")
    if a.shape[1] > 8:
        raise ValueError(f"{name}: at most 8 coordinates a row, got {a.shape[1]}")


def unique_rows(coords: np.ndarray):
    """Dedup keeping the smallest-index representative, in index order.
    Returns (unique_coords [M, D] int32, src_idx [M] int32)."""
    coords = _i32(coords)
    _rows(coords, "unique_rows")
    n, d = coords.shape
    out = np.empty_like(coords)
    src = np.empty(n, np.int32)
    m = load().dgr_unique_rows(_ptr(coords, ctypes.c_int32), n, d,
                               _ptr(out, ctypes.c_int32), _ptr(src, ctypes.c_int32))
    return out[:m], src[:m]


def voxelize(xyz: np.ndarray, voxel_size: float):
    """floor(xyz / voxel_size) in f64, one point a voxel (the smallest index).
    Returns (xyz_sel [M, 3] f32, coords [M, 3] int32)."""
    xyz = _f32(xyz)
    _rows(xyz, "voxelize", 3)
    n = len(xyz)
    out_xyz = np.empty_like(xyz)
    out_coords = np.empty((n, 3), np.int32)
    m = load().dgr_voxelize(_ptr(xyz, ctypes.c_float), n, voxel_size,
                            _ptr(out_xyz, ctypes.c_float),
                            _ptr(out_coords, ctypes.c_int32))
    return out_xyz[:m], out_coords[:m]


def kernel_map(in_coords: np.ndarray, out_coords: np.ndarray, offsets: np.ndarray,
               unit: int, transpose: bool = False) -> np.ndarray:
    """Host kernel map; returns [K, n_out] int32 (-1 = empty site)."""
    in_coords, out_coords, offsets = _i32(in_coords), _i32(out_coords), _i32(offsets)
    _rows(in_coords, "kernel_map in_coords")
    _rows(out_coords, "kernel_map out_coords", in_coords.shape[1])
    _rows(offsets, "kernel_map offsets", in_coords.shape[1])
    k, d = offsets.shape
    n_out = len(out_coords)
    kmap = np.empty((k, n_out), np.int32)
    load().dgr_kernel_map(_ptr(in_coords, ctypes.c_int32), len(in_coords),
                          _ptr(out_coords, ctypes.c_int32), n_out, d,
                          _ptr(offsets, ctypes.c_int32), k, unit,
                          -1 if transpose else 1, _ptr(kmap, ctypes.c_int32))
    return kmap


def radius_pairs(src: np.ndarray, tgt: np.ndarray, trans: np.ndarray,
                 radius: float, max_pairs: int | None = None) -> np.ndarray:
    """All (i, j) with |T(src[i]) - tgt[j]| <= radius, at most ``max_pairs``
    (default max(32 N, 2^20); pairs past it are dropped, as in the JAX
    package). [M, 2] int32, in the library's order."""
    src, tgt = _f32(src), _f32(tgt)
    _rows(src, "radius_pairs src", 3)
    _rows(tgt, "radius_pairs tgt", 3)
    if max_pairs is None:
        max_pairs = max(len(src) * 32, 1 << 20)
    rot = _f32(np.asarray(trans)[:3, :3])
    t = _f32(np.asarray(trans)[:3, 3])
    pairs = np.empty((max_pairs, 2), np.int32)
    m = load().dgr_radius_pairs(_ptr(src, ctypes.c_float), len(src),
                                _ptr(tgt, ctypes.c_float), len(tgt),
                                _ptr(rot, ctypes.c_float), _ptr(t, ctypes.c_float),
                                radius, _ptr(pairs, ctypes.c_int32), max_pairs)
    return pairs[:m]


# Plain numpy versions, which the tests hold the library against.

def unique_rows_plain(coords: np.ndarray):
    coords = _i32(coords)
    _, sel = np.unique(coords, axis=0, return_index=True)
    sel = np.sort(sel)
    return coords[sel], sel.astype(np.int32)


def voxelize_plain(xyz: np.ndarray, voxel_size: float):
    xyz = _f32(xyz)
    coords = np.floor(xyz.astype(np.float64) / voxel_size).astype(np.int32)
    _, sel = unique_rows_plain(coords)
    return xyz[sel], coords[sel]


def kernel_map_plain(in_coords, out_coords, offsets, unit: int,
                     transpose: bool = False) -> np.ndarray:
    in_coords, out_coords, offsets = _i32(in_coords), _i32(out_coords), _i32(offsets)
    table = {tuple(c): i for i, c in reversed(list(enumerate(in_coords)))}
    sign = -1 if transpose else 1
    kmap = np.full((len(offsets), len(out_coords)), -1, np.int32)
    for ki, off in enumerate(offsets):
        for j, q in enumerate(out_coords + sign * off * unit):
            kmap[ki, j] = table.get(tuple(q), -1)
    return kmap


def radius_pairs_plain(src, tgt, trans, radius: float) -> np.ndarray:
    """The same pair set (scipy KD-tree), in another order."""
    return get_matching_indices(_f32(src), _f32(tgt), trans, radius).astype(np.int32)
