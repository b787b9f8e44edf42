"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (the hash is of the source and the ``*.cuh``
headers beside it, so an edited source or header rebuilds) at first use. Nothing here runs at import time.

Threads may launch kernels at once (``register_many``): the first load of a
library runs under a lock, and so does each add to a wrapper's launch count
(``count_launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD = PKG_DIR / "_build"
SOURCES = ("nn1_scan", "nn1_mma", "gather", "slot_sum")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a shared header rebuilds all
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES, verbose: bool = False) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:  # one build and load, whichever thread comes first
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build((name,))[name]))
                _loaded[name] = lib
    return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``. ``+=`` on an attribute reads, adds
    and writes, so two threads adding at once could lose a launch."""
    with _count_lock:
        wrapper.launches += n
