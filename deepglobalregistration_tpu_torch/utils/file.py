"""File listing and 3DMatch trajectory I/O (a copy of the JAX package's
``utils/file.py``; reference util/file.py:29-90)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, NamedTuple

import numpy as np


def _alphanum_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def sorted_alphanum(names: List[str]) -> List[str]:
    return sorted(names, key=_alphanum_key)


def get_file_list(path: str | Path, extension: str | None = None) -> List[str]:
    p = Path(path)
    files = [str(f) for f in p.iterdir() if f.is_file()
             and (extension is None or f.suffix == extension)]
    return sorted_alphanum(files)


def get_folder_list(path: str | Path) -> List[str]:
    return sorted_alphanum([str(f) for f in Path(path).iterdir() if f.is_dir()])


class CameraPose(NamedTuple):
    """One gt.log trajectory entry: metadata ids + 4x4 pose (util/file.py:69-90)."""

    meta: List[int]
    pose: np.ndarray


def read_trajectory(filename: str | Path, dim: int = 4) -> List[CameraPose]:
    """Parse a 3DMatch gt.log: blocks of one metadata line + dim pose rows."""
    traj = []
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        meta = [int(x) for x in lines[i].split()]
        rows = [list(map(float, lines[i + 1 + r].split())) for r in range(dim)]
        traj.append(CameraPose(meta=meta, pose=np.asarray(rows, dtype=np.float64)))
        i += dim + 1
    return traj


def write_trajectory(traj: List[CameraPose], filename: str | Path, dim: int = 4):
    with open(filename, "w") as f:
        for entry in traj:
            f.write(" ".join(map(str, entry.meta)) + "\n")
            for r in range(dim):
                f.write(" ".join(f"{v:.8f}" for v in entry.pose[r]) + "\n")
