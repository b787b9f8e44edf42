"""Point-cloud host utilities: GT matching, overlap, PLY I/O.

A copy of the JAX package's ``utils/pointcloud.py``: scipy in place of the
Open3D helpers of the reference's util/pointcloud.py (KD-tree GT matching
:83-96, overlap ratio :72-80), and a dependency-free PLY reader/writer
(o3d.io.read_point_cloud at threedmatch_loader.py:192-193, demo.py:34-36),
byte for byte the JAX package's format. These run on the host, in the data
pipeline, not on the card.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree


def apply_transform_np(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return pts @ trans[:3, :3].T + trans[:3, 3]


def get_matching_indices(source: np.ndarray, target: np.ndarray, trans: np.ndarray,
                         search_voxel_size: float, K: int | None = None) -> np.ndarray:
    """GT positive pairs: for each transformed source point, all target points
    within search_voxel_size (util/pointcloud.py:83-96). Returns [M, 2] int."""
    moved = apply_transform_np(source, trans)
    tree = cKDTree(target)
    pairs = []
    for i, neighbors in enumerate(tree.query_ball_point(moved, search_voxel_size)):
        if K is not None:
            neighbors = neighbors[:K]
        for j in neighbors:
            pairs.append((i, j))
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def compute_overlap_ratio(pcd0: np.ndarray, pcd1: np.ndarray, trans: np.ndarray,
                          voxel_size: float) -> float:
    """Symmetric overlap fraction at voxel-size matching distance
    (util/pointcloud.py:72-80)."""
    matching01 = get_matching_indices(pcd0, pcd1, trans, voxel_size, K=1)
    matching10 = get_matching_indices(pcd1, pcd0,
                                      np.linalg.inv(trans), voxel_size, K=1)
    o01 = len(matching01) / max(len(pcd0), 1)
    o10 = len(matching10) / max(len(pcd1), 1)
    return max(o01, o10)


def evaluate_feature_3dmatch(pcd0, pcd1, feat0, feat1, trans_gth,
                             inlier_thresh: float = 0.1) -> float:
    """Feature-matching hit ratio under GT transform (util/pointcloud.py:99-130):
    fraction of mutual-nearest feature matches within inlier_thresh meters."""
    tree = cKDTree(feat1)
    _, nn = tree.query(feat0)
    moved = apply_transform_np(pcd0, trans_gth)
    dist = np.linalg.norm(moved - pcd1[nn], axis=1)
    return float((dist < inlier_thresh).mean())


# ---------------------------------------------------------------------------
# Minimal PLY point-cloud I/O (xyz properties; ascii + binary_little_endian)
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8), "float64": ("d", 8),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
    "short": ("h", 2), "ushort": ("H", 2), "char": ("b", 1), "uchar": ("B", 1),
    "int8": ("b", 1), "uint8": ("B", 1), "int16": ("h", 2), "uint16": ("H", 2),
}


def read_point_cloud(path: str | Path) -> np.ndarray:
    """Read the xyz vertices of a .ply file into [N, 3] float32."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii", "ignore")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n_vertex = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list property in vertex element unsupported")
                props.append((parts[1], parts[2]))
            elif line == "end_header":
                break

        names = [p[1] for p in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex).reshape(n_vertex, -1)
            return data[:, [ix, iy, iz]].astype(np.float32)
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        rec = np.dtype([(f"p{i}", "<" + {"f": "f4", "d": "f8", "i": "i4", "I": "u4",
                                         "h": "i2", "H": "u2", "b": "i1", "B": "u1"}[
            _PLY_TYPES[t][0]]) for i, (t, _) in enumerate(props)])
        data = np.frombuffer(f.read(rec.itemsize * n_vertex), dtype=rec, count=n_vertex)
        return np.stack([data[f"p{ix}"], data[f"p{iy}"], data[f"p{iz}"]], 1).astype(np.float32)


def write_point_cloud(path: str | Path, xyz: np.ndarray):
    """Write [N, 3] points as binary_little_endian PLY."""
    xyz = np.asarray(xyz, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(xyz)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\nend_header\n")
        f.write(xyz.astype("<f4").tobytes())
