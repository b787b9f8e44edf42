"""RGB-D TSDF fragment integration on the card (util/integration.py:44-141).

Counterpart of the JAX package's ``utils/integration.py``: fuse a sequence of
depth images into a fragment point cloud, the tool the reference uses (via
Open3D's ScalableTSDFVolume) to build the 3DMatch training fragments. A
dense truncated signed-distance volume over a fixed box, updated once a
frame, with surface points at the zero crossings.

The volumes (``tsdf``, ``weight``) are float32 tensors on ``device``. The
geometry is float64, as the JAX version's numpy is (an int64 voxel grid
times a float), so both round pixel coordinates alike and the volumes agree
bit for bit: ``u`` and ``v`` round half to even in float64, the signed
distance and the running average are float64 and are stored into the
float32 volumes. A frame runs in slabs along x of at most ``SLAB_VOXELS``
voxels, so that the tool's default 600 x 600 x 400 volume does not build
~12 GB of per-frame intermediates.

CLI: python -m deepglobalregistration_tpu_torch.utils.integration --help
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

SLAB_VOXELS = 1 << 22  # voxels a slab: ~0.6 GiB of float64 intermediates


class TSDFVolume:
    """Dense TSDF volume over a fixed bounding box, on ``device``."""

    def __init__(self, origin, voxel_size: float, dims: tuple, sdf_trunc: float,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.origin = np.asarray(origin)  # [3] world coords of voxel (0, 0, 0)
        self.voxel_size = voxel_size
        self.dims = tuple(int(d) for d in dims)  # (nx, ny, nz)
        self.sdf_trunc = sdf_trunc
        self.tsdf = torch.ones(self.dims, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(self.dims, dtype=torch.float32, device=self.device)
        self._origin64 = torch.as_tensor(self.origin, dtype=torch.float64,
                                         device=self.device)

    def _slab_points(self, x0: int, x1: int) -> torch.Tensor:
        """World coordinates [(x1 - x0) ny nz, 3] f64 of the voxels of
        planes x0..x1-1, in the volume's row-major order."""
        _, ny, nz = self.dims
        ar = lambda a, b: torch.arange(a, b, dtype=torch.int64, device=self.device)
        ii, jj, kk = torch.meshgrid(ar(x0, x1), ar(0, ny), ar(0, nz), indexing="ij")
        ijk = torch.stack([ii, jj, kk], -1).reshape(-1, 3)
        return ijk.double() * float(self.voxel_size) + self._origin64

    def integrate(self, depth, intrinsics: np.ndarray, extrinsic: np.ndarray,
                  depth_trunc: float = 4.0):
        """Fuse one depth image (meters). extrinsic: world->camera 4x4."""
        depth = torch.as_tensor(np.asarray(depth), dtype=torch.float32,
                                device=self.device)
        E = torch.as_tensor(np.asarray(extrinsic), device=self.device).double()
        fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
        cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])
        h, w = depth.shape
        nx, ny, nz = self.dims
        step = max(1, SLAB_VOXELS // max(ny * nz, 1))
        flat_t, flat_w = self.tsdf.view(nx, -1), self.weight.view(nx, -1)
        for x0 in range(0, nx, step):
            x1 = min(nx, x0 + step)
            cam = self._slab_points(x0, x1) @ E[:3, :3].T + E[:3, 3]
            z = cam[:, 2]
            front = z > 0.05
            zs = torch.where(front, z, torch.ones_like(z))
            u = torch.round(cam[:, 0] / zs * fx + cx)
            v = torch.round(cam[:, 1] / zs * fy + cy)
            valid = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            ui = torch.where(valid, u, torch.zeros_like(u)).long()
            vi = torch.where(valid, v, torch.zeros_like(v)).long()
            d = torch.where(valid, depth[vi, ui], torch.zeros((), device=self.device))
            valid &= (d > 0) & (d < depth_trunc)
            sdf = d.double() - z
            valid &= sdf > -self.sdf_trunc
            tsdf_new = torch.clamp(sdf / self.sdf_trunc, max=1.0)

            t, wt = flat_t[x0:x1].reshape(-1), flat_w[x0:x1].reshape(-1)
            sel = torch.nonzero(valid)[:, 0]
            t_old, w_old = t[sel], wt[sel]
            w_new = w_old + 1.0
            avg = ((t_old * w_old).double() + tsdf_new[sel]) / w_new.double()
            t[sel] = avg.float()  # t and wt are views of the volumes
            wt[sel] = w_new

    def extract_point_cloud(self, weight_thresh: float = 1.0) -> np.ndarray:
        """Surface points [M, 3] f32 (numpy): voxels whose TSDF changes sign
        along any axis between two observed voxels, in row-major order."""
        t, observed = self.tsdf, self.weight >= weight_thresh
        sign = torch.sign(t)
        cross = torch.zeros(self.dims, dtype=torch.bool, device=self.device)
        for axis in range(3):
            n = self.dims[axis]
            lo = lambda x: x.narrow(axis, 0, n - 1)
            hi = lambda x: x.narrow(axis, 1, n - 1)
            lo(cross).logical_or_((lo(sign) != hi(sign)) & lo(observed) & hi(observed))
        ijk = torch.nonzero(cross)
        pts = ijk.double() * float(self.voxel_size) + self._origin64
        return pts.float().cpu().numpy().reshape(-1, 3)


def integrate_rgbd_sequence(depth_files, intrinsics: np.ndarray, poses,
                            voxel_size: float = 0.01, sdf_trunc: float = 0.04,
                            bbox_min=(-3, -3, 0), bbox_max=(3, 3, 4),
                            device: str | torch.device = "cuda") -> np.ndarray:
    """Fuse a list of depth .png/.npy files with camera->world poses into
    points (util/integration.py:44-71 fragment builder)."""
    origin = np.asarray(bbox_min, np.float32)
    dims = tuple(int(np.ceil((hi - lo) / voxel_size))
                 for lo, hi in zip(bbox_min, bbox_max))
    vol = TSDFVolume(origin=origin, voxel_size=voxel_size, dims=dims,
                     sdf_trunc=sdf_trunc, device=device)
    for f, pose in zip(depth_files, poses):
        if str(f).endswith(".npy"):
            depth = np.load(f).astype(np.float32)
        else:
            depth = _read_depth_png(f)
        vol.integrate(depth, intrinsics, np.linalg.inv(pose))
    return vol.extract_point_cloud()


def _read_depth_png(path, scale: float = 1000.0) -> np.ndarray:
    """16-bit depth PNG in millimeters -> meters (3DMatch convention)."""
    try:
        from PIL import Image  # pillow may not be installed

        return np.asarray(Image.open(path), np.float32) / scale
    except ImportError as e:
        raise RuntimeError("reading PNG depth requires pillow; use .npy depth") from e


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth_dir", required=True, help="directory of depth .npy/.png")
    ap.add_argument("--pose_file", required=True,
                    help="npz with poses [N,4,4] camera->world")
    ap.add_argument("--intrinsics", required=True, help="npz/npy 3x3 K matrix")
    ap.add_argument("--voxel_size", type=float, default=0.01)
    ap.add_argument("--out", required=True, help="output .npz fragment (key pcd)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    depth_files = sorted(Path(args.depth_dir).iterdir())
    poses = np.load(args.pose_file)["poses"]
    K = np.load(args.intrinsics)
    if hasattr(K, "files"):
        K = K[K.files[0]]
    pcd = integrate_rgbd_sequence(depth_files, K, poses, voxel_size=args.voxel_size,
                                  device=args.device)
    np.savez(args.out, pcd=pcd)
    print(f"wrote {args.out}: {len(pcd)} points")
    return pcd


if __name__ == "__main__":
    main()
