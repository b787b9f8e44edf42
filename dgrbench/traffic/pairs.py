"""The one generator of every mix: a pool of registration pairs drawn from a
seed, as the mix's parameters say.

Parameters (keys of a mix file):

- ``scene``: ``"street"`` (two vantage views of one street scene at least
  10 m apart, the KITTI odometry protocol) or ``"room"`` (two half-space
  crops of one room, each under its own random rotation);
- ``points``: street: points a sweep (a view with more is cut to this many);
  room: points of the room;
- ``scene_points``: street: points of the whole scene;
- ``pool``: pairs in the pool;
- ``keep``: room: [low, high) share of the room each crop keeps;
- ``rotation_deg``: room: range of each cloud's rotation;
- ``scale``: [low, high) of a random scale, drawn with probability
  ``scale_prob`` (training's augmentation), else none.

Each pair comes from its own stream of the pool's seed (pair i of seed s
draws from ``SeedSequence([s, i])``), so a pool's pairs do not depend on its
size. A mix fixes its pool's seed (``pool_seed``): every run serves the same
set of pairs, and the run's own seed orders them (and draws the nets, where
the mix fixes no ``weights_seed``), so that runs of different seeds do the
same work.
Returns a list of dicts: ``xyz0``, ``xyz1`` float32 [N, 3], ``T`` [4, 4]
float64 (the pose taking xyz0 into xyz1's frame), ``scale``.
"""

from __future__ import annotations

import numpy as np

from . import scenes


def rng_for(seed: int, i: int) -> np.random.RandomState:
    state = np.random.SeedSequence([int(seed) % 2 ** 64, i % 2 ** 32]).generate_state(1)[0]
    return np.random.RandomState(int(state))


def _street(rng, mix):
    scene = scenes.make_outdoor_scene(rng, int(mix["scene_points"]))
    xyz0, xyz1, T = scenes.lidar_views(rng, scene)
    n = int(mix["points"])
    cut = lambda x: x[np.sort(rng.choice(len(x), n, replace=False))] if len(x) > n else x
    return cut(xyz0), cut(xyz1), T.astype(np.float64)


def _room(rng, mix):
    room = scenes.make_room(rng, int(mix["points"]))
    lo, hi = mix["keep"]
    keep = lo + (hi - lo) * rng.rand()
    xyz0 = scenes.crop_view(rng, room, keep)
    xyz1 = scenes.crop_view(rng, room, keep)
    return xyz0, xyz1, np.eye(4)


def pair(seed: int, i: int, mix: dict) -> dict:
    rng = rng_for(seed, i)
    xyz0, xyz1, T = (_street if mix["scene"] == "street" else _room)(rng, mix)
    scale = 1.0
    if "scale" in mix and rng.rand() < mix["scale_prob"]:
        lo, hi = mix["scale"]
        scale = lo + (hi - lo) * rng.rand()
        xyz0, xyz1 = scale * xyz0, scale * xyz1
        T = T.copy()
        T[:3, 3] *= scale
    if mix.get("rotation_deg"):
        T0 = scenes.sample_random_trans(xyz0, rng, mix["rotation_deg"])
        T1 = scenes.sample_random_trans(xyz1, rng, mix["rotation_deg"])
        T = T1 @ T @ np.linalg.inv(T0)
        xyz0 = xyz0 @ T0[:3, :3].T + T0[:3, 3]
        xyz1 = xyz1 @ T1[:3, :3].T + T1[:3, 3]
    return {"xyz0": np.ascontiguousarray(xyz0, np.float32),
            "xyz1": np.ascontiguousarray(xyz1, np.float32), "T": T, "scale": scale}


def pool(seed: int, mix: dict, count: int | None = None) -> list:
    return [pair(seed, i, mix) for i in range(int(count or mix["pool"]))]
