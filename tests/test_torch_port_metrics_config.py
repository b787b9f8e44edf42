"""Port vs JAX package: ``ops/metrics.py`` and the configuration.

Metrics: every function on random rotations and translations, and at the
clamps (identical rotations, half turns), f32 on both sides: atol 1e-6 on
radians and metres, 1e-5 on degrees (57.3 times the radians' rounding);
``rte_rre``'s success flag equal. The random pairs lie 2-150 deg apart,
where arccos' slope is at most 2: the two packages sum the trace in
different f32 orders (XLA's FMA chain, PyTorch's reduction), which may
differ by an ulp, and near 0 or 180 deg arccos magnifies that ulp past
1e-6 in either package.

Configuration: ``get_config`` parses every flag of the JAX parser with the
same group, name, type and default, plus ``--device``; on the argv that the
repo's training scripts pass (recorded by running each script with
``python`` stubbed out) every value equals the JAX parser's.
"""

import dataclasses
import os
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu import config as jconfig
from deepglobalregistration_tpu.ops import metrics as jmetrics
from deepglobalregistration_tpu_torch import config
from deepglobalregistration_tpu_torch.ops import metrics

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-6


def _rotations(rng, b: int) -> np.ndarray:
    """Pairs of random rotations 2-150 deg apart, then the clamp cases:
    equal rotations (tr = 3) and half turns (tr = -1)."""
    R = Rotation.random(b, random_state=rng).as_matrix()
    rel = Rotation.from_rotvec(_unit(rng.randn(b, 3))
                               * np.radians(rng.uniform(2.0, 150.0, (b, 1))))
    R2 = (R @ rel.as_matrix()).astype(np.float32)
    R = R.astype(np.float32)
    R2[:3] = R[:3]  # rotation error 0: the upper clamp
    R2[3] = R[3] @ np.diag([-1.0, -1.0, 1.0]).astype(np.float32)  # half turn
    R2[4] = R[4] @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return R, R2


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(fn_name, *arrays):
    a = getattr(metrics, fn_name)(*[torch.as_tensor(x) for x in arrays])
    b = getattr(jmetrics, fn_name)(*[jnp.asarray(x) for x in arrays])
    return np.asarray(a), np.asarray(b)


def test_rotation_and_translation_errors(rng):
    R, R2 = _rotations(rng, 16)
    for i in range(len(R)):
        a, b = _both("rotation_error", R[i], R2[i])
        np.testing.assert_allclose(a, b, atol=ATOL)
    a, b = _both("batch_rotation_error", R, R2)
    np.testing.assert_allclose(a, b, atol=ATOL)
    a, b = _both("batch_rotation_error", R.reshape(-1, 9), R2.reshape(-1, 9))
    np.testing.assert_allclose(a, b, atol=ATOL)
    # The clamps: 0.9999 for one pair, 0.999 batched.
    np.testing.assert_allclose(_both("rotation_error", R[0], R2[0])[0],
                               np.arccos(np.float32(0.9999)), atol=ATOL)
    np.testing.assert_allclose(_both("batch_rotation_error", R, R2)[0][:3],
                               np.arccos(np.float32(0.999)), atol=ATOL)
    t1, t2 = rng.randn(16, 3).astype(np.float32), rng.randn(16, 3).astype(np.float32)
    a, b = _both("batch_translation_error", t1, t2)
    np.testing.assert_allclose(a, b, atol=ATOL)
    a, b = _both("translation_error", t1[0], t2[0])
    np.testing.assert_allclose(a, b, atol=ATOL)


def test_rte_rre_success_flags_equal(rng):
    R, R2 = _rotations(rng, 12)
    flags = []
    for i in range(len(R)):
        T, T2 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
        T[:3, :3], T2[:3, :3] = R[i], R2[i] if i < 6 else R[i]
        T2[:3, 3] = rng.randn(3).astype(np.float32) * (0.05 if i % 2 else 0.5)
        got = metrics.rte_rre(torch.as_tensor(T), torch.as_tensor(T2), 0.3, 15.0)
        want = jmetrics.rte_rre(jnp.asarray(T), jnp.asarray(T2), 0.3, 15.0)
        assert bool(got[0]) == bool(want[0])
        np.testing.assert_allclose(float(got[1]), float(want[1]), atol=ATOL)
        np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-5)
        flags.append(bool(got[0]))
    assert any(flags) and not all(flags)


@pytest.mark.parametrize("weighted,masked", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_corr_dist(rng, weighted, masked):
    xyz = rng.randn(200, 3).astype(np.float32)
    R, R2 = _rotations(rng, 6)
    est, gth = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    est[:3, :3], gth[:3, :3] = R[5], R2[5]
    est[:3, 3] = rng.randn(3) * 0.1
    w = rng.rand(200).astype(np.float32) if weighted else None
    m = rng.rand(200) > 0.3 if masked else None
    a = metrics.corr_dist(torch.as_tensor(est), torch.as_tensor(gth), torch.as_tensor(xyz),
                          None if w is None else torch.as_tensor(w), 1.0,
                          None if m is None else torch.as_tensor(m))
    b = jmetrics.corr_dist(jnp.asarray(est), jnp.asarray(gth), jnp.asarray(xyz),
                           None if w is None else jnp.asarray(w), 1.0,
                           None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(float(a), float(b), atol=ATOL)


@pytest.mark.parametrize("dist_type", ["L2", "SquareL2"])
def test_pdist(rng, dist_type):
    A, B = rng.rand(40, 8).astype(np.float32), rng.rand(50, 8).astype(np.float32)
    a = metrics.pdist(torch.as_tensor(A), torch.as_tensor(B), dist_type).numpy()
    b = np.asarray(jmetrics.pdist(jnp.asarray(A), jnp.asarray(B), dist_type))
    np.testing.assert_allclose(a, b, atol=ATOL)
    with pytest.raises(NotImplementedError):
        metrics.pdist(torch.as_tensor(A), torch.as_tensor(B), "L1")


def _actions(parser):
    """{dest: (group title, option strings, type, default, choices, nargs)}."""
    out = {}
    for group in parser._action_groups:
        for a in group._group_actions:
            if a.dest != "help":
                out[a.dest] = (group.title, tuple(a.option_strings), a.type, a.default,
                               a.choices, a.nargs, type(a).__name__)
    return out


def test_parser_has_every_jax_flag_plus_device():
    port, jax = _actions(config.parser), _actions(jconfig.parser)
    assert set(port) == set(jax) | {"device"}
    for dest, spec in jax.items():
        p = port[dest]
        # Same group, name, default, choices, action; types by name (each
        # module has its own str2bool).
        assert p[:2] == spec[:2] and p[3:] == spec[3:], dest
        assert getattr(p[2], "__name__", p[2]) == getattr(spec[2], "__name__", spec[2])
    assert port["device"][3] == "cuda"
    assert {f.name for f in dataclasses.fields(config.Config)} == set(port)


def _script_argvs(script: Path):
    """The argv of every ``python`` call of a shell script, with the
    script's defaults (``python`` replaced by a function that records its
    arguments)."""
    stub = 'python() { printf "%s\\0" "$@"; printf "\\n\\0"; }; source "$0"'
    out = subprocess.run(["bash", "-c", stub, str(script)], capture_output=True,
                         check=True, env={"PATH": os.environ["PATH"]}).stdout
    calls = [c.split(b"\0") for c in out.split(b"\n\0") if c]
    argvs = []
    for call in calls:
        argv = [t.decode() for t in call if t]
        first = next(i for i, t in enumerate(argv) if t.startswith("--"))
        argvs.append(argv[first:])
    return argvs


@pytest.mark.parametrize("script", ["train_3dmatch.sh", "train_kitti.sh"])
def test_get_config_on_the_training_scripts(script):
    argvs = _script_argvs(ROOT / "scripts" / script)
    assert len(argvs) == 2 and any("--voxel_size" in a for a in argvs)
    for argv in argvs + [[]]:
        got = dataclasses.asdict(config.get_config(argv))
        want = vars(jconfig.parser.parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want


def test_get_config_device_and_bools():
    cfg = config.get_config(["--device", "cpu", "--bf16", "true", "--test_random_crop",
                             "--icp_candidates", "on"])
    assert (cfg.device, cfg.bf16, cfg.test_random_crop, cfg.icp_candidates) == (
        "cpu", True, True, "on")
    with pytest.raises(SystemExit):
        config.get_config(["--icp_candidates", "sometimes"])


def test_default_config_raises_on_an_unknown_key():
    cfg = config.default_config(voxel_size=0.3, device="cpu")
    assert (cfg.voxel_size, cfg.device) == (0.3, "cpu")
    assert cfg == config.get_config(["--voxel_size", "0.3", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown config key"):
        config.default_config(no_such_flag=1)
