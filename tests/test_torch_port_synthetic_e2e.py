"""Port vs the repo's ``tools/synthetic_e2e.py``: the train -> validate ->
benchmark chain (``deepglobalregistration_tpu_torch/tools/synthetic_e2e.py``).

The hit probe is held to the JAX tool's expression (tools/synthetic_e2e.py:
182-205), rebuilt here from the JAX package's functions on the same FCGF
parameters and batch (at level shrink 1 and without the dense box, so that
no JAX level truncates the small clouds). The three stages run on the CPU
with small nets (ResUNetBN2F / ResUNetBN2FX, 3000 points, two FCGF steps,
one inlier iteration) and write the JAX tool's summary schema; ``--skip_a``
and ``--skip_b`` reuse their checkpoints; stage A's learning rate is
optax's exponential decay step by step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.ops.knn import find_nn
from deepglobalregistration_tpu.ops.sparse_grid import Grid
from deepglobalregistration_tpu_torch.core import train_step as ts
from deepglobalregistration_tpu_torch.data.collate import PairBatch
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.tools import synthetic_e2e as e2e
from deepglobalregistration_tpu_torch.utils import convert
from torch_port_trees import numpy_tree, pair_batch, torch_threads

# The summary keys of the JAX tool (docs/e2e_r04_smoke/summary.json).
JAX_KEYS = ["n_points", "fcgf_steps", "max_epoch", "iters_per_epoch",
            "fcgf_final_loss", "fcgf_val_hit_ratio", "best_val", "best_val_epoch",
            "recall", "te", "re", "mean_time_s", "n_pairs", "stats_npz"]
SMALL = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
             inlier_model="ResUNetBN2FX", val_max_iter=1)
ARGS = ["--quick", "--device", "cpu", "--fcgf_steps", "2", "--iters_per_epoch", "1",
        "--synthetic_points", "3000"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax_hit_probe(spec, cfg, params, state, batch, radius):
    """tools/synthetic_e2e.py:182-205, at level shrink 1, no dense box."""
    @jax.jit
    def hit_probe(params, state, batch):
        b, n = batch.xyz0.shape[:2]
        grids = Grid(coords=jnp.concatenate([batch.coords0, batch.coords1], 0),
                     num=jnp.concatenate([batch.num0, batch.num1], 0))
        plan = jax.vmap(spec.build_plan, in_axes=(0, None, None, None, None))(
            grids, cfg, 1, None, True)
        feats, _ = spec.apply(params, state, cfg, plan,
                              jnp.ones((2 * b, n, 1), jnp.float32), train=False)
        feats = feats.astype(jnp.float32)
        idx, _ = jax.vmap(find_nn)(feats[:b], feats[b:], batch.num0, batch.num1)
        x0in1 = jnp.einsum("bij,bnj->bni", batch.T_gt[:, :3, :3],
                           batch.xyz0) + batch.T_gt[:, None, :3, 3]
        d = jnp.linalg.norm(x0in1 - jnp.take_along_axis(batch.xyz1, idx[..., None],
                                                        axis=1), axis=-1)
        valid = jnp.arange(n)[None, :] < batch.num0[:, None]
        return jnp.sum((d < radius) & valid) / jnp.maximum(jnp.sum(valid), 1), idx

    hit, idx = hit_probe(params, state, batch)
    return float(hit), np.asarray(idx)


def test_hit_probe_matches_the_jax_expression():
    rng = np.random.RandomState(3)
    jspec = jload("ResUNetBN2F")
    jcfg = jspec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    params, state = numpy_tree(jspec, jcfg, rng)
    nb = PairBatch(*pair_batch(rng, 2, 192, 64, span=7))
    radius = 0.15
    want_hit, want_idx = _jax_hit_probe(jspec, jcfg, params, state,
                                        PairBatch(*map(jnp.asarray, nb)), radius)

    spec = load_model("ResUNetBN2F")
    cfg = spec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    net.train()  # the probe runs eval-mode BN and restores the mode
    batch = ts.batch_to(nb, "cpu")
    feats, idx = e2e.probe_match(net, batch)
    assert net.training
    valid = np.arange(nb.xyz0.shape[1])[None] < nb.num0[:, None]
    np.testing.assert_array_equal(idx.numpy()[valid], want_idx[valid])
    got = e2e.hit_ratio(batch, idx, radius)
    assert 0.05 < want_hit < 0.95
    assert got == pytest.approx(want_hit, abs=1e-7)
    assert e2e.hit_probe(net, batch, radius) == got


def test_stage_a_learning_rate_is_optax_exponential_decay():
    sched = optax.exponential_decay(1e-3, 1200, 0.3)
    got = np.array([e2e.fcgf_lr(i, 1200) for i in range(0, 1201, 7)])
    want = np.array([float(sched(i)) for i in range(0, 1201, 7)])
    assert got[0] == 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_build_config_keeps_the_jax_profiles():
    for profile, want in (
            ("room", dict(dataset="SyntheticPairDataset", voxel_size=0.05,
                          feat_conv1_kernel_size=7, dense_extent="256,256,256",
                          remat=False, success_rte_thresh=0.3, synthetic_points=15000)),
            ("lidar", dict(dataset="SyntheticLidarPairDataset", voxel_size=0.3,
                           feat_conv1_kernel_size=5, dense_extent="384,384,128",
                           remat=True, success_rte_thresh=0.6, synthetic_points=30000))):
        config, run = e2e.build_config(e2e.parse_args(["--profile", profile,
                                                       "--device", "cpu"]))
        for k, v in dict(want, feat_model="ResUNetBN2C", feat_model_n_out=32,
                         inlier_model="ResUNetBN2C", inlier_conv1_kernel_size=3,
                         optimizer="SGD", lr=0.1, exp_gamma=0.99, best_val_metric="f1",
                         edge_budget_scale=2.5, bf16=True, test_valid=False,
                         batch_size=2, val_max_iter=16).items():
            assert getattr(config, k) == v, (profile, k)
        assert (run.fcgf_steps, run.max_epoch, run.iters) == (1200, 3, 120)
    _, run = e2e.build_config(e2e.parse_args(["--quick", "--device", "cpu"]))
    assert (run.n_points, run.fcgf_steps, run.max_epoch, run.iters) == (4000, 6, 1, 2)


def _small(monkeypatch):
    build = e2e.build_config

    def small(args):
        config, run = build(args)
        for k, v in SMALL.items():
            setattr(config, k, v)
        return config, run

    monkeypatch.setattr(e2e, "build_config", small)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """stage_a -> stage_b -> stage_c with small nets on the CPU."""
    out = tmp_path_factory.mktemp("chain")
    config, run = e2e.build_config(e2e.parse_args(ARGS + ["--out_dir", str(out)]))
    for k, v in SMALL.items():
        setattr(config, k, v)
    summary = {}
    a = e2e.stage_a(config, run, summary)
    b = e2e.stage_b(config, run, a["ckpt"], summary)
    c = e2e.stage_c(config, run, b["ckpt"], summary)
    return dict(out=out, a=a, b=b, c=c, summary=summary)


def test_the_three_stages_run_and_write_the_jax_schema(chain):
    out, s = chain["out"], chain["summary"]
    assert len(chain["a"]["losses"]) == 2 and np.isfinite(chain["a"]["losses"]).all()
    assert (out / "fcgf_selftrained.pkl").exists()
    assert (out / "checkpoint.pkl").exists() and (out / "best_val_checkpoint.pkl").exists()
    assert chain["b"]["ckpt"] == str(out / "best_val_checkpoint.pkl")
    assert chain["c"]["dgr"].inlier_trained
    assert list(s) == JAX_KEYS[4:]
    stats = np.load(out / "3dmatch-stats.npz")["stats"]
    assert stats.shape == (1, 2, 5) and s["n_pairs"] == 2
    assert 0 <= s["recall"] <= 1 and 0 <= s["fcgf_val_hit_ratio"] <= 1


def test_main_reuses_the_checkpoints_of_skip_a_and_skip_b(chain, tmp_path, monkeypatch):
    _small(monkeypatch)
    a, b = chain["a"]["ckpt"], chain["b"]["ckpt"]
    s = e2e.main(ARGS + ["--out_dir", str(tmp_path / "b"), "--skip_a", a])
    assert not (tmp_path / "b" / "fcgf_selftrained.pkl").exists()
    assert (tmp_path / "b" / "best_val_checkpoint.pkl").exists()
    assert "fcgf_final_loss" not in s and "best_val" in s
    assert set(s["stage_s"]) == {"b", "c"}
    # As the JAX tool: --skip_b replaces stage B only; with --skip_a, C alone runs.
    s = e2e.main(ARGS + ["--out_dir", str(tmp_path / "c"), "--skip_a", a, "--skip_b", b])
    assert not (tmp_path / "c" / "checkpoint.pkl").exists()
    assert not (tmp_path / "c" / "fcgf_selftrained.pkl").exists()
    assert "best_val" not in s and set(s["stage_s"]) == {"c"}
    written = json.loads((tmp_path / "c" / "summary.json").read_text())
    assert written == s
    want = [k for k in JAX_KEYS if k not in ("fcgf_final_loss", "fcgf_val_hit_ratio",
                                             "best_val", "best_val_epoch")]
    assert list(s)[:len(want)] == want
    assert s["card"] == "cpu" and s["launches"]["c"] == dict.fromkeys(
        ("nn1_scan", "nn1_mma", "nn1_scan_batched", "nn1_mma_batched"), 0)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2e.main(["--device", "cuda"])
