"""Port vs the repo's tools: the stats analysis, the golden FCGF K-order
check, the bench-weights export and the RANSAC sweep.

Each port tool is held to the root script it copies (``scripts/
analyze_stats.py``, ``tools/golden_fcgf.py``, ``tools/export_bench_weights.py``,
``tools/ransac_sweep.py``) on the same inputs. The FCGF of the K-order check
runs on 400 points in a 0.6 m box: the JAX plan caps level 1 at 256 rows
(512-row buffer, level shrink 2) without raising its overflow flag
(ROADMAP §3), and this cloud keeps level 1 under that cap.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.utils import checkpoint as jckpt
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.scripts import analyze_stats
from deepglobalregistration_tpu_torch.tools import (export_bench_weights, golden_fcgf,
                                                    ransac_sweep)
from deepglobalregistration_tpu_torch.utils import checkpoint as ckpt
from torch_port_trees import numpy_tree, torch_threads

FEAT_TOL = 1e-4  # f32 both sides, same weights and points


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_analyze_stats_matches_the_root_script(capsys):
    from scripts import analyze_stats as root

    rng = np.random.RandomState(0)
    stats = np.concatenate([rng.rand(2, 40, 1) > 0.3, rng.rand(2, 40, 1) * 0.5,
                            rng.rand(2, 40, 1) * 20, rng.rand(2, 40, 1),
                            rng.randint(0, 3, (2, 40, 1))], -1).astype(np.float64)
    names = np.array(["a", "b"])
    root.summarize(stats, names)
    want = capsys.readouterr().out
    analyze_stats.summarize(stats, names)
    assert capsys.readouterr().out == want and "recall" in want
    got, exp = analyze_stats.recall_curves(stats, names), root.recall_curves(stats, names)
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert got[2].keys() == exp[2].keys()
    for k in exp[2]:
        for g, e in zip(got[2][k], exp[2][k]):
            np.testing.assert_array_equal(g, e)


def test_analyze_stats_main_reads_the_eval_npz(tmp_path, capsys):
    stats = np.zeros((1, 3, 5))
    stats[0, :, 0] = [1, 0, 1]
    path = tmp_path / "3dmatch-stats.npz"
    np.savez(path, stats=stats, names=["DGR-torch"])
    analyze_stats.main([str(path)])
    out = capsys.readouterr().out
    assert "DGR-torch" in out and "0.6667" in out


@pytest.mark.parametrize("k", [3, 7])
def test_k_order_candidates_match_the_jax_tool(k):
    from tools.golden_fcgf import k_order_candidates

    want = k_order_candidates(k, 3)
    got = golden_fcgf.k_order_candidates(k, 3)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.fixture(scope="module")
def fcgf_tree():
    spec = jload("ResUNetBN2F")
    cfg = spec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    rng = np.random.RandomState(0)
    params, state = numpy_tree(spec, cfg, rng)
    xyz = (rng.rand(400, 3) * 0.6).astype(np.float32)
    return spec, cfg, params, state, xyz


def _sorted(feats, coords):
    order = np.lexsort(coords.T[::-1])
    return feats[order], coords[order]


def test_run_fcgf_on_permuted_kernels_matches_jax(fcgf_tree):
    from tools import golden_fcgf as jtool

    jspec, jcfg, params, state, xyz = fcgf_tree
    spec = load_model("ResUNetBN2F")
    cfg = spec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    cands = golden_fcgf.k_order_candidates(3, 3)
    out = {}
    for name in ("identity", "reversed"):
        perm = lambda K, name=name: cands[name] if K == 27 else None
        got = _sorted(*golden_fcgf.run_fcgf(
            spec, cfg, golden_fcgf.permute_kernels(params, perm), state, xyz, 0.05,
            device="cpu"))
        want = _sorted(*jtool.run_fcgf(jspec, jcfg, jtool.permute_kernels(params, perm),
                                       state, xyz, 0.05))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FEAT_TOL)
        out[name] = got[0]
    assert np.abs(out["reversed"] - out["identity"]).max() > 1e-3


def test_golden_main_confirms_the_identity_order(fcgf_tree, tmp_path, capsys):
    _, _, params, state, xyz = fcgf_tree
    weights = tmp_path / "fcgf.pkl"
    ckpt.save_checkpoint(weights, epoch=0, params=params, state=state, config={
        "feat_model": "ResUNetBN2F", "feat_model_n_out": 8,
        "feat_conv1_kernel_size": 3, "bn_momentum": 0.05, "normalize_feature": True})
    spec, cfg, p, s, k1 = golden_fcgf.load_fcgf(str(weights))
    feats, coords = golden_fcgf.run_fcgf(spec, cfg, p, s, xyz, 0.05, device="cpu")
    golden = tmp_path / "golden.npz"
    np.savez(golden, xyz=xyz, feats=feats, coords=coords)
    res = golden_fcgf.main(["--weights", str(weights), "--golden", str(golden),
                            "--device", "cpu"])
    assert [n for n, r in res.items() if r["pass"]] == ["identity"]
    assert res["identity"]["matched"] == len(coords)
    assert "CONFIRMED" in capsys.readouterr().out


def test_export_bench_weights_matches_the_jax_tool(fcgf_tree, tmp_path, monkeypatch):
    from tools import export_bench_weights as jtool

    _, _, params, state, _ = fcgf_tree
    src = tmp_path / "fcgf_selftrained.pkl"
    ckpt.save_checkpoint(src, epoch=3, params=params, state=state)
    ours, theirs = tmp_path / "ours.pkl", tmp_path / "theirs.pkl"
    assert export_bench_weights.main(["--ckpt", str(src), "--out", str(ours)]) == str(ours)
    monkeypatch.setattr(sys, "argv", ["x", "--ckpt", str(src), "--out", str(theirs)])
    jtool.main()
    a, b = jckpt.load_checkpoint(str(theirs)), ckpt.load_checkpoint(str(ours))
    c = jckpt.load_checkpoint(str(ours))
    for got in (b, c):
        assert got["epoch"] == a["epoch"] == 3 and got["config"] == a["config"]
        assert got["state_dict_inlier"] is None
        for tree in ("params", "state"):
            jl = jax.tree_util.tree_leaves_with_path(a["state_dict"][tree])
            pl = jax.tree_util.tree_leaves_with_path(got["state_dict"][tree])
            assert [k for k, _ in jl] == [k for k, _ in pl]
            for (k, x), (_, y) in zip(jl, pl):
                np.testing.assert_array_equal(np.asarray(y, np.float32),
                                              np.asarray(x, np.float32), err_msg=str(k))


def test_ransac_make_pair_matches_the_jax_tool():
    from tools.ransac_sweep import make_pair

    for ratio in (0.02, 0.2):
        a, b = np.random.RandomState(5), np.random.RandomState(5)
        for x, y in zip(make_pair(a, 300, ratio), ransac_sweep.make_pair(b, 300, ratio)):
            np.testing.assert_array_equal(x, y)


def test_ransac_sweep_runs_on_the_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    res = ransac_sweep.main(["--trials", "2", "--n", "256", "--budgets", "64,256",
                             "--ratios", "0.5", "--device", "cpu", "--out", str(out)])
    assert set(res) == {"r0.5_h64", "r0.5_h256"} and out.exists()
    for r in res.values():
        assert r["recall"] == 1.0 and r["ms_per_call"] > 0
        assert r["median_rte"] < 0.05


def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ransac_sweep.main(["--trials", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        golden_fcgf.main(["--weights", str(tmp_path / "none.pkl")])
