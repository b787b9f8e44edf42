"""The pipelined ``register_many`` against a loop of ``register()`` (CPU).

``register_many`` runs a bounded window of pairs on worker threads (on the
card, each on its own CUDA stream). Each pair takes its RANSAC seed in pair
order, so on the CPU the window returns a loop's transforms bit for bit and
the same per-call records, with a pair on the RANSAC branch, two voxel
buckets and more pairs than the window. Also: the launch counters under
threads, a failing pair's exception, the routes that stay sequential, and
``tools/stream_probe``'s code at windows 1 and 2. The comparison with the
JAX package's ``register_many`` lives in ``test_torch_port_pipeline.py``,
beside that file's JAX instance.

Runs with one PyTorch thread (``torch_port_trees.torch_threads``): each
pair's ops then take the same path on a worker thread as on the caller's.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.ops import knn
from deepglobalregistration_tpu_torch.tools import stream_probe
from deepglobalregistration_tpu_torch.utils import cuda_build
from torch_port_trees import torch_threads

CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def _dgr(**kw):
    return DeepGlobalRegistration(default_config(**dict(CFG, **kw)), device="cpu")


def _pairs():
    """Five pairs: two at the 512 bucket, one of 120 points (at most 120
    voxels, so its weighted sum stays under the gate's 200: RANSAC), one of
    700 points (the 1024 bucket) and a rotated one."""
    rng = np.random.RandomState(1)
    a = (rng.rand(300, 3) * 1.2).astype(np.float32)
    small = (rng.rand(120, 3) * 1.2).astype(np.float32)
    big = (rng.rand(700, 3) * 1.2).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    xs = [a, a + np.float32(0.4), small, big, a]
    ys = [a + np.float32(0.4), a, small + np.float32(0.05), big + np.float32(0.1),
          (a @ R.T + np.float32(0.02)).astype(np.float32)]
    return xs, ys


def _fields(rec):
    return rec._replace(stage_s=None)


def test_register_many_is_the_loop_bit_for_bit():
    xs, ys = _pairs()
    loop = _dgr()
    T_loop, recs = [], []
    for x, y in zip(xs, ys):
        T_loop.append(loop.register(x, y))
        recs.append(loop.last_record)
    many = _dgr()
    T = many.register_many(xs, ys)
    assert T.shape == (5, 4, 4) and T.dtype == np.float64
    np.testing.assert_array_equal(T, np.stack(T_loop))
    assert [_fields(r) for r in many.last_many] == [_fields(r) for r in recs]
    assert "ransac" in [r.branch for r in recs]
    assert {r.cap for r in recs} == {512, 1024}
    assert len(xs) > many._STREAM_WINDOW
    # The counters summed on the calling thread, as the loop's.
    assert many.overflow_count == loop.overflow_count
    assert many.stage_timers["icp"].calls == loop.stage_timers["icp"].calls == 5
    assert many.last_branch == loop.last_branch


def test_launch_counts_are_exact_under_threads():
    class Fake:
        launches = 0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_build.count_launch(Fake)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert Fake.launches == 16 * 2000


def test_register_many_counts_every_match_and_icp_scan(monkeypatch):
    """Each pair's 1-NN calls, counted by worker threads through a counting
    find_nn: one match a pair and one scan an ICP evaluation (its
    iterations plus the init's), as the records report."""
    plain = knn.find_nn

    def counted(F0, F1, num0=None, num1=None):
        cuda_build.count_launch(counted)
        return plain(F0, F1, num0, num1)

    counted.launches = 0
    monkeypatch.setattr(knn, "find_nn", counted)
    xs, ys = _pairs()
    dgr = _dgr()
    dgr.register_many(xs + xs, ys + ys, window=4)
    want = sum(1 + r.iterations["icp"] + 1 for r in dgr.last_many)
    assert counted.launches == want


def test_failing_pair_raises_after_the_window_drains(monkeypatch):
    dgr = _dgr()
    done = []
    one = dgr._register_one

    def fake(a, b, seed):
        if a.shape[0] == 121:
            raise RuntimeError("pair 1 failed")
        out = one(a, b, seed)
        done.append(a.shape[0])
        return out

    monkeypatch.setattr(dgr, "_register_one", fake)
    rng = np.random.RandomState(3)
    xs = [(rng.rand(n, 3) * 1.2).astype(np.float32) for n in (120, 121, 122, 123, 124)]
    with pytest.raises(RuntimeError, match="pair 1 failed"):
        dgr.register_many(xs, [x + np.float32(0.05) for x in xs], window=3)
    # Pairs 0, 2 and 3 were in flight or collected; pair 4 was never sent.
    assert sorted(done) == [120, 122, 123]
    assert dgr.stage_timers["voxelize"].calls == 3


@pytest.mark.parametrize("field,value", [("knn_search_method", "cpu"),
                                         ("safeguard_method", "feature_matching"),
                                         (None, None)])
def test_sequential_routes(monkeypatch, field, value):
    dgr = _dgr(knn_search_method=value) if field == "knn_search_method" else _dgr()
    if field == "safeguard_method":
        dgr.safeguard_method = value
    threads = []
    one = dgr._register_one
    monkeypatch.setattr(dgr, "_register_one", lambda *a: threads.append(
        threading.get_ident()) or one(*a))
    xs, ys = _pairs()
    dgr.register_many(xs[:2], ys[:2])
    on_caller = [t == threading.get_ident() for t in threads]
    assert on_caller == ([True, True] if field else [False, False])
    assert len(dgr.last_many) == 2


def test_register_many_takes_no_window_below_one():
    with pytest.raises(ValueError, match="window"):
        _dgr().register_many([], [], window=0)


def test_stream_probe_at_windows_1_and_2():
    xs, ys = _pairs()
    rows = stream_probe.probe(_dgr(), xs[:2], ys[:2], windows=(1, 2), turns=1)
    assert [r["form"] for r in rows] == ["loop", "window 1", "window 2", "batch"]
    for r in rows:
        assert r["pairs"] == 2 and r["turns"] == 1
        assert r["s_per_pair_median"] > 0 and len(r["s_per_pair_turns"]) == 1
        assert r["busy_share"] is None and r["peak_mem_gib"] is None
        assert set(r["launches"]) == {"nn1_scan", "nn1_mma", "nn1_scan_batched",
                                      "nn1_mma_batched"}

