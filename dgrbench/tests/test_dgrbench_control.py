"""``correct`` has to come out false where the answers are wrong.

On the CPU: small copies of each cell (the cells' own limits, smaller
clouds) run through the harness with its look for a card skipped, once
sound and once with the timed path broken underneath: an answer altered
where it is produced (registration: the FCGF features, the ICP pose);
a batched refinement that leaves half of its pairs unrefined, or gives
each pair the weights of another; a training step that leaves its state unchanged; a training step that
leaves half of its batch out and takes the mean over the rest. Each fault
must turn ``correct`` false through a number that the sound run keeps
within its limit. (The cells run on one card: there is no exchange between
chips to leave out.)

On a card (marker ``card``): the control, the reference in the program's
place with TF32 on, at each cell's own size on three seeds, must come out
not correct."""

import argparse
import contextlib
import json
import os

import pytest
import torch

from conftest import ROOT
from dgrbench import control, run

BENCH = run.with_held(json.load(open(os.path.join(ROOT, "BENCHMARK.json"))))
SMALL = {
    "3dmatch-register-b4": ({"voxel_size": 0.1}, {"points": 3000, "pool": 8}),
    "3dmatch-train-b8": ({"voxel_size": 0.1}, {"points": 3000, "pool_batches": 3,
                                               "batch": 2}),
}
SEED = 2 ** 31 + 101


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A root holding small copies of the cells, under the cells' names."""
    root = tmp_path_factory.mktemp("small")
    for sub in ("configs", "workloads", "limits"):
        (root / "dgrbench" / sub).mkdir(parents=True)
    bench = json.loads(json.dumps(BENCH))
    for conf in bench["configs"]:
        src = json.load(open(os.path.join(ROOT, conf["file"])))
        cell = next(w for w in bench["workloads"] if w["config"] == conf["name"])
        src.update(SMALL[cell["name"]][0])
        (root / conf["file"]).write_text(json.dumps(src))
    for w in bench["workloads"]:
        mix = json.load(open(os.path.join(ROOT, "dgrbench", "workloads",
                                          w["traffic"] + ".json")))
        mix.update(SMALL[w["name"]][1])
        (root / "dgrbench" / "workloads" / (w["traffic"] + ".json")).write_text(
            json.dumps(mix))
        lim = open(os.path.join(ROOT, "dgrbench", "limits", w["name"] + ".json")).read()
        (root / "dgrbench" / "limits" / (w["name"] + ".json")).write_text(lim)
    # the small 3DMatch configuration serves both 3DMatch cells
    return str(root), bench


def _run(small, workload, fault=contextlib.nullcontext):
    root, bench = small
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=0.5, trace=0)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with fault():
            return run.run(args, device="cpu", bench=bench, root=root)
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def _patched(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def altered_features():
    from deepglobalregistration_tpu_torch.core import pipeline

    def wrap(f):
        def g(self, grid, batch_size, cap):
            feats, ov = f(self, grid, batch_size, cap)
            return feats + 1e-3, ov
        return g
    return _patched(pipeline.DeepGlobalRegistration, "_fcgf_forward", wrap)


def altered_pose():
    from deepglobalregistration_tpu_torch.ops import icp

    def wrap(f):
        def g(*a, **kw):
            res = f(*a, **kw)
            T = res.T.clone()
            T[..., :3, 3] += 0.05
            return res._replace(T=T)
        return g
    return _patched(icp, "registration_icp", wrap)


def state_unchanged():
    from deepglobalregistration_tpu_torch.core import train_step as ts

    def wrap(f):
        def g(*a, **kw):
            opt = f(*a, **kw)
            opt.step = lambda closure=None: None
            return opt
        return g
    return _patched(ts, "make_optimizer", wrap)


def half_batch():
    from deepglobalregistration_tpu_torch.core import train_step as ts

    def wrap(f):
        def g(batch, device):
            b = f(batch, device)
            return type(b)(*(x[:max(1, x.shape[0] // 2)] for x in b))
        return g
    return _patched(ts, "batch_to", wrap)


def _batched_solve(alter):
    """The batched refinement with its answer (R, t) or its input weights
    altered by ``alter``; one pair's refinement (a rerun) is left alone."""
    from deepglobalregistration_tpu_torch.core import registration

    def wrap(f):
        def g(points, trans_points, weights, **kw):
            if points.dim() < 3:
                return f(points, trans_points, weights, **kw)
            return alter(f, points, trans_points, weights, **kw)
        return g
    return _patched(registration, "global_registration", wrap)


def half_unrefined():
    def alter(f, points, trans_points, weights, **kw):
        res = f(points, trans_points, weights, **kw)
        R, t = res.R.clone(), res.t.clone()
        half = max(1, R.shape[0] // 2)
        R[:half] = torch.eye(3, dtype=R.dtype, device=R.device)
        t[:half] = 0
        return res._replace(R=R, t=t)
    return _batched_solve(alter)


def swapped_weights():
    def alter(f, points, trans_points, weights, **kw):
        return f(points, trans_points, weights.roll(1, 0), **kw)
    return _batched_solve(alter)


CASES = [("3dmatch-register-b4", altered_features, "fcgf_gap"),
         ("3dmatch-register-b4", altered_pose, "icp_fit_gap"),
         ("3dmatch-register-b4", half_unrefined, "icp_fit_gap"),
         ("3dmatch-register-b4", swapped_weights, "icp_fit_gap"),
         ("3dmatch-train-b8", state_unchanged, "change_gap"),
         ("3dmatch-train-b8", half_batch, "loss1_gap")]


@pytest.fixture(scope="module")
def sound(small):
    return {w: _run(small, w) for w in SMALL}


@pytest.mark.parametrize("workload,fault,number", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in CASES])
def test_a_fault_turns_correct_false(small, sound, workload, fault, number):
    ok = sound[workload]["checks"][number]
    assert ok["value"] <= ok["limit"], (number, ok)
    out = _run(small, workload, fault)
    assert out["correct"] is False
    bad = out["checks"][number]
    assert bad["value"] > bad["limit"], (number, bad)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    limits = json.load(open(os.path.join(ROOT, "dgrbench", "limits", workload + ".json")))
    for seed in (3_300_000_001, 3_300_000_002, 3_300_000_003):
        g = control.readings(workload, seed)
        assert any(g.get(k, float("inf")) > v for k, v in limits.items()), (seed, g)
