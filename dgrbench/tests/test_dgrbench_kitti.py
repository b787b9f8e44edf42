"""The KITTI training cell, ``kitti-train-b8``, on the CPU.

Its files are found by name. A small copy of the cell (the configuration's
nets at their published widths, FCGF ResUNetBN2C conv1 5 in 3D and the 6D
ResUNetBN2C conv1 3, both drawn from the seed; short street sweeps, batches
of 2) runs through the harness with its look for a card skipped: the judge
holds the program's FCGF features, logits, step 1's loss and gradient and
the change after three steps to the reference's within the cell's own
limits, and the traced run's tile counts read. Then the two faults of the
training cells, half the batch left out and a state left unchanged, must
each turn ``correct`` false. The process peaks near 11 GB (the 6D net's
236M parameters, their gradients and momentum, on both sides)."""

import argparse
import contextlib
import json
import os

import pytest
import torch

from conftest import ROOT
from dgrbench import run
from dgrbench.conftest import SMALL
from test_dgrbench_control import half_batch, state_unchanged

CELL = "kitti-train-b8"
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SMALL_CONFIG, SMALL_MIX = SMALL[CELL]
SEED = 2 ** 31 + 19


def test_cell_files_are_found_by_name():
    cell, conf, config, mix = run.find_cell(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "dgr-kitti", "street-batches-b8", 1)
    assert conf["file"] == "dgrbench/configs/dgr-kitti.json" and conf["reduced"] == []
    assert (config["voxel_size"], config["feat_conv1_kernel_size"], config["inlier_model"],
            config["lr"], config["precision"], config["bf16"]) == (
        0.3, 5, "ResUNetBN2C", 0.01, "float32", False)
    assert (mix["scene"], mix["points"], mix["batch"]) == ("street", 120000, 8)
    assert os.path.exists(os.path.join(ROOT, "dgrbench", "drivers", mix["driver"] + ".py"))
    limits = run.load_json(ROOT, "dgrbench", "limits", CELL + ".json")
    assert set(limits) == set(run.load_json(ROOT, "dgrbench", "limits",
                                            "3dmatch-train-b8.json"))
    e2e = [m["name"] for m in run.metrics_for(BENCH, CELL, False)]
    assert e2e == ["train_pairs_per_s", "setup_s"]
    layer = [m["name"] for m in run.metrics_for(BENCH, CELL, True)]
    assert layer == ["train.plan6_ms", "train.backward_ms", "slot_sum_roofline.train",
                     "nn1_roofline.train", "idle_pct.train", "mfu.train",
                     "conv_gemm_roofline.kitti_train", "tile_pad_pct.kitti_train",
                     "train.inlier_ms"]
    for name in layer:
        assert callable(run.metric_reader(name))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A root holding a small copy of the cell under its own names."""
    root = tmp_path_factory.mktemp("small_kitti")
    for sub in ("configs", "workloads", "limits"):
        (root / "dgrbench" / sub).mkdir(parents=True)
    cell, conf, config, mix = run.find_cell(BENCH, CELL)
    (root / conf["file"]).write_text(json.dumps(dict(config, **SMALL_CONFIG)))
    (root / "dgrbench" / "workloads" / (cell["traffic"] + ".json")).write_text(
        json.dumps(dict(mix, **SMALL_MIX)))
    (root / "dgrbench" / "limits" / (CELL + ".json")).write_text(
        open(os.path.join(ROOT, "dgrbench", "limits", CELL + ".json")).read())
    return str(root)


def _run(root, trace=0, fault=contextlib.nullcontext):
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=0.1, trace=trace)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with fault():
            return run.run(args, device="cpu", bench=BENCH, root=root)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sound(small):
    return _run(small, trace=1)


def test_the_port_holds_to_the_reference(sound):
    for k in ("fcgf_gap", "logit_gap", "loss1_gap", "grad_gap", "change_gap",
              "voxel_mismatch", "label_mismatch", "match_gap"):
        c = sound["checks"][k]
        assert c["value"] <= c["limit"], (k, c)
    assert sound["correct"] is True


def test_traced_run_reads_the_tile_counts(sound):
    """The CPU trace has no kernels, so the device shares stay out; the
    counters and the stage timers read."""
    m = sound["metrics"]
    assert 0 < m["tile_pad_pct.kitti_train"]["value"] < 100
    for name in ("train.inlier_ms", "train.backward_ms", "train.plan6_ms"):
        assert m[name]["value"] > 0, name
    assert "conv_gemm_roofline.kitti_train" not in m


def test_a_program_without_counters_leaves_the_metric_out(monkeypatch):
    """The parent of the counters: the driver hands no tile counts, and the
    reader gives nothing (no error)."""
    from deepglobalregistration_tpu_torch.ops import sparse_conv
    monkeypatch.delattr(sparse_conv, "tile_counts")
    from dgrbench.drivers import train_step_tiles
    assert train_step_tiles._counters() is None
    reader = run.metric_reader("tile_pad_pct.kitti_train")
    assert reader({"kind": "train", "traced_work": {"convs": [], "tiles": None}}) is None


@pytest.mark.parametrize("fault,number", [(half_batch, "loss1_gap"),
                                          (state_unchanged, "change_gap")],
                         ids=["half_batch", "state_unchanged"])
def test_a_fault_turns_correct_false(small, sound, fault, number):
    out = _run(small, fault=fault)
    assert out["correct"] is False
    bad = out["checks"][number]
    assert bad["value"] > bad["limit"], (number, bad)
