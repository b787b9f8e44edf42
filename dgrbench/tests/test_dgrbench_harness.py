"""The harness is driven by data: a cell, a configuration, a mix and a metric
added as new files are found by name with no edit, and BENCHMARK.json keeps
to its contract (names, units, which cells report which metrics)."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from dgrbench import run

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# The cells held out of BENCHMARK.json (dgrbench/held/) keep to the same rules,
# so that a later PR can list them again as they are.
HELD = run.with_held(BENCH)
METRICS = HELD["end_to_end"] + HELD["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dgrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [x["name"] for x in HELD["configs"] + HELD["workloads"]
                                  + METRICS]
                         + [w["traffic"] for w in HELD["workloads"]]
                         + [w["config"] for w in HELD["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in HELD["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("m", HELD["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    e2e = {x["name"]: x for x in HELD["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert _reports(cell, e2e[m["moves"]]), (m["name"], cell)


@pytest.mark.parametrize("w", HELD["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_whole(w):
    e2e = [m["name"] for m in HELD["end_to_end"] if _reports(w["name"], m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(w["name"], m) for m in HELD["per_layer"])
    mix = json.load(open(os.path.join(ROOT, "dgrbench", "workloads", w["traffic"] + ".json")))
    assert os.path.exists(os.path.join(ROOT, "dgrbench", "drivers", mix["driver"] + ".py"))
    assert os.path.exists(os.path.join(ROOT, "dgrbench", "limits", w["name"] + ".json"))
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert os.path.exists(os.path.join(ROOT, "dgrbench", "metrics", m["name"] + ".py"))


def test_held_cells_stay_out_of_the_check():
    """A held cell, and every metric that only it reports, is absent from
    BENCHMARK.json; every metric BENCHMARK.json lists is reported by a cell
    it lists."""
    listed = {w["name"] for w in BENCH["workloads"]}
    held = [w["name"] for w in HELD["workloads"] if w not in BENCH["workloads"]]
    assert held and not listed & set(held)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert any(_reports(c, m) for c in listed), m["name"]
        assert not set(m.get("workloads", [])) & set(held), m["name"]


def test_layers_spelled_alike():
    layers = {m["layer"] for m in HELD["per_layer"]}
    for m in HELD["per_layer"]:
        assert m["layer"] == next(x for x in layers if x.lower() == m["layer"].lower())


def _digest(tree):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(tree)):
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell added as files (in a
    temporary copy) are found, and no file that was there changes."""
    shutil.copytree(os.path.join(ROOT, "dgrbench"), tmp_path / "dgrbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digest(tmp_path / "dgrbench")
    d = tmp_path / "dgrbench"
    cfg = json.load(open(d / "configs" / "dgr-3dmatch.json"))
    (d / "configs" / "dgr-new.json").write_text(json.dumps(dict(cfg, voxel_size=0.04)))
    mix = json.load(open(d / "workloads" / "room-pairs-b4.json"))
    (d / "workloads" / "room-pairs-b8.json").write_text(json.dumps(dict(mix, batch=8)))
    (d / "metrics" / "reg.new_ms.py").write_text(
        "def read(ctx):\n    return 1000.0 * ctx['stage_s']['match'] / ctx['pairs']\n")
    (d / "limits" / "new-register-b8.json").write_text(
        (d / "limits" / "3dmatch-register-b4.json").read_text())
    bench = json.loads(json.dumps(HELD))
    bench["configs"].append(dict(next(c for c in bench["configs"]
                                      if c["name"] == "dgr-3dmatch"), name="dgr-new",
                                 file="dgrbench/configs/dgr-new.json"))
    bench["workloads"].append({"name": "new-register-b8", "config": "dgr-new",
                               "traffic": "room-pairs-b8", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "3dmatch-register-b4" in m["workloads"]:
            m["workloads"].append("new-register-b8")
    bench["per_layer"].append({"name": "reg.new_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "pipeline",
                               "moves": "register_pairs_per_s",
                               "workloads": ["new-register-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json\n"
        "from dgrbench import run\n"
        "b = run.load_json(run.ROOT, 'BENCHMARK.json')\n"
        "cell, conf, config, mix = run.find_cell(b, 'new-register-b8')\n"
        "names = [m['name'] for m in run.metrics_for(b, 'new-register-b8', True)]\n"
        "v = run.metric_reader('reg.new_ms')({'stage_s': {'match': 0.5}, 'pairs': 10})\n"
        "print(json.dumps([config['voxel_size'], mix['batch'], 'reg.new_ms' in names, v,\n"
        "                  run.ROOT]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    voxel, batch, listed, value, root = json.loads(out.stdout.strip().splitlines()[-1])
    assert (voxel, batch, listed, value) == (0.04, 8, True, 50.0)
    assert os.path.realpath(root) == os.path.realpath(tmp_path)
    for f in ("run.py", "drivers/register_batch.py", "metrics/__init__.py"):
        assert (d / f).read_text() == open(os.path.join(ROOT, "dgrbench", f)).read()
    after = _digest(tmp_path / "dgrbench")
    assert before != after  # the new files are there; the old ones are the same:
    for sub in ("configs", "workloads", "metrics", "limits"):
        for f in os.listdir(os.path.join(ROOT, "dgrbench", sub)):
            if f.endswith((".py", ".json")):
                assert (d / sub / f).read_bytes() == open(
                    os.path.join(ROOT, "dgrbench", sub, f), "rb").read()


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and dgrbench/, a run exits
    with another code than 0 and prints no result."""
    shutil.copytree(os.path.join(ROOT, "dgrbench"), tmp_path / "dgrbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "dgrbench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout
