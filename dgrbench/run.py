"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m dgrbench.run --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(configuration, traffic), the configuration's file, the traffic mix
``dgrbench/workloads/<traffic>.json`` (which names its driver,
``dgrbench/drivers/<driver>.py``), the limits of its correctness check
``dgrbench/limits/<cell>.json``, and one reader a metric,
``dgrbench/metrics/<metric>.py``. A cell, a mix, a driver or a metric is
added by adding files; nothing here names one. A cell held out of
BENCHMARK.json (``dgrbench/held/<cell>.json``) runs the same way by hand.

A run: set-up (build the program, make the inputs and weights from the
seed, warm up every shape, drive the first calls that the check reads),
then ``--seconds`` of closed-loop calls, whole calls counted; then the
check against the plain reference. With ``--trace 1`` a few more calls run
under ``torch.profiler`` after the window, and the per-layer metrics are
read from them and from the window.
The last lines on standard error and the result's last key give each
number compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "dgrbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepglobalregistration_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str, root: str = ROOT):
    """(workload entry, configuration entry, configuration file's dict, mix),
    the files read under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, conf, load_json(root, conf["file"]), load_json(
        root, "dgrbench", "workloads", cell["traffic"] + ".json")


def with_held(bench: dict, root: str = ROOT) -> dict:
    """``bench`` with the cells held out of BENCHMARK.json added back: each
    ``dgrbench/held/<cell>.json`` holds a cell's ``workloads`` entry and the
    ``end_to_end`` and ``per_layer`` entries that only it reports. A held
    cell runs by hand and in the tests; the check runs only the listed ones."""
    out = json.loads(json.dumps(bench))
    held = os.path.join(root, "dgrbench", "held")
    for f in sorted(os.listdir(held)) if os.path.isdir(held) else []:
        cell = load_json(held, f)
        for k in ("workloads", "end_to_end", "per_layer"):
            out[k] += cell.get(k, [])
    return out


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"dgrbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"dgrbench: the cell needs {chips} CUDA card(s), {n} visible",
              file=sys.stderr)
        raise SystemExit(3)


def run(args, device: str = "cuda", bench: dict | None = None, root: str = ROOT) -> dict:
    """One run; returns the result's dict (``checks`` last). ``device`` and
    ``root`` (where the cell's files are read) are for the tests, which run
    small cells on the CPU."""
    import torch

    from . import tracing

    bench = bench or load_json(root, "BENCHMARK.json")
    cell, conf, config, mix = find_cell(bench, args.workload, root)
    limits = load_json(root, "dgrbench", "limits", cell["name"] + ".json")
    driver = importlib.import_module(f"dgrbench.drivers.{mix['driver']}").Driver(
        config, mix, args.seed, device, bool(args.trace))
    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    work, calls = 0, 0
    t0 = time.perf_counter()
    while True:
        work += driver.call()
        calls += 1
        if time.perf_counter() - t0 >= args.seconds and calls >= driver.min_calls:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    ctx = dict(kind=driver.kind, work=work, calls=calls, window_s=window_s,
               setup_s=setup_s, **driver.layer_context())
    attempted, failed = driver.attempted, driver.failed
    if args.trace:
        # The profiled calls come after the window, so that the window runs
        # as in an untraced run and its stage timers describe the timed path.
        traced = tracing.Trace(device)
        traced.start()
        for _ in range(int(mix["trace_calls"])):
            driver.call(traced=True)
        ctx.update(traced.stop(), traced_work=driver.traced_work())

    values = {}
    for m in metrics_for(bench, cell["name"], bool(args.trace)):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    gaps = driver.check()
    counts = {k: v for k, v in ctx.items() if isinstance(v, int)}
    print(f"dgrbench: window {window_s:.3f} s, {calls} calls, {counts}; the reference's "
          f"check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {k: {"value": float(gaps[k]), "limit": float(limits[k])} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": name,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": values, "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = ctx["busy_s"], ctx["trace_window_s"]
        out["breakdown"] = ctx["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    bench = with_held(load_json(ROOT, "BENCHMARK.json"))
    require_cards(int(find_cell(bench, args.workload)[0]["chips"]))
    out = run(args, bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"dgrbench: the process loaded {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
