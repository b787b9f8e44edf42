"""The device trace of a run's first window calls, and what it says.

``torch.profiler`` records CPU and CUDA activity between ``start`` and
``stop``; the Chrome trace goes to a file under the temporary directory
the run was given and is read back and deleted. Device time is the union
of the intervals in which a kernel, a copy or a set ran (operations that
overlap on several streams count once; the arithmetic of the program's
``utils/profiling.kernel_busy_ms``).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_s(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def gaps(spans):
    """The idle intervals between the union of ``spans`` (microseconds)."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def _host_label(cpu_ops, starts, t: float) -> str:
    """The innermost operator the host was in at time t, or "python".
    ``cpu_ops`` (start, end, name) sorted by start; ``starts`` their starts.
    Operators nest, so the innermost one holding t started last."""
    for a, b, name in reversed(cpu_ops[max(0, bisect.bisect_right(starts, t) - 4096):
                                       bisect.bisect_right(starts, t)]):
        if b >= t:
            return name
    return "python"


class Trace:
    def __init__(self, device: str):
        self.device = device
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        """Ends the trace and returns its summary; keeps nothing of it."""
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        return summary(events, self.window_s)


def summary(events: list, window_s: float) -> dict:
    """Device busy time, time by kernel name and the longest idle gaps by
    what the host was doing, from a Chrome trace's events."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        k = kernels[e["name"]]
        k[0] += float(e["dur"]) / 1e6
        k[1] += 1
    cpu_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") == "cpu_op" and "dur" in e)
    starts = [op[0] for op in cpu_ops]
    idle = collections.Counter()
    for a, b in sorted(gaps(spans), key=lambda g: g[0] - g[1])[:200]:
        idle[_host_label(cpu_ops, starts, (a + b) / 2)] += (b - a) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": union_s(spans), "trace_window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "breakdown": {"device_ops": [[k, v[0]] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}}
