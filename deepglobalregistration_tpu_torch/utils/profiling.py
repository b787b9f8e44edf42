"""Profiling hooks: torch.profiler traces and their per-kernel device time.

Counterpart of the JAX package's ``utils/profiling.py`` (SURVEY.md section
5): ``trace()`` wraps a code region in ``torch.profiler`` (CPU and CUDA
activities, Python stacks) and writes a Chrome trace into ``log_dir``;
``summarize_trace`` parses the newest trace there into device ms per CUDA
kernel name; ``attribute_trace`` puts each kernel's time on the Python line,
the PyTorch operator or the port's span (``utils/spans.py``) that launched
it, so results read without TensorBoard.

The JAX ``attribute_trace`` joins device ops to the compiled HLO's source
metadata, through a ``compiled_text`` argument. An eager PyTorch program has
no HLO, so that argument is dropped: each kernel event is joined through its
``correlation`` id to the host runtime call that launched it, and through
its ``External id`` to the operator (``cpu_op``) around that call; the host
call's time on its thread finds the innermost enclosing Python frame of
this package.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from . import spans

PACKAGE = "deepglobalregistration_tpu_torch/"
_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")
# Host-side events that launch device work (CUPTI's runtime and driver APIs).
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def trace(log_dir: str | None = None, with_stack: bool = True):
    """Profile the enclosed region and write ``<log_dir>/<ns>.pt.trace.json``
    (``log_dir`` defaults to ``dgr_trace`` under the temporary directory).
    CUDA activity is recorded when a card is visible. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dgr_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns():020d}.pt.trace.json"))


def load_trace(log_dir: str) -> List[dict] | None:
    """The events of the newest Chrome trace (``*.json`` or ``*.json.gz``)
    under ``log_dir``, or None when there is none."""
    files = glob.glob(f"{log_dir}/**/*.json", recursive=True) + \
        glob.glob(f"{log_dir}/**/*.json.gz", recursive=True)
    if not files:
        return None
    path = max(files, key=lambda f: (os.path.getmtime(f), f))
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def _kernels(events: List[dict]) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e]


def summarize_trace(log_dir: str, top: int = 25) -> Dict[str, float]:
    """Device ms per CUDA kernel name (its first 80 characters), the ``top``
    largest, from the newest trace in ``log_dir``; ``{}`` when the trace has
    no kernel events (a CPU run)."""
    optime: collections.Counter = collections.Counter()
    for e in _kernels(load_trace(log_dir) or []):
        optime[e["name"][:80]] += e["dur"]
    return {name: dur / 1000.0 for name, dur in optime.most_common(top)}


def kernel_totals(log_dir: str) -> Tuple[float, int]:
    """(device ms, launches) of every CUDA kernel in the newest trace."""
    ks = _kernels(load_trace(log_dir) or [])
    return sum(e["dur"] for e in ks) / 1000.0, len(ks)


def kernel_busy_ms(log_dir: str) -> float:
    """Device ms in which at least one CUDA kernel of the newest trace ran:
    the union of the kernels' intervals, so kernels overlapping on several
    streams count once."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in _kernels(load_trace(log_dir) or []))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1000.0


def _frame_key(name: str) -> str | None:
    """``deepglobalregistration_tpu_torch/<file>:<line>`` of a Python frame
    event of this package (the line is the function's first), else None."""
    m = _FRAME.match(name)
    if m is None or PACKAGE not in m.group(1):
        return None
    path = m.group(1)
    return f"{path[path.index(PACKAGE):]}:{m.group(2)}"


def _innermost(frames: List[Tuple[float, float, str]],
               times: List[Tuple[float, int]]) -> Dict[int, str]:
    """For each (t, id) of ``times``, the key of the innermost interval of
    ``frames`` (start, end, key; one thread's, so they nest) that holds t,
    by one sweep: the stack holds the chain of intervals open at t."""
    frames = sorted(frames, key=lambda f: (f[0], -f[1]))
    out, stack, i = {}, [], 0
    for t, q in sorted(times):
        while i < len(frames) and frames[i][0] <= t:
            while stack and stack[-1][1] < frames[i][0]:
                stack.pop()
            stack.append(frames[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[q] = stack[-1][2]
    return out


def _span_labels(events: List[dict], launches: Dict[tuple, list]) -> Dict[int, str]:
    """For each (t, id) of ``launches`` (by thread), the name of the
    innermost ``dgr.*`` span (ids dropped) the thread was in at t. A thread
    in no span then (autograd runs CUDA backward on a thread of its own)
    takes the innermost span any thread was in: the one that started last."""
    by_thread: Dict[tuple, list] = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X" \
                and e["name"].startswith(spans.PREFIX):
            by_thread[(e["pid"], e["tid"])].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 spans.split_label(e["name"])[0]))
    out: Dict[int, str] = {}
    for thread, ts in launches.items():
        out.update(_innermost(by_thread.get(thread, []), ts))
    rest = [tq for ts in launches.values() for tq in ts if tq[1] not in out]
    out.update(_innermost([f for fs in by_thread.values() for f in fs], rest))
    return out


def attribute_trace(log_dir: str, top: int = 30, by: str = "line") -> Dict[str, float]:
    """Device ms of the newest trace's CUDA kernels, grouped by what launched
    them: ``by="line"`` on the innermost ``file:line`` of this package in the
    launching Python stack (the trace must have been taken with stacks),
    ``by="op"`` on the launching PyTorch operator's name, ``by="span"`` on
    the innermost of the port's spans (``dgr.train.plan6``, ``dgr.fcgf``,
    ...: ``utils/spans.py``) around the launch, a launch from a thread in no
    span (autograd's backward thread) taking the span another thread was in.
    A kernel with no such frame, operator or span (a kernel launched through
    ctypes has no operator) groups under its own name."""
    if by not in ("line", "op", "span"):
        raise ValueError(f"by must be 'line', 'op' or 'span', got {by!r}")
    events = load_trace(log_dir) or []
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    kernels = _kernels(events)
    labels: Dict[int, str] = {}
    if by == "op":
        for q, k in enumerate(kernels):
            args = k.get("args", {})
            launch = launches.get(args.get("correlation"), {})
            ext = args.get("External id") or launch.get("args", {}).get("External id")
            if ext in ops:
                labels[q] = ops[ext]
    else:
        times: Dict[tuple, list] = collections.defaultdict(list)
        for q, k in enumerate(kernels):
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is not None:
                times[(launch["pid"], launch["tid"])].append((float(launch["ts"]), q))
    if by == "span":
        labels = _span_labels(events, times)
    elif by == "line":
        frames: Dict[tuple, list] = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "python_function" and e.get("ph") == "X":
                key = _frame_key(e["name"])
                if key is not None:
                    frames[(e["pid"], e["tid"])].append(
                        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), key))
        for thread, ts in times.items():
            labels.update(_innermost(frames.get(thread, []), ts))
    agg: collections.Counter = collections.Counter()
    for q, k in enumerate(kernels):
        agg[labels.get(q, k["name"][:80])] += k["dur"] / 1000.0
    return dict(agg.most_common(top))
