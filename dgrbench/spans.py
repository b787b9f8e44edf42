"""What the program's spans say in a run's device trace.

The port marks its work with spans (``utils/spans.py`` in the program):
while a profiler records, each span is a ``user_annotation`` event named
``dgr.<name>`` (ids, where given, after the name in brackets:
``dgr.train.step[step=3]``), on the host clock that the device events
share. From the profiled calls' Chrome events this builds, by span name
(ids dropped):

- ``device_s``: seconds of the kernels, copies and sets whose launch
  (joined through ``correlation``) fell inside the span. A launch from a
  thread in no span (autograd runs CUDA backward on a thread of its own) is
  placed in the span that the other threads were in then: the innermost,
  the one that started last.
- ``idle_s``: seconds in which no kernel, copy or set ran, from the first
  span or device event to the last: every gap of the union of the device
  intervals, cut at the span edges, each piece given to the innermost span
  the host was in.
- ``waits``: the host's waits on the card: the runtime's and the driver's
  stream, device and event synchronisations and synchronous ``cudaMemcpy``.
- ``n``: how many spans of the name the trace holds; ``within``: the same
  three sums over the span and every span inside it.

Each of the first three is placed on the innermost span only (its self
share, so they sum over the names and ``outside`` to the trace's totals).
A program without spans gives no name and puts everything ``outside``.
"""

from __future__ import annotations

import bisect
import collections

PREFIX = "dgr."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
         "cuMemcpy")
OUTSIDE = "outside"
STEP = "dgr.train.step"


def _innermost(spans, times):
    """For each (t, key) of ``times``, the index in ``spans`` ((start, end,
    ...), sorted by start, then longest first) of the span holding t that
    started last, by one sweep."""
    out, stack, i = {}, [], 0
    for t, key in sorted(times):
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1]
    return out


def _place(spans, by_thread, thread_times):
    """key -> span index for keys timed on a thread ({thread: [(t, key)]}):
    the thread's own innermost span, else the innermost of any thread's."""
    out = {}
    for thread, times in thread_times.items():
        own = by_thread.get(thread, [])
        got = _innermost([spans[j] for j in own], times)
        out.update({k: own[j] for k, j in got.items()})
    rest = [tk for times in thread_times.values() for tk in times if tk[1] not in out]
    out.update(_innermost(spans, rest))
    return out


def _union(intervals):
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def by_span(events: list) -> dict:
    """``{"spans": {name: {"n", "device_s", "idle_s", "waits", "within"}},
    "outside": {"device_s", "idle_s", "waits"}, "steps": train.step spans}``
    (see the module's docstring)."""
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name", "").startswith(PREFIX) and "dur" in e:
            a = float(e["ts"])
            spans.append((a, a + float(e["dur"]), e["name"].partition("[")[0],
                          (e.get("pid"), e.get("tid"))))
    spans.sort(key=lambda s: (s[0], -s[1]))
    by_thread = collections.defaultdict(list)
    for j, s in enumerate(spans):
        by_thread[s[3]].append(j)
    # Each span's parent: the span of its thread around it (spans nest).
    parent = {}
    for own in by_thread.values():
        stack = []
        for j in own:
            while stack and spans[stack[-1]][1] < spans[j][1]:
                stack.pop()
            parent[j] = stack[-1] if stack else None
            stack.append(j)

    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and "dur" in e]
    at = collections.defaultdict(list)
    for q, e in enumerate(dev):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            at[(launch.get("pid"), launch.get("tid"))].append((float(launch["ts"]), q))
    dev_at = _place(spans, by_thread, at)

    waits = collections.defaultdict(list)
    for q, e in enumerate(events):
        if e.get("cat") in LAUNCH_CATS and e.get("name") in WAITS:
            waits[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), q))
    wait_at = _place(spans, by_thread, waits)

    busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    cuts = sorted({x for sp in spans for x in sp[:2]})
    ends = cuts + [x for iv in busy for x in iv]
    pieces = []  # the idle time, cut at every span edge
    if ends:
        holes, end = [], min(ends)
        for a, b in busy + [[max(ends), max(ends)]]:
            if a > end:
                holes.append((end, a))
            end = max(end, b)
        for a, b in holes:
            inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
            pieces += zip([a] + inner, inner + [b])
    idle_at = _innermost(spans, [((x + y) / 2, q) for q, (x, y) in enumerate(pieces)])

    self_ = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for q, e in enumerate(dev):
        self_[dev_at.get(q)][0] += float(e["dur"]) / 1e6
    for q, (x, y) in enumerate(pieces):
        self_[idle_at.get(q)][1] += (y - x) / 1e6
    for thread_waits in waits.values():
        for _, q in thread_waits:
            self_[wait_at.get(q)][2] += 1

    keys = ("device_s", "idle_s", "waits")
    out = {}
    for j, s in enumerate(spans):
        o = out.setdefault(s[2], {"n": 0, **{k: 0 for k in keys},
                                  "within": {k: 0 for k in keys}})
        o["n"] += 1
        for k, v in zip(keys, self_.get(j, (0.0, 0.0, 0))):
            o[k] += v
    # Inclusive sums: each span's own share goes to it and every span around
    # it, each name once (a name nested in itself counts once).
    for j in range(len(spans)):
        v, names, i = self_.get(j), set(), j
        if v is None:
            continue
        while i is not None:
            names.add(spans[i][2])
            i = parent.get(i)
        for name in names:
            for k, x in zip(keys, v):
                out[name]["within"][k] += x
    rest = self_.get(None, (0.0, 0.0, 0))
    return {"spans": out, "outside": dict(zip(keys, rest)),
            "steps": out.get(STEP, {}).get("n", 0)}


def extend(summary: dict, events: list) -> dict:
    """``summary`` (``tracing.summary``'s dict for the same events) with
    ``spans`` (``by_span``) and, in its breakdown, ``idle_by_span`` and
    ``device_by_span``: [name, seconds] on the innermost span, ``outside``
    for time under none, largest first. Nothing it had changes."""
    sp = by_span(events)
    out = dict(summary, spans=sp)
    out["breakdown"] = dict(summary.get("breakdown", {}))
    for key, field in (("idle_by_span", "idle_s"), ("device_by_span", "device_s")):
        rows = [[n, v[field]] for n, v in sp["spans"].items() if v[field] > 0]
        if sp["outside"][field] > 0:
            rows.append([OUTSIDE, sp["outside"][field]])
        out["breakdown"][key] = sorted(rows, key=lambda r: -r[1])
    return out


def per_step(ctx, name: str, field: str, scale: float = 1.0):
    """``within[field]`` of span ``name`` a profiled train step, times
    ``scale``; None outside a traced train run, or where the trace holds no
    step or no such span (a program without the spans)."""
    sp = ctx.get("spans") if ctx.get("kind") == "train" else None
    if not sp or not sp["steps"] or name not in sp["spans"]:
        return None
    return scale * sp["spans"][name]["within"][field] / sp["steps"]
