"""Named spans of the port's work, in the profiler's own trace.

``span(name, **ids)`` marks a region of the program. While a profiler
records (``torch.profiler.profile``, ``utils/profiling.trace``), it enters
``torch.profiler.record_function("dgr." + name)``: the region lands in the
same Kineto trace as the kernels, as a ``user_annotation`` event on the same
clock, so a trace reader can put each kernel, each idle gap of the card and
each host wait on the span the host was in. Spans nest, and nesting gives
the parent. ``ids`` (a step number, a pair or sub-batch index) ride in the
event's name as ``dgr.<name>[key=value,...]``: a profiler that does not
record shapes (the default) keeps no arguments of a ``user_annotation``.
``split_label`` takes such a name apart.

With no profiler recording a span costs one flag read and returns a shared
no-op context: no profiler call, no CUDA call. The names the port uses:

  training (``core/train_step.py``): ``train.step[step=n]`` and under it
  ``train.fcgf``, ``train.match``, ``train.plan6``, ``train.inlier``,
  ``train.loss``, ``train.backward``, ``train.optimizer``; ``train.batch_to``.

  registration (``core/pipeline.py``): ``register[pair=n]`` and
  ``register_batch[sub_batch=n]``, under them ``voxelize``, ``fcgf``,
  ``match``, ``inlier`` (with ``plan6``, the 6D plan apart from its net),
  ``solve`` (with ``refine``, the Procrustes and Adam refinement) and ``icp``.

A span given ``Timer``s (``utils/timer.py``) also times its region into
each of them, as the stage timers of the train step and the pipeline do.
With ``cuda=True`` it records a CUDA event on the current stream at each
edge and hands the pair to the timers, which read it only when they are
read: the time is the region's interval on the card's timeline, from the
stream reaching the first marker to the stream reaching the second, and
timing it waits for nothing. Without ``cuda`` the timers take the host
clock.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

PREFIX = "dgr."
_NULL = contextlib.nullcontext()


def label(name: str, ids: dict) -> str:
    """The trace event's name of span ``name`` with ``ids``."""
    if not ids:
        return PREFIX + name
    return PREFIX + name + "[" + ",".join(f"{k}={v}" for k, v in ids.items()) + "]"


def split_label(event_name: str) -> tuple[str, dict]:
    """(``dgr.<name>``, ids) of a span's event name; ids' values are ints
    where they read as ints."""
    base, _, rest = event_name.partition("[")
    ids = {}
    for kv in rest.rstrip("]").split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            ids[k] = int(v) if v.lstrip("-").isdigit() else v
    return base, ids


def span(name: str, *timers, cuda: bool = False, **ids):
    """The context of span ``name``: a no-op unless a profiler records or
    ``timers`` are given (see the module's docstring)."""
    if not timers and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, timers, cuda, ids)


class _Span:
    __slots__ = ("name", "timers", "cuda", "ids", "record", "start")

    def __init__(self, name, timers, cuda, ids):
        self.name, self.timers, self.cuda, self.ids = name, timers, cuda, ids
        self.record = self.start = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.record = torch.profiler.record_function(label(self.name, self.ids))
            self.record.__enter__()
        if self.timers:
            if self.cuda:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        if self.timers and kind is None:
            if self.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                for t in self.timers:
                    t.add_events(self.start, end)
            else:
                seconds = time.perf_counter() - self.start
                for t in self.timers:
                    t.add(seconds)
        if self.record is not None:
            self.record.__exit__(kind, value, tb)
        return False
