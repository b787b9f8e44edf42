"""``dgrbench/spans.py`` on a hand-written Chrome trace: device time joined
to its launch's span (a backward launch from autograd's own thread
included), idle time cut at span edges with ``outside``, host waits, the
new readers, and ``tracing.summary`` untouched by the spans' events."""

import pytest

from dgrbench import run, spans, tracing

NEW = ("train.plan6_kernel_ms", "train.plan6_idle_ms", "train.backward_kernel_ms",
       "train.backward_idle_ms", "train.host_waits")


def _span(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": {}}


def _rt(name, ts, corr=None, tid=1):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": 2, "args": args}


def _dev(ts, dur, corr, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _events():
    """One step (20-200 us) after a batch_to (0-10): plan6 (30-80) launches
    a kernel and waits once; backward (100-180) sits while autograd's thread
    2 launches a kernel and waits; a kernel launched at 210 is outside."""
    return [
        _span("dgr.train.batch_to", 0, 10),
        _rt("cudaMemcpyAsync", 5, 1),
        _dev(12, 8, 1, "gpu_memcpy", "Memcpy HtoD"),
        _span("dgr.train.step[step=0]", 20, 180),
        _span("dgr.train.plan6", 30, 50),
        {"ph": "X", "cat": "cpu_op", "name": "aten::unique", "pid": 1, "tid": 1,
         "ts": 32, "dur": 40, "args": {}},
        _rt("cudaLaunchKernel", 35, 2),
        _dev(40, 20, 2, name="unique_kernel"),
        _rt("cudaStreamSynchronize", 70),
        _span("dgr.train.backward", 100, 80),
        _rt("cudaLaunchKernel", 110, 3, tid=2),
        _dev(120, 30, 3, name="gemm"),
        _rt("cudaStreamSynchronize", 160, tid=2),
        _rt("cudaLaunchKernel", 210, 4),
        _dev(215, 10, 4, name="slice"),
        # The profiler's device-side copy of a span: not a span, not device work.
        _span("dgr.train.step[step=0]", 40, 185, tid=7, cat="gpu_user_annotation"),
    ]


def test_device_time_goes_to_the_launch_span():
    sp = spans.by_span(_events())
    got = {n: v["device_s"] for n, v in sp["spans"].items()}
    assert got == pytest.approx({"dgr.train.batch_to": 8e-6, "dgr.train.step": 0.0,
                                 "dgr.train.plan6": 20e-6, "dgr.train.backward": 30e-6},
                                abs=1e-12)
    assert sp["outside"]["device_s"] == pytest.approx(10e-6, abs=1e-12)
    assert sp["spans"]["dgr.train.step"]["within"]["device_s"] == pytest.approx(50e-6)
    assert sp["steps"] == 1 and sp["spans"]["dgr.train.plan6"]["n"] == 1


def test_idle_is_cut_at_span_edges():
    sp = spans.by_span(_events())
    got = {n: v["idle_s"] for n, v in sp["spans"].items()}
    assert got == pytest.approx({"dgr.train.batch_to": 10e-6, "dgr.train.step": 50e-6,
                                 "dgr.train.plan6": 30e-6, "dgr.train.backward": 50e-6},
                                abs=1e-12)
    assert sp["outside"]["idle_s"] == pytest.approx(17e-6, abs=1e-12)
    # Window 0-225 us less 68 us of device time, all of it placed.
    assert sum(got.values()) + sp["outside"]["idle_s"] == pytest.approx(157e-6)
    assert sp["spans"]["dgr.train.step"]["within"]["idle_s"] == pytest.approx(130e-6)


def test_host_waits():
    sp = spans.by_span(_events())
    assert {n: v["waits"] for n, v in sp["spans"].items()} == {
        "dgr.train.batch_to": 0, "dgr.train.step": 0, "dgr.train.plan6": 1,
        "dgr.train.backward": 1}
    assert sp["spans"]["dgr.train.step"]["within"]["waits"] == 2
    assert sp["outside"]["waits"] == 0


def test_extend_adds_the_breakdowns_and_keeps_the_rest():
    ev = _events()
    base = tracing.summary(ev, 0.001)
    out = spans.extend(base, ev)
    assert {k: out[k] for k in base if k != "breakdown"} == \
        {k: v for k, v in base.items() if k != "breakdown"}
    assert set(out) - set(base) == {"spans"}
    assert {k: out["breakdown"][k] for k in base["breakdown"]} == base["breakdown"]
    assert set(out["breakdown"]) - set(base["breakdown"]) == {"idle_by_span",
                                                              "device_by_span"}
    idle = out["breakdown"]["idle_by_span"]
    assert [n for n, _ in idle] == ["dgr.train.step", "dgr.train.backward",
                                    "dgr.train.plan6", "outside", "dgr.train.batch_to"]
    assert out["breakdown"]["device_by_span"][0] == ["dgr.train.backward",
                                                     pytest.approx(30e-6)]


def test_summary_is_blind_to_the_span_events():
    """``tracing.summary`` of a trace gives what it gives with the spans'
    events taken out, key for key."""
    ev = _events()
    bare = [e for e in ev if e.get("cat") != "user_annotation"]
    assert tracing.summary(ev, 0.001) == tracing.summary(bare, 0.001)


def test_readers():
    ctx = spans.extend({"busy_s": 0.0}, _events())
    got = {n: run.metric_reader(n)(dict(ctx, kind="train")) for n in NEW}
    assert got == pytest.approx({"train.plan6_kernel_ms": 0.020,
                                 "train.plan6_idle_ms": 0.030,
                                 "train.backward_kernel_ms": 0.030,
                                 "train.backward_idle_ms": 0.050,
                                 "train.host_waits": 2}, abs=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_where_there_is_nothing(name):
    read = run.metric_reader(name)
    with_spans = spans.extend({}, _events())
    assert read(dict(with_spans, kind="register")) is None
    assert read({"kind": "train", "steps": 3, "train_stage_s": {}}) is None
    # A program without spans: a trace with no step.
    bare = [e for e in _events() if e.get("cat") != "user_annotation"]
    assert read(dict(spans.extend({}, bare), kind="train")) is None
