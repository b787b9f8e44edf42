"""The port's profiler hooks (``utils/profiling.py``).

``trace()`` on the CPU writes a Chrome trace with no kernel events, which
``summarize_trace`` reads as ``{}``, as the JAX version does for a trace with
no device ops. The parsers are held to exact sums on a small hand-written
trace in torch.profiler's Chrome format: kernel events joined through
``correlation`` to their host launches and through ``External id`` to the
launching operator, with a nested Python stack on two host threads, and
the port's ``dgr.*`` spans on one of them.
"""

import gzip
import json
import os

import pytest
import torch

from deepglobalregistration_tpu_torch.utils import profiling

PID = 100
MMA = "(anonymous namespace)::mma_kernel(float const*, int, nn1::Counts)"
PACK = "(anonymous namespace)::pack_kernel(float const*, nn1::Counts)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32"
INDEX_ADD = "void at::native::indexFuncLargeIndex<float, long>(...)"


def _frame(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": name, "pid": PID,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _op(name, ts, dur, ext):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": PID, "tid": 1,
            "ts": ts, "dur": dur, "args": {"External id": ext}}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": PID, "tid": 1,
            "ts": ts, "dur": dur, "args": {}}


def _launch(ts, corr, ext=0, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": PID,
            "tid": tid, "ts": ts, "dur": 5, "args": {"External id": ext,
                                                     "correlation": corr}}


def _kernel(name, ts, dur, corr, ext=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts,
            "dur": dur, "args": {"External id": ext, "correlation": corr,
                                 "device": 0, "stream": 7}}


def _events():
    pkg = "deepglobalregistration_tpu_torch"
    return [
        {"ph": "M", "name": "process_name", "pid": PID, "tid": 0,
         "args": {"name": "python"}},
        _frame(f"/src/{pkg}/core/pipeline.py(200): register", 0, 1000),
        _frame(f"{pkg}/ops/knn.py(123): _call", 100, 100),
        _frame("torch/nn/modules/module.py(1700): _call_impl", 300, 200),
        _frame(f"{pkg}/ops/sparse_conv.py(50): conv", 600, 200),
        _frame(f"{pkg}/ops/sparse_conv.py(80): _gather", 650, 50),
        _frame(f"{pkg}/ops/gather.py(40): take", 0, 400, tid=2),
        _op("aten::mm", 320, 100, 8),
        _span("dgr.register[pair=0]", 0, 1000),
        _span("dgr.match", 100, 150),
        _span("dgr.fcgf", 600, 200),
        _op("aten::index_add_", 660, 30, 7),
        _launch(150, 1),              # through ctypes: no operator
        _launch(330, 2, 8),           # aten::mm inside torch's frame
        _launch(665, 3, 7),           # aten::index_add_ inside _gather
        _launch(1500, 4),             # outside every frame
        _launch(120, 5, tid=2),
        _kernel(MMA, 2000, 250, 1),
        _kernel(GEMM, 2300, 40, 2, 8),
        _kernel(INDEX_ADD, 2400, 30, 3, 7),
        _kernel(MMA, 2500, 50, 4),
        _kernel(PACK, 2600, 10, 5),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
         "ts": 2700, "dur": 999, "args": {"correlation": 6}},
    ]


def _write(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)


@pytest.fixture
def hand_trace(tmp_path):
    _write(tmp_path / "old.pt.trace.json", [_kernel("stale", 0, 1, 1)])
    os.utime(tmp_path / "old.pt.trace.json", (1, 1))
    _write(tmp_path / "new.pt.trace.json.gz", _events(), gz=True)
    return str(tmp_path)


def test_summarize_trace_on_a_hand_written_trace(hand_trace):
    got = profiling.summarize_trace(hand_trace)
    assert got == pytest.approx({MMA[:80]: 0.300, GEMM[:80]: 0.040,
                                 INDEX_ADD[:80]: 0.030, PACK[:80]: 0.010}, abs=1e-12)
    assert list(got)[0] == MMA[:80]
    assert list(profiling.summarize_trace(hand_trace, top=2)) == [MMA[:80], GEMM[:80]]
    ms, n = profiling.kernel_totals(hand_trace)
    assert ms == pytest.approx(0.330 + 0.040 + 0.010, abs=1e-12) and n == 5


def test_attribute_trace_by_op(hand_trace):
    got = profiling.attribute_trace(hand_trace, by="op")
    assert got == pytest.approx({MMA[:80]: 0.300, "aten::mm": 0.040,
                                 "aten::index_add_": 0.030, PACK[:80]: 0.010},
                                abs=1e-12)


def test_attribute_trace_by_line(hand_trace):
    pkg = "deepglobalregistration_tpu_torch"
    got = profiling.attribute_trace(hand_trace, by="line")
    assert got == pytest.approx({f"{pkg}/ops/knn.py:123": 0.250,
                                 MMA[:80]: 0.050,
                                 f"{pkg}/core/pipeline.py:200": 0.040,
                                 f"{pkg}/ops/sparse_conv.py:80": 0.030,
                                 f"{pkg}/ops/gather.py:40": 0.010}, abs=1e-12)
    assert list(profiling.attribute_trace(hand_trace, top=1)) == [f"{pkg}/ops/knn.py:123"]
    with pytest.raises(ValueError):
        profiling.attribute_trace(hand_trace, by="hlo")


def test_attribute_trace_by_span(hand_trace):
    """Each kernel on the innermost span around its launch, ids dropped; the
    launch on thread 2, which holds no span, takes thread 1's span then."""
    got = profiling.attribute_trace(hand_trace, by="span")
    assert got == pytest.approx({"dgr.match": 0.260, "dgr.register": 0.040,
                                 "dgr.fcgf": 0.030, MMA[:80]: 0.050}, abs=1e-12)


def test_trace_on_the_cpu_has_no_kernel_events(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert log_dir == str(tmp_path)
    events = profiling.load_trace(log_dir)
    cats = {e.get("cat") for e in events}
    assert {"cpu_op", "python_function"} <= cats
    assert profiling.summarize_trace(log_dir) == {}
    assert profiling.kernel_totals(log_dir) == (0.0, 0)
    assert profiling.attribute_trace(log_dir) == {}
    assert profiling.summarize_trace(str(tmp_path / "nothing")) == {}
