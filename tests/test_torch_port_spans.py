"""The port's spans (``utils/spans.py``) and the stage timers built on them.

With no profiler recording, a span is a shared no-op: no profiler call and
no CUDA call. Under ``utils/profiling.trace`` the train step's and the
batched registration's spans land in the trace as nested ``dgr.*``
``user_annotation`` events, the step or sub-batch id in the name. A
``Timer`` takes CUDA event pairs and reads them only when it is read; the
stage timers of ``make_train_step`` and of the pipeline wait for nothing at
a stage edge and still count every call. CPU only, no JAX.
"""

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core import train_step as ts
from deepglobalregistration_tpu_torch.core.pipeline import STAGES, DeepGlobalRegistration
from deepglobalregistration_tpu_torch.data.collate import PairBatch
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.utils import convert, device, profiling, spans
from deepglobalregistration_tpu_torch.utils.timer import Timer
from torch_port_trees import pair_batch, torch_threads

TRAIN = ("fcgf", "match", "plan6", "inlier", "loss", "backward", "optimizer")
REG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


@pytest.fixture(autouse=True)
def one_thread():
    with torch_threads(1):
        yield


class FakeEvent:
    """A CUDA event that counts its records and waits."""

    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.log.append("record")
        self.t = len(self.log)

    def synchronize(self):
        self.log.append("wait")

    def elapsed_time(self, end):
        return 1000.0 * (end.t - self.t)  # ms


@pytest.fixture
def no_waits(monkeypatch):
    """Every way the port could wait for the card raises."""
    def boom(*a, **k):
        raise AssertionError("a stage edge waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", boom)


def _train_step(timers=None):
    def net(name, cin, cout, D, normalize, train):
        spec = load_model(name)
        cfg = spec.make_config(cin, cout, conv1_kernel_size=3,
                               normalize_feature=normalize, D=D)
        n = spec.module(cfg)
        n.load_state_dict(convert.from_jax_params(
            *spec.init_params(device.generator(D), cfg), cfg))
        return n.train(train).requires_grad_(train)

    fcgf = net("ResUNetBN2F", 1, 8, 3, True, False)
    inlier = net("ResUNetBN2FX", 6, 1, 6, False, True)
    config = default_config(feat_model="ResUNetBN2F", feat_model_n_out=8,
                            inlier_model="ResUNetBN2FX", inlier_feature_type="coords",
                            device="cpu")
    opt = ts.make_optimizer("SGD", inlier.parameters(), config)
    step, _ = ts.make_train_step(fcgf, inlier, config, opt, timers=timers)
    batch = PairBatch(*pair_batch(np.random.RandomState(0), 2, 96, 32, span=6))
    return step, batch


def _pairs(n=2):
    rng = np.random.RandomState(1)
    xs = [(rng.rand(300, 3) * 1.2).astype(np.float32) for _ in range(n)]
    return xs, [x + np.float32(0.05) for x in xs]


def test_span_without_a_profiler_is_a_shared_no_op(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = spans.span("train.plan6"), spans.span("train.step", step=3)
    assert a is b
    with a, b:
        pass


def test_labels_carry_the_ids():
    assert spans.label("register", {"pair": 4}) == "dgr.register[pair=4]"
    assert spans.label("train.plan6", {}) == "dgr.train.plan6"
    assert spans.split_label("dgr.register_batch[sub_batch=2,tag=a]") == \
        ("dgr.register_batch", {"sub_batch": 2, "tag": "a"})
    assert spans.split_label("dgr.fcgf") == ("dgr.fcgf", {})


def _annotations(log_dir):
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
                   for e in profiling.load_trace(log_dir)
                   if e.get("cat") == "user_annotation" and e["name"].startswith("dgr.")),
                  key=lambda a: (a[0], -a[1]))


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1] and child[3] == parent[3]


def test_train_spans_nest_under_the_step_in_the_trace(tmp_path):
    step, batch = _train_step()
    with profiling.trace(str(tmp_path), with_stack=False) as log_dir:
        for _ in range(2):
            step(ts.batch_to(batch, "cpu"))
    got = _annotations(log_dir)
    steps = [a for a in got if a[2].startswith("dgr.train.step")]
    assert [a[2] for a in steps] == ["dgr.train.step[step=0]", "dgr.train.step[step=1]"]
    assert [a[2] for a in got].count("dgr.train.batch_to") == 2
    for s in steps:
        inner = [a[2] for a in got if a is not s and _inside(a, s)]
        assert inner == ["dgr.train." + n for n in TRAIN]


def test_register_batch_spans_nest_in_the_trace(tmp_path):
    dgr = DeepGlobalRegistration(default_config(**REG), device="cpu")
    xs, ys = _pairs()
    with profiling.trace(str(tmp_path), with_stack=False) as log_dir:
        dgr.register_batch(xs, ys, force_vmapped=True)
        dgr.register(xs[0], ys[0])
    got = _annotations(log_dir)
    names = [a[2] for a in got]
    sub = got[names.index("dgr.register_batch[sub_batch=0]")]
    inner = [a[2] for a in got if a is not sub and _inside(a, sub)]
    assert inner[:5] == ["dgr.voxelize", "dgr.fcgf", "dgr.match", "dgr.inlier", "dgr.plan6"]
    if any(dgr.last_batch["gate"]):
        assert ["dgr.solve", "dgr.refine", "dgr.icp"] == inner[5:]
    one = [a for a in got if a[2].startswith("dgr.register[")]
    assert one[-1][2] == f"dgr.register[pair={len(one) - 1}]"
    inner = [a[2] for a in got if a is not one[-1] and _inside(a, one[-1])]
    assert inner[:5] == ["dgr.voxelize", "dgr.fcgf", "dgr.match", "dgr.inlier", "dgr.plan6"]


def test_timer_reads_event_pairs_when_read(monkeypatch):
    FakeEvent.log = []
    t = Timer()
    a, b, c = FakeEvent(True), FakeEvent(True), FakeEvent(True)
    for e in (a, b, c):
        e.record()
    t.add_events(a, b)
    t.add_events(a, c)
    assert t.calls == 2 and "wait" not in FakeEvent.log
    assert t.total_time == pytest.approx(3.0)
    assert FakeEvent.log.count("wait") == 2
    assert (t.diff, t.avg, t.calls) == (pytest.approx(2.0), pytest.approx(1.5), 2)
    t.add_events(b, c)
    t.reset()
    assert (t.calls, t.total_time) == (0, 0.0) and FakeEvent.log.count("wait") == 2


def test_a_timed_cuda_span_records_events_and_waits_for_nothing(monkeypatch, no_waits):
    FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    t, u = Timer(), Timer()
    with spans.span("fcgf", t, u, cuda=True):
        pass
    assert FakeEvent.log == ["record", "record"]
    assert (t.calls, u.calls) == (1, 1) and t.total_time == u.total_time == 1.0
    # The pipeline's stages on the card: events on the current stream, no wait.
    dgr = DeepGlobalRegistration(default_config(**REG), device="cpu")
    dgr.device = torch.device("cuda")
    FakeEvent.log = []
    with dgr._stage("icp", dgr.batch_stage_timers):
        pass
    assert dgr.batch_stage_timers["icp"].calls == 1
    assert FakeEvent.log == ["record", "record"]


def test_train_step_stage_timers_wait_for_nothing(no_waits):
    timers = {s: Timer() for s in TRAIN}
    step, batch = _train_step(timers)
    for _ in range(2):
        step(ts.batch_to(batch, "cpu"))
    assert {s: t.calls for s, t in timers.items()} == {s: 2 for s in TRAIN}
    assert all(t.total_time > 0 for t in timers.values())


def test_register_batch_stage_timers_wait_for_nothing(no_waits):
    dgr = DeepGlobalRegistration(default_config(**REG), device="cpu")
    xs, ys = _pairs()
    dgr.register_batch(xs, ys, force_vmapped=True)
    calls = {s: dgr.batch_stage_timers[s].calls for s in STAGES}
    assert calls["voxelize"] == calls["fcgf"] == calls["inlier"] == 1
    rec = dgr.register(xs[0], ys[0])
    assert rec.shape == (4, 4)
    assert set(dgr.last_record.stage_s) == set(STAGES)
    assert dgr.feat_timer.calls == dgr.stage_timers["fcgf"].calls
