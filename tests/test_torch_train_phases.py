"""PyTorch port, the training step's phases (``TrainMetrics.mark``), on
the CPU:

- with telemetry on, a three-step loop records ``train/input_wait``,
  ``train/forward``, ``train/backward`` and ``train/optimizer`` under
  each timed step's ``train/step`` by ``parent_id``, inside it, their
  host times summing to at most the step's; ``report()["phases"]``
  holds each step's input wait and phase milliseconds;
- the transformer's and ResNet's train steps mark those phases;
- on a CUDA device the phases' milliseconds are read from events, and
  partition the step's ``(start, end)`` exactly (events faked here);
- with telemetry off nothing is made: no ``torch.cuda.Event``, no span,
  no ``phases`` in the report;
- a telemetry span and the profiler's events share one clock: a span
  around a matmul encloses its kineto CPU event within 1 ms.
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.utils import metrics  # noqa: E402
from tensorflowonspark_tpu_torch.utils import telemetry  # noqa: E402

PHASES = ("forward", "backward", "optimizer")


@pytest.fixture
def telemetry_on(tmp_path, monkeypatch):
    for env in (telemetry.SPOOL_ENV, telemetry.NODE_ENV, telemetry.ROLE_ENV,
                telemetry.TRACE_ENV):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv(telemetry.DIR_ENV, str(tmp_path))
    yield tmp_path
    telemetry.flush()


def _spans():
    telemetry.flush()
    with open(telemetry.sink_path()) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "span"]


def _loop(tm, steps=3, step_fn=None):
    for i in range(steps):
        t0 = time.perf_counter()
        time.sleep(0.002)  # the wait for the batch
        if i:
            tm.infeed_wait(time.perf_counter() - t0)
        if step_fn is None:
            for phase in PHASES:
                tm.mark(phase)
                time.sleep(0.001)
        else:
            step_fn()
        tm.step(items=1)


def _check_tree(recs, phases=PHASES):
    steps = [r for r in recs if r["name"] == "train/step"]
    assert len(steps) == 2  # the first step only arms the timer
    for st in steps:
        kids = [r for r in recs
                if r["attrs"].get("parent_id") == st["attrs"]["span_id"]]
        assert sorted(r["name"] for r in kids) == sorted(
            ["train/input_wait"] + [f"train/{p}" for p in phases])
        assert sum(r["dur_ms"] for r in kids) <= st["dur_ms"]
        end = st["ts"] + st["dur_ms"] / 1e3
        for r in kids:
            assert r["attrs"]["trace_id"] == st["attrs"]["trace_id"]
            assert st["ts"] - 1e-3 <= r["ts"]
            assert r["ts"] + r["dur_ms"] / 1e3 <= end + 1e-3


def test_phases_are_children_of_the_step(telemetry_on):
    tm = metrics.TrainMetrics(health=False)
    _loop(tm)
    _check_tree(_spans())
    phases = tm.report()["phases"]
    assert [e["step"] for e in phases] == [0, 1, 2]
    assert "input_wait" not in phases[0]
    for e in phases[1:]:
        wall, ms = e["input_wait"]
        assert ms >= 2.0 and wall <= time.time()
    for e in phases:
        assert all(e[p] >= 1.0 for p in PHASES)
    tm.reset()
    assert tm.report()["phases"] == []


def _transformer_step():
    from tensorflowonspark_tpu_torch.examples import transformer_spark as ts
    from tensorflowonspark_tpu_torch.models import transformer as T

    cfg = T.Config(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                   max_seq=16, dtype="float32")
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, opt = ts.make_optimizer(params)
    batch = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                          .manual_seed(1))
    return lambda tm: ts.train_step(params, opt, batch, cfg, tm=tm)


def _resnet_step():
    from tensorflowonspark_tpu_torch.models import resnet

    params, state = resnet.init(torch.Generator().manual_seed(0), depth=20,
                                num_classes=4, width=4, small_inputs=True)
    opt = torch.optim.SGD([p.requires_grad_() for p in
                           resnet.param_leaves(params)], lr=0.1)
    images = torch.randint(0, 256, (2, 8, 8, 3), dtype=torch.uint8)
    labels = torch.tensor([0, 3])

    def step(tm):
        fn = resnet.make_train_step(opt, depth=20, small_inputs=True,
                                    compute_dtype=torch.float32, tm=tm)
        return fn(params, state, images, labels)

    return step


@pytest.mark.parametrize("model", ["transformer", "resnet"])
def test_train_steps_mark_their_phases(model, telemetry_on):
    make = {"transformer": _transformer_step, "resnet": _resnet_step}[model]
    step = make()
    tm = metrics.TrainMetrics(health=False)
    _loop(tm, step_fn=lambda: step(tm))
    _check_tree(_spans())
    for e in tm.report()["phases"]:
        assert set(PHASES) <= set(e)


class _FakeEvent:
    """A CUDA event on the host clock (ms)."""

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = 1e3 * time.perf_counter()

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_phases_partition_the_step(telemetry_on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    tm = metrics.TrainMetrics(device=torch.device("cuda"), health=False)
    spans = []
    for _ in range(3):
        start, end = _FakeEvent(True), _FakeEvent(True)
        start.record()
        for phase in PHASES:
            tm.mark(phase)
            time.sleep(0.001)
        end.record()
        spans.append(start.elapsed_time(end))
        tm.step(items=1, events=(start, end))
    for e, want in zip(tm.report()["phases"], spans):
        assert sum(e[p] for p in PHASES) == pytest.approx(want, abs=1e-9)
        assert all(e[p] >= 1.0 for p in PHASES)


def test_telemetry_off_makes_nothing(monkeypatch):
    monkeypatch.delenv(telemetry.DIR_ENV, raising=False)

    def refuse(*a, **k):
        raise AssertionError("a CUDA event was built with telemetry off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    tm = metrics.TrainMetrics(device=torch.device("cuda"), health=False)
    step = _transformer_step()
    _loop(tm, step_fn=lambda: step(tm))
    assert "phases" not in tm.report()
    assert tm._phases is None and not hasattr(tm, "_marks")
    assert telemetry.recent() == []


def test_span_encloses_the_profilers_event(telemetry_on):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("test/matmul"):
            torch.mm(a, a)
    rec, = [r for r in telemetry.recent() if r["name"] == "test/matmul"]
    t0, t1 = rec["ts"] * 1e6, (rec["ts"] + rec["dur_ms"] / 1e3) * 1e6
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        s = e.start_ns() / 1e3
        assert t0 - 1e3 <= s and s + e.duration_ns() / 1e3 <= t1 + 1e3
