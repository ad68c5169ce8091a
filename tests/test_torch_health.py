"""PyTorch port, the training-health watchtower and the trace capture,
on the CPU, held against the JAX package on the same inputs:

- ``HealthMonitor`` fed one seeded step sequence (a NaN loss, a loss
  spike, a run of slow steps, an infeed stall, a non-finite gradient
  norm) under each reaction (``none``, ``checkpoint``, ``halt``): the
  same kinds fire at the same steps, with the same counts, last anomaly,
  last finite step, checkpoint calls, ``HealthHalt`` message and
  ``tfos_health_*`` series; the env gates read alike;
- ``straggler_report`` (with its ``tfos_node_skew`` gauge),
  ``snapshot_anomaly_total`` and ``process_summary`` on the same
  inputs;
- ``TrainMetrics`` builds ``monitor_from_env()`` by default and takes
  ``health=False``; a planned ``train.step:nan`` under ``halt`` raises
  ``HealthHalt`` out of ``step()`` at the poisoned step;
- ``utils.profiler``'s capture writes a Chrome trace, refuses a second
  one while the first runs and never raises; ``serve_control`` acks
  both directives and an unknown one;
- ``POST /profilez`` and ``/flightz`` round trips through a manager and
  a live publisher, with the 404 / 400 / 405 answers;
- end to end on a one-executor ``LocalEngine``: a NaN planned at the
  5th step under ``TFOS_HEALTH_ACTION=halt`` turns ``/healthz`` to
  ``degraded``, halts the trainer with its checkpoint at step 4, and
  leaves a ``health/nan`` flight dump and a ``health/halt`` event.
"""

import glob
import json
import os
import random
import threading
import time
import types
import urllib.request

import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.obs import health as jhealth  # noqa: E402
from tensorflowonspark_tpu.utils import metrics_registry as jreg  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import manager as tfmanager  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.obs import health as phealth  # noqa: E402
from tensorflowonspark_tpu_torch.obs import http as phttp  # noqa: E402
from tensorflowonspark_tpu_torch.obs import publish  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults, profiler  # noqa: E402
from tensorflowonspark_tpu_torch.utils import (  # noqa: E402
    metrics_registry as preg,
)
from tensorflowonspark_tpu_torch.utils import telemetry  # noqa: E402

_ENV = (preg.PORT_ENV, preg.INTERVAL_ENV, phealth.ENABLE_ENV,
        phealth.ACTION_ENV, phealth.SPIKE_SIGMA_ENV, phealth.WARMUP_ENV,
        phealth.STEP_FACTOR_ENV, phealth.STEP_PATIENCE_ENV,
        phealth.STALL_FRAC_ENV, faults.PLAN_ENV, faults.EXECUTOR_ENV,
        telemetry.DIR_ENV, telemetry.SPOOL_ENV, telemetry.NODE_ENV,
        telemetry.ROLE_ENV, "TFOS_EXECUTOR_INDEX")


def _reset_faults():
    """Forget the plan cache and its hit counts."""
    faults._state.update(pid=None, plan=None, faults=(), hits={})


@pytest.fixture(autouse=True)
def _health_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    preg.reset()
    jreg.reset()
    _reset_faults()
    yield
    preg.reset()
    jreg.reset()
    _reset_faults()
    phealth._LAST_STRAGGLERS.clear()
    jhealth._LAST_STRAGGLERS.clear()


def _enable(monkeypatch, interval="0.1"):
    monkeypatch.setenv(preg.PORT_ENV, "0")
    monkeypatch.setenv(preg.INTERVAL_ENV, interval)
    preg.reset()
    jreg.reset()


def _steps(seed=5, n=70):
    """One seeded step sequence: (loss, step_s, stall, grad_norm,
    grad_finite) a step, with a spike at 25, a NaN at 30, slow steps
    34-41, a stall 45-49 and an infinite gradient norm at 55."""
    rng = random.Random(seed)
    out = []
    for i in range(1, n + 1):
        loss = 2.0 - 0.01 * i + rng.gauss(0, 0.01)
        step_s = 0.1 * rng.uniform(0.95, 1.05)
        stall = 0.05
        gn, gf = 1.0 + rng.random(), True
        if i == 25:
            loss *= 5
        if i == 30:
            loss = float("nan")
        if 34 <= i <= 41:
            step_s *= 4
        if 45 <= i <= 49:
            stall = 0.8
        if i == 55:
            gn, gf = float("inf"), False
        out.append((loss, step_s, stall, gn, gf))
    return out


def _replay(mod, action):
    calls = []
    m = mod.HealthMonitor(action=action,
                          checkpoint_fn=lambda: calls.append(
                              m.last_finite_step))
    fires, halted = [], None
    for i, (loss, dur, stall, gn, gf) in enumerate(_steps(), start=1):
        try:
            fires.append((i, m.observe_step(
                loss=loss, step_time_s=dur, infeed_frac=stall,
                grad_norm=gn, grad_finite=gf, step=i)))
        except mod.HealthHalt as e:
            halted = (i, str(e))
            break
    return {"fires": fires, "counts": m.counts, "last": m.last_anomaly,
            "finite": m.last_finite_step, "status": m.status,
            "summary": m.summary(), "calls": calls, "halted": halted}


@pytest.mark.parametrize("action", ["none", "checkpoint", "halt"])
def test_monitor_matches_jax_on_one_step_sequence(monkeypatch, action):
    _enable(monkeypatch)
    got, want = _replay(phealth, action), _replay(jhealth, action)
    assert got == want
    assert preg.snapshot() == jreg.snapshot()
    fired = [k for _, ks in got["fires"] for k in ks]
    if action == "halt":
        assert got["halted"][0] == 30 and got["calls"] == [29]
        assert fired == ["loss_spike"]
    else:
        assert got["halted"] is None
        assert set(fired) == set(phealth.KINDS)
        assert got["calls"] == ([29, 54] if action == "checkpoint" else [])


def test_env_gates_read_as_the_jax_ones(monkeypatch):
    for raw in ("", "1", "0", "off", "no", "False"):
        monkeypatch.setenv(phealth.ENABLE_ENV, raw)
        assert phealth.enabled() == jhealth.enabled()
    for raw in ("", "halt", "CHECKPOINT", "bogus"):
        monkeypatch.setenv(phealth.ACTION_ENV, raw)
        assert phealth.action_from_env() == jhealth.action_from_env()
    monkeypatch.setenv(phealth.WARMUP_ENV, "3")
    monkeypatch.setenv(phealth.SPIKE_SIGMA_ENV, "x")
    p, j = phealth.HealthMonitor("none"), jhealth.HealthMonitor("none")
    assert (p.warmup, p.spike_sigma) == (j.warmup, j.spike_sigma) == (3, 6.0)
    with pytest.raises(ValueError):
        phealth.HealthMonitor(action="explode")


def _entry(p50_scale, count, seed):
    rng = random.Random(seed)
    counts = [0] * 16
    for _ in range(count):
        v = p50_scale * rng.uniform(0.5, 1.5)
        counts[next((i for i, b in enumerate(preg.DEFAULT_BUCKETS_MS)
                     if v <= b), 15)] += 1
    return {"metrics": {"tfos_train_step_ms": {
        "type": "histogram", "help": "", "series": [{
            "labels": {}, "bounds": list(preg.DEFAULT_BUCKETS_MS),
            "counts": counts, "sum": 1.0, "count": count}]},
        "tfos_health_anomalies_total": {
            "type": "counter", "help": "", "series": [
                {"labels": {"kind": "nan"}, "value": float(seed)},
                {"labels": {"kind": "slow_step"}, "value": 2.0}]}}}


def test_straggler_report_and_summaries_match_jax(monkeypatch):
    _enable(monkeypatch)
    entries = {"worker-0": _entry(10, 40, 1), "worker-1": _entry(40, 40, 2),
               "worker-2": _entry(12, 1, 3), "ps-0": {"metrics": None}}
    for kw in ({}, {"min_nodes": 3}, {"min_count": 1}, {"emit": False}):
        assert phealth.straggler_report(entries, **kw) == \
            jhealth.straggler_report(entries, **kw)
    assert phealth.straggler_report({}) is None
    assert preg.snapshot() == jreg.snapshot()
    assert "tfos_node_skew" in preg.snapshot()
    for ent in entries.values():
        assert phealth.snapshot_anomaly_total(ent["metrics"]) == \
            jhealth.snapshot_anomaly_total(ent["metrics"])
    assert phealth.process_summary()["max_skew"] == \
        jhealth.process_summary()["max_skew"]
    assert set(phealth.process_summary()) == set(jhealth.process_summary())


def test_train_metrics_builds_the_monitor(monkeypatch):
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    assert isinstance(TrainMetrics().health, phealth.HealthMonitor)
    assert TrainMetrics(health=False).health is None
    monkeypatch.setenv(phealth.ENABLE_ENV, "0")
    assert TrainMetrics().health is None


def test_train_metrics_poison_halts_at_the_planned_step(monkeypatch):
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    monkeypatch.setenv(faults.PLAN_ENV, "train.step:nan@5")
    monkeypatch.setenv(phealth.ACTION_ENV, "halt")
    _reset_faults()
    tm = TrainMetrics()
    with pytest.raises(phealth.HealthHalt, match="last finite step 4"):
        for _ in range(10):
            tm.step(items=1, loss=1.0)
    assert tm.steps == 5 and tm.health.counts == {"nan": 1}


def test_profiler_capture_refuses_a_second_and_never_raises(tmp_path):
    assert profiler.stop_trace() is False  # none running
    with profiler.trace(str(tmp_path / "a")):
        import torch

        torch.ones(8) @ torch.ones(8)
        assert profiler.start_trace(str(tmp_path / "b")) is False
    path = profiler.last_trace()
    assert path.startswith(str(tmp_path / "a"))
    assert path.endswith(".pt.trace.json")
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert not os.path.exists(tmp_path / "b")
    with profiler.trace(str(tmp_path / "c"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "c")


class _FakeCtlMgr:
    def __init__(self):
        self.kv = {}

    def obs_control_take(self, nid):
        return self.kv.pop("ctl:" + nid, None)

    def obs_control_ack(self, nid, res):
        self.kv["ack:" + nid] = res


def test_serve_control_acks_every_directive(monkeypatch, tmp_path):
    _enable(monkeypatch)
    fm = _FakeCtlMgr()
    fm.kv["ctl:w0"] = {"cmd": "profile", "ms": 10, "seq": 7}
    ack = publish.serve_control(fm, "w0")
    assert ack["ok"] is True and ack["seq"] == 7 and ack["ms"] == 10
    assert os.path.isfile(ack["trace"]) and fm.kv["ack:w0"] == ack
    fm.kv["ctl:w0"] = {"cmd": "flight", "seq": 8}
    ack = publish.serve_control(fm, "w0")  # telemetry off: degraded
    assert ack["ok"] is False and "telemetry disabled" in ack["error"]
    fm.kv["ctl:w0"] = {"cmd": "zap", "seq": 9}
    assert "unknown cmd" in publish.serve_control(fm, "w0")["error"]
    assert publish.serve_control(fm, "w0") is None
    caps = {(s["labels"]["kind"], s["labels"]["status"]): s["value"]
            for s in preg.snapshot()["tfos_health_captures_total"]
            ["series"]}
    assert caps == {("profile", "ok"): 1.0, ("flight", "degraded"): 1.0}


def _http(method, url, timeout=60):
    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def test_profilez_flightz_round_trip(tmp_path, monkeypatch):
    _enable(monkeypatch)
    monkeypatch.setenv(telemetry.DIR_ENV, str(tmp_path))
    mgr = tfmanager.start(b"hp-secret", ("control",), "local")
    stop = srv = None
    try:
        meta = {"job_name": "worker", "task_index": 0, "executor_id": 0,
                "host": "127.0.0.1", "addr": list(mgr.address),
                "authkey": b"hp-secret".hex()}
        node_mgr = tfmanager.connect(tuple(mgr.address), b"hp-secret")
        preg.inc("tfos_engine_jobs_total")
        stop = publish.start_publisher(node_mgr, "worker-0", role="worker",
                                       interval=0.1)
        srv = phttp.ObsServer(types.SimpleNamespace(cluster_info=[meta]),
                              port=0, interval=0.1).start()
        code, body = _http("POST", srv.url + "/profilez?node=worker-0"
                                             "&ms=200&wait_s=60")
        res = json.loads(body)
        assert code == 200 and res["ok"] is True, res
        assert res["cmd"] == "profile" and res["ms"] == 200
        assert res["capture"].startswith(str(tmp_path))
        assert os.path.isfile(res["trace"])
        code, body = _http("POST", srv.url + "/flightz?node=worker-0"
                                             "&wait_s=60")
        res = json.loads(body)
        assert code == 200 and res["ok"] is True, res
        with open(res["capture"]) as f:
            dump = json.load(f)
        assert dump["trigger"] == "health/on_demand"
        assert dump["node"] == "worker-0"
        assert _http("POST", srv.url + "/profilez?node=worker-9")[0] == 404
        assert _http("POST", srv.url + "/profilez")[0] == 400
        assert _http("GET", srv.url + "/profilez")[0] == 405
    finally:
        if srv is not None:
            srv.stop()
        if stop is not None:
            stop.set()
        mgr.shutdown()


# -- end to end ---------------------------------------------------------------

def nan_halt_main(args, ctx):
    """Steps until the planned NaN halts it; its monitor's checkpoint is
    the last finite step's (module level: the executor imports it)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    mon = phealth.monitor_from_env(node=f"worker-{ctx.task_index}")
    mon.checkpoint_fn = lambda: ckpt.save_checkpoint(
        args["ckpt_dir"], {"w": np.zeros(1, np.float32)},
        mon.last_finite_step)
    tm = TrainMetrics(health=mon)
    for i in range(600):
        tm.step(items=1, loss=1.0 + 0.001 * i)
        time.sleep(0.02)


def _nan_halt(tmp_path):
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    engine = LocalEngine(1, env={"OMP_NUM_THREADS": "1",
                                 faults.PLAN_ENV: "train.step:nan@5",
                                 phealth.ACTION_ENV: "halt"})
    degraded = None
    try:
        cluster = TFCluster.run(
            engine, nan_halt_main, {"ckpt_dir": str(tmp_path / "ckpt")},
            num_executors=1, input_mode=TFCluster.InputMode.TENSORFLOW,
            reservation_timeout=60)
        base = cluster.obs.url
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and degraded is None:
            code, body = _http("GET", base + "/healthz", timeout=10)
            doc = json.loads(body)
            if code == 503 and doc["status"] == "degraded":
                degraded = doc
            time.sleep(0.1)
        cluster.shutdown()
    finally:
        engine.stop()
    assert degraded is not None, "healthz never turned degraded"
    assert degraded["nodes"]["worker-0"]["anomalies"] == 1.0
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 4
    dumps = glob.glob(str(tmp_path / "telemetry" / "spool-*" /
                          "flight-*.json"))
    assert any(json.load(open(p))["trigger"] == "health/nan" for p in dumps)
    names = set()
    for path in glob.glob(str(tmp_path / "telemetry" / "run-*" / "*.jsonl")):
        with open(path) as f:
            names |= {json.loads(line)["name"] for line in f}
    assert {"health/nan", "health/halt", "fault/injected"} <= names, names


def test_e2e_nan_halt_checkpoints_the_last_finite_step(tmp_path,
                                                        monkeypatch):
    _enable(monkeypatch)
    monkeypatch.setenv(telemetry.DIR_ENV, str(tmp_path / "telemetry"))
    err = []

    def run():
        try:
            _nan_halt(tmp_path)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(150)
    assert not t.is_alive(), "the NaN halt run did not end within 150 s"
    if err:
        raise err[0]
