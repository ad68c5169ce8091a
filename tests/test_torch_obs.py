"""PyTorch port, the live metrics plane, on the CPU, held against the JAX
package on the same inputs:

- the metrics catalog: every name, type and help the JAX package's;
- the registry: a seeded series of counter, gauge and histogram updates
  gives both packages' registries the same ``snapshot``, the same
  Prometheus text (``render_text``) and the same ``quantile`` of every
  histogram series;
- ``obs.http.node_summary`` and ``data_summary`` of seeded snapshots,
  ``obs.slo.parse_spec`` (the objectives, and the message of each
  malformed spec), ``evaluate`` and the ``Engine``'s burn rates, breach
  edges and ``tfos_slo_*`` series over one snapshot series;
- ``obs.top``'s table, SLO and health panes of one ``/statusz`` document;
- a lint: every ``tfos_*`` metric the port's code names is in its
  ``CATALOG``;
- end to end on a 2-executor ``LocalEngine`` (SPARK mode, the plane on):
  ``/metrics`` carries the engine's, the feed's and the train step's
  series, ``/healthz`` is ok, ``/statusz`` names both workers,
  ``tfos-top-torch --once`` renders it, and ``shutdown()`` stops every
  obs thread; with the gate off no server runs;
- importing ``obs`` and its CLIs imports no torch (so the driver holds no
  CUDA context for them).

Every cluster test bounds its waits; the e2e test has its own limit.
"""

import io
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.obs import http as jhttp  # noqa: E402
from tensorflowonspark_tpu.obs import slo as jslo  # noqa: E402
from tensorflowonspark_tpu.obs import top as jtop  # noqa: E402
from tensorflowonspark_tpu.utils import metrics_registry as jreg  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.obs import http as phttp  # noqa: E402
from tensorflowonspark_tpu_torch.obs import slo as pslo  # noqa: E402
from tensorflowonspark_tpu_torch.obs import top as ptop  # noqa: E402
from tensorflowonspark_tpu_torch.utils import (  # noqa: E402
    metrics_registry as preg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tensorflowonspark_tpu_torch")
TIMEOUT = 120
_ENV = (preg.PORT_ENV, preg.INTERVAL_ENV, phttp.HOST_ENV, pslo.SPEC_ENV)


@pytest.fixture(autouse=True)
def _obs_env(monkeypatch):
    """Each test starts with the gate off and both registries empty."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    preg.reset()
    jreg.reset()
    yield
    preg.reset()
    jreg.reset()


def _enable(monkeypatch, interval="0.1"):
    monkeypatch.setenv(preg.PORT_ENV, "0")
    monkeypatch.setenv(preg.INTERVAL_ENV, interval)
    preg.reset()
    jreg.reset()


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _drive(mods, seed, n=300):
    """The same seeded updates into each module's registry."""
    rng = random.Random(seed)
    names = sorted(preg.CATALOG)
    for _ in range(n):
        name = rng.choice(names)
        kind = preg.CATALOG[name][0]
        labels = {}
        if rng.random() < 0.5:
            labels["status"] = rng.choice(["ok", "error", "shed"])
        if rng.random() < 0.2:
            labels["kind"] = rng.choice(['a"b', "c\\d", "e\nf"])
        v = rng.choice([0.0, 0.5, 1.0, 3.0, 17.25, 999.0, 1e5, 7.0e-4])
        for m in mods:
            if kind == "counter":
                m.inc(name, v, **labels)
            elif kind == "gauge":
                m.set_gauge(name, v, **labels)
            else:
                m.observe(name, v, **labels)


def _snapshots(monkeypatch, seed):
    _enable(monkeypatch)
    _drive((preg, jreg), seed)
    return preg.snapshot(), jreg.snapshot()


def test_catalog_equals_the_jax_catalog():
    assert preg.CATALOG == jreg.CATALOG
    assert preg.DEFAULT_BUCKETS_MS == jreg.DEFAULT_BUCKETS_MS


def test_disabled_registry_is_a_noop():
    preg.inc("tfos_train_steps_total")
    preg.observe("tfos_train_step_ms", 3.0)
    assert not preg.enabled() and preg.snapshot() is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_render_and_quantile_match_jax(monkeypatch, seed):
    psnap, jsnap = _snapshots(monkeypatch, seed)
    assert psnap == jsnap
    pairs = [({"node": "worker-0"}, psnap), ({"node": "driver"}, psnap)]
    text = preg.render_text(pairs)
    assert text == jreg.render_text(pairs)
    assert "# TYPE tfos_train_step_ms histogram" in text
    hists = [s for ent in psnap.values() for s in ent["series"]
             if "count" in s]
    assert hists
    for s in hists:
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert preg.quantile(s, q) == jreg.quantile(s, q)
    assert preg.quantile({"count": 0}, 0.5) is None


@pytest.mark.parametrize("seed", [3, 4])
def test_node_and_data_summaries_match_jax(monkeypatch, seed):
    psnap, jsnap = _snapshots(monkeypatch, seed)
    assert phttp.node_summary(psnap) == jhttp.node_summary(jsnap)
    assert phttp.node_summary(None) == jhttp.node_summary(None)
    assert phttp.data_summary([psnap, None]) == \
        jhttp.data_summary([jsnap, None])
    assert phttp.data_summary([]) is jhttp.data_summary([]) is None


SPECS = [
    pslo.DEFAULT_SPEC,
    "ttft:latency:tfos_decode_ttft_ms<250@99.9; avail:availability:"
    "tfos_serve_requests_total@95",
    "step:latency:tfos_train_step_ms<100@50",
    "",
    "bad",
    "x:latency:tfos_decode_ttft_ms@99",
    "x:latency:tfos_decode_ttft_ms<abc@99",
    "x:availability:tfos_serve_requests_total@100",
    "x:bogus:m@99",
    ":latency:m<1@99",
    "x:availability:@99",
    "x:availability:m@nine",
    "x:availability:m",
]


@pytest.mark.parametrize("spec", SPECS)
def test_slo_parse_spec_matches_jax(spec):
    try:
        want = [repr(o) for o in jslo.parse_spec(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pslo.parse_spec(spec)
        assert str(got.value) == str(e)
        return
    assert [repr(o) for o in pslo.parse_spec(spec)] == want


def test_slo_engine_burn_and_edges_match_jax(monkeypatch):
    """One snapshot series (latency good, then breaching, then good
    again; availability breaching): the same rows, the same burn, the
    same breach edges and the same tfos_slo_* series."""
    _enable(monkeypatch)
    spec = ("ttft:latency:tfos_decode_ttft_ms<250@90;"
            "avail:availability:tfos_serve_requests_total@99;"
            "steps:latency:tfos_train_step_ms<100@50")
    pe, je = pslo.Engine(spec), jslo.Engine(spec)
    rng = random.Random(7)
    series = []
    for phase in (20.0, 900.0, 900.0, 20.0, 20.0):
        _drive((preg, jreg), rng.randrange(1000), n=50)
        for _ in range(30):
            v = phase * rng.uniform(0.5, 1.5)
            preg.observe("tfos_decode_ttft_ms", v)
            jreg.observe("tfos_decode_ttft_ms", v)
        series.append((preg.snapshot(), jreg.snapshot()))
    for psnap, jsnap in series:
        prep = pe.step([psnap, None])
        jrep = je.step([jsnap, None])
        assert prep["objectives"] == jrep["objectives"]
        assert pslo.evaluate(pe.objectives[0], [psnap]) == \
            jslo.evaluate(je.objectives[0], [jsnap])
    assert any(r["breaching"] for r in prep["objectives"])
    slo_series = {k: v for k, v in preg.snapshot().items()
                  if k.startswith("tfos_slo_")}
    assert slo_series == {k: v for k, v in jreg.snapshot().items()
                          if k.startswith("tfos_slo_")}
    assert "tfos_slo_breaches_total" in slo_series
    h = pslo.merge_histogram([psnap, psnap], "tfos_decode_ttft_ms")
    assert h == jslo.merge_histogram([jsnap, jsnap], "tfos_decode_ttft_ms")
    for thr in (0.0, 1.0, 250.0, 1e9):
        assert pslo.fraction_over(h, thr) == jslo.fraction_over(h, thr)
    assert pslo.counter_outcomes([psnap], "tfos_serve_requests_total") == \
        jslo.counter_outcomes([jsnap], "tfos_serve_requests_total")


def _statusz_doc(monkeypatch):
    """A /statusz document with two workers, a driver, stragglers and an
    SLO report, as the port's ObsServer renders it."""
    _enable(monkeypatch)

    from tensorflowonspark_tpu_torch.actors.ledger import DeliveryLedger

    class Server:
        _feeds = DeliveryLedger()

    for part in range(3):
        Server._feeds.record("input", part)

    class Cluster:
        meta = {"id": 0x1234abcd5678, "epoch": 1, "num_executors": 2}
        restarts, _restarts_used, cluster_info, server = 2, 1, [], Server()

    obs = phttp.ObsServer(Cluster(), port=0)
    rng = random.Random(11)
    for i, slow in enumerate((1.0, 3.0)):
        preg.reset()
        for _ in range(40):
            preg.observe("tfos_train_step_ms", slow * rng.uniform(8, 12))
            preg.inc("tfos_train_steps_total")
        preg.set_gauge("tfos_train_items_per_sec", 12345.678)
        preg.set_gauge("tfos_train_mfu", 0.4321)
        preg.set_gauge("tfos_train_infeed_stall_frac", 0.0123)
        preg.set_gauge("tfos_feed_ring_bytes", 65536)
        preg.set_gauge("tfos_health_status", float(i))
        preg.inc("tfos_health_anomalies_total", i, kind="nan")
        preg.set_gauge("tfos_health_grad_norm", 3.25)
        obs._nodes[f"worker-{i}"] = {
            "node_id": f"worker-{i}", "role": "worker", "executor_id": i,
            "host": "h", "heartbeat_age_s": 0.5 + i, "last_seen":
            time.time() - 1.0, "metrics": preg.snapshot()}
    preg.reset()
    preg.inc("tfos_engine_respawns_total", 2)
    for v in (100.0, 300.0, 900.0):
        preg.observe("tfos_decode_ttft_ms", v)
    obs.slo.step(obs._all_snapshots())
    try:
        doc = json.loads(json.dumps(obs.render_statusz()))
    finally:
        obs.stop()
    return doc


def test_top_render_matches_jax(monkeypatch):
    doc = _statusz_doc(monkeypatch)
    assert set(doc["nodes"]) == {"worker-0", "worker-1", "driver"}
    assert doc["stragglers"]["slowest"] == "worker-1"
    text = ptop.render(doc)
    assert text == jtop.render(doc)
    assert ptop.render_slo(doc) == jtop.render_slo(doc)
    assert ptop.render_health(doc) == jtop.render_health(doc)
    assert "worker-1" in text and "feed ledger: input:3" in text
    for empty in ({}, {"nodes": {}}):
        assert ptop.render(empty) == jtop.render(empty)
        assert ptop.render_slo(empty) == jtop.render_slo(empty)
        assert ptop.render_health(empty) == jtop.render_health(empty)


_METRIC_CALL = re.compile(
    r"metrics_registry\.(?:inc|set_gauge|observe)\(\s*[\"'](tfos_\w+)")


def _port_metric_names():
    names = {}
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for name in _METRIC_CALL.findall(fh.read()):
                        names.setdefault(name, path)
    return names


def test_every_metric_name_in_the_port_is_in_its_catalog():
    names = _port_metric_names()
    assert len(names) >= 30, sorted(names)
    missing = {n: p for n, p in names.items() if n not in preg.CATALOG}
    assert not missing, missing


def test_obs_import_initialises_no_cuda():
    """The driver imports obs, the registry and telemetry without torch:
    no CUDA context can come from them."""
    code = ("import sys\n"
            "import tensorflowonspark_tpu_torch.obs\n"
            "from tensorflowonspark_tpu_torch.obs import (flight, health,"
            " http, postmortem, publish, slo, top)\n"
            "from tensorflowonspark_tpu_torch.utils import telemetry\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'tensorflowonspark_tpu.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


# -- end to end ---------------------------------------------------------------

def obs_trainer_fn(args, ctx):
    """Steps on every batch until the feed ends (module level: the
    executors import it)."""
    from tensorflowonspark_tpu_torch.utils.metrics import TrainMetrics

    tm = TrainMetrics()
    feed = ctx.get_data_feed(train_mode=True, metrics=tm)
    tm.step()
    while not feed.should_stop():
        batch = feed.next_batch(8)
        if batch:
            tm.step(items=len(batch), loss=1.0)
        time.sleep(0.05)


def _within(limit, fn):
    """``fn()`` on a thread that must end within ``limit`` seconds."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"no end within {limit} s"
    if err:
        raise err[0]
    return out[0] if out else None


def _endpoints_e2e():
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    cluster = None
    try:
        cluster = TFCluster.run(engine, obs_trainer_fn, [], num_executors=2,
                                input_mode=TFCluster.InputMode.SPARK,
                                reservation_timeout=TIMEOUT)
        assert cluster.obs is not None and cluster.obs.port > 0
        base = cluster.obs.url
        cluster.train(engine.parallelize(range(256), 4),
                      feed_timeout=TIMEOUT)
        want = ("tfos_engine_jobs_total", "tfos_engine_tasks_total",
                "tfos_feed_chunks_total", "tfos_feed_records_total",
                "tfos_train_steps_total", "tfos_train_step_ms_bucket")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            _, text = _get(base + "/metrics")
            if all(w in text for w in want):
                break
            time.sleep(0.1)
        assert all(w in text for w in want), text[-2000:]
        assert 'node="driver"' in text
        assert re.search(r'tfos_train_steps_total\{node="worker-\d"\}', text)
        code, body = _get(base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok", health
        _, body = _get(base + "/statusz")
        status = json.loads(body)
        assert status["cluster"]["num_executors"] == 2
        assert status["feeds"] == {"input": 4}
        workers = {n: e for n, e in status["nodes"].items()
                   if n.startswith("worker-")}
        assert set(workers) == {"worker-0", "worker-1"}
        assert all(e["alive"] and e["role"] == "worker"
                   for e in workers.values())
        assert sum(e["summary"].get("steps", 0)
                   for e in workers.values()) > 0
        code, body = _get(base + "/slo")
        assert code == 200 and "objectives" in json.loads(body)
        assert _get(base + "/nowhere")[0] == 404
        out = io.StringIO()
        assert ptop.main(["--url", base, "--once", "--health"],
                         out=out) == 0
        assert "worker-0" in out.getvalue() and "health" in out.getvalue()
        cluster.shutdown()
        assert cluster.obs is None
        names = {t.name for t in threading.enumerate()}
        assert not any(n.startswith("tfos-obs") for n in names), names
    finally:
        if cluster is not None and cluster.obs is not None:
            cluster.obs.stop()
        engine.stop()


def test_cluster_endpoints_e2e(monkeypatch):
    _enable(monkeypatch)
    _within(180, _endpoints_e2e)


def noop_fn(args, ctx):
    pass


def test_cluster_without_the_gate_runs_no_obs():
    def run():
        engine = LocalEngine(1, env={"OMP_NUM_THREADS": "1"})
        try:
            cluster = TFCluster.run(engine, noop_fn, [], num_executors=1,
                                    input_mode=TFCluster.InputMode.TENSORFLOW,
                                    reservation_timeout=TIMEOUT)
            assert cluster.obs is None
            assert not any(t.name.startswith("tfos-obs")
                           for t in threading.enumerate())
            cluster.shutdown()
        finally:
            engine.stop()

    _within(120, run)
