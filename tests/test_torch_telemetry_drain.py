"""PyTorch port, the telemetry drain and the flight recorder, on the CPU,
held against the JAX package:

- ``telemetry``: ``configure`` / ``sink_path`` / ``run_dir`` /
  ``trace_root`` / ``recent`` behave as the JAX module's, and
  ``read_spool`` of one directory (a whole file, a torn trailing record,
  a file of garbage, a file that is not ``*.jsonl``) returns what the JAX
  ``read_spool`` returns;
- ``obs.flight``: a dump is bounded (``TFOS_FLIGHT_CAP``), redacted,
  rotated (``TFOS_FLIGHT_KEEP``) and read by the JAX package's
  ``obs.postmortem``;
- end to end on a 2-executor ``LocalEngine`` (SPARK mode): the clean
  shutdown drains the driver's, each executor's and each trainer's
  spool and the trainers' flight dumps into one ``run-<id>`` directory,
  which the JAX package's ``telemetry.read_spool`` and
  ``obs.postmortem`` (``load_dumps``, ``render_report``) and the port's
  ``tfos-postmortem-torch`` read; a trainer that fails still gets its
  timeline drained; with telemetry off a cluster writes nothing.

Each cluster test runs on a thread with its own time limit.
"""

import glob
import io
import json
import os
import threading

import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu.obs import postmortem as jpost  # noqa: E402
from tensorflowonspark_tpu.utils import telemetry as jtel  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import (  # noqa: E402
    LocalEngine,
    TaskError,
)
from tensorflowonspark_tpu_torch.obs import flight  # noqa: E402
from tensorflowonspark_tpu_torch.obs import postmortem as ppost  # noqa: E402
from tensorflowonspark_tpu_torch.utils import telemetry as ptel  # noqa: E402

_ENV = (ptel.DIR_ENV, ptel.SPOOL_ENV, ptel.NODE_ENV, ptel.ROLE_ENV,
        ptel.TRACE_ENV, flight.CAP_ENV, flight.KEEP_ENV, "TFOS_OBS_PORT")


@pytest.fixture(autouse=True)
def _telemetry_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    yield


def _records(root):
    out = []
    for path in glob.glob(os.path.join(str(root), "**", "*.jsonl"),
                          recursive=True):
        with open(path) as f:
            out += [json.loads(line) for line in f if line.strip()]
    return out


def _within(limit, fn):
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
    return out[0]


def test_identity_sink_run_dir_and_ring_as_jax(tmp_path, monkeypatch):
    assert ptel.sink_path() is None and ptel.recent() == []
    assert ptel.trace_root(ptel.CLUSTER_RUN) is None
    assert ptel.run_dir(0xabc) is jtel.run_dir(0xabc) is None
    monkeypatch.setenv(ptel.DIR_ENV, str(tmp_path))
    assert ptel.run_dir(0x1234abcd5678) == jtel.run_dir(0x1234abcd5678)
    rec = ptel.configure(node_id="worker 0/x", role="worker",
                         spool=str(tmp_path / "spool"))
    assert os.environ[ptel.NODE_ENV] == "worker 0/x"
    assert rec.path == os.path.join(str(tmp_path / "spool"),
                                    f"worker_0_x-{os.getpid()}.jsonl")
    assert ptel.sink_path() == rec.path
    ctx = ptel.trace_root(ptel.CLUSTER_RUN, executors=2)
    assert os.environ[ptel.TRACE_ENV] == ctx.to_header()
    with ptel.span("a/b") as sp:
        sp.add(k=1)
    ptel.event("c/d")
    names = [r["name"] for r in ptel.recent()]
    assert names == [ptel.CLUSTER_RUN, "a/b", "c/d"]
    assert ptel.recent(window_s=-60) == []
    ptel.flush()
    recs = [json.loads(line) for line in open(rec.path)]
    assert [r["name"] for r in recs] == names
    assert recs[1]["attrs"]["k"] == 1
    assert recs[1]["attrs"]["trace_id"] == ctx.trace_id
    assert tuple(recs[0]) == ptel.SCHEMA_KEYS == jtel.SCHEMA_KEYS


def test_read_spool_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(ptel.DIR_ENV, str(tmp_path))
    ptel.configure(node_id="t-0", role="test")
    for n in range(3):
        ptel.event("good", n=n, s="é" * 3)
    ptel.flush()
    path = ptel.sink_path()
    with open(path, "r+", encoding="utf-8") as f:
        head, last = f.read().rstrip("\n").rsplit("\n", 1)
        f.seek(0)
        f.truncate()
        f.write(head + "\n" + last[: len(last) // 2])
    (tmp_path / "junk-1.jsonl").write_text("\x00\x01 not json")
    (tmp_path / "other.txt").write_text('{"x": 1}\n')
    got = ptel.read_spool(str(tmp_path))
    assert got == jtel.read_spool(str(tmp_path))
    (name, text), = got
    assert name == os.path.basename(path) and text.endswith("\n")
    assert [json.loads(x)["attrs"]["n"] for x in text.splitlines()] == [0, 1]
    assert ptel.read_spool(str(tmp_path / "nope")) == []


def test_flight_dump_bounded_redacted_rotated(tmp_path, monkeypatch):
    assert flight.snapshot("t/none") is None  # telemetry off
    monkeypatch.setenv(ptel.DIR_ENV, str(tmp_path))
    monkeypatch.setenv(flight.CAP_ENV, "4096")
    monkeypatch.setenv(flight.KEEP_ENV, "2")
    ptel.configure(node_id="worker-3", role="worker")
    for i in range(200):
        ptel.event("step/x", i=i, blob=b"raw", prompt="p" * 500)
    paths = [flight.snapshot("engine/executor_respawn", node="executor-3",
                             reason="r", inflight=[{"id": i, "t": object()}
                                                   for i in range(100)])
             for _ in range(3)]
    assert all(paths)
    left = sorted(glob.glob(str(tmp_path / "flight-*.json")))
    assert left == sorted(paths[1:])
    with open(paths[-1]) as f:
        raw = f.read()
    dump = json.loads(raw)
    assert len(raw) <= 4096 + 1 and dump["truncated"] > 0
    assert len(dump["inflight"]) == 64
    assert dump["inflight"][0]["t"] == "<redacted object>"
    attrs = dump["records"][-1]["attrs"]
    assert attrs["blob"] == "<redacted bytes>"
    assert len(attrs["prompt"]) == 201
    # the JAX package's postmortem reads the port's dump and spool
    dumps, corrupt = jpost.load_dumps(str(tmp_path))
    assert corrupt == 0 and dumps[-1]["trigger"] == "engine/executor_respawn"
    ptel.flush()
    out = io.StringIO()
    jpost.render_report(dumps[-1], jpost.load_spool_records(str(tmp_path)),
                        30.0, out)
    assert "victim=executor-3" in out.getvalue()
    assert "worker-3" in out.getvalue()


# -- end to end ---------------------------------------------------------------

def drain_trainer_fn(args, ctx):
    """Consumes the feed inside a user span and writes one flight dump
    (module level: the executors import it)."""
    from tensorflowonspark_tpu_torch.obs import flight as fl
    from tensorflowonspark_tpu_torch.utils import telemetry as t

    feed = ctx.get_data_feed(train_mode=True)
    with t.span("user/work", task=ctx.task_index):
        while not feed.should_stop():
            feed.next_batch(16)
    fl.snapshot("user/flight", reason="test dump")
    if args.get("fail"):
        raise RuntimeError("deliberate failure after feeding")


def _run(tmp_path, fail=False):
    engine = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    raised = None
    try:
        cluster = TFCluster.run(engine, drain_trainer_fn, {"fail": fail},
                                num_executors=2,
                                input_mode=TFCluster.InputMode.SPARK,
                                reservation_timeout=60)
        cluster.train(engine.parallelize(range(64), 2), feed_timeout=60)
        try:
            cluster.shutdown(grace_secs=1)
        except (TaskError, RuntimeError, SystemExit) as e:
            raised = e
        cid = cluster.meta["id"]
    finally:
        engine.stop()
    return ptel.run_dir(cid), raised


def test_drain_on_clean_shutdown(tmp_path, monkeypatch):
    monkeypatch.setenv(ptel.DIR_ENV, str(tmp_path))
    rdir, raised = _within(150, lambda: _run(tmp_path))
    assert raised is None
    assert os.path.isdir(rdir)
    recs = _records(rdir)
    names = {r["name"] for r in recs}
    assert {"node/boot", "node/main", "user/work", "rendezvous/register",
            "feed/partition_queued", "engine/task", "cluster/start",
            "cluster/run", "engine/job"} <= names, names
    # the driver's file, and each node's executor and trainer files
    files = os.listdir(rdir)
    assert any(f.startswith("driver-") for f in files), files
    for node in ("worker-0", "worker-1"):
        mine = [f for f in files if f.startswith(f"exec{node[-1]}-{node}-")
                and f.endswith(".jsonl")]
        assert len(mine) == 2, (node, files)
    assert {r["node_id"] for r in recs if r["name"] == "user/work"} == \
        {"worker-0", "worker-1"}
    # each partition's feeder: its parts under its feed/partition span
    parts = {r["attrs"]["span_id"]: r for r in recs
             if r["name"] == "feed/partition"}
    assert len(parts) == 2, parts
    for sid, part in parts.items():
        kids = [r for r in recs if r["attrs"].get("parent_id") == sid]
        assert {r["name"] for r in kids} == {
            "feed/read", "feed/encode", "feed/put", "feed/drain"}, kids
        end = part["ts"] + part["dur_ms"] / 1e3
        for r in kids:
            assert part["ts"] - 1e-3 <= r["ts"]
            assert r["ts"] + r["dur_ms"] / 1e3 <= end + 1e-3
    # one trace: the driver's root, the nodes' records under it
    root = [r for r in recs if r["name"] == ptel.CLUSTER_RUN]
    assert len(root) == 1
    boots = [r for r in recs if r["name"] == "node/boot"]
    assert {r["attrs"].get("trace_id") for r in boots} == \
        {root[0]["attrs"]["trace_id"]}
    # the JAX package reads the drained run directory
    for name, text in jtel.read_spool(rdir):
        assert text == open(os.path.join(rdir, name)).read()
    dumps, corrupt = jpost.load_dumps(rdir)
    assert corrupt == 0 and len(dumps) == 2
    assert {d["trigger"] for d in dumps} == {"user/flight"}
    out = io.StringIO()
    jpost.render_report(dumps[-1], jpost.load_spool_records(rdir), 60.0,
                        out)
    assert "POSTMORTEM  trigger=user/flight" in out.getvalue()
    mine = io.StringIO()
    assert ppost.main(["--dir", rdir, "--window", "60"], out=mine) == 0
    assert mine.getvalue() == out.getvalue()
    assert not glob.glob(f"/dev/shm/tfos-{os.path.basename(rdir)[4:]}*")


def test_drain_on_error_shutdown(tmp_path, monkeypatch):
    monkeypatch.setenv(ptel.DIR_ENV, str(tmp_path))
    rdir, raised = _within(150, lambda: _run(tmp_path, fail=True))
    assert raised is not None
    names = {r["name"] for r in _records(rdir)}
    assert {"node/boot", "user/work", "feed/partition_queued"} <= names
    driver = {r["name"] for r in _records(tmp_path)
              if r["role"] == "driver"}
    assert {"cluster/shutdown", "cluster/telemetry_drain"} <= driver


def test_telemetry_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = set(os.listdir(tmp_path))
    _within(150, lambda: _run(tmp_path))
    assert set(os.listdir(tmp_path)) == before
