"""PyTorch port, the cluster plumbing of the SPARK-fed path, on the CPU:
the GPU claim, the process group, ``synchronized``, record exactness,
failure propagation, and the units under them (engine, rendezvous
ledger, manager, ``DataFeed``).

The multi-process tests run real executor processes (``LocalEngine``,
spawn) and gloo process groups.  pytest-timeout is not installed, so
each bounds itself: ``reservation_timeout`` bounds the registration wait
and the process group's collectives, ``feed_timeout`` the feeders'
wait, and a trainer that fails reaches the driver as an error.  The
``main_fun``s are module-level functions of this file, which the
executors import (so this file imports no JAX at the top).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import (  # noqa: E402
    gpu_info,
    infeed,
    manager,
    marker,
    node,
    rendezvous,
)
from tensorflowonspark_tpu_torch.engine import (  # noqa: E402
    LocalEngine,
    TaskError,
)
from tensorflowonspark_tpu_torch.feed import DataFeed  # noqa: E402

TIMEOUT = 60  # seconds: registration, collectives, feed consumption


@pytest.fixture(scope="module")
def engine():
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "2",
                            gpu_info.COUNT_ENV: "2",
                            "CUDA_VISIBLE_DEVICES": None,
                            gpu_info.INHERITED_ENV: None})
    yield e
    e.stop()


def _run(engine, main_fun, args, n=2, mode=TFCluster.InputMode.SPARK,
         **kw):
    return TFCluster.run(engine, main_fun, args, num_executors=n,
                         input_mode=mode, reservation_timeout=TIMEOUT,
                         **kw)


def _write(args, ctx, payload):
    path = os.path.join(args["out_dir"], f"{ctx.executor_id}.json")
    with open(path, "w") as f:
        json.dump(payload, f)


def _read(out_dir, n):
    return [json.load(open(os.path.join(out_dir, f"{i}.json")))
            for i in range(n)]


# -- gpu_info ----------------------------------------------------------------

def test_gpu_claim_by_same_host_index_without_cuda(monkeypatch):
    """A faked count of 4 GPUs and no inherited mask: worker i takes the
    block [i*n, (i+1)*n) as CUDA_VISIBLE_DEVICES, and a later claim
    takes from the host again, not from the previous claim; a demand
    past the host's supply raises, and a claim inside a K8s pod, where
    no host scan runs and the scheduler offered nothing, raises
    RuntimeError; num_gpus=0 leaves the environment.  No call reaches
    torch.cuda (each would raise here)."""
    _forbid_cuda(monkeypatch)
    monkeypatch.setenv(gpu_info.COUNT_ENV, "4")
    monkeypatch.delenv(gpu_info.INHERITED_ENV, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "untouched")
    assert gpu_info.claim_gpus(0, 1) == []
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "untouched"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu_info.claim_gpus(1, 3) == [3]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
    assert gpu_info.claim_gpus(2, 1) == [2, 3]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert gpu_info.claim_gpus(2) == [0, 1]
    with pytest.raises(RuntimeError, match="of the 4 visible"):
        gpu_info.claim_gpus(2, 2)
    monkeypatch.setenv("SPARK_EXECUTOR_POD_IP", "10.0.0.1")
    with pytest.raises(RuntimeError, match="unable to allocate 1 GPU"):
        gpu_info.claim_gpus(1, 0)
    monkeypatch.delenv(gpu_info.COUNT_ENV)
    monkeypatch.setenv("PATH", "")  # no nvidia-smi: no GPUs
    assert gpu_info.count_gpus() == 0


def test_gpu_claim_takes_its_block_from_an_inherited_mask(monkeypatch):
    """An executor confined to GPUs 3,5,6,7 of 8: worker i takes the
    i-th block of that list, not of the host's physical indices, also
    on a later claim by the same executor; UUID entries are taken as
    they are; an empty mask offers none."""
    _forbid_cuda(monkeypatch)
    monkeypatch.setenv(gpu_info.COUNT_ENV, "8")
    monkeypatch.delenv(gpu_info.INHERITED_ENV, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6,7")
    assert gpu_info.claim_gpus(1, 0) == [3]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"
    assert gpu_info.claim_gpus(2, 1) == [6, 7]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "6,7"
    with pytest.raises(RuntimeError, match="of the 4 visible"):
        gpu_info.claim_gpus(1, 4)
    monkeypatch.delenv(gpu_info.INHERITED_ENV)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-aaaa, GPU-bbbb")
    assert gpu_info.claim_gpus(1, 1) == ["GPU-bbbb"]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "GPU-bbbb"
    monkeypatch.delenv(gpu_info.INHERITED_ENV)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="of the 0 visible"):
        gpu_info.claim_gpus(1, 0)


def _forbid_cuda(monkeypatch):
    for name in ("is_available", "device_count", "init", "current_device"):
        monkeypatch.setattr(torch.cuda, name, _no_cuda)


def _no_cuda(*args, **kwargs):
    raise AssertionError("gpu_info must not call torch.cuda")


# -- the process group ---------------------------------------------------------

def group_main(args, ctx):
    """Foreground node: join a gloo group, all-reduce the ranks."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.utils import train

    env = ctx.torch_initialize("cpu")
    t = torch.tensor([float(env["process_id"])])
    dist.all_reduce(t)
    # the data-parallel gradient all-reduce: the mean over the ranks
    g = torch.full((3,), float(env["process_id"] + 1))
    train.all_reduce_mean_([g, None])
    _write(args, ctx, {
        "grad_mean": g.tolist(),
        "env": {k: env[k] for k in ("coordinator_address", "num_processes",
                                    "process_id", "local_rank")},
        "sum": t.item(), "world": dist.get_world_size(),
        "rank": dist.get_rank(), "healthy": env["slice_health"]["healthy"],
        "global_devices": env["slice_health"]["global_devices"],
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_initialized": torch.cuda.is_initialized()})


def test_torch_initialize_joins_a_gloo_group(engine, tmp_path):
    """Two executors, one process group: torch_initialize joins it with
    the rendezvous' coordinator and ranks (chief first), the all-reduce
    of the ranks gives 0 + 1 on both, ``all_reduce_mean_`` gives the
    ranks' mean gradient, and each executor claimed its own GPU by
    worker index without touching CUDA (faked count of 2)."""
    c = _run(engine, group_main, {"out_dir": str(tmp_path)},
             mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
             num_gpus=1)
    c.shutdown()
    got = _read(tmp_path, 2)
    assert [g["rank"] for g in got] == [0, 1]
    for i, g in enumerate(got):
        assert g["sum"] == 1.0 and g["world"] == 2 and g["healthy"]
        assert g["global_devices"] == 2  # the ranks' counts, via the store
        assert g["grad_mean"] == [1.5, 1.5, 1.5]
        assert g["env"]["process_id"] == i and g["env"]["local_rank"] == i
        assert g["env"]["coordinator_address"] == \
            got[0]["env"]["coordinator_address"]
        assert g["visible"] == str(i) and not g["cuda_initialized"]


def ragged_main(args, ctx):
    """SPARK node: count the steps ``synchronized`` lets through."""
    import torch.distributed as dist

    ctx.torch_initialize("cpu")
    feed = ctx.get_data_feed()
    steps = 0
    for batch in infeed.synchronized(infeed.device_feed(
            feed, 4, collate=np.asarray, placement="cpu"), feed=feed):
        t = torch.ones(1)
        dist.all_reduce(t)  # a step's collective: both ranks must join
        steps += 1
    _write(args, ctx, {"steps": steps})


def test_synchronized_stops_both_ranks_on_the_same_step(engine, tmp_path):
    """Executor 0 gets 3 batches, executor 1 five: both stop after 3
    steps, the longer one drains its feed, and nothing hangs."""
    c = _run(engine, ragged_main, {"out_dir": str(tmp_path)})
    ds = engine.parallelize(range(12), 1).union(
        engine.parallelize(range(100, 120), 1))
    c.train(ds, feed_timeout=TIMEOUT)
    c.shutdown()
    assert [g["steps"] for g in _read(tmp_path, 2)] == [3, 3]


def ids_main(args, ctx):
    """SPARK node: record every id that reaches this trainer."""
    feed = ctx.get_data_feed()
    seen = []
    while not feed.should_stop():
        seen.extend(int(r[0]) for r in feed.next_batch(7))
    _write(args, ctx, {"ids": seen})


def test_every_record_is_consumed_exactly_once(engine, tmp_path):
    """Seeded, shuffled ids in 7 partitions over two trainers: each id
    arrives exactly once, and the rendezvous ledger records every
    partition as consumed."""
    ids = np.random.default_rng(7).permutation(500)
    c = _run(engine, ids_main, {"out_dir": str(tmp_path)})
    c.train(engine.parallelize([(int(i), "x" * 10) for i in ids], 7),
            feed_timeout=TIMEOUT)
    assert c.server.fed_partitions("input") == list(range(7))
    c.shutdown()
    seen = [i for g in _read(tmp_path, 2) for i in g["ids"]]
    assert len(seen) == len(ids) and sorted(seen) == list(range(500))


def failing_main(args, ctx):
    raise ValueError("boom in main_fun")


def test_failing_main_fun_reaches_the_driver(engine):
    """A trainer that raises: the feeder sees its error and the train()
    job fails with it, then shutdown() raises it too, instead of either
    hanging."""
    c = _run(engine, failing_main, {}, n=1)
    with pytest.raises(TaskError, match="boom in main_fun"):
        c.train(engine.parallelize(list(range(10)), 1),
                feed_timeout=TIMEOUT)
    with pytest.raises(TaskError, match="boom in main_fun"):
        c.shutdown()


def test_cut_features_raise_not_implemented(engine, monkeypatch):
    # ps/evaluator nodes and TensorBoard are ported
    # (tests/test_torch_roles.py)
    # recovery is ported (tests/test_torch_recovery.py), the data
    # service too (tests/test_torch_data.py)
    # retryable jobs are ported: they run (tests/test_torch_engine.py)
    assert engine.parallelize([1, 2]).foreach_partition(
        print, retryable=True, max_retries=2) is None
    # run(background=) and LocalEngine(workdir=) are ported
    # (test_background_chooses_the_trainer_process_as_jax_does below,
    # tests/test_torch_engine.py)
    # a skipped partition is drained without reaching a node
    monkeypatch.setenv("TFOS_PARTITION_INDEX", "0")
    assert node.train([], {}, skip={0})(iter(range(3))) is None
    with pytest.raises(ValueError, match="spawn"):
        LocalEngine(1, start_method="fork")


def where_main(args, ctx):
    """Record the process ``main_fun`` runs in, and its parent."""
    path = os.path.join(args["out_dir"], f"where-{ctx.executor_id}.json")
    with open(path, "w") as f:
        json.dump({"pid": os.getpid(), "ppid": os.getppid()}, f)


class ExecutorPid:
    """A ``map_partitions`` function: the executor's pid."""

    def __call__(self, it):
        list(it)
        return [os.getpid()]


def _where(cluster_mod, eng, mode, background, out_dir):
    """``where_main`` on a 2-node cluster of ``cluster_mod`` (either
    package's) under ``mode`` and ``background``: for each executor,
    whether main_fun ran in the executor itself or in a child it
    forked."""
    os.makedirs(out_dir)
    c = cluster_mod.run(eng, where_main, {"out_dir": str(out_dir)}, 2,
                        input_mode=mode, background=background,
                        reservation_timeout=TIMEOUT)
    c.shutdown()
    execs = eng.parallelize([0, 1], 2).map_partitions(ExecutorPid()) \
        .collect(spread=True)
    out = []
    for i, pid in enumerate(execs):
        w = json.load(open(os.path.join(out_dir, f"where-{i}.json")))
        out.append("executor" if w["pid"] == pid else
                   "forked" if w["ppid"] == pid else "elsewhere")
    return out


@pytest.mark.parametrize("mode,background,want", [
    ("TENSORFLOW", True, "forked"), ("SPARK", False, "executor")])
def test_background_chooses_the_trainer_process_as_jax_does(
        engine, tmp_path, mode, background, want):
    """``run(background=)`` against each package's default for the
    mode: a TENSORFLOW-mode main_fun forked from its executor, a
    SPARK-mode one run in the executor, as the JAX package runs them."""
    from tensorflowonspark_tpu import cluster as JC
    from tensorflowonspark_tpu.engine import LocalEngine as JaxEngine

    got = _where(TFCluster, engine, getattr(TFCluster.InputMode, mode),
                 background, tmp_path / "torch")
    jeng = JaxEngine(2)
    try:
        ref = _where(JC, jeng, getattr(JC.InputMode, mode), background,
                     tmp_path / "jax")
    finally:
        jeng.stop()
    assert got == ref == [want, want]


# -- units ---------------------------------------------------------------------

class _Record:
    """A ``foreach_partition`` task: write the partition's items and the
    executor that ran it to ``<out_dir>/<partition>.json``."""

    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, it):
        part = os.environ["TFOS_PARTITION_INDEX"]
        with open(os.path.join(self.out_dir, f"{part}.json"), "w") as f:
            json.dump({"items": list(it),
                       "executor": int(os.environ["TFOS_EXECUTOR_INDEX"])},
                      f)


def test_engine_partitions_union_and_placement(engine, tmp_path):
    """parallelize cuts contiguous partitions in order, union appends
    partitions, and foreach_partition runs task i on executor
    ``placement[i]`` (or on executor i mod n with ``spread``)."""
    ds = engine.parallelize(range(10), 3)
    assert ds.num_partitions == 3
    both = ds.union(engine.parallelize(range(100, 104), 1))
    assert both.num_partitions == 4
    both.foreach_partition(_Record(str(tmp_path)), placement=[1, 1, 0, 1])
    got = _read(tmp_path, 4)
    assert [g["items"] for g in got] == [[0, 1, 2, 3], [4, 5, 6],
                                         [7, 8, 9], [100, 101, 102, 103]]
    assert [g["executor"] for g in got] == [1, 1, 0, 1]
    both.foreach_partition(_Record(str(tmp_path)), spread=True)
    assert [g["executor"] for g in _read(tmp_path, 4)] == [0, 1, 0, 1]


def test_rendezvous_registers_and_keeps_the_feed_ledger():
    server = rendezvous.Server(2)
    addr = server.start()
    try:
        # one client per thread: a client's socket carries one exchange
        # at a time
        a, b, w = (rendezvous.Client(addr) for _ in range(3))
        a.register({"executor_id": 0})
        assert server.reservations.remaining() == 1
        done = []
        t = threading.Thread(target=lambda: done.append(
            w.await_reservations(timeout=10)))
        t.start()
        b.register({"executor_id": 1})
        t.join(timeout=10)
        assert not t.is_alive()
        assert sorted(m["executor_id"] for m in done[0]) == [0, 1]
        for part in (3, 1, 3):
            a.partition_done("input", part)
        assert b.fed_partitions("input") == [1, 3]
        server.reset_feed("input")
        assert server.fed_partitions("input") == []
        a.request_stop()
        assert server.done.is_set()
        b.close()
        w.close()
    finally:
        server.stop()


def test_datafeed_batches_markers_columns_and_terminate():
    """Chunks carry over between batches, EndPartition is skipped in
    training mode, None ends the feed; next_batch_columns densifies;
    terminate() drains and marks the node terminating."""
    mgr = manager.start(b"k" * 16, ["input", "output", "error"])
    try:
        q = mgr.get_queue("input")
        q.put([(i, float(i)) for i in range(5)])
        q.put(marker.EndPartition())
        q.put([(i, float(i)) for i in range(5, 8)])
        feed = DataFeed(mgr, input_mapping={"a": "x", "b": "y"})
        cols = feed.next_batch_columns(4)
        np.testing.assert_array_equal(cols["x"], [0, 1, 2, 3])
        assert cols["y"].dtype == np.float64
        q.put(None)
        assert feed.next_batch(10) == {"x": [4, 5, 6, 7],
                                       "y": [4.0, 5.0, 6.0, 7.0]}
        assert feed.should_stop() and feed.records == 8
        q.put([(9, 9.0)] * 3)
        plain = DataFeed(mgr)
        assert plain.next_batch(2) == [(9, 9.0), (9, 9.0)]
        assert plain.records == 2
        q.put([(1, 1.0)])
        plain.terminate()
        assert q.qsize() == 0 and mgr.get("state") == "terminating"
    finally:
        mgr.shutdown()


MANAGER_PROBE = '''
import multiprocessing as mp
import sys

if __name__ == "__mp_main__":  # imported again by a spawned process
    with open(sys.argv[1], "a") as f:
        f.write("imported\\n")


def child():
    from tensorflowonspark_tpu_torch import manager
    mgr = manager.start(b"k" * 16, ["input"])
    mgr.set("state", "ok")
    assert mgr.get("state") == "ok"
    mgr.shutdown()


if __name__ == "__main__":
    p = mp.get_context("spawn").Process(target=child)
    p.start()
    p.join(120)
    sys.exit(p.exitcode)
'''


def test_a_spawned_executors_manager_does_not_import_the_main_module(
        tmp_path):
    """An engine's executor is spawned, so its default start method is
    spawn; the node's manager server is forked all the same: the main
    module is imported once, by the executor, and not again by the
    server (a driver that imports torch would pay for it at every
    node's boot)."""
    script, marks = tmp_path / "driver.py", tmp_path / "imports"
    script.write_text(MANAGER_PROBE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, str(script), str(marks)],
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert marks.read_text().splitlines() == ["imported"]
