"""PyTorch port, dynamic split dispatch (``data/splits.py``,
``DynamicDataService``), the shared epoch cache and the stall
autoscaler, on the CPU, held against the JAX package.

Exact where the JAX package is deterministic: the split ids and
protocol marks, the per-trainer chunk streams of one worker (its
least-backlogged pick over queues that nothing drains is a pure
function of the pushes), the autoscaler's decisions on one stall
sequence, the cache's blocks.  Where claim order is a race (two
concurrent workers), the multiset of delivered records is held equal
to the JAX package's: an exact cover, each record once an epoch.
End to end: ``cluster.run(data_workers=2)`` with default (dynamic)
dispatch feeds a trainer that logs every record it got, with the
serving worker SIGKILLed mid-split: the provider requeues the split,
the trainer's ``DataFeed`` drops the re-served prefix, and every record
arrives exactly once.
"""

import collections
import json
import os
import secrets
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu import data as jdata  # noqa: E402
from tensorflowonspark_tpu import feed as jfeed  # noqa: E402
from tensorflowonspark_tpu import manager as jmanager  # noqa: E402
from tensorflowonspark_tpu import rendezvous as jrendezvous  # noqa: E402
from tensorflowonspark_tpu.data import autoscale as jautoscale  # noqa: E402
from tensorflowonspark_tpu.data import cache as jcache  # noqa: E402
from tensorflowonspark_tpu.data import service as jservice  # noqa: E402
from tensorflowonspark_tpu.data import splits as jsplits  # noqa: E402
from tensorflowonspark_tpu_torch import cluster as TFCluster  # noqa: E402
from tensorflowonspark_tpu_torch import (  # noqa: E402
    data,
    feed,
    gpu_info,
    manager,
    marker,
    rendezvous,
)
from tensorflowonspark_tpu_torch.actors import liveness  # noqa: E402
from tensorflowonspark_tpu_torch.data import autoscale  # noqa: E402
from tensorflowonspark_tpu_torch.data import cache  # noqa: E402
from tensorflowonspark_tpu_torch.data import service  # noqa: E402
from tensorflowonspark_tpu_torch.data import splits  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.utils import faults  # noqa: E402

TIMEOUT = 90
N_RECORDS = 120
BLOCK = 6          # 20 blocks
SPLIT_BLOCKS = 4   # 5 splits an epoch

PKGS = {
    "jax": dict(data=jdata, service=jservice, splits=jsplits,
                manager=jmanager, rendezvous=jrendezvous,
                DataFeed=jfeed.DataFeed, cache=jcache),
    "port": dict(data=data, service=service, splits=splits,
                 manager=manager, rendezvous=rendezvous,
                 DataFeed=feed.DataFeed, cache=cache),
}


def _arrays(n, width=4):
    x = (np.arange(n * width, dtype=np.float32).reshape(n, width)) / 7.0
    return {"x": x, "y": np.arange(n, dtype=np.int64)}


def _trainer_meta(m, executor_id, authkey):
    return {"executor_id": executor_id, "host": "localhost",
            "job_name": "worker", "addr": list(m.address),
            "authkey": authkey.hex()}


def _drain_chunks(q):
    out = []
    while not q.empty():
        c = q.get()
        q.task_done()
        if c is not None:
            out.append(c)
    return out


class _Ctx:
    """The part of ``ActorContext`` the provider uses, to drive it in
    this process."""

    def __init__(self, mgr):
        self.mgr = mgr
        self._kv = {}

    def kv_get(self, key):
        return self._kv.get(key)

    def kv_set(self, key, value):
        self._kv[key] = value


class _Board:
    def __init__(self, pkg):
        self.authkey = secrets.token_bytes(8)
        self.mgr = pkg["manager"].start(self.authkey, [])
        self.board = pkg["splits"].SplitBoard(self.mgr, "input")

    def close(self):
        self.mgr.shutdown()


def test_sid_packing_matches_jax():
    for sid in [(0, 0), (0, 7), (3, 0), (12, 2 ** 31 + 5)]:
        part = splits.sid_to_part(sid)
        assert part == jsplits.sid_to_part(sid)
        assert splits.part_to_sid(part) == sid
        assert splits.sid_str(sid) == jsplits.sid_str(sid)
    assert splits.split_feed("q") == jsplits.split_feed("q")


def _provider_protocol(pkg):
    """One simulated worker against a provider driven inline: the sids
    it claims in order, the eof and completion."""
    tb = _Board(pkg)
    server = pkg["rendezvous"].Server(1)
    addr = server.start()
    try:
        ctx = _Ctx(tb.mgr)
        p = pkg["splits"].SplitProvider("input", server_addr=addr,
                                        num_epochs=2, window=4)
        p.on_start(ctx)
        client = pkg["rendezvous"].Client(addr)
        got = []
        for _ in range(200):
            p.on_tick(ctx)
            if tb.board.complete():
                break
            sid = tb.board.claim_next()
            if sid is None:
                continue
            tb.board.set_claim(sid, 0)
            if sid[1] >= 3:              # the dataset has 3 splits
                tb.board.set_eof(sid[1])
            got.append(sid)
            client.partition_done(pkg["splits"].split_feed("input"),
                                  pkg["splits"].sid_to_part(sid))
        client.close()
        status = p.on_message(ctx, "status", None)
        assert status.pop("requeued", 0) == 0   # the port's own count
        return got, tb.board.eof(), tb.board.complete(), status
    finally:
        server.stop()
        tb.close()


def test_provider_protocol_matches_jax():
    """FCFS posting order, the eof found at split 3, epochs by id
    arithmetic, completion from the ledger: the sids claimed, the marks
    and the provider's status are the JAX package's."""
    want = _provider_protocol(PKGS["jax"])
    got = _provider_protocol(PKGS["port"])
    assert got == want
    assert got[1] == 3 and got[2]
    assert sorted(s for s in got[0] if s[1] < 3) == \
        [(e, k) for e in range(2) for k in range(3)]


def test_provider_requeues_a_dead_incarnations_claims():
    """A claim whose claimant stopped beating goes to the pin queue of
    its trainer, not the shared queue; a live claimant's claim stays,
    however old.  A respawned worker beats under its own incarnation's
    name, so its dead twin's claims are swept while it runs (the JAX
    worker beats under its index alone, which would keep them)."""
    pkg = PKGS["port"]
    tb = _Board(pkg)
    server = rendezvous.Server(1)
    addr = server.start()
    try:
        ctx = _Ctx(tb.mgr)
        p = splits.SplitProvider("input", server_addr=addr, num_epochs=1,
                                 window=2, stale_secs=1.0)
        p.on_start(ctx)
        p.on_tick(ctx)
        sid = tb.board.claim_next()
        assert sid == (0, 0)
        tb.board.set_claim(sid, "0.111")   # incarnation 111 of worker 0
        tb.board.set_pin(sid, 1)
        # its respawn, incarnation 222 of the same worker, beats
        stop = liveness.start_heartbeat(tb.mgr, tb.board.beat_key("0.222"),
                                        interval=0.1)
        time.sleep(1.2)
        p.on_tick(ctx)
        assert tb.board.claim_next(ranks=[1]) == sid
        assert tb.board.claim_of(sid) is None
        sid2 = tb.board.claim_next()
        tb.board.set_claim(sid2, "0.222")
        time.sleep(1.2)
        p.on_tick(ctx)
        claim = tb.board.claim_of(sid2)
        assert claim is not None and claim[0] == "0.222"
        stop.set()
    finally:
        server.stop()
        tb.close()


def _run_dynamic(pkg, n_workers, n_trainers, num_epochs=1, use_cache=False):
    """Board, provider and ``n_workers`` DynamicDataService threads over
    ``n_trainers`` trainer managers; the per-trainer chunk streams."""
    keys = [secrets.token_bytes(8) for _ in range(n_trainers)]
    mgrs = [pkg["manager"].start(k, ["input", "output", "error"])
            for k in keys]
    tb = _Board(pkg)
    server = pkg["rendezvous"].Server(1)
    addr = server.start()
    try:
        tb.board.set_plan(range(n_workers))
        ctx = _Ctx(tb.mgr)
        p = pkg["splits"].SplitProvider("input", server_addr=addr,
                                        num_epochs=num_epochs, window=8)
        p.on_start(ctx)
        info = [_trainer_meta(m, i, k)
                for i, (m, k) in enumerate(zip(mgrs, keys))]
        meta = {"server_addr": addr,
                pkg["service"].SPLIT_BOARD_META: {
                    "address": tuple(tb.mgr.address),
                    "authkey": tb.authkey}}
        pipe = pkg["data"].from_arrays(_arrays(N_RECORDS), BLOCK)
        stop = threading.Event()

        def _tick():
            while not stop.is_set() and not tb.board.complete():
                p.on_tick(ctx)
                time.sleep(0.02)

        ticker = threading.Thread(target=_tick, daemon=True)
        ticker.start()
        workers = [pkg["service"].DynamicDataService(
            pipe, info, meta, worker_index=w, split_blocks=SPLIT_BLOCKS,
            feed_timeout=60, use_cache=use_cache) for w in range(n_workers)]
        for w in workers:
            # nothing drains the queues until the workers are done
            w.queue_cap = 4 * (N_RECORDS // BLOCK) * num_epochs
        threads = [threading.Thread(target=w.run, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
            assert not t.is_alive(), "dynamic worker wedged"
        stop.set()
        ticker.join(timeout=5)
        assert tb.board.complete()
        return [_drain_chunks(m.get_queue("input")) for m in mgrs]
    finally:
        server.stop()
        tb.close()
        for m in mgrs:
            m.shutdown()


def _ids(chunks):
    return [int(v) for c in chunks for v in c.columns[1]]


@pytest.mark.parametrize("use_cache", [False, True])
def test_one_worker_streams_match_jax(use_cache):
    """One worker over two trainers (its least-backlogged pick, the LRU
    tie-break, splits tagged ``("split", sid, seq, n)``): each trainer's
    chunk stream, tags included, is the JAX package's; through the
    shared epoch cache too, over two epochs."""
    epochs = 2 if use_cache else 1
    PKGS["jax"]["cache"].clear()
    cache.clear()
    try:
        want = _run_dynamic(PKGS["jax"], 1, 2, epochs, use_cache)
        got = _run_dynamic(PKGS["port"], 1, 2, epochs, use_cache)
    finally:
        PKGS["jax"]["cache"].clear()
        cache.clear()
    for g, w in zip(got, want):
        assert [c.meta for c in g] == [c.meta for c in w]
        assert _ids(g) == _ids(w)
        for a, b in zip(g, w):
            assert a.spec == b.spec
            np.testing.assert_array_equal(a.columns[0], b.columns[0])
    assert all(got), [len(s) for s in got]   # both trainers got splits
    counts = collections.Counter(v for s in got for v in _ids(s))
    assert counts == {i: epochs for i in range(N_RECORDS)}


@pytest.mark.parametrize("n_workers,n_trainers,epochs",
                         [(2, 2, 2), (2, 1, 1), (3, 2, 1)])
def test_concurrent_workers_cover_exactly_as_jax(n_workers, n_trainers,
                                                 epochs):
    """Concurrent claimants race, so streams differ run to run; the
    delivered multiset is an exact cover, each record ``epochs`` times,
    in both packages.  With more workers than trainers the ones that own
    none leave without a claim, and the epoch ends without a stale
    sweep."""
    want = collections.Counter(
        v for s in _run_dynamic(PKGS["jax"], 2, 2, epochs) for v in _ids(s))
    t0 = time.monotonic()
    got = collections.Counter(
        v for s in _run_dynamic(PKGS["port"], n_workers, n_trainers, epochs)
        for v in _ids(s))
    assert got == want == {i: epochs for i in range(N_RECORDS)}
    assert time.monotonic() - t0 < 30


def _dedup(pkg):
    """A split served twice (the worker died after two of its chunks):
    what the trainer's DataFeed hands out."""
    authkey = secrets.token_bytes(8)
    m = pkg["manager"].start(authkey, ["input", "output", "error"])
    try:
        chunks = list(pkg["data"].from_arrays(_arrays(24), 6).chunks())
        q = m.get_queue("input")
        sid = (0, 0)
        for seq, c in enumerate(chunks[:2]):
            c.meta = ("split", sid, seq, seq + 1)
            q.put(c)
        for seq, c in enumerate(chunks[:4]):
            q.put(type(c)(c.spec, c.columns, shapes=c.shapes,
                          meta=("split", sid, seq, seq + 1)))
        q.put(None)
        f = pkg["DataFeed"](m, train_mode=True,
                            input_mapping={"x": "x", "y": "y"})
        got = []
        while not f.should_stop():
            got.extend(int(v) for v in f.next_batch_columns(6)["y"])
        return got, getattr(f, "split_dup_chunks", None)
    finally:
        m.shutdown()


def test_datafeed_drops_a_reserved_prefix_as_jax_does():
    want, _ = _dedup(PKGS["jax"])
    got, dups = _dedup(PKGS["port"])
    assert got == want == list(range(24))
    assert dups == 2
    assert marker.split_tag((0, 0), 1) == ("split", (0, 0), 1, 2)


def test_fault_mid_split_requeues_and_stays_exact(monkeypatch):
    """A worker faulted mid-split (``data.split_serve:exc@6``: after a
    chunk of its second split, before the split is recorded) leaves the
    claim; the provider sweeps it back pinned, a fresh worker serves it
    whole again, and the feed drops the prefix: every record once."""
    monkeypatch.setenv(faults.PLAN_ENV, "data.split_serve:exc@6")
    authkey = secrets.token_bytes(8)
    m = manager.start(authkey, ["input", "output", "error"])
    tb = _Board(PKGS["port"])
    server = rendezvous.Server(1)
    addr = server.start()
    try:
        tb.board.set_plan([0])
        ctx = _Ctx(tb.mgr)
        p = splits.SplitProvider("input", server_addr=addr, num_epochs=1,
                                 window=8, stale_secs=0.8)
        p.on_start(ctx)
        info = [_trainer_meta(m, 0, authkey)]
        meta = {"server_addr": addr,
                service.SPLIT_BOARD_META: {"address": tuple(tb.mgr.address),
                                           "authkey": tb.authkey}}
        pipe = data.from_arrays(_arrays(N_RECORDS), BLOCK)
        for _ in range(30):
            p.on_tick(ctx)
            if tb.board.queue_depth():
                break

        def svc():
            return service.DynamicDataService(
                pipe, info, meta, worker_index=0, split_blocks=SPLIT_BLOCKS,
                feed_timeout=60, use_cache=False)

        with pytest.raises(faults.FaultInjected):
            svc().run()
        monkeypatch.delenv(faults.PLAN_ENV)
        time.sleep(1.0)   # the claim goes stale; the sweep requeues it
        p.on_tick(ctx)
        done = threading.Event()

        def _tick():
            while not done.is_set() and not tb.board.complete():
                p.on_tick(ctx)
                time.sleep(0.02)

        t = threading.Thread(target=_tick, daemon=True)
        t.start()
        svc().run()
        done.set()
        t.join(timeout=5)
        assert tb.board.complete()
        m.get_queue("input").put(None)
        f = feed.DataFeed(m, train_mode=True,
                          input_mapping={"x": "x", "y": "y"})
        got = []
        while not f.should_stop():
            got.extend(int(v) for v in f.next_batch_columns(6)["y"])
        assert sorted(got) == list(range(N_RECORDS))
        assert len(got) == N_RECORDS and f.split_dup_chunks == 1
    finally:
        server.stop()
        tb.close()
        m.shutdown()


# -- the epoch cache -------------------------------------------------------------

def _cache_reads(pkg, tmp):
    pipe = pkg["data"].from_arrays(_arrays(80), 8).shuffle(30, 2).batch(8)
    c = pkg["cache"].EpochCache(pipe, memory_bytes=300, spill_dir=tmp)
    try:
        b5 = c.block(5)
        before = c.num_blocks
        past = c.block(10) is None
        out = [_blk(b5), before, past, c.num_blocks,
               [_blk(b) for b in c.blocks_range(4, 3)],
               [_blk(b) for b in c.blocks_range()]]
        spilled = c._spill_path is not None and os.path.exists(c._spill_path)
        return out, spilled
    finally:
        c.close()


def _blk(b):
    return {k: np.asarray(v).tolist() for k, v in sorted(b.items())}


def test_epoch_cache_matches_jax(tmp_path):
    """Incremental fill (block 5 before the end is known), the end found
    at 10, seeks into the spill past a 300-byte budget: every read is
    the JAX cache's; the registry keys by signature."""
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want, jspill = _cache_reads(PKGS["jax"], str(tmp_path / "j"))
    got, pspill = _cache_reads(PKGS["port"], str(tmp_path / "p"))
    assert got == want and pspill and jspill
    assert got[1] is None and got[2] is True and got[3] == 10
    cache.clear()
    try:
        a = data.from_arrays(_arrays(40), 5)
        assert cache.shared(a) is cache.shared(data.from_arrays(
            _arrays(40), 5))
        assert cache.shared(data.from_arrays(_arrays(40), 8)) is not \
            cache.shared(a)
    finally:
        cache.clear()


# -- the autoscaler ----------------------------------------------------------------

def _decisions(mod, stalls):
    seq = iter(stalls)
    ups, downs = [], []
    a = mod.StallAutoscaler(lambda: next(seq), ups.append, downs.append,
                            min_workers=1, max_workers=3, high=0.25,
                            low=0.05, cooldown=10.0)
    out = []
    for i, _ in enumerate(stalls):
        out.append(a.step(100.0 + 7.0 * i))
    return out, ups, downs, a.workers


def test_autoscaler_decides_as_jax():
    """One seeded stall sequence (with None, no signal, among it): the
    same up/down decisions, the same workers added and retired (last in,
    first out), the same clamps and cooldowns."""
    rng = np.random.default_rng(9)
    stalls = [None if v < 0.08 else float(v) * 0.5
              for v in rng.random(60)]
    got = _decisions(autoscale, stalls)
    assert got == _decisions(jautoscale, stalls)
    assert "up" in got[0] and "down" in got[0]


def test_obs_stall_reader_matches_jax(monkeypatch):
    """The windowed trainer feed-wait ratio: data and driver snapshots
    never count; a clock stepped by hand gives both packages' readers
    the same ratios."""
    snaps = {"t0": {"role": "worker", "metrics": {
        "tfos_feed_wait_seconds_total": {"series": [{"value": 0.0}]}}},
        "d0": {"role": "data", "metrics": {
            "tfos_feed_wait_seconds_total": {"series": [{"value": 9.0}]}}}}
    clock = {"t": 10.0}
    monkeypatch.setattr(autoscale.time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(jautoscale.time, "monotonic", lambda: clock["t"])
    readers = [autoscale.obs_stall_reader(lambda: snaps),
               jautoscale.obs_stall_reader(lambda: snaps)]
    outs = []
    for wait in (0.0, 0.5, 1.25, 1.25):
        snaps["t0"]["metrics"]["tfos_feed_wait_seconds_total"][
            "series"][0]["value"] = wait
        outs.append([r() for r in readers])
        clock["t"] += 2.0
    assert [a for a, b in outs] == [b for a, b in outs]
    assert outs[0][0] is None and outs[2][0] == pytest.approx(0.375)


# -- end to end: dynamic dispatch on a cluster, a worker SIGKILLed mid-split --

E2E_N, E2E_BLOCK, E2E_SPLIT = 240, 10, 2   # 24 blocks, 12 splits of 2


def ids_main(args, ctx):
    """A trainer that logs every record id its DataFeed hands out."""
    f = ctx.get_data_feed(train_mode=True, input_mapping={"x": "x",
                                                          "y": "y"})
    ids = []
    while not f.should_stop():
        ids.extend(int(v) for v in f.next_batch_columns(16)["y"])
        time.sleep(0.01)
    with open(os.path.join(args["out_dir"], "ids.json"), "w") as fh:
        json.dump({"ids": ids, "feed": f.stats()}, fh)


def test_dynamic_service_survives_a_worker_kill_mid_split(tmp_path,
                                                          monkeypatch):
    """``cluster.run(data_workers=2)`` with the default dispatch: worker
    0, on executor 1, owns the one trainer; worker 1, on the node's
    executor 0, owns none and leaves at once.  ``data.split_serve:kill@6``
    (the first incarnation of executor 1) SIGKILLs the serving worker
    after the first chunk of its third split; the engine respawns it, the
    provider requeues its unrecorded splits pinned to the trainer, the
    respawn serves them whole, and the trainer's DataFeed drops each
    re-served prefix: every record exactly once, no cluster recovery."""
    monkeypatch.setenv("TFOS_ACTOR_HEARTBEAT_SECS", "0.2")
    monkeypatch.setenv("TFOS_ACTOR_HEARTBEAT_STALE", "2")
    monkeypatch.setenv("TFOS_DATA_SPLIT_BLOCKS", str(E2E_SPLIT))
    engine = LocalEngine(2, env={
        "OMP_NUM_THREADS": "2", gpu_info.COUNT_ENV: "0",
        "CUDA_VISIBLE_DEVICES": None, gpu_info.INHERITED_ENV: None,
        "TFOS_ACTOR_HEARTBEAT_SECS": "0.2", "TFOS_DATA_SPLIT_BLOCKS":
        str(E2E_SPLIT), faults.PLAN_ENV: "data.split_serve:kill@6",
        faults.EXECUTOR_ENV: "1", faults.INCARNATION_ENV: "0"})
    try:
        c = TFCluster.run(engine, ids_main, {"out_dir": str(tmp_path)},
                          num_executors=1,
                          input_mode=TFCluster.InputMode.SPARK,
                          reservation_timeout=TIMEOUT, restarts=1,
                          data_workers=2)
        try:
            c.train(data.from_arrays(_arrays(E2E_N), E2E_BLOCK),
                    feed_timeout=TIMEOUT)
            done = c.server.fed_partitions(splits.split_feed("input"))
        finally:
            c.shutdown()
        incarnations = list(engine._incarnation)
    finally:
        engine.stop()
    with open(tmp_path / "ids.json") as fh:
        got = json.load(fh)
    assert incarnations == [0, 1]
    assert c._restarts_used == 0
    assert c.data_status["complete"] and c.data_status["requeued"] >= 1
    assert collections.Counter(got["ids"]) == {i: 1 for i in range(E2E_N)}
    assert got["feed"]["split_dup_chunks"] >= 1
    # every split of the epoch recorded, and past its end only empty ones
    n_splits = E2E_N // E2E_BLOCK // E2E_SPLIT
    done = sorted(splits.part_to_sid(p) for p in done)
    assert done[:n_splits + 1] == [(0, k) for k in range(n_splits + 1)]


def test_dynamic_service_mnist_gives_the_feeder_losses(tmp_path):
    """MNIST through ``cluster.run(data_workers=2)`` with the default
    dispatch and one-batch splits: one worker owns the one trainer and
    claims the splits in posting order, so the trainer steps on
    feeder-mode ``train()``'s batches and gives its losses (rtol 1e-6,
    the same float32 steps)."""
    from tensorflowonspark_tpu_torch.examples import mnist_spark

    batch, steps = 16, 10
    rows = mnist_spark.synthetic_records(batch * steps, seed=6)
    pipe = data.from_arrays(
        {"image": np.stack([r[0] for r in rows]).astype(np.float32),
         "label": np.asarray([r[1] for r in rows], np.int32)}, batch)
    engine = LocalEngine(2, env={
        "OMP_NUM_THREADS": "2", gpu_info.COUNT_ENV: "0",
        "CUDA_VISIBLE_DEVICES": None, gpu_info.INHERITED_ENV: None,
        "TFOS_DATA_SPLIT_BLOCKS": "1"})
    losses = {}
    try:
        for name, dataset, kw in (
                ("feeder", engine.parallelize(rows, 2), {}),
                ("dynamic", pipe, {"data_workers": 2})):
            out = tmp_path / name
            out.mkdir()
            c = TFCluster.run(
                engine, mnist_spark.main_fun,
                {"batch_size": batch, "lr": 0.05, "device": "cpu",
                 "seed": 0, "out_dir": str(out)}, num_executors=1,
                input_mode=TFCluster.InputMode.SPARK,
                reservation_timeout=TIMEOUT, **kw)
            try:
                c.train(dataset, feed_timeout=TIMEOUT)
            finally:
                c.shutdown()
            with open(out / "mnist-rank0.json") as fh:
                losses[name] = json.load(fh)["losses"]
    finally:
        engine.stop()
    assert len(losses["feeder"]) == steps
    np.testing.assert_allclose(losses["dynamic"], losses["feeder"],
                               rtol=1e-6)
