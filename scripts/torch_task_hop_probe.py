#!/usr/bin/env python3
"""How long one SPARK-fed ResNet-50 partition takes to reach an executor.

    python3 scripts/torch_task_hop_probe.py [--reps 6]

Run it from the root of a checkout.  ``LocalEngine``
(``tensorflowonspark_tpu_torch/engine.py``) pickles each
task and sends it to its executor through a ``multiprocessing.Queue``,
whose pipe carries the whole payload.  This script times that hop for
the payload ``chip_smoke.py``'s ``spark_resnet`` phase sends a
partition (256 seeded uint8 224x224x3 images and their labels, 38.5 MB
pickled), and two ways around it, in this order:

- ``queue``: a spawned reader's ``get`` of each message through an
  ``mp.Queue`` whose pipe has its default size, and then 1 MiB
  (``F_SETPIPE_SZ``), twice each, in turns; every message is put before
  the reader starts, as the engine puts a job's tasks, and the reader
  sleeps 0.2 s (a step) between gets;
- ``shm_file``: writing the payload to a file in ``/dev/shm`` and
  reading it back;
- ``ring``: the same records as the feeder's columnar chunk, put into
  and popped from the port's ring (``recordio.shm``, the node's default
  256 MiB) in one process, twelve times: the first six touch ring pages
  for the first time, the rest reuse them; every pop copies into a
  buffer of its own;
- ``manager_start``: a node's boot in an engine executor.  An executor
  is spawned, so it imports the driver's main module (this script,
  which imports torch as a training driver does), and its default start
  method is spawn.  In one executor, a ``manager.TFManager`` server
  started with each start method, ``--reps`` times (``spawn`` imports
  the main module again; ``fork`` copies the executor); then
  ``cluster.run`` of a one-node SPARK-mode cluster whose ``main_fun``
  only drains its feed, from the call to its return (the manager, the
  ring, the rendezvous).

Prints one JSON object per line: the pickling, each row of times in ms,
and the host's kernel release and the card (``nvidia-smi``), when there
is one.  Needs no card; its numbers are host numbers.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import multiprocessing as mp
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch  # noqa: F401 - the main module's weight, as a driver's

sys.path.insert(0, os.getcwd())  # the checkout's port

F_SETPIPE_SZ, F_GETPIPE_SZ = 1031, 1032


def _payload():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (256, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, 1000, 256)
    return [(images[i], int(labels[i])) for i in range(256)]


def _reader(q, out, go, reps):
    go.wait()  # every message was put: time the gets alone
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        q.get()
        times.append(1e3 * (time.perf_counter() - t0))
        time.sleep(0.2)
    out.put(times)


def queue_hop(blob, pipe_bytes, reps):
    """ms of each ``get`` of ``reps`` messages of ``blob``; the pipe's
    size as the kernel set it."""
    ctx = mp.get_context("spawn")
    q, out, go = ctx.Queue(), ctx.Queue(), ctx.Event()
    if pipe_bytes:
        fcntl.fcntl(q._writer.fileno(), F_SETPIPE_SZ, pipe_bytes)
    size = fcntl.fcntl(q._writer.fileno(), F_GETPIPE_SZ)
    p = ctx.Process(target=_reader, args=(q, out, go, reps))
    p.start()
    try:
        for i in range(reps):  # as the engine puts a job's tasks
            q.put(("task", 1, i, blob))
        go.set()
        times = out.get(timeout=600)
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    return size, times


def shm_file_hop(blob, reps):
    """ms to write ``blob`` to a file in /dev/shm and to read it back."""
    d = tempfile.mkdtemp(dir="/dev/shm")
    rows = []
    try:
        for i in range(reps):
            path = os.path.join(d, f"task{i}")
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                f.write(blob)
            t1 = time.perf_counter()
            with open(path, "rb") as f:
                f.read()
            t2 = time.perf_counter()
            os.unlink(path)
            rows.append([1e3 * (t1 - t0), 1e3 * (t2 - t1)])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return rows


def ring_hop(records, reps=12):
    """ms to put the records' columnar chunk into a fresh ring and to
    pop it, ``reps`` times in turn."""
    from tensorflowonspark_tpu_torch import node
    from tensorflowonspark_tpu_torch.recordio import shm

    chunk = node._make_chunk_encoder()(records)
    ring = shm.ShmQueue(f"/tfosq-probe-{os.getpid()}", node.SHM_FEED_BYTES,
                        create=True)
    rows = []
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            ring.put(chunk)
            t1 = time.perf_counter()
            ring.get()
            rows.append([1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1)])
    finally:
        ring.close()
    return rows


def drain_main(args, ctx):
    """A ``main_fun`` that only drains its feed."""
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        feed.next_batch(8)


class ManagerStart:
    """An engine task: a manager server started and shut down with
    each start method, ``reps`` times; the seconds of each start."""

    def __init__(self, reps):
        self.reps = reps

    def __call__(self, it):
        import secrets

        from tensorflowonspark_tpu_torch import manager

        list(it)
        manager.TFManager.register("get_queue", callable=manager._get_queue)
        out = {"default_start_method": mp.get_start_method()}
        for method in ("spawn", "fork"):
            seconds = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                mgr = manager.TFManager(address=("localhost", 0),
                                        authkey=secrets.token_bytes(8),
                                        ctx=mp.get_context(method))
                mgr.start()
                mgr.get_queue("input")
                seconds.append(time.perf_counter() - t0)
                mgr.shutdown()
            out[f"{method}_start_s"] = seconds
        return [out]


def manager_start(reps):
    """The manager's start with each method in an executor, and the
    seconds of ``cluster.run`` of one node, ``reps`` times each."""
    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(1)
    try:
        starts = engine.parallelize([0], 1).map_partitions(
            ManagerStart(reps)).collect()[0]
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            c = TFCluster.run(engine, drain_main, {}, num_executors=1,
                              input_mode=TFCluster.InputMode.SPARK)
            runs.append(time.perf_counter() - t0)
            c.train(engine.parallelize(list(range(16)), 1))
            c.shutdown()
    finally:
        engine.stop()
    return dict(starts, cluster_run_s=runs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        card = None
    print(json.dumps({"kernel": os.uname().release, "card": card}),
          flush=True)
    records = _payload()
    t0 = time.perf_counter()
    blob = pickle.dumps(records)
    t1 = time.perf_counter()
    pickle.loads(blob)
    t2 = time.perf_counter()
    print(json.dumps({"pickle": {"mb": len(blob) / 1e6,
                                 "dumps_ms": 1e3 * (t1 - t0),
                                 "loads_ms": 1e3 * (t2 - t1)}}), flush=True)
    for pipe_bytes in (0, 1 << 20, 0, 1 << 20):
        size, times = queue_hop(blob, pipe_bytes, args.reps)
        print(json.dumps({"queue": {"pipe_bytes": size, "get_ms": times}}),
              flush=True)
    print(json.dumps({"shm_file": {"write_read_ms": shm_file_hop(
        blob, args.reps)}}), flush=True)
    print(json.dumps({"ring": {"put_get_ms": ring_hop(records)}}),
          flush=True)
    print(json.dumps({"manager_start": manager_start(args.reps)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
