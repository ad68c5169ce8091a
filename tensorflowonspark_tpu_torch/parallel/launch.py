"""A pool of processes that form one ``torch.distributed`` group.

``RankPool(n)`` spawns n processes, each of which joins a process group
of world size n (gloo by default) through a ``FileStore`` in a fresh
temporary directory, and then runs whatever function :meth:`RankPool.run`
sends it, on every rank at once.  It is how this package runs a
multi-rank program on one host without a launcher: the dry run
(:func:`parallel.dryrun.dryrun_multichip`) and the tests, which start
the ranks once and send each case to them.

The functions travel by reference (plain pickle): they must be
module-level functions of an importable module.  Each call has its own
timeout; a rank that raises or a call that times out breaks the pool
(the others may be stuck in a collective), which is then terminated and
restarted at the next call.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback

DEFAULT_TIMEOUT = 300.0
PG_TIMEOUT_S = 120.0   # bounds each collective a rank waits in


def _rank_main(rank, world, store_path, backend, env, tasks, results):
    os.environ.update(env)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(env.get("OMP_NUM_THREADS", "1")))
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args, kwargs = item
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # noqa: BLE001 - reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        # a function may have left the group (the dry run's shrink)
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``n`` spawned processes in one process group.

    ``env`` is set in each rank before torch loads (default
    ``OMP_NUM_THREADS=1``)."""

    def __init__(self, n, backend="gloo", env=None):
        self.n = int(n)
        self.backend = backend
        self.env = {"OMP_NUM_THREADS": "1", **(env or {})}
        self._procs = []
        self._tasks, self._results = (), None
        self._tmp = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="tfos-rankpool-")
        store = os.path.join(self._tmp, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.n, store, self.backend, self.env,
                              self._tasks[r], self._results))
            for r in range(self.n)]
        for p in self._procs:
            p.start()
        self._collect(DEFAULT_TIMEOUT, "start")

    def _collect(self, timeout, what):
        out, errors = [None] * self.n, []
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        got = 0
        while got < self.n:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                break
            try:
                rank, ok, value = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead and not errors:
                    self.close()
                    raise RuntimeError(f"RankPool({self.n}): {what}: "
                                       f"ranks exited (rank, code): {dead}")
                continue
            got += 1
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                if len(errors) == 1:
                    # the others may wait in a collective for this one
                    deadline = min(deadline, datetime.datetime.now()
                                   + datetime.timedelta(seconds=5))
        if errors:
            self.close()
            raise RuntimeError(f"RankPool({self.n}): {what} failed\n"
                               + "\n".join(errors))
        if got < self.n:
            self.close()
            raise TimeoutError(f"RankPool({self.n}): {what} did not finish "
                               f"on every rank within {timeout} s")
        return out

    def run(self, fn, *args, timeout=DEFAULT_TIMEOUT, **kwargs):
        """``fn(*args, **kwargs)`` on every rank; returns the results in
        rank order.  Raises RuntimeError with the ranks' tracebacks when
        one raises, TimeoutError when they do not finish in time."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(timeout, getattr(fn, "__name__", "call"))

    def close(self):
        """Stop the ranks (terminate what does not exit) and remove the
        rendezvous directory.  The next :meth:`run` starts new ranks."""
        procs, self._procs = self._procs, []
        for p, q in zip(procs, self._tasks):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
        # end the queues' feeder threads, which would outlive the pool
        for q in (*self._tasks, self._results):
            if q is not None:
                q.cancel_join_thread()
                q.close()
        self._tasks, self._results = (), None
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def free_port():
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(backend="gloo", timeout=DEFAULT_TIMEOUT):
    """A one-rank process group in this process for the block, over a
    ``TCPStore`` on a free port of 127.0.0.1, destroyed after it (as an
    NCCL group on the one card must be); yields the store, which the
    block may use as the job's key-value store."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield store
    finally:
        dist.destroy_process_group()


def run_ranks(n, fn, *args, backend="gloo", timeout=DEFAULT_TIMEOUT,
              **kwargs):
    """``fn(*args, **kwargs)`` on every rank of an n-process group;
    returns the results in rank order.  One rank runs in this process,
    in a :func:`one_rank_group` made for the call; more ranks run in a
    :class:`RankPool`, closed after the call."""
    if n == 1:
        with one_rank_group(backend, timeout):
            return [fn(*args, **kwargs)]
    with RankPool(n, backend=backend) as pool:
        return pool.run(fn, *args, timeout=timeout, **kwargs)
