"""Execution engine: the scheduler the framework federates.

An own copy of the part of ``tensorflowonspark_tpu/engine.py`` that the
SPARK-fed training path calls: ``LocalEngine``, a pool of executor
*processes* on this host, and ``LocalDataset``, its partitioned dataset
(``parallelize``, ``union``, ``foreach_partition``).  Node-placement
jobs run ``spread=True`` or with an explicit ``placement`` (task i on
executor i's own inbox); other jobs go to a shared queue that any free
executor pulls from.

Differences from the JAX package:

- Tasks are shipped with the standard library's ``pickle``, not
  ``cloudpickle``: every function a task carries is a module-level
  function or an instance of a module-level class (the node runtime's
  closures are such classes), and user ``map_fun``s are module-level
  functions, as the spawn start already requires.
- Executors start with ``spawn`` only.  A driver that has used CUDA (as
  ``chip_smoke.py`` has by then) cannot hand a CUDA context to a forked
  child; spawned executors start clean, and do nothing with CUDA, so the
  trainers they fork can.
- No task retries, executor respawns or elastic shrink (``retryable``
  raises NotImplementedError): they come with ``restarts``
  (ROADMAP.md queue 1, item 15).  An executor that dies fails the job.
  No ``SparkEngine`` adapter (ROADMAP.md queue 1, item 15).
- No ``map_partitions`` lineage, ``collect`` or ``from_partitions``:
  the SPARK-fed path only feeds partitions to nodes.  No caller-owned
  scratch root (``workdir`` raises NotImplementedError, ROADMAP.md
  queue 1, item 14).
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import multiprocessing as mp
import os
import pickle
import queue as _queue
import shutil
import tempfile
import threading
import time
import traceback

from tensorflowonspark_tpu_torch.actors import supervise as _supervise
from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

RESTARTS_ITEM = "ROADMAP.md queue 1, item 15 (restarts, elastic, SparkEngine)"


class TaskError(RuntimeError):
    """A task raised on an executor; carries the remote traceback."""


# ----------------------------------------------------------------------------
# Executor worker process
# ----------------------------------------------------------------------------

def _executor_main(index, workdir, shared_inbox, own_inbox, results):
    """Executor process loop: pull a task, run it, report the result."""
    os.chdir(workdir)
    os.environ["TFOS_EXECUTOR_INDEX"] = str(index)
    # an executor is never the driver: shed any telemetry identity and
    # spool directory it inherited, so its records (and its trainers')
    # go to TFOS_TELEMETRY_DIR
    os.environ.pop(telemetry.NODE_ENV, None)
    os.environ.pop(telemetry.SPOOL_ENV, None)
    os.environ[telemetry.ROLE_ENV] = "executor"
    try:
        while True:
            try:
                msg = own_inbox.get(timeout=0.02)
            except _queue.Empty:
                try:
                    msg = shared_inbox.get(timeout=0.02)
                except _queue.Empty:
                    continue
            if msg[0] == "stop":
                break
            _, job_id, task_id, blob = msg
            # the feeder recovers its partition number from this (the
            # engine's analogue of pyspark's TaskContext.partitionId())
            os.environ["TFOS_PARTITION_INDEX"] = str(task_id)
            try:
                fn, items = pickle.loads(blob)
                fn(iter(items))
                results.put(("ok", job_id, task_id, index, None))
            except BaseException:  # noqa: BLE001 - report any task failure
                results.put(("error", job_id, task_id, index,
                             traceback.format_exc()))
    finally:
        telemetry.flush()
        _reap_executor_children()


def _reap_executor_children():
    """Terminate and collect every live child of this executor before the
    interpreter exits: a background trainer left behind by a crashed run
    would block multiprocessing's exit join (it is not a daemon)."""
    for child in mp.active_children():
        try:
            child.terminate()
            child.join(timeout=3)
            if child.is_alive():
                child.kill()
                child.join(timeout=2)
        except (OSError, ValueError, AssertionError):
            pass


# ----------------------------------------------------------------------------
# Dataset (RDD parity surface)
# ----------------------------------------------------------------------------

def _no_retries(retryable, max_retries):
    if retryable or max_retries is not None:
        raise NotImplementedError(
            f"retryable jobs come with {RESTARTS_ITEM}")


class LocalDataset:
    """Partitioned dataset: a list of partitions, each a list of items."""

    def __init__(self, engine, partitions):
        self._engine = engine
        self._partitions = partitions

    @property
    def num_partitions(self):
        return len(self._partitions)

    def foreach_partition(self, fn, spread=False, placement=None,
                          retryable=False, max_retries=None):
        """Run ``fn`` over every partition.  ``placement`` pins task i
        to executor ``placement[i]``; ``spread`` to executor i."""
        _no_retries(retryable, max_retries)
        self._engine._run_job([(p, fn) for p in self._partitions],
                              spread=spread, placement=placement)

    def union(self, *others):
        parts = list(self._partitions)
        for o in others:
            parts.extend(o._partitions)
        return LocalDataset(self._engine, parts)


# ----------------------------------------------------------------------------
# Local engine
# ----------------------------------------------------------------------------

@contextlib.contextmanager
def _patched_env(env):
    """Apply env overrides around a spawn (None removes a variable)."""
    saved = {}
    for k, v in env.items():
        saved[k] = os.environ.get(k)
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


class LocalEngine:
    """A pool of executor processes on this host."""

    def __init__(self, num_executors, workdir=None, start_method="spawn",
                 env=None):
        """``env``: environment overrides for the executor processes, set
        before they boot (a value of None removes the variable).
        Construction briefly changes ``os.environ``: construct engines
        from the driver's main thread."""
        if workdir is not None:
            raise NotImplementedError(
                "a caller-owned scratch root comes with ROADMAP.md queue 1, "
                "item 14")
        if start_method != "spawn":
            raise ValueError(
                f"LocalEngine starts executors with 'spawn' only, got "
                f"{start_method!r}: a forked executor would inherit the "
                "driver's CUDA state, which a child cannot use")
        self.num_executors = int(num_executors)
        self._ctx = mp.get_context("spawn")
        self._env = dict(env) if env else {}
        self._root = tempfile.mkdtemp(prefix="tfos_engine_")
        self._shared_inbox = self._ctx.Queue()
        self._results = self._ctx.Queue()
        self._own_inboxes = []
        self._procs = []
        self._job_counter = 0
        self._job_lock = threading.Lock()
        self._job_queues = {}  # job_id -> local queue (results demux)
        self._cancelled = False
        self._stopped = False
        self.executor_dirs = []
        with _patched_env(self._env):
            for i in range(self.num_executors):
                d = os.path.join(self._root, f"executor-{i}")
                os.makedirs(d, exist_ok=True)
                self.executor_dirs.append(d)
                self._own_inboxes.append(self._ctx.Queue())
                p = self._ctx.Process(
                    target=_executor_main,
                    args=(i, d, self._shared_inbox, self._own_inboxes[i],
                          self._results),
                    name=f"tfos-executor-{i}",
                    # not a daemon: an executor forks the trainer and the
                    # IPC manager's server
                    daemon=False)
                p.start()
                self._procs.append(p)
        # concurrent jobs (the node launcher and a feeder) share one
        # results pipe; the pump sorts results by job
        self._pump = threading.Thread(target=self._pump_results,
                                      name="tfos-result-pump", daemon=True)
        self._pump.start()
        atexit.register(self.stop)
        logger.info("LocalEngine started %d executors under %s",
                    self.num_executors, self._root)

    @property
    def default_fs(self):
        return "file://"

    def parallelize(self, seq, num_partitions=None):
        """``seq`` cut into ``num_partitions`` (default: one per
        executor) contiguous partitions, in order."""
        items = list(seq)
        n = num_partitions or self.num_executors
        n = max(1, min(n, max(len(items), 1)))
        parts = [[] for _ in range(n)]
        for i, item in enumerate(items):
            parts[i * n // max(len(items), 1)].append(item)
        return LocalDataset(self, parts)

    def cancel_all_jobs(self):
        """Abort every running and later job."""
        self._cancelled = True

    def _pump_results(self):
        while not self._stopped:
            try:
                item = self._results.get(timeout=0.2)
            except _queue.Empty:
                continue
            except (OSError, EOFError, ValueError):
                break
            with self._job_lock:
                q = self._job_queues.get(item[1])
            if q is not None:
                q.put(item)

    def _run_job(self, tasks, spread, placement=None):
        """Dispatch one ``(items, fn)`` task per partition; block until
        every task finished.  The first failure raises ``TaskError``."""
        if self._cancelled:
            raise TaskError("engine cancelled")
        with self._job_lock:
            self._job_counter += 1
            job_id = self._job_counter
            my_results = _queue.Queue()
            self._job_queues[job_id] = my_results
        try:
            self._run_job_inner(tasks, spread, placement, job_id,
                                my_results)
        finally:
            with self._job_lock:
                self._job_queues.pop(job_id, None)

    def _run_job_inner(self, tasks, spread, placement, job_id, my_results):
        # only executors that die during this job fail it
        dead_at_start = {i for i, p in enumerate(self._procs)
                         if not p.is_alive()}
        for task_id, (part, fn) in enumerate(tasks):
            msg = ("task", job_id, task_id,
                   pickle.dumps((fn, list(part))))
            if placement is not None and task_id < len(placement):
                target = placement[task_id] % self.num_executors
            elif spread:
                target = task_id % self.num_executors
            else:
                self._shared_inbox.put(msg)
                continue
            if not self._procs[target].is_alive():
                raise TaskError(f"cannot place task {task_id} on executor "
                                f"{target}: executor process is dead")
            self._own_inboxes[target].put(msg)

        ndone = 0
        while ndone < len(tasks):
            if self._cancelled:
                raise TaskError("engine cancelled")
            try:
                status, _, tid, idx, err = my_results.get(timeout=0.25)
            except _queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if i not in dead_at_start and not p.is_alive()]
                if dead:
                    raise TaskError(
                        f"executor(s) {dead} died with tasks in flight (job "
                        f"{job_id}, {len(tasks) - ndone} pending); driver "
                        "scripts must guard their entry with if __name__ == "
                        "'__main__' under the spawn start method") from None
                continue
            if status == "error":
                raise TaskError(f"task {tid} failed on executor {idx}:\n"
                                f"{err}")
            ndone += 1

    def stop(self):
        """Stop every executor, then kill any child they left behind."""
        if self._stopped:
            return
        self._stopped = True
        for inbox in self._own_inboxes:
            try:
                inbox.put(("stop",))
            except (OSError, ValueError):
                pass
        # never block interpreter exit on a flush to a dead reader
        for q in (self._shared_inbox, self._results, *self._own_inboxes):
            try:
                q.cancel_join_thread()
            except (OSError, ValueError):
                pass
        deadline = time.time() + 5
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
            if p.is_alive():
                p.kill()
                p.join(timeout=2)
        _supervise.reap_orphans(self.executor_dirs, what="leftover child")
        shutil.rmtree(self._root, ignore_errors=True)


def as_dataset(obj):
    """``obj`` if it is a ``LocalDataset``; raises otherwise."""
    if isinstance(obj, LocalDataset):
        return obj
    cls = type(obj)
    if cls.__module__.startswith("pyspark"):
        raise NotImplementedError(
            f"pyspark datasets come with {RESTARTS_ITEM}")
    raise TypeError(f"not a dataset: {obj!r}")


def as_engine(obj):
    """``obj`` if it is a ``LocalEngine``; raises otherwise."""
    if isinstance(obj, LocalEngine):
        return obj
    cls = type(obj)
    if cls.__module__.startswith("pyspark"):
        raise NotImplementedError(
            f"a SparkContext comes with {RESTARTS_ITEM}")
    raise TypeError(f"not an engine: {obj!r}")
