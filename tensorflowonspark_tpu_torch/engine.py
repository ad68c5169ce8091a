"""Execution engine: the scheduler the framework federates.

An own copy of the part of ``tensorflowonspark_tpu/engine.py`` that the
SPARK-fed training path and the TFRecord loaders call: ``LocalEngine``,
a pool of executor *processes* on this host, and ``LocalDataset``, its
partitioned dataset (``parallelize``, ``map_partitions``, ``union``,
``foreach_partition``, ``collect``, ``repartition``).  Every executor
reads its own inbox only.  Node-placement jobs run ``spread=True`` or
with an explicit ``placement`` (task i on executor i's inbox); other
jobs' tasks wait in a shared queue on the driver, which hands each to
the inbox of an executor that has nothing queued or running.  A process
killed while it waits on a queue keeps that queue's reader lock, so a
respawned executor gets a fresh inbox, and the tasks that were queued
for the dead one and not yet started follow it there.

``map_partitions`` is lazy: a dataset carries, for each partition, its
items and the chain of functions to run over them (``Lineage``), and
the chain runs in the executor before the job's own function, which
gets the last stage's iterator.  So ``dfutil.load_tfrecords`` ships read
units ``(path, stride, offset)`` and each executor reads its own shards:
the records never cross the driver's pipe.  The running task's
``task_report`` holds each stage's milliseconds (the last stage's grow
as the job consumes it), where the feeder reads them.

Differences from the JAX package:

- Tasks are shipped with the standard library's ``pickle``, not
  ``cloudpickle``: every function a task carries is a module-level
  function or an instance of a module-level class (the node runtime's
  closures, the lineage and ``dfutil``'s readers are such classes), and
  user ``map_fun``s are module-level functions, as the spawn start
  already requires.
- Executors start with ``spawn`` only.  A driver that has used CUDA (as
  ``chip_smoke.py`` has by then) cannot hand a CUDA context to a forked
  child; spawned executors start clean, and do nothing with CUDA, so the
  trainers they fork can.
- Retryable jobs (``foreach_partition(retryable=True)``, the serving
  replicas' job) are supervised as in the JAX package: a failed task is
  retried after a jittered exponential backoff (``TFOS_TASK_RETRIES``,
  ``TFOS_RETRY_BACKOFF``), and a dead executor is respawned within a
  budget (``TFOS_EXECUTOR_RESPAWNS``) after its children are killed;
  its lost tasks are re-dispatched from the kept blobs.  A job that is
  not retryable fails at the first task error or executor death.
  Cluster recovery heals the pool with ``ensure_executors``; an elastic
  shrink (``cluster.run(min_executors=)``) reads ``alive_executors`` and
  takes dead slots out of the pool with ``retire_executors``: a retired
  slot is never respawned and spread jobs skip it.
- No inbox is read by more than one process, and none outlives its
  reader: the JAX package's executors also poll one inbox they all
  share and keep theirs across a respawn, so an executor killed from
  outside while it waits leaves a reader lock taken for good (ROADMAP.md
  queue 3, repaired in the port).
- ``SparkEngine`` and ``SparkDataset`` adapt a pyspark ``SparkContext``
  and its RDDs, as in the JAX package; ``as_engine`` and ``as_dataset``
  take them.  Spark ships tasks with its own serializer, but the
  adapter's own callables are module-level classes all the same.
- ``LocalEngine(workdir=)``: the executors' directories go under a
  root the caller owns, which ``stop()`` keeps (the pid ledgers of the
  executors' children are swept, so it is left clean); without one, a
  temporary root is made and removed.  ``from_partitions`` takes the
  partitions as they are given.
"""

from __future__ import annotations

import atexit
import collections
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
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

class TaskError(RuntimeError):
    """A task raised on an executor; carries the remote traceback."""


class ResultPumpError(TaskError):
    """The result transport itself failed (a corrupt stream, a payload
    the driver cannot unpickle): not the fault of any one task's code."""


# the running task's report, in the executor: ``lineage_ms``, each
# map_partitions stage's milliseconds, and what a stage adds to it
# (dfutil's reader: the ``codec`` it read with).  Cleared per task.
task_report = {}


# ----------------------------------------------------------------------------
# Executor worker process
# ----------------------------------------------------------------------------

def _executor_main(index, incarnation, workdir, inbox, results):
    """Executor process loop: take a task from this executor's own inbox,
    run it, report the result.  Every result names the executor and its
    incarnation, so the driver can tell a dead incarnation's late
    answers from the live one's."""
    os.chdir(workdir)
    os.environ["TFOS_EXECUTOR_INDEX"] = str(index)
    os.environ["TFOS_EXECUTOR_INCARNATION"] = str(incarnation)
    # an executor is never the driver: shed any telemetry identity and
    # spool directory it inherited, so its records (and its trainers')
    # go to TFOS_TELEMETRY_DIR
    os.environ.pop(telemetry.NODE_ENV, None)
    os.environ.pop(telemetry.SPOOL_ENV, None)
    os.environ[telemetry.ROLE_ENV] = "executor"
    who = (index, incarnation)
    try:
        t_wait = time.perf_counter()  # since the previous task ended
        while True:
            msg = inbox.get()
            if msg[0] == "stop":
                break
            _, job_id, task_id, blob, trace = msg
            # start-ack before running: the driver re-dispatches exactly
            # the tasks that were running on an executor that dies
            results.put(("start", job_id, task_id, who, None))
            # the feeder recovers its partition number from this (the
            # engine's analogue of pyspark's TaskContext.partitionId())
            os.environ["TFOS_PARTITION_INDEX"] = str(task_id)
            try:
                t_got = time.perf_counter()
                faults.check("engine.task", job=job_id, task=task_id)
                fn, items, collect, lineage = pickle.loads(blob)
                # the task's hop from the driver: the wait since the
                # previous task ended (its transfer), and its unpickling
                os.environ["TFOS_TASK_RECV_MS"] = \
                    f"{1e3 * (t_got - t_wait):.3f}"
                os.environ["TFOS_TASK_LOADS_MS"] = \
                    f"{1e3 * (time.perf_counter() - t_got):.3f}"
                task_report.clear()
                task_report["lineage_ms"] = []
                # the dispatcher's trace, for the task's records and, on
                # the env, for the processes it forks (a trainer)
                prev = os.environ.get(telemetry.TRACE_ENV)
                if trace is not None:
                    os.environ[telemetry.TRACE_ENV] = trace
                try:
                    with telemetry.activate(trace), telemetry.span(
                            "engine/task", job=job_id, task=task_id):
                        if lineage is not None:
                            items = lineage.run(items,
                                                task_report["lineage_ms"])
                        out = fn(iter(items)) if fn is not None else items
                        # pickled here: an unpicklable result fails this
                        # task, not the results pipe every job shares
                        payload = (pickle.dumps(list(out)) if collect
                                   and out is not None else None)
                finally:
                    if trace is not None:
                        if prev is None:
                            os.environ.pop(telemetry.TRACE_ENV, None)
                        else:
                            os.environ[telemetry.TRACE_ENV] = prev
                results.put(("ok", job_id, task_id, who, payload))
            except BaseException:  # noqa: BLE001 - report any task failure
                results.put(("error", job_id, task_id, who,
                             traceback.format_exc()))
            t_wait = time.perf_counter()
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

class Lineage:
    """A partition's ``map_partitions`` chain: ``fns`` run in order, each
    over the list the one before it returned, and the last one's output
    goes to the job unmaterialised, as the JAX package's composed chain
    does (so a stage that yields in chunks bounds the executor's
    memory)."""

    def __init__(self, fns):
        self.fns = tuple(fns)

    def then(self, fn):
        return Lineage(self.fns + (fn,))

    def run(self, items, stage_ms):
        """An iterator over the last stage's output.  Appends each
        stage's milliseconds to ``stage_ms``; the last stage's entry
        grows with the time spent in its ``next`` as the caller
        consumes the iterator."""
        *parents, last = self.fns
        for fn in parents:
            t0 = time.perf_counter()
            out = fn(iter(items))
            items = [] if out is None else list(out)
            stage_ms.append(1e3 * (time.perf_counter() - t0))
        stage_ms.append(0.0)
        t0 = time.perf_counter()
        out = last(iter(items))
        stage_ms[-1] += 1e3 * (time.perf_counter() - t0)
        return _timed(iter(() if out is None else out), stage_ms)


def _timed(it, stage_ms):
    """``it``'s items, the time spent in each of its ``next`` added to
    ``stage_ms[-1]``."""
    end = object()
    while True:
        t0 = time.perf_counter()
        item = next(it, end)
        stage_ms[-1] += 1e3 * (time.perf_counter() - t0)
        if item is end:
            return
        yield item


class LocalDataset:
    """Partitioned dataset with a lazy ``map_partitions`` lineage: one
    ``(items, Lineage or None)`` task a partition, so a union of
    differently derived datasets keeps each branch's chain."""

    def __init__(self, engine, partitions, tasks=None):
        self._engine = engine
        self._tasks = (list(tasks) if tasks is not None
                       else [(p, None) for p in partitions])

    @property
    def num_partitions(self):
        return len(self._tasks)

    def map_partitions(self, fn):
        """A dataset whose partitions are ``fn(iterator)`` of these,
        computed in the executor when a job runs.  ``fn`` must pickle
        with plain ``pickle``: a module-level function or an instance of
        a module-level class."""
        return LocalDataset(self._engine, None, tasks=[
            (items, Lineage((fn,)) if chain is None else chain.then(fn))
            for items, chain in self._tasks])

    def foreach_partition(self, fn, spread=False, placement=None,
                          retryable=False, max_retries=None):
        """Run ``fn`` over every partition, after its lineage.
        ``placement`` pins task i to executor ``placement[i]``;
        ``spread`` to executor i.

        ``retryable=True`` declares every task idempotent: a failed task
        is retried with backoff (budget ``max_retries``, default
        ``TFOS_TASK_RETRIES``) and a dead executor is respawned with its
        lost tasks re-dispatched, instead of failing the job."""
        self._engine._run_job([(items, fn, chain)
                               for items, chain in self._tasks],
                              collect=False, spread=spread,
                              placement=placement, retryable=retryable,
                              max_retries=max_retries)

    def collect(self, spread=False, retryable=False, max_retries=None,
                placement=None):
        """Every partition's items after its lineage, in partition
        order, through the driver.  ``spread``, ``placement`` and
        ``retryable`` as in :meth:`foreach_partition` (``retryable`` for
        idempotent lineages only)."""
        parts = self._engine._run_job([(items, None, chain)
                                       for items, chain in self._tasks],
                                      collect=True, spread=spread,
                                      placement=placement,
                                      retryable=retryable,
                                      max_retries=max_retries)
        return [x for p in parts for x in (p or [])]

    def union(self, *others):
        tasks = list(self._tasks)
        for o in others:
            tasks.extend(o._tasks)
        return LocalDataset(self._engine, None, tasks=tasks)

    def repartition(self, num_partitions):
        """``num_partitions`` round-robin partitions of every item.  This
        materialises the whole dataset through the driver; for TFRecords
        ``dfutil.load_tfrecords(..., min_partitions=n)`` stripes the
        shard files instead, with nothing through the driver."""
        rows = self.collect()
        n = max(1, min(num_partitions, max(len(rows), 1)))
        logger.info("repartition(%d) materialised %d rows through the "
                    "driver", n, len(rows))
        return LocalDataset(self._engine, [rows[i::n] for i in range(n)])


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
        from the driver's main thread.  ``workdir``: the root of the
        executors' directories, the caller's (kept by :meth:`stop`);
        default a temporary one, removed by :meth:`stop`."""
        if start_method != "spawn":
            raise ValueError(
                f"LocalEngine starts executors with 'spawn' only, got "
                f"{start_method!r}: a forked executor would inherit the "
                "driver's CUDA state, which a child cannot use")
        self.num_executors = int(num_executors)
        self._ctx = mp.get_context("spawn")
        self._env = dict(env) if env else {}
        self._root = workdir or tempfile.mkdtemp(prefix="tfos_engine_")
        self._owns_root = workdir is None
        self._results = self._ctx.Queue()
        # one inbox an executor, read by it alone, and replaced at each
        # respawn: a process killed while it waits in ``get`` keeps the
        # queue's reader lock, so no later reader could take from it.
        # Work any executor may run waits in ``_shared`` on the driver,
        # which hands it to an idle executor's inbox (``_feed_idle``).
        self._inboxes = []
        self._incarnation = []
        self._queued = []    # per slot: (job, task) -> (msg, pinned), unstarted
        self._running = []   # per slot: the (job, task) started, unfinished
        self._shared = collections.deque()
        self._dispatch_lock = threading.Lock()
        self._procs = []
        self._job_counter = 0
        self._job_lock = threading.Lock()
        self._job_queues = {}  # job_id -> local queue (results demux)
        self._cancelled = False
        self._stopped = False
        self.executor_dirs = []
        # supervision of retryable jobs; the mechanisms live in
        # actors.supervise
        self._max_retries = int(os.environ.get("TFOS_TASK_RETRIES", "2"))
        self._retry_backoff = float(os.environ.get("TFOS_RETRY_BACKOFF",
                                                   "0.25"))
        self._budget = _supervise.RespawnBudget(
            int(os.environ.get("TFOS_EXECUTOR_RESPAWNS", "8")),
            what="executor", env_name="TFOS_EXECUTOR_RESPAWNS",
            error_cls=TaskError)
        self._retired = set()  # slots an elastic shrink took out
        self._spawn_lock = threading.Lock()
        # the latest job's dispatch: its tasks, the seconds the driver
        # spent pickling them, the bytes they came to and the largest
        # task's bytes
        self.last_dispatch = None
        with _patched_env(self._env):
            for i in range(self.num_executors):
                d = os.path.join(self._root, f"executor-{i}")
                os.makedirs(d, exist_ok=True)
                self.executor_dirs.append(d)
                self._inboxes.append(self._ctx.Queue())
                self._incarnation.append(0)
                self._queued.append({})
                self._running.append(set())
                self._procs.append(self._spawn_executor(i))
        # concurrent jobs (the node launcher and a feeder) share one
        # results pipe; the pump sorts results by job
        self._pump = threading.Thread(target=self._pump_results,
                                      name="tfos-result-pump", daemon=True)
        self._pump.start()
        atexit.register(self.stop)
        metrics_registry.set_gauge("tfos_engine_executors",
                                   self.num_executors)
        logger.info("LocalEngine started %d executors under %s",
                    self.num_executors, self._root)

    def _spawn_executor(self, index):
        """Start executor ``index``'s process on its inbox and working
        dir."""
        p = self._ctx.Process(
            target=_executor_main,
            args=(index, self._incarnation[index], self.executor_dirs[index],
                  self._inboxes[index], self._results),
            name=f"tfos-executor-{index}",
            # not a daemon: an executor forks the trainer and the IPC
            # manager's server
            daemon=False)
        p.start()
        return p

    @property
    def _respawns(self):
        """Respawns consumed so far."""
        return self._budget.used

    def _respawn_executor(self, index):
        """Replace a dead executor process; True if a respawn happened.
        The dead one's children (IPC-manager server, trainer) are killed
        first, so a relaunched task never meets a half-dead twin, and
        also when the respawn budget is spent, which raises
        ``TaskError``."""
        with self._spawn_lock:
            if self._stopped or self._procs[index].is_alive():
                return False
            if index in self._retired:
                raise TaskError(
                    f"executor {index} is retired (elastic cluster shrink); "
                    "its slot is no longer part of the dispatch pool")
            # its children die with it, also when no respawn follows
            _supervise.reap_orphans([self.executor_dirs[index]],
                                    what=f"child of dead executor {index}")
            self._budget.consume(index)
            with self._dispatch_lock:
                old = self._inboxes[index]
                self._inboxes[index] = self._ctx.Queue()
                self._incarnation[index] += 1
                # started tasks are the jobs' to retry or fail; the
                # unstarted ones of live jobs go to the new incarnation
                # (pinned) or back to the shared queue
                self._running[index].clear()
                queued, self._queued[index] = self._queued[index], {}
                with self._job_lock:
                    live = set(self._job_queues)
                for key, (msg, pinned) in queued.items():
                    if key[0] not in live:
                        continue
                    if pinned:
                        self._queued[index][key] = (msg, True)
                        self._inboxes[index].put(msg)
                    else:
                        self._shared.appendleft(msg)
            with contextlib.suppress(OSError, ValueError):
                old.cancel_join_thread()
                old.close()
            with _patched_env(self._env):
                self._procs[index] = self._spawn_executor(index)
        telemetry.event("engine/executor_respawn", executor=index,
                        respawns=self._budget.used)
        try:  # the flight ring's last seconds; never blocks a respawn
            from tensorflowonspark_tpu_torch.obs import flight

            flight.snapshot("engine/executor_respawn",
                            node=f"executor-{index}",
                            reason=f"respawn {self._budget.used}/"
                                   f"{self._budget.budget}")
        except Exception:  # noqa: BLE001 - dumps are best-effort
            logger.debug("flight snapshot failed", exc_info=True)
        metrics_registry.inc("tfos_engine_respawns_total")
        metrics_registry.set_gauge("tfos_engine_executors",
                                   len(self.alive_executors()))
        self._feed_idle()
        logger.warning("respawned executor %d (%d/%d respawns used)",
                       index, self._budget.used, self._budget.budget)
        return True

    def ensure_executors(self):
        """Respawn every dead executor that is not retired; returns the
        respawned indices.  Cluster recovery heals the pool with it; it
        raises ``TaskError`` once the respawn budget is spent, which an
        elastic recovery (``cluster.run(min_executors=k)``) answers by
        re-forming the cluster over :meth:`alive_executors`."""
        return [i for i, p in enumerate(self._procs)
                if i not in self._retired and not p.is_alive()
                and self._respawn_executor(i)]

    def alive_executors(self):
        """Sorted indices of the executor processes alive now."""
        return sorted(i for i, p in enumerate(self._procs) if p.is_alive())

    def retire_executors(self, indices):
        """Replace the set of slots out of the dispatch pool (an elastic
        shrink): spread jobs skip them and they are never respawned; a
        later ``retire_executors([])`` (the cluster re-grew) restores
        them."""
        self._retired = {int(i) for i in indices}
        telemetry.event("engine/retire", retired=sorted(self._retired))
        self._feed_idle()
        if self._retired:
            logger.warning("engine: retired executor slot(s) %s",
                           sorted(self._retired))

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

    def from_partitions(self, partitions):
        """A dataset of ``partitions`` as given, one list each."""
        return LocalDataset(self, [list(p) for p in partitions])

    def cancel_all_jobs(self):
        """Abort every running and later job."""
        self._cancelled = True

    def _send(self, index, msg, pinned):
        """Put ``msg`` on executor ``index``'s inbox, kept until the
        executor acks its start, so that a respawn hands it on.  Call
        under ``_dispatch_lock``."""
        self._queued[index][(msg[1], msg[2])] = (msg, pinned)
        self._inboxes[index].put(msg)

    def _feed_idle(self):
        """Hand shared-queue tasks, oldest first, to every live slot in
        the pool that has nothing queued or running; a task of a job
        that has ended is dropped."""
        with self._dispatch_lock:
            with self._job_lock:
                live = set(self._job_queues)
            for i, p in enumerate(self._procs):
                if not self._shared:
                    return
                if (i in self._retired or self._queued[i]
                        or self._running[i] or not p.is_alive()):
                    continue
                while self._shared:
                    msg = self._shared.popleft()
                    if msg[1] in live:
                        self._send(i, msg, pinned=False)
                        break

    def _pump_results(self):
        while not self._stopped:
            try:
                item = self._results.get(timeout=0.2)
            except _queue.Empty:
                continue
            except (OSError, EOFError, ValueError):
                break
            except Exception as e:  # noqa: BLE001 - transport corruption
                # results are pickled in the executor, so a bad payload
                # fails only its own task: an error here is the pipe's.
                # Ending the pump would leave every job waiting for good;
                # each in-flight job gets a typed error instead
                logger.exception("result pump error")
                with self._job_lock:
                    queues = list(self._job_queues.values())
                for q in queues:
                    q.put(("pump_error", None, -1, -1,
                           f"result pump transport error: {e!r}", None))
                continue
            status, job_id, task_id, (index, incarnation), payload = item
            key = (job_id, task_id)
            with self._dispatch_lock:
                # a dead incarnation's late answer changes no slot
                if incarnation == self._incarnation[index]:
                    if status == "start":
                        self._queued[index].pop(key, None)
                        self._running[index].add(key)
                    else:
                        self._running[index].discard(key)
            if status != "start":
                self._feed_idle()
            with self._job_lock:
                q = self._job_queues.get(job_id)
            if q is not None:
                q.put((status, job_id, task_id, index, payload, incarnation))

    def _run_job(self, tasks, collect=False, spread=False, placement=None,
                 retryable=False, max_retries=None):
        """Dispatch one ``(items, fn, lineage)`` task per partition; block
        until every task finished.  Returns each partition's result list
        when ``collect``.  A task that fails for good raises
        ``TaskError``: at once unless ``retryable``."""
        if self._cancelled:
            raise TaskError("engine cancelled")
        with self._job_lock:
            self._job_counter += 1
            job_id = self._job_counter
            my_results = _queue.Queue()
            self._job_queues[job_id] = my_results
        try:
            with telemetry.span("engine/job", job=job_id, tasks=len(tasks),
                                spread=bool(spread or placement is not None),
                                retryable=bool(retryable)):
                out = self._run_job_inner(tasks, collect, spread, placement,
                                          job_id, my_results, retryable,
                                          max_retries)
            metrics_registry.inc("tfos_engine_jobs_total", status="ok")
            return out
        except BaseException:
            metrics_registry.inc("tfos_engine_jobs_total", status="error")
            raise
        finally:
            with self._job_lock:
                self._job_queues.pop(job_id, None)

    def _target(self, task_id, spread, placement):
        """The executor a task is pinned to, or None (the shared queue)."""
        if placement is not None and task_id < len(placement):
            return placement[task_id] % self.num_executors
        if spread:
            # retired slots are out of the pool
            pool = [i for i in range(self.num_executors)
                    if i not in self._retired]
            if not pool:
                raise TaskError("all executor slots are retired")
            return pool[task_id % len(pool)]
        return None

    def _run_job_inner(self, tasks, collect, spread, placement, job_id,
                       my_results, retryable=False, max_retries=None):
        # only executors that die during this job fail it
        dead_at_start = {i for i, p in enumerate(self._procs)
                         if not p.is_alive()}
        if max_retries is None:
            max_retries = self._max_retries
        if not retryable:
            max_retries = 0
        # the blobs are kept for the job's life, so that a failed or lost
        # task is re-dispatched byte for byte
        pickle_s = 0.0
        blobs = []
        for part, fn, lineage in tasks:
            t0 = time.perf_counter()
            blobs.append(pickle.dumps((fn, list(part), collect, lineage)))
            pickle_s += time.perf_counter() - t0
        self.last_dispatch = {"tasks": len(tasks), "pickle_s": pickle_s,
                              "bytes": sum(map(len, blobs)),
                              "max_bytes": max(map(len, blobs), default=0)}

        ctx = telemetry.current()
        trace = ctx.to_header() if ctx is not None else None

        def dispatch(task_id):
            msg = ("task", job_id, task_id, blobs[task_id], trace)
            target = self._target(task_id, spread, placement)
            if target is None:
                with self._dispatch_lock:
                    self._shared.append(msg)
                self._feed_idle()
                return
            if not self._procs[target].is_alive():
                if not retryable:
                    raise TaskError(
                        f"cannot place task {task_id} on executor "
                        f"{target}: executor process is dead")
                self._respawn_executor(target)
                dead_at_start.discard(target)
            with self._dispatch_lock:
                self._send(target, msg, pinned=True)

        sched = _supervise.RetrySchedule(max_retries, self._retry_backoff)
        running = {}    # task_id -> (executor, incarnation), start-acked
        retry_at = {}   # task_id -> monotonic re-dispatch time

        def fail_attempt(tid, subject, reason):
            """Count a failed attempt; schedule its re-dispatch after a
            backoff, or raise ``subject``, ``reason`` and the earlier
            attempts' reasons once the task's retries are spent."""
            sched.record_failure(tid, reason)
            metrics_registry.inc("tfos_engine_tasks_total", status="error")
            running.pop(tid, None)
            if sched.exhausted(tid):
                if retryable:
                    telemetry.event("engine/task_poison", job=job_id,
                                    task=tid, attempts=sched.attempt(tid) + 1)
                raise TaskError(sched.permanent_error(tid, subject))
            delay = sched.next_delay(tid)
            retry_at[tid] = time.monotonic() + delay
            telemetry.event("engine/task_retry", job=job_id, task=tid,
                            attempt=sched.attempt(tid),
                            delay_ms=int(delay * 1000))
            metrics_registry.inc("tfos_engine_task_retries_total")
            logger.warning("task %d of job %d failed (attempt %d of %d); "
                           "retrying in %.2fs", tid, job_id,
                           sched.attempt(tid), max_retries + 1, delay)

        for task_id in range(len(tasks)):
            dispatch(task_id)
        results = [None] * len(tasks)
        done = [False] * len(tasks)
        ndone = 0
        while ndone < len(tasks):
            if self._cancelled or self._stopped:
                raise TaskError("engine cancelled" if self._cancelled
                                else "engine stopped")
            now = time.monotonic()
            for tid in [t for t, at in retry_at.items() if at <= now]:
                del retry_at[tid]
                dispatch(tid)
            try:
                status, _, tid, idx, payload, inc = my_results.get(
                    timeout=0.25)
            except _queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if i not in dead_at_start and not p.is_alive()]
                # tasks whose executor died and was respawned already, by
                # another job's loop (jobs share executors): this loop
                # never sees that process dead
                gone = sorted(t for t, (ex, life) in running.items()
                              if ex not in dead
                              and life != self._incarnation[ex])
                if not dead and not gone:
                    continue
                if not retryable:
                    raise TaskError(
                        f"executor(s) {dead or [running[t][0] for t in gone]}"
                        f" died with tasks in flight (job {job_id}, "
                        f"{len(tasks) - ndone} pending); driver scripts must "
                        "guard their entry with if __name__ == '__main__' "
                        "under the spawn start method") from None
                lost = []
                for e in dead:
                    lost += [(t, e) for t, (ex, _) in running.items()
                             if ex == e]
                    self._respawn_executor(e)
                    dead_at_start.discard(e)
                lost += [(t, running[t][0]) for t in gone]
                for t, e in sorted(lost):
                    fail_attempt(t, f"task {t} lost",
                                 f"executor {e} died while running "
                                 f"task {t} (process loss)")
                continue
            if status == "start":
                running[tid] = (idx, inc)
                continue
            if status == "pump_error":
                raise ResultPumpError(payload)
            if done[tid]:
                continue  # a late answer of a superseded attempt
            if status == "error":
                # a job that is not retryable has no retries: the first
                # failure raises, with the task's traceback
                fail_attempt(tid, f"task {tid} failed on executor {idx}",
                             payload)
                continue
            running.pop(tid, None)
            if payload is not None:
                try:
                    results[tid] = pickle.loads(payload)
                except Exception as e:  # noqa: BLE001 - any unpickler error
                    raise ResultPumpError(
                        f"result of task {tid} (job {job_id}) could not be "
                        f"deserialized: {e!r}") from e
            done[tid] = True
            ndone += 1
            metrics_registry.inc("tfos_engine_tasks_total", status="ok")
        return results

    def stop(self):
        """Stop every executor, then kill any child they left behind."""
        if self._stopped:
            return
        self._stopped = True
        for inbox in self._inboxes:
            try:
                inbox.put(("stop",))
            except (OSError, ValueError):
                pass
        # never block interpreter exit on a flush to a dead reader
        for q in (self._results, *self._inboxes):
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
        # the pid ledgers are cleared once swept, so a caller's root is
        # left without them
        _supervise.reap_orphans(self.executor_dirs, what="leftover child")
        # the pump (which sees _stopped), then the queues' feeder threads
        # end: the driver's process outlives its engines (a test run, a
        # long-lived driver), and may fork later
        self._pump.join(timeout=5)
        for q in (self._results, *self._inboxes):
            with contextlib.suppress(OSError, ValueError):
                q.close()
        if self._owns_root:
            shutil.rmtree(self._root, ignore_errors=True)


# ----------------------------------------------------------------------------
# Spark adapter
# ----------------------------------------------------------------------------

class _BarrierRun:
    """A ``foreach_partition`` function under barrier execution: runs
    ``fn`` and yields one item, since a barrier stage ends in an action."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, it):
        self.fn(it)
        return iter([0])


def _identity(it):
    return it


class SparkDataset:
    """An RDD behind the dataset contract.

    ``spread`` and ``placement`` map onto Spark's barrier execution
    (``rdd.barrier()``): every partition is scheduled at once, one a
    free slot.  Spark pins no task to an executor; the node's feeder and
    shutdown tasks find their node by the executor-id file of whichever
    executor they land on, as in the JAX package, so barrier's distinct
    slots are what they need.  ``retryable`` and ``max_retries`` are
    accepted and left to Spark's own task retries
    (``spark.task.maxFailures``)."""

    def __init__(self, rdd):
        self.rdd = rdd

    @property
    def num_partitions(self):
        return self.rdd.getNumPartitions()

    def map_partitions(self, fn):
        return SparkDataset(self.rdd.mapPartitions(fn))

    def foreach_partition(self, fn, spread=False, placement=None,
                          retryable=False, max_retries=None):
        del retryable, max_retries
        if spread or placement is not None:
            self.rdd.barrier().mapPartitions(_BarrierRun(fn)).count()
        else:
            self.rdd.foreachPartition(fn)

    def collect(self, spread=False, retryable=False, max_retries=None,
                placement=None):
        del retryable, max_retries
        if spread or placement is not None:
            return self.rdd.barrier().mapPartitions(_identity).collect()
        return self.rdd.collect()

    def union(self, *others):
        rdd = self.rdd
        for o in others:
            rdd = rdd.union(o.rdd if isinstance(o, SparkDataset) else o)
        return SparkDataset(rdd)

    def repartition(self, num_partitions):
        return SparkDataset(self.rdd.repartition(num_partitions))


class SparkEngine:
    """A pyspark ``SparkContext`` behind the engine contract.  The node
    runtime needs a fixed executor set for a cluster's life, so dynamic
    allocation raises, as in the JAX package."""

    def __init__(self, sc):
        self.sc = sc
        conf = sc.getConf()
        self.num_executors = int(conf.get("spark.executor.instances", "1"))
        if conf.get("spark.dynamicAllocation.enabled",
                    "false").strip().lower() == "true":
            raise RuntimeError(
                "TFCluster requires spark.dynamicAllocation.enabled=false: "
                "executors host long-lived nodes and must not be reclaimed "
                "mid-job")

    @property
    def default_fs(self):
        return self.sc._jsc.hadoopConfiguration().get("fs.defaultFS")

    def parallelize(self, seq, num_partitions=None):
        return SparkDataset(self.sc.parallelize(seq, num_partitions))

    def cancel_all_jobs(self):
        self.sc.cancelAllJobs()

    def stop(self):
        """Nothing: the caller owns the SparkContext."""


def _is_pyspark(obj, name):
    cls = type(obj)
    return cls.__module__.startswith("pyspark") and cls.__name__ == name


def as_dataset(obj):
    """``obj`` as a dataset: a ``LocalDataset`` or ``SparkDataset`` as it
    is, a pyspark RDD wrapped; raises otherwise."""
    if isinstance(obj, (LocalDataset, SparkDataset)):
        return obj
    if _is_pyspark(obj, "RDD"):
        return SparkDataset(obj)
    raise TypeError(f"not a dataset or RDD: {obj!r}")


def as_engine(obj):
    """``obj`` as an engine: a ``LocalEngine`` or ``SparkEngine`` as it
    is, a pyspark ``SparkContext`` wrapped; raises otherwise."""
    if isinstance(obj, (LocalEngine, SparkEngine)):
        return obj
    if _is_pyspark(obj, "SparkContext"):
        return SparkEngine(obj)
    raise TypeError(f"not an engine or SparkContext: {obj!r}")
