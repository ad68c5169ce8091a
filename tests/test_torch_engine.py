"""PyTorch port, the engine's retryable jobs on the CPU (the supervision
the serving replicas run under), as the JAX package's
tests/test_supervision.py has them:

- a failed retryable task is retried, and its retry succeeds;
- a dead executor is respawned and its task re-dispatched from the kept
  blob, the job then completing;
- a task that fails past its budget raises ``TaskError`` with every
  attempt's reason, and a job losing an executor past the respawn
  budget raises too;
- a job that is not retryable still fails at the first task error or
  executor death;
- shared-queue jobs from six driver threads at once each get every item
  back exactly once (the driver's hand-off to idle executors);
- a results pipe that raises, or a result the driver cannot unpickle,
  fails the job with ``ResultPumpError`` and the next job runs, on the
  port's engine and on the JAX package's alike.

No wait here is on the wall clock: the tasks signal through files and
the test waits on those conditions with a hang guard (``HANG``)."""

import os
import pickle
import threading
import time

import pytest

pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

from tensorflowonspark_tpu_torch.engine import (  # noqa: E402
    LocalEngine,
    ResultPumpError,
    TaskError,
)

HANG = 120


class FailFirst:
    """Fails the first attempt of each partition (a marker file per
    partition in ``d``), then returns its items doubled."""

    def __init__(self, d):
        self.d = d

    def __call__(self, it):
        part = os.environ["TFOS_PARTITION_INDEX"]
        mark = os.path.join(self.d, f"tried-{part}")
        if not os.path.exists(mark):
            open(mark, "w").close()
            raise RuntimeError(f"first attempt of partition {part}")
        return [2 * x for x in it]


class AlwaysFail:
    def __call__(self, it):
        raise ValueError("poison task")


class BlockFirst:
    """The first attempt of each partition writes ``started-<p>`` with
    its pid and blocks until ``release`` exists; later attempts return
    their items at once."""

    def __init__(self, d):
        self.d = d

    def __call__(self, it):
        part = os.environ["TFOS_PARTITION_INDEX"]
        mark = os.path.join(self.d, f"started-{part}")
        if not os.path.exists(mark):
            with open(mark, "w") as f:
                f.write(str(os.getpid()))
            while not os.path.exists(os.path.join(self.d, "release")):
                time.sleep(0.02)
        return list(it)


def _wait_file(path):
    deadline = time.monotonic() + HANG
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"hang guard: {path}"
        time.sleep(0.02)


@pytest.fixture()
def engine(monkeypatch):
    monkeypatch.setenv("TFOS_RETRY_BACKOFF", "0.01")
    e = LocalEngine(2, env={"OMP_NUM_THREADS": "1"})
    yield e
    e.stop()


def test_failed_retryable_task_is_retried(engine, tmp_path):
    out = engine.parallelize(range(6), 3).map_partitions(
        FailFirst(str(tmp_path))).collect(retryable=True, max_retries=2)
    assert out == [0, 2, 4, 6, 8, 10]
    assert sorted(os.listdir(tmp_path)) == ["tried-0", "tried-1", "tried-2"]
    assert engine._respawns == 0


def test_dead_executor_is_respawned_and_its_task_redispatched(engine,
                                                              tmp_path):
    d = str(tmp_path)
    results, errors = [], []

    def job():
        try:
            results.extend(engine.parallelize(range(4), 2).map_partitions(
                BlockFirst(d)).collect(spread=True, retryable=True))
        except TaskError as e:  # pragma: no cover - asserted below
            errors.append(e)

    t = threading.Thread(target=job)
    t.start()
    _wait_file(os.path.join(d, "started-1"))
    _wait_file(os.path.join(d, "started-0"))
    proc = engine._procs[1]
    victim = proc.pid
    with open(os.path.join(d, "started-1")) as f:
        assert int(f.read()) == victim
    os.kill(victim, 9)
    proc.join(HANG)  # dead before task 0 is released
    open(os.path.join(d, "release"), "w").close()
    t.join(HANG)
    assert not t.is_alive(), "job hung after the executor kill"
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    assert engine._respawns == 1
    assert engine._procs[1].pid != victim
    assert all(p.is_alive() for p in engine._procs)
    assert engine.ensure_executors() == []  # nothing left to heal


def test_retry_budget_exhaustion_raises_every_attempt(engine):
    with pytest.raises(TaskError) as ei:
        engine.parallelize([1], 1).foreach_partition(
            AlwaysFail(), retryable=True, max_retries=2)
    msg = str(ei.value)
    assert "poison task" in msg and "permanent after 3 attempts" in msg


def test_respawn_budget_exhaustion_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("TFOS_EXECUTOR_RESPAWNS", "0")
    eng = LocalEngine(1, env={"OMP_NUM_THREADS": "1"})
    try:
        d = str(tmp_path)
        errors = []

        def job():
            try:
                eng.parallelize([1], 1).foreach_partition(
                    BlockFirst(d), spread=True, retryable=True)
            except TaskError as e:
                errors.append(e)

        t = threading.Thread(target=job)
        t.start()
        _wait_file(os.path.join(d, "started-0"))
        os.kill(eng._procs[0].pid, 9)
        t.join(HANG)
        assert not t.is_alive()
        assert errors and "respawn budget" in str(errors[0])
        assert "TFOS_EXECUTOR_RESPAWNS=0" in str(errors[0])
    finally:
        eng.stop()


def test_job_that_is_not_retryable_fails_fast(engine, tmp_path):
    with pytest.raises(TaskError, match="first attempt of partition 0"):
        engine.parallelize([1], 1).foreach_partition(FailFirst(str(tmp_path)))
    assert os.listdir(tmp_path) == ["tried-0"]  # no second attempt
    d = str(tmp_path / "kill")
    os.makedirs(d)
    errors = []

    def job():
        try:
            engine.parallelize([1], 1).foreach_partition(BlockFirst(d),
                                                         spread=True)
        except TaskError as e:
            errors.append(e)

    t = threading.Thread(target=job)
    t.start()
    _wait_file(os.path.join(d, "started-0"))
    os.kill(engine._procs[0].pid, 9)
    t.join(HANG)
    assert not t.is_alive()
    assert errors and "died with tasks in flight" in str(errors[0])
    assert engine._respawns == 0


def _tagged(it):
    """Each item with the executor that ran it."""
    return [(x, int(os.environ["TFOS_EXECUTOR_INDEX"])) for x in it]


def test_concurrent_shared_jobs_run_each_task_once():
    """The driver hands shared-queue tasks to idle executors from several
    threads at once (the jobs' and the result pump's): six jobs of eight
    partitions from six threads, a tiny switch interval, and every job
    gets each of its items back exactly once, from executors that ran
    one task at a time."""
    import sys

    engine = LocalEngine(3, env={"OMP_NUM_THREADS": "1"})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    out, errors = {}, []

    def job(j):
        try:
            items = list(range(100 * j, 100 * j + 16))
            out[j] = engine.parallelize(items, 8).map_partitions(
                _tagged).collect()
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    try:
        threads = [threading.Thread(target=job, args=(j,)) for j in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HANG)
        assert not any(t.is_alive() for t in threads), "a job hung"
    finally:
        sys.setswitchinterval(old)
        engine.stop()
    assert not errors, errors
    for j, got in out.items():
        assert [x for x, _ in got] == list(range(100 * j, 100 * j + 16))
        assert {e for _, e in got} <= {0, 1, 2}
    assert len(out) == 6


# -- a caller's root and partitions as given ----------------------------------

class TrackChild:
    """Start a sleeping child of the executor and record it in the
    executor's pid ledger, with ``pkg``'s helper, as a node records its
    trainer; returns the child's pid."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __call__(self, it):
        import importlib
        import subprocess
        import sys

        list(it)
        utils = importlib.import_module(f"{self.pkg}.utils")
        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
        utils.track_child_pid(p.pid)
        return [p.pid]


def _part_items(it):
    return [(int(os.environ["TFOS_PARTITION_INDEX"]), list(it))]


def _gone(pid):
    """True once ``pid`` is dead (absent, or a zombie awaiting its reaper),
    within the hang guard."""
    deadline = time.monotonic() + HANG
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] in ("Z", "X"):
                    return True
        except OSError:
            return True
        time.sleep(0.05)
    return False


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, dirs, files in os.walk(root) for n in dirs + files)


def _engine_of(pkg, n, **kw):
    if pkg == "jax":
        from tensorflowonspark_tpu.engine import LocalEngine as JaxEngine

        return JaxEngine(n, **kw)
    return LocalEngine(n, env={"OMP_NUM_THREADS": "1"}, **kw)


def test_workdir_is_kept_without_pid_droppings_as_in_jax(tmp_path):
    """``LocalEngine(workdir=)``: the executors work under the caller's
    root, which ``stop()`` keeps; the children an executor recorded are
    killed and its pid ledger is swept, so the root holds what the JAX
    engine's holds after the same job: the executors' empty dirs."""
    left = {}
    for pkg in ("tensorflowonspark_tpu_torch", "tensorflowonspark_tpu"):
        root = tmp_path / pkg
        eng = _engine_of("jax" if pkg == "tensorflowonspark_tpu" else pkg, 2,
                         workdir=str(root))
        try:
            pids = eng.parallelize(range(2), 2).map_partitions(
                TrackChild(pkg)).collect(spread=True)
            assert any(n == "tfos_child_pids" for n in
                       (os.path.basename(p) for p in _tree(root))), \
                _tree(root)
        finally:
            eng.stop()
        assert root.is_dir()
        assert all(_gone(p) for p in pids), pids
        left[pkg] = _tree(root)
    assert left["tensorflowonspark_tpu_torch"] == \
        left["tensorflowonspark_tpu"] == ["executor-0", "executor-1"]
    # without a workdir the engine's own root goes with it
    eng = LocalEngine(1, env={"OMP_NUM_THREADS": "1"})
    root = eng._root
    eng.stop()
    assert not os.path.exists(root)


def test_from_partitions_keeps_the_partitions_as_jax_does():
    parts = [[1, 2, 3], [], [4], ["a", "b"]]
    got = {}
    for pkg in ("torch", "jax"):
        eng = _engine_of(pkg, 2)
        try:
            ds = eng.from_partitions(parts)
            got[pkg] = (ds.num_partitions,
                        sorted(ds.map_partitions(_part_items).collect()))
        finally:
            eng.stop()
    assert got["torch"] == got["jax"] == (4, list(enumerate(parts)))


class _PipeFault:
    """An engine's results-pipe ``get`` that raises
    ``pickle.UnpicklingError`` once, at the first call made while a job
    is in flight, and otherwise reads the pipe."""

    def __init__(self, eng):
        self.eng, self.get, self.fired = eng, eng._results.get, False

    def __call__(self, *args, **kwargs):
        if not self.fired and self.eng._job_queues:
            self.fired = True
            raise pickle.UnpicklingError("injected: corrupt results pipe")
        return self.get(*args, **kwargs)


def _only_in(pid):
    """Unpickles only in process ``pid``."""
    if os.getpid() != pid:
        raise pickle.UnpicklingError(f"unpicklable outside {pid}")
    return pid


class _ExecutorOnly:
    """A result that pickles in the executor and unpickles there, but not
    in the driver."""

    def __init__(self):
        self.pid = os.getpid()

    def __reduce__(self):
        return _only_in, (self.pid,)


def _executor_only(it):
    obj = _ExecutorOnly()
    pickle.loads(pickle.dumps(obj))  # fine where it was made
    return [obj]


def _pump_error_classes(pkg):
    """(ResultPumpError, TaskError) of the port's or the JAX engine."""
    if pkg == "torch":
        return ResultPumpError, TaskError
    from tensorflowonspark_tpu import engine as jax_engine

    return jax_engine.ResultPumpError, jax_engine.TaskError


def _job_error(fn, bound=30):
    """What ``fn()`` raises, on a thread, within ``bound`` seconds."""
    got = {}

    def run():
        try:
            got["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - the test reads it
            got["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(bound)
    assert not t.is_alive(), f"the job still waits after {bound} s"
    return got.get("error"), got.get("out")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_results_pipe_error_fails_the_job_with_result_pump_error(
        pkg, tmp_path):
    """The results pipe raises ``pickle.UnpicklingError`` once while a job
    runs: the job raises ``ResultPumpError`` (a ``TaskError``) within the
    bound instead of waiting for good, the pump keeps running, and the
    next job returns its items, on both engines (JAX:
    ``engine.py:518-545``, ``:691-692``)."""
    eng = _engine_of(pkg, 1)
    cls, task_error = _pump_error_classes(pkg)
    try:
        eng._results.get = fault = _PipeFault(eng)
        d = str(tmp_path)
        error, _ = _job_error(lambda: eng.parallelize(range(3), 1)
                              .map_partitions(BlockFirst(d)).collect())
        assert fault.fired
        assert isinstance(error, cls) and isinstance(error, task_error), \
            repr(error)
        assert "result pump transport error" in str(error)
        assert "injected: corrupt results pipe" in str(error)
        open(os.path.join(d, "release"), "w").close()
        error, out = _job_error(lambda: eng.parallelize(range(4), 2)
                                .map_partitions(_part_items).collect())
        assert error is None, repr(error)
        assert sorted(out) == [(0, [0, 1]), (1, [2, 3])]
    finally:
        eng.stop()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_result_the_driver_cannot_unpickle_raises_result_pump_error(pkg):
    """A task's result pickles and unpickles in its executor but not in
    the driver: the job raises ``ResultPumpError`` naming the task (not
    the unpickler's own error), and the next job runs (JAX:
    ``engine.py:703-709``)."""
    eng = _engine_of(pkg, 1)
    cls, _ = _pump_error_classes(pkg)
    try:
        error, _ = _job_error(lambda: eng.parallelize(range(2), 1)
                              .map_partitions(_executor_only).collect())
        assert isinstance(error, cls), repr(error)
        assert "result of task 0" in str(error)
        assert "could not be deserialized" in str(error)
        assert isinstance(error.__cause__, pickle.UnpicklingError)
        error, out = _job_error(lambda: eng.parallelize(range(2), 1)
                                .map_partitions(_part_items).collect())
        assert error is None and out == [(0, [0, 1])], repr(error)
    finally:
        eng.stop()
