"""What a port test file starts ends with it.

The suite runs many files in one process (an xdist worker runs every
file it is given in turn), and the JAX package's tests fork that
process: a driver-hosted ps node, a manager server.  A thread, a child
process or an environment variable that a port test file left behind
would be inherited by such a fork, or change what a later file sees.
So every ``tests/test_torch_*.py`` imports :func:`module_hygiene`, a
module-scoped autouse fixture: after the file's last test (and after its
own module fixtures, which tear down first) it closes the
``multiprocessing`` queues whose feeder threads the file started (an
engine's, once the engine stopped: the JAX package's ``LocalEngine``
leaves its queues open), waits up to ``GRACE_S`` for the threads and
child processes the file started to end, restores the environment the
file found, and fails if a thread or a child is still alive (the child
is killed first).  multiprocessing's resource tracker, a helper that
lives as long as the process, and children that already exited
(zombies) do not count.
"""

import gc
import multiprocessing.queues
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

GRACE_S = 20.0
IGNORED_ENV = ("PYTEST_CURRENT_TEST",)


def live_children():
    """``{pid: cmdline}`` of this process's children that are alive
    (not zombies), multiprocessing's resource tracker excepted."""
    out = {}
    me = os.getpid()
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me or fields[0] in ("Z", "X"):
                continue
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError, ValueError):
            continue
        if "resource_tracker" not in cmd:
            out[int(name)] = cmd[:120]
    return out


def close_stray_queues(threads_before):
    """Close every ``multiprocessing`` queue whose feeder thread started
    after the snapshot and still runs; returns how many."""
    closed = 0
    for obj in gc.get_objects():
        # type(), not isinstance: a lazy module attribute warns when
        # its __class__ is read
        if not issubclass(type(obj), multiprocessing.queues.Queue):
            continue
        feeder = getattr(obj, "_thread", None)
        if feeder is not None and feeder.is_alive() and \
                feeder.ident not in threads_before:
            try:
                obj.close()
                closed += 1
            except (OSError, ValueError):
                pass
    return closed


def leftovers(threads_before, children_before, grace_s=GRACE_S):
    """The threads and children started since the snapshot that are
    still alive after up to ``grace_s`` seconds:
    ``([thread names], {pid: cmdline})``."""
    deadline = time.monotonic() + grace_s
    while True:
        threads = [t for t in threading.enumerate()
                   if t.ident not in threads_before and t.is_alive()
                   and t is not threading.current_thread()]
        children = {p: c for p, c in live_children().items()
                    if p not in children_before}
        if (not threads and not children) or time.monotonic() > deadline:
            return sorted(t.name for t in threads), children
        time.sleep(0.1)


def restore_env(saved):
    """``os.environ`` back to ``saved`` (``IGNORED_ENV`` aside)."""
    for key in set(os.environ) - set(saved):
        if key not in IGNORED_ENV:
            del os.environ[key]
    for key, value in saved.items():
        if key not in IGNORED_ENV and os.environ.get(key) != value:
            os.environ[key] = value


@pytest.fixture(scope="module", autouse=True)
def module_hygiene(request):
    threads = {t.ident for t in threading.enumerate()}
    children = set(live_children())
    env = dict(os.environ)
    yield
    close_stray_queues(threads)
    names, kids = leftovers(threads, children)
    restore_env(env)
    for pid in kids:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    if names or kids:
        pytest.fail(f"{request.module.__name__} left running: threads "
                    f"{names}, child processes {kids}")


# -- the helpers themselves -----------------------------------------------

def test_a_thread_left_running_is_found_and_an_ended_one_is_not():
    before = {t.ident for t in threading.enumerate()}
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="hygiene-probe",
                         daemon=True)
    t.start()
    try:
        names, kids = leftovers(before, set(live_children()), grace_s=0.3)
        assert names == ["hygiene-probe"] and kids == {}
    finally:
        stop.set()
        t.join(5)
    assert leftovers(before, set(live_children()), grace_s=5) == ([], {})


def test_a_child_left_running_is_found_and_a_reaped_one_is_not():
    before = set(live_children())
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"])
    try:
        names, kids = leftovers({t.ident for t in threading.enumerate()},
                                before, grace_s=0.3)
        assert list(kids) == [p.pid] and "time.sleep(60)" in kids[p.pid]
    finally:
        p.kill()
        p.wait(10)
    assert p.pid not in live_children()


def test_a_queue_left_open_is_closed_and_its_feeder_ends():
    import multiprocessing as mp

    before = {t.ident for t in threading.enumerate()}
    q = mp.get_context("spawn").Queue()
    q.put("x")
    q.cancel_join_thread()
    assert leftovers(before, set(live_children()), grace_s=0.3)[0] == \
        ["QueueFeederThread"]
    assert close_stray_queues(before) == 1
    assert leftovers(before, set(live_children()), grace_s=5) == ([], {})


def test_restore_env_undoes_additions_changes_and_removals(monkeypatch):
    monkeypatch.setenv("TFOS_HYGIENE_KEPT", "a")
    monkeypatch.setenv("TFOS_HYGIENE_GONE", "b")
    saved = dict(os.environ)
    os.environ["TFOS_HYGIENE_ADDED"] = "c"
    os.environ["TFOS_HYGIENE_KEPT"] = "changed"
    del os.environ["TFOS_HYGIENE_GONE"]
    restore_env(saved)
    assert "TFOS_HYGIENE_ADDED" not in os.environ
    assert os.environ["TFOS_HYGIENE_KEPT"] == "a"
    assert os.environ["TFOS_HYGIENE_GONE"] == "b"
