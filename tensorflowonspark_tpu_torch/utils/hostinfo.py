"""Host address, executor-id persistence and child-process bookkeeping.

An own copy of the part of ``tensorflowonspark_tpu/utils/hostinfo.py``
that the port's engine, node and feeder call.  The executor-id file is
the key that lets a feeder task, scheduled later onto the same executor,
reattach to the manager the node task started.
"""

from __future__ import annotations

import logging
import os
import signal
import tempfile
import time

logger = logging.getLogger(__name__)

_EXECUTOR_ID_FILE = "executor_id"
_CHILD_PIDS_FILE = "tfos_child_pids"
HOST_IP_ENV = "TFOS_HOST_IP"


def get_ip_address():
    """The address this host advertises to its peers: ``TFOS_HOST_IP``
    when set, else the loopback address.

    The port's only engine is ``LocalEngine``, whose executors all share
    one host, so loopback reaches every peer; a deployment spanning
    hosts sets ``TFOS_HOST_IP``.  (The JAX package discovers the
    address by routing a UDP socket towards a public address; the port
    never names an outside host.)"""
    return os.environ.get(HOST_IP_ENV) or "127.0.0.1"


def write_executor_id(num, cwd=None):
    """Persist this executor's id in its working dir."""
    path = os.path.join(cwd or os.getcwd(), _EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))
    return path


def read_executor_id(cwd=None):
    """Read back the executor id; None if no node task ran here."""
    path = os.path.join(cwd or os.getcwd(), _EXECUTOR_ID_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read())


def child_pids_dir():
    """Directory of this process's child-pid ledger: the executor's
    working dir inside an executor (``TFOS_EXECUTOR_INDEX`` set), where
    the engine's teardown reads it; a per-process temp dir elsewhere."""
    if "TFOS_EXECUTOR_INDEX" in os.environ:
        return os.getcwd()
    return os.path.join(tempfile.gettempdir(), f"tfos-pids-{os.getpid()}")


def track_child_pid(pid, cwd=None):
    """Record a long-lived child of this executor (the IPC manager's
    server, the background trainer), so that the engine's ``stop()`` can
    kill it if the executor dies before it could."""
    base = cwd or child_pids_dir()
    path = os.path.join(base, _CHILD_PIDS_FILE)
    try:
        os.makedirs(base, exist_ok=True)
        with open(path, "a") as f:
            f.write(f"{pid}\n")
    except OSError as e:  # bookkeeping only
        logger.warning("could not record child pid %s: %s", pid, e)
    return path


def read_child_pids(cwd=None):
    """Pids recorded by :func:`track_child_pid` in ``cwd``."""
    path = os.path.join(cwd or child_pids_dir(), _CHILD_PIDS_FILE)
    try:
        with open(path) as f:
            return [int(line) for line in f.read().split()]
    except (OSError, ValueError):
        return []


def clear_child_pids(cwd=None):
    """Forget the child pids recorded for ``cwd``."""
    try:
        os.remove(os.path.join(cwd or child_pids_dir(), _CHILD_PIDS_FILE))
    except OSError:
        pass


def kill_pid(pid, sig=None):
    """Send ``sig`` (default SIGKILL) to pid; True if the signal was sent."""
    try:
        os.kill(pid, signal.SIGKILL if sig is None else sig)
        return True
    except OSError:
        return False


def reap_child(pid, timeout=5.0, term_first=True):
    """Make a direct child exit and collect it: wait up to ``timeout``,
    then SIGTERM, then SIGKILL.  A pid that is not this process's child
    counts as gone once signal 0 fails.  True if it exited."""

    def gone():
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
            return done == pid
        except ChildProcessError:
            return not kill_pid(pid, 0)
        except OSError:
            return True

    def wait(seconds):
        deadline = time.time() + seconds
        while time.time() < deadline:
            if gone():
                return True
            time.sleep(0.05)
        return gone()

    if wait(timeout):
        return True
    if term_first:
        kill_pid(pid, signal.SIGTERM)
        if wait(2.0):
            return True
    kill_pid(pid)
    return wait(2.0)
