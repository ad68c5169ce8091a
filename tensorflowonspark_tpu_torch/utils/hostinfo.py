"""Host address, executor-id persistence and child-process bookkeeping.

An own copy of ``tensorflowonspark_tpu/utils/hostinfo.py``: what the
port's engine, node, feeder and ``parallel_run`` call.  The executor-id
file is the key that lets a feeder task, scheduled later onto the same
executor, reattach to the manager the node task started.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import subprocess
import tempfile
import time

logger = logging.getLogger(__name__)

_EXECUTOR_ID_FILE = "executor_id"
_CHILD_PIDS_FILE = "tfos_child_pids"
HOST_IP_ENV = "TFOS_HOST_IP"
CHILD_PIDS_DIR_ENV = "TFOS_CHILD_PIDS_DIR"
CLASSPATH_FLAG_ENV = "TFOS_CLASSPATH_UPDATED"
ROUTE_PROBE_ADDR = "192.0.2.1"  # TEST-NET-1: only a route lookup


def get_ip_address():
    """The address this host advertises to its peers: ``TFOS_HOST_IP``
    when set, else the source address of this host's route out, as the
    JAX package finds it (a UDP socket's ``connect``, which sends no
    packet), else the loopback address when there is no route.

    The route is asked for ``ROUTE_PROBE_ADDR``, an address of the block
    reserved for documentation (RFC 5737), which no host owns: like any
    address outside the host's own networks it takes the default
    route."""
    override = os.environ.get(HOST_IP_ENV)
    if override:
        return override
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((ROUTE_PROBE_ADDR, 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


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
    """Directory of this process's child-pid ledger:
    ``TFOS_CHILD_PIDS_DIR`` when set; else the executor's working dir
    inside an executor (``TFOS_EXECUTOR_INDEX`` set), where the engine's
    teardown reads it; a per-process temp dir elsewhere."""
    override = os.environ.get(CHILD_PIDS_DIR_ENV)
    if override:
        return override
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


def single_node_env(num_gpus=0, worker_index=-1):
    """Set up a single-node job's environment: claim ``num_gpus`` GPUs
    for worker ``worker_index`` (``gpu_info.claim_gpus``, which calls no
    CUDA), then, once a process (``TFOS_CLASSPATH_UPDATED``), append
    ``$HADOOP_PREFIX/bin/hadoop classpath --glob`` to ``CLASSPATH`` when
    that script exists, for ``hdfs://`` paths read through
    ``recordio.fs``.  Returns the claimed GPUs."""
    from tensorflowonspark_tpu_torch import gpu_info

    gpus = gpu_info.claim_gpus(num_gpus, worker_index)
    if "HADOOP_PREFIX" in os.environ and \
            CLASSPATH_FLAG_ENV not in os.environ:
        hadoop = os.path.join(os.environ["HADOOP_PREFIX"], "bin", "hadoop")
        if os.path.exists(hadoop):
            extra = subprocess.check_output(
                [hadoop, "classpath", "--glob"]).decode()
            os.environ["CLASSPATH"] = (os.environ.get("CLASSPATH", "")
                                       + os.pathsep + extra)
        os.environ[CLASSPATH_FLAG_ENV] = "1"
    return gpus
