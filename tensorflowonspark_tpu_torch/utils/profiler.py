"""The dashboard node's TensorBoard, and trace captures.

An own copy of ``tensorflowonspark_tpu/utils/profiler.py``.
``launch_tensorboard`` starts TensorBoard on a log directory (port from
``TENSORBOARD_PORT``, else an ephemeral one; the binary next to the
Python executable, on ``PATH``, or the ``tensorboard`` module), and
``stop_tensorboard`` kills it.  A missing TensorBoard logs a warning and
returns ``(None, None)``: the cluster runs without a dashboard, as in
the JAX package.

``start_trace`` / ``stop_trace`` / ``trace(log_dir)`` capture a trace
with ``torch.profiler``: CPU activity, and CUDA activity (every kernel
and copy on the card, through CUPTI, whichever thread launched it) when
this process holds a CUDA context.  ``stop_trace`` writes the capture
into ``log_dir`` as a Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``
(the name ``tensorboard_trace_handler`` gives, which TensorBoard's
profiler plugin and Perfetto read), where the JAX package writes an XLA
xplane under ``plugins/profile/``.  CPU ops are recorded on the thread
that started the capture only, so a capture started on another thread
than the train loop's (the obs publisher's ``profile`` directive) holds
the device side of the step.  A capture that cannot start (no
``torch.profiler``, or one already running: one capture at a time in a
process) warns once and returns False; no entry point raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

logger = logging.getLogger(__name__)


def _find_tensorboard():
    """The command that starts TensorBoard, or None: the executable next
    to this Python's, then one on ``PATH``, then ``python -m
    tensorboard.main`` when the module is importable."""
    candidates = [os.path.join(os.path.dirname(sys.executable),
                               "tensorboard"),
                  shutil.which("tensorboard")]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return [c]
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        return None
    return [sys.executable, "-m", "tensorboard.main"]


def launch_tensorboard(log_dir, port=None):
    """Start TensorBoard on ``log_dir``; returns ``(process, port)``, or
    ``(None, None)`` when none is installed or it exits at once."""
    cmd = _find_tensorboard()
    if not cmd:
        logger.warning("tensorboard not found; dashboard disabled")
        return None, None
    if port is None:
        if os.environ.get("TENSORBOARD_PORT"):
            port = int(os.environ["TENSORBOARD_PORT"])
        else:
            with socket.socket() as s:
                s.bind(("", 0))
                port = s.getsockname()[1]
    os.makedirs(log_dir, exist_ok=True)
    tb_log = os.path.join(log_dir, "tensorboard.log")
    with open(tb_log, "ab") as sink:
        proc = subprocess.Popen(
            cmd + ["--logdir", log_dir, "--port", str(port), "--bind_all"],
            stdout=sink, stderr=sink)
    # an ephemeral port can be taken between its release and the child's
    # bind, and a broken install dies at once: advertise no dashboard
    # that is not running
    time.sleep(1.0)
    if proc.poll() is not None:
        logger.warning("tensorboard exited at once (rc=%s); see %s",
                       proc.returncode, tb_log)
        return None, None
    logger.info("TensorBoard pid=%d port=%d logdir=%s", proc.pid, port,
                log_dir)
    return proc, port


def stop_tensorboard(proc):
    """Kill a TensorBoard that :func:`launch_tensorboard` started."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


# the running capture: (profile object, log_dir), under _TRACE_LOCK
_TRACE = {"prof": None, "dir": None, "last": None}
_TRACE_LOCK = threading.Lock()
_degraded_warned = False


def _warn_unavailable(err):
    global _degraded_warned
    if not _degraded_warned:
        logger.warning("torch profiler capture unavailable (%s); trace is "
                       "a no-op", err)
        _degraded_warned = True
    else:
        logger.debug("torch profiler capture unavailable: %s", err)


def start_trace(log_dir):
    """Begin a ``torch.profiler`` capture whose trace goes to
    ``log_dir``.  True when a capture started; False (warned once) when
    none can, among them while another capture runs."""
    with _TRACE_LOCK:
        if _TRACE["prof"] is not None:
            _warn_unavailable(f"a capture into {_TRACE['dir']} is running")
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            _warn_unavailable(e)
            return False
        _TRACE.update(prof=prof, dir=log_dir)
        return True


def stop_trace():
    """End the running capture and write its Chrome trace into the
    ``log_dir`` it started with; True on success (never raises)."""
    with _TRACE_LOCK:
        prof, log_dir = _TRACE["prof"], _TRACE["dir"]
        _TRACE.update(prof=None, dir=None)
        if prof is None:
            _warn_unavailable("no capture is running")
            return False
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(
                log_dir, f"{socket.gethostname()}_{os.getpid()}."
                         f"{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            _warn_unavailable(e)
            return False
        _TRACE["last"] = path
        return True


def last_trace():
    """The file the latest successful :func:`stop_trace` wrote, or
    None."""
    return _TRACE["last"]


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """``with profiler.trace(log_dir): step(...)``: the body always runs;
    the capture is skipped when disabled or unavailable."""
    if not enabled:
        yield
        return
    started = start_trace(log_dir)
    try:
        yield
    finally:
        if started:
            stop_trace()
