"""The dashboard node's TensorBoard.

An own copy of the launcher half of ``tensorflowonspark_tpu/utils/
profiler.py``: ``launch_tensorboard`` starts TensorBoard on a log
directory (port from ``TENSORBOARD_PORT``, else an ephemeral one; the
binary next to the Python executable, on ``PATH``, or the
``tensorboard`` module), and ``stop_tensorboard`` kills it.  A missing
TensorBoard logs a warning and returns ``(None, None)``: the cluster
runs without a dashboard, as in the JAX package.

The trace half (``start_trace``, ``trace``) comes with ROADMAP.md
queue 1, item 21, on ``torch.profiler``.
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import subprocess
import sys
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
