"""GPU discovery and per-worker claim.

Counterpart of ``tensorflowonspark_tpu/tpu_info.py`` (itself the TPU
version of the reference's ``gpu_info.py``): which GPUs this process
may use, and which of them this worker takes, exported as
``CUDA_VISIBLE_DEVICES`` before the trainer touches CUDA.

Importing this module and claiming GPUs call nothing of
``torch.cuda``: the node task claims GPUs in the executor process, which
then forks the trainer, and a forked child cannot use CUDA if its parent
created a CUDA context.  The GPUs are counted with ``nvidia-smi
--list-gpus`` (or ``TFOS_GPUS_PER_HOST``, which tests set to fake a
count).  The trainer's first CUDA call is :func:`slice_health`'s probe,
which ``TFNodeContext.torch_initialize`` runs on a bounded thread.

The claim follows ``tpu_info.claim_chips``' decision table:

1. the scheduler first: a Spark 3 task's ``TaskContext.resources()``
   addresses under ``gpu``, ``tpu`` or ``accelerator`` win when present
   (cut to ``num_gpus`` when the caller asked for fewer);
2. otherwise, for an explicit request, the host: same-host worker ``i``
   takes the ``i``-th contiguous block of ``num_gpus`` GPUs out of those
   the executor was given (the entries of the ``CUDA_VISIBLE_DEVICES``
   it inherited, or every GPU of the host when it inherited none), but
   not inside a Spark-on-K8s pod, where device plugins may advertise
   GPUs to pods without them;
3. a request that cannot be met raises ``RuntimeError``.
"""

from __future__ import annotations

import copy
import logging
import os
import subprocess
import threading
import time

logger = logging.getLogger(__name__)

COUNT_ENV = "TFOS_GPUS_PER_HOST"
MASK_ENV = "CUDA_VISIBLE_DEVICES"
# the executor's own mask, kept at its first claim, so that a later
# cluster on the same executor claims from it and not from the previous
# claim; NO_MASK stands for "inherited none"
INHERITED_ENV = "TFOS_INHERITED_CUDA_VISIBLE_DEVICES"
NO_MASK = "<unset>"
# Spark resource names that may carry this task's accelerator addresses
RESOURCE_NAMES = ("gpu", "tpu", "accelerator")
HEALTH_TIMEOUT_ENV = "TFOS_SLICE_HEALTH_TIMEOUT"
HEALTH_TIMEOUT_S = 60.0  # the probe's bound, unless the env says
# a peer-count wait outlives the caller's bound by this much, so that the
# caller's join, not the wait, ends a probe that waits on a silent peer
_STORE_WAIT_MARGIN_S = 1.0


def count_gpus():
    """GPUs on this host: ``TFOS_GPUS_PER_HOST`` if set, else the lines
    of ``nvidia-smi --list-gpus`` (0 when nvidia-smi is missing or
    fails).  ``nvidia-smi`` ignores ``CUDA_VISIBLE_DEVICES``: this is
    the physical count."""
    override = os.environ.get(COUNT_ENV)
    if override:
        return int(override)
    try:
        out = subprocess.run(["nvidia-smi", "--list-gpus"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def visible_gpus():
    """The GPUs this executor was given, as ``CUDA_VISIBLE_DEVICES``
    entries: those of the mask it inherited (indices as ints, UUIDs as
    strings), or every GPU of the host by index without one."""
    mask = os.environ.get(INHERITED_ENV, os.environ.get(MASK_ENV, NO_MASK))
    if mask == NO_MASK:
        return list(range(count_gpus()))
    entries = [e.strip() for e in mask.split(",") if e.strip()]
    return [int(e) if e.isdigit() else e for e in entries]


def is_k8s():
    """True inside a Spark-on-K8s executor pod."""
    return "SPARK_EXECUTOR_POD_IP" in os.environ


def _has_spark_resource_api():
    """True when a pyspark 3 ``TaskContext`` with ``resources()`` is
    importable."""
    try:
        from pyspark import TaskContext
    except ImportError:
        return False
    return hasattr(TaskContext, "resources")


def _task_resources():
    """``{resource name: [addresses]}`` from the scheduler's task
    context, or None outside a Spark 3 task."""
    if not _has_spark_resource_api():
        return None
    from pyspark import TaskContext

    context = TaskContext.get()
    if context is None:
        return None
    return {name: list(info.addresses)
            for name, info in (context.resources() or {}).items()}


def get_gpus(num_gpus, worker_index=-1):
    """The ``num_gpus`` GPUs worker ``worker_index`` takes out of
    :func:`visible_gpus`: the first block without an index, else the
    index's block.  Raises when too few are visible."""
    if num_gpus <= 0:
        return []
    available = visible_gpus()
    base = 0 if worker_index < 0 else worker_index * num_gpus
    if base + num_gpus > len(available):
        raise RuntimeError(
            f"unable to allocate {num_gpus} GPU(s): worker {worker_index} "
            f"needs entries [{base}, {base + num_gpus}) of the "
            f"{len(available)} visible, {available}")
    gpus = available[base:base + num_gpus]
    logger.info("claimed GPUs %s (worker_index=%d, visible %s)", gpus,
                worker_index, available)
    return gpus


def claim_gpus(num_gpus=0, worker_index=-1):
    """Claim GPUs for this process by the module's decision table and
    export them as ``CUDA_VISIBLE_DEVICES``; returns their ids (possibly
    []).  With no scheduler resources, ``num_gpus=0`` claims nothing and
    leaves the environment as it is."""
    requested = num_gpus > 0
    gpus = []
    resources = _task_resources()
    if resources:
        for name in RESOURCE_NAMES:
            if resources.get(name):
                gpus = [str(a) for a in resources[name]]
                logger.info("scheduler %s resources: %s", name, gpus)
                break
        if gpus and requested and num_gpus < len(gpus):
            logger.warning("requested %d GPU(s), the scheduler assigned "
                           "%d; taking the first %d", num_gpus, len(gpus),
                           num_gpus)
            gpus = gpus[:num_gpus]
    if not gpus and requested and not is_k8s():
        os.environ.setdefault(INHERITED_ENV,
                              os.environ.get(MASK_ENV, NO_MASK))
        gpus = get_gpus(num_gpus, worker_index)
    if requested and len(gpus) < num_gpus:
        raise RuntimeError(f"unable to allocate {num_gpus} GPU(s); the "
                           f"scheduler and the host offered {gpus}")
    if gpus:
        os.environ[MASK_ENV] = ",".join(str(g) for g in gpus)
    return gpus


def local_device_info():
    """``[{"id", "platform", "kind"}]`` for the CUDA devices this process
    sees, or ``[]`` without CUDA or on any error (best-effort, as the
    JAX package's ``tpu_info.local_device_info``).  Calls ``torch.cuda``:
    not for an executor that forks a trainer."""
    try:
        import torch

        return [{"id": i, "platform": "gpu",
                 "kind": torch.cuda.get_device_name(i)}
                for i in range(torch.cuda.device_count())]
    except Exception as e:  # noqa: BLE001 - discovery is best-effort
        logger.debug("no CUDA device info: %s", e)
        return []


def _health_timeout():
    """``TFOS_SLICE_HEALTH_TIMEOUT`` in seconds; nan, 0, negative and
    garbage fall back to 60 with a warning."""
    try:
        timeout = float(os.environ.get(HEALTH_TIMEOUT_ENV,
                                       HEALTH_TIMEOUT_S))
    except ValueError:
        timeout = float("nan")
    if not (timeout > 0):  # rejects nan, 0, negatives
        logger.warning("bad %s=%r; using %g", HEALTH_TIMEOUT_ENV,
                       os.environ.get(HEALTH_TIMEOUT_ENV), HEALTH_TIMEOUT_S)
        timeout = HEALTH_TIMEOUT_S
    return timeout


def _local_devices(want, local_rank=None):
    """The devices the probe checks for a request of ``want``: on CUDA
    (none without it) the device ``want`` names, else the one a
    ``local_rank`` takes (``local_rank`` modulo the visible count), else
    every visible one; ``[want]`` on the CPU.  The process's first CUDA
    contact when ``want`` is CUDA."""
    import torch

    if want.type != "cuda":
        return [want]
    if not torch.cuda.is_available():
        return []
    n = torch.cuda.device_count()
    if want.index is not None:
        if want.index >= n:
            raise RuntimeError(f"device {want} but {n} visible")
        return [want]
    if local_rank is not None:
        return [torch.device("cuda", local_rank % n)]
    return [torch.device("cuda", i) for i in range(n)]


def _smoke_product(dev):
    """A 4x4 product of small integers on ``dev``, checked against the
    CPU (exact in float32); the product as a list when it differs, else
    None."""
    import torch

    a = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    got = (a.to(dev) @ a.to(dev)).cpu()
    return None if torch.equal(got, a @ a) else got.tolist()


def slice_health(expected_processes=None, expected_local_devices=None,
                 smoke=True, timeout=None, device=None, store=None, rank=0,
                 world_size=1, local_rank=None):
    """Health-check this process's devices and the job's device count.

    The counterpart of the JAX package's ``tpu_info.slice_health``: it
    checks that (a) this process sees its local devices, (b) the global
    device count, the sum of every rank's local count, is processes x
    local devices, and (c) a small exact product runs on every local
    device.  ``device`` is what the caller asks for: ``"cuda:<i>"``
    checks that CUDA device (platform ``"gpu"``); None or ``"cuda"`` the
    one a ``local_rank`` takes (``local_rank`` modulo the visible count,
    as ``TFNodeContext.torch_initialize`` picks it, so that a rank makes
    a context on its own card alone), or every visible one without a
    ``local_rank``; ``"cpu"`` the CPU alone (platform ``"cpu"``, one
    device, no CUDA call).  GPUs
    on the host (:func:`count_gpus`) that CUDA does not see are a
    finding unless the caller asked for the CPU.

    A job of ``world_size`` > 1 processes exchanges the local counts
    through ``store`` (a ``torch.distributed`` key-value store shared by
    the ranks, under keys ``local/<rank>``): a store wait that times out
    leaves no state behind, where a collective abandoned by the bounded
    probe would leave the process group out of step.  With a store, a
    one-process job goes through it too; without one it counts its own.

    The probe, the process's first CUDA contact, runs on a daemon thread
    joined for ``timeout`` seconds (default ``TFOS_SLICE_HEALTH_TIMEOUT``,
    60; capped at ``threading.TIMEOUT_MAX``).  Each finding is recorded
    as it is found, and the caller gets a snapshot, so a probe that hangs
    later keeps what it found before and cannot change the report after
    it was returned.  A probe still running at the timeout sets
    ``timed_out``, and ``bare_timeout`` when it found nothing else.

    Returns ``{healthy, platform, kind, local_devices, global_devices,
    process_index, timed_out, bare_timeout, errors, probe_s}``; never
    raises and never waits past ``timeout``: callers decide whether a
    finding is fatal (``node.enforce_slice_health``)."""
    if timeout is None:
        timeout = _health_timeout()
    # inf or huge values would make join() raise OverflowError
    timeout = min(timeout, threading.TIMEOUT_MAX)
    deadline = time.monotonic() + timeout
    lock = threading.Lock()
    work = {
        "healthy": False,
        "platform": None,
        "kind": None,
        "local_devices": 0,
        "global_devices": 0,
        "process_index": rank,
        "timed_out": False,
        "bare_timeout": False,
        "errors": [],
        "probe_s": None,
    }

    def err(msg):
        with lock:
            work["errors"].append(msg)

    def probe():
        t0 = time.perf_counter()
        try:
            import torch

            want = torch.device("cuda" if device is None else device)
            # every torch call outside the lock: a device that wedges
            # mid-call must not wedge the caller's snapshot too
            devs = _local_devices(want, local_rank)
            platform = ("gpu" if want.type == "cuda" else want.type) \
                if devs else None
            kind = (torch.cuda.get_device_name(devs[0])
                    if platform == "gpu" else platform)
            with lock:
                work.update(platform=platform, kind=kind,
                            local_devices=len(devs))
            if store is not None:
                store.set(f"local/{rank}", str(len(devs)))
            if want.type == "cuda" and not devs and count_gpus() > 0:
                err(f"{count_gpus()} GPUs present on this host but CUDA "
                    "sees none (CUDA runtime failed to initialize?)")
            if not devs:
                err("no local devices visible")
                return
            if expected_local_devices is not None and \
                    len(devs) != expected_local_devices:
                err(f"local devices {len(devs)} != expected "
                    f"{expected_local_devices}")
            if expected_processes is not None and \
                    world_size != expected_processes:
                err(f"process count {world_size} != expected "
                    f"{expected_processes}")
            if smoke:
                for d in devs:
                    got = _smoke_product(d)
                    if got is not None:
                        err(f"device {d} smoke product returned {got}")
            if store is not None:
                import datetime

                keys = [f"local/{r}" for r in range(world_size)]
                left = deadline - time.monotonic() + _STORE_WAIT_MARGIN_S
                # (a zero timeout would mean none at all)
                store.wait(keys, datetime.timedelta(
                    seconds=max(left, 1e-3)))
                n_global = sum(int(store.get(k)) for k in keys)
            elif world_size > 1:
                err(f"no store to count the devices of {world_size} "
                    "processes")
                return
            else:
                n_global = len(devs)
            with lock:
                work["global_devices"] = n_global
            # a peer that came up short shows as global != processes x
            # local, with or without an explicit expectation
            want_global = ((expected_processes or world_size)
                           * (expected_local_devices or len(devs)))
            if n_global != want_global:
                err(f"global devices {n_global} != expected "
                    f"{want_global} (a peer host may be short of chips)")
        except Exception as e:  # noqa: BLE001 - report, never raise
            err(f"{type(e).__name__}: {str(e)[:160]}")
        finally:
            with lock:
                work["done"] = True
                work["probe_s"] = time.perf_counter() - t0

    t = threading.Thread(target=probe, daemon=True, name="tfos-slice-health")
    t.start()
    t.join(timeout=timeout)
    with lock:
        report = copy.deepcopy(work)
    if not report.pop("done", False):
        report["timed_out"] = True
        report["bare_timeout"] = not report["errors"]
        report["errors"].append(
            f"health probe still hung after {timeout}s (a wedged device, "
            f"a silent peer, or a first CUDA contact slower than "
            f"{HEALTH_TIMEOUT_ENV}?)")
    report["healthy"] = not report["errors"]
    return report
