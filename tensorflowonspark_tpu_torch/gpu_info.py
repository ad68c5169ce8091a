"""GPU discovery and per-worker claim.

Counterpart of ``tensorflowonspark_tpu/tpu_info.py`` (itself the TPU
version of the reference's ``gpu_info.py``): which GPUs this process
may use, and which of them this worker takes, exported as
``CUDA_VISIBLE_DEVICES`` before the trainer touches CUDA.

Nothing here calls ``torch.cuda``: the node task claims GPUs in the
executor process, which then forks the trainer, and a forked child
cannot use CUDA if its parent created a CUDA context.  The GPUs are
counted with ``nvidia-smi --list-gpus`` (or ``TFOS_GPUS_PER_HOST``,
which tests set to fake a count); the trainer's health check
(``TFNodeContext.torch_initialize``) is the first CUDA call.

The claim follows ``tpu_info.claim_chips``' decision order, minus the
scheduler's resources (the port has no Spark engine yet, ROADMAP.md
queue 1, item 15): a claim inside a Spark-on-K8s pod raises
NotImplementedError (the reference trusts no host scan there, since
device plugins may advertise GPUs to pods without them, and takes the
scheduler's resources instead); otherwise same-host worker ``i`` takes
the ``i``-th contiguous block of ``num_gpus`` GPUs out of those the
executor was given: the entries of the ``CUDA_VISIBLE_DEVICES`` it
inherited, or every GPU of the host when it inherited none.  A request
that cannot be met raises.
"""

from __future__ import annotations

import logging
import os
import subprocess

logger = logging.getLogger(__name__)

COUNT_ENV = "TFOS_GPUS_PER_HOST"
MASK_ENV = "CUDA_VISIBLE_DEVICES"
# the executor's own mask, kept at its first claim, so that a later
# cluster on the same executor claims from it and not from the previous
# claim; NO_MASK stands for "inherited none"
INHERITED_ENV = "TFOS_INHERITED_CUDA_VISIBLE_DEVICES"
NO_MASK = "<unset>"
K8S_ITEM = "ROADMAP.md queue 1, item 15 (recovery and other engines)"


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
    """Claim ``num_gpus`` GPUs for this process and export them as
    ``CUDA_VISIBLE_DEVICES``; returns their ids.  ``num_gpus=0`` claims
    nothing and leaves the environment as it is."""
    if num_gpus <= 0:
        return []
    if is_k8s():
        raise NotImplementedError(
            f"claiming GPUs inside a Spark-on-K8s pod takes the scheduler's "
            f"resources, which come with {K8S_ITEM}")
    os.environ.setdefault(INHERITED_ENV, os.environ.get(MASK_ENV, NO_MASK))
    gpus = get_gpus(num_gpus, worker_index)
    os.environ[MASK_ENV] = ",".join(str(g) for g in gpus)
    return gpus
