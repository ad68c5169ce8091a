"""Embarrassingly parallel mode: N independent single-node jobs.

Counterpart of ``tensorflowonspark_tpu/parallel_run.py`` (the reference's
``TFParallel.run``).  No cluster is formed: no rendezvous, no process
group.  Each engine executor runs ``map_fn(tf_args, ctx)`` on its own
devices, the pattern for batch inference over many hosts
(``examples/mnist_inference.py``).  Under Spark the tasks run in one
barrier stage, so they start together and see their peers' addresses
(``BarrierTaskContext.getTaskInfos()``), from which each takes its
same-host index; on the built-in engine every executor is a process of
this host, and its executor index is that index.  With ``num_gpus`` the
index picks the worker's block of GPUs (``gpu_info.claim_gpus``),
exported as ``CUDA_VISIBLE_DEVICES`` before ``map_fn`` touches CUDA.

``run`` returns the ``map_fn`` results, one a worker.  The task is a
module-level class (``_ParallelTask``), shipped with plain ``pickle``;
``map_fn`` is a module-level function.  A worker that uses the card
leaves a CUDA context in its executor (``pipeline``'s note).
"""

from __future__ import annotations

import logging
import os
import sys

from tensorflowonspark_tpu_torch import engine as engine_mod
from tensorflowonspark_tpu_torch import gpu_info
from tensorflowonspark_tpu_torch.utils import get_ip_address

logger = logging.getLogger(__name__)


def _barrier_placement(executor_id, num_workers):
    """``(peer hosts, same-host index, worker number)`` of this task:
    from the barrier context under Spark, else the engine's executor
    index on this host."""
    if "pyspark" in sys.modules:
        try:
            from pyspark import BarrierTaskContext

            tc = BarrierTaskContext.get()
            if tc is not None:
                addrs = [info.address.split(":")[0]
                         for info in tc.getTaskInfos()]
                worker = tc.partitionId()
                same_host = sum(1 for a in addrs[:worker]
                                if a == addrs[worker])
                return addrs, same_host, worker
        except Exception:  # noqa: BLE001 - not a barrier task
            pass
    idx = int(os.environ.get("TFOS_EXECUTOR_INDEX", executor_id))
    return [get_ip_address()] * num_workers, idx, executor_id


class _ParallelTask:
    """The task each worker runs: claim its GPUs, build its context,
    run ``map_fn`` and return ``[result]``."""

    def __init__(self, map_fn, tf_args, meta, num_workers):
        self.map_fn = map_fn
        self.tf_args = tf_args
        self.meta = meta
        self.num_workers = num_workers

    def __call__(self, iterator):
        from tensorflowonspark_tpu_torch.node import TFNodeContext

        executor_id = 0
        for item in iterator:  # one id a partition
            executor_id = item
        peers, same_host, worker = _barrier_placement(executor_id,
                                                      self.num_workers)
        gpu_info.claim_gpus(self.meta["num_gpus"], same_host)
        info = [{"executor_id": i, "host": h, "job_name": "worker",
                 "task_index": i, "port": None}
                for i, h in enumerate(peers)]
        ctx = TFNodeContext(
            executor_id=worker, job_name="worker", task_index=worker,
            cluster_spec={"worker": info},
            default_fs=self.meta["default_fs"],
            working_dir=self.meta["working_dir"], mgr=None,
            cluster_info=info)
        logger.info("parallel worker %d/%d starting", worker,
                    self.num_workers)
        return [self.map_fn(self.tf_args, ctx)]


def run(sc, map_fn, tf_args, num_executors=None, num_gpus=0):
    """Run ``map_fn(tf_args, ctx)`` as ``num_executors`` (default: every
    executor) independent single-node jobs; returns their results in
    worker order.  ``sc``: a ``LocalEngine`` or a pyspark
    ``SparkContext``.  ``num_gpus``: GPUs each worker claims."""
    eng = engine_mod.as_engine(sc)
    n = int(num_executors or eng.num_executors)
    meta = {"default_fs": eng.default_fs, "working_dir": os.getcwd(),
            "num_gpus": num_gpus}
    task = _ParallelTask(map_fn, tf_args, meta, n)
    if isinstance(eng, engine_mod.SparkEngine):
        # barrier only: a cluster that cannot start all n together fails
        # the job instead of running the workers one after another
        rdd = eng.sc.parallelize(range(n), n)
        return rdd.barrier().mapPartitions(task).collect()
    # spread pins one task an executor, the barrier guarantee; more tasks
    # than executors would queue behind each other and claim overlapping
    # GPU blocks
    if n > eng.num_executors:
        raise ValueError(f"parallel run of {n} workers requires {n} "
                         f"executors; engine has {eng.num_executors}")
    return eng.parallelize(range(n), n).map_partitions(task).collect(
        spread=True)
