"""Driver-side cluster orchestration.

An own copy of the part of ``tensorflowonspark_tpu/cluster.py`` that the
SPARK-fed training path calls: ``run()`` computes the cluster template
(which executor is chief or worker), starts the rendezvous server,
launches one node per executor on a background thread and waits for all
of them to register; the ``TFCluster`` it returns feeds a dataset into
the trainers (``train``) and stops them (``shutdown``).

``num_gpus`` is the per-executor GPU claim (``gpu_info``), the
counterpart of the JAX package's ``num_chips``.  Arguments the copy does
not carry raise NotImplementedError naming their ROADMAP.md item: the
data service and streaming feeds, ``restarts`` / ``min_executors``
recovery, ps/evaluator nodes, ``inference()`` and TensorBoard.
``serve()`` stands up the online serving tier on the cluster's engine
after ``shutdown()``.  The live metrics endpoint and the telemetry drain
are left out too (item 21): with ``TFOS_TELEMETRY_DIR`` set, every
process writes its spans straight into that directory.
"""

from __future__ import annotations

import logging
import os
import random
import secrets
import sys
import threading
import time

from tensorflowonspark_tpu_torch import engine as engine_mod
from tensorflowonspark_tpu_torch import node, rendezvous
from tensorflowonspark_tpu_torch.node import ROLES_ITEM
from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

DATA_SERVICE_ITEM = "ROADMAP.md queue 1, item 17 (data service)"
STREAMING_ITEM = "ROADMAP.md queue 1, item 18 (streaming feeds)"


class InputMode:
    """How the training job ingests data."""

    TENSORFLOW = 0  #: nodes read their own data
    SPARK = 1       #: engine partitions are fed through executor queues


# driver-side status shared with the launcher thread
tf_status = {}


class TFCluster:
    """A running cluster: ``train`` feeds it, ``shutdown`` stops it."""

    engine = None
    meta = None
    cluster_meta = None
    cluster_info = None
    input_mode = None
    queues = None
    server = None
    _node_ids = None
    _launcher = None

    def train(self, dataset, num_epochs=1, feed_timeout=600, qname="input"):
        """Feed ``dataset`` into the trainers.  Epochs are the dataset
        unioned with itself.  Partition i goes to the node on executor
        ``node_ids[i % n]``, so every trainer gets a balanced share; a
        partition counts as fed once its trainer consumed it (the
        rendezvous server's feed ledger, ``server.fed_partitions``)."""
        if self.input_mode != InputMode.SPARK:
            raise ValueError("train() requires InputMode.SPARK")
        if hasattr(dataset, "_blocks") and hasattr(dataset, "chunks"):
            raise NotImplementedError(
                f"feeding a data.Pipeline comes with {DATA_SERVICE_ITEM}")
        if hasattr(dataset, "foreachRDD"):
            raise NotImplementedError(f"DStreams come with {STREAMING_ITEM}")
        ds = engine_mod.as_dataset(dataset)
        if num_epochs < 0:
            raise ValueError("num_epochs cannot be negative")
        if num_epochs > 1:
            ds = ds.union(*[ds for _ in range(num_epochs - 1)])
        # this train() owns the ledger's scope
        self.server.reset_feed(qname)
        feeder = node.train(self.cluster_info, self.cluster_meta,
                            feed_timeout, qname)
        ids = self._node_ids
        ds.foreach_partition(
            feeder, placement=[ids[i % len(ids)]
                               for i in range(ds.num_partitions)])

    def train_stream(self, *args, **kwargs):
        raise NotImplementedError(f"streaming feeds come with "
                                  f"{STREAMING_ITEM}")

    def inference(self, *args, **kwargs):
        raise NotImplementedError(f"inference() comes with {ROLES_ITEM}")

    def serve(self, export_dir=None, ckpt_dir=None, num_replicas=None,
              **kw):
        """An online inference service on this cluster's engine: a
        started ``serving.Server`` of ``ModelSpec(export_dir, ckpt_dir,
        predict=kw.pop("predict"), device=kw.pop("device"))`` with
        ``num_replicas`` (default: the cluster's executors); the other
        keywords go to ``Server``.  The caller owns ``stop()``.

        Call after :meth:`shutdown`: replicas are engine tasks and need
        free executors, and a replica on the card holds a CUDA context,
        so its executor must fork no SPARK trainer afterwards."""
        from tensorflowonspark_tpu_torch import serving

        spec = serving.ModelSpec(export_dir=export_dir, ckpt_dir=ckpt_dir,
                                 predict=kw.pop("predict", None),
                                 device=kw.pop("device", None))
        n = num_replicas or self.meta["num_executors"]
        server = serving.Server(spec, num_replicas=n, engine=self.engine,
                                **kw)
        server.start()
        return server

    def shutdown(self, ssc=None, grace_secs=0, timeout=259200):
        """Stop the cluster: end-of-feed to every node and the trainers
        reaped (the shutdown task), then the launcher joined.  A node's
        failure raises ``TaskError``, a failure the launcher saw exits
        the driver with 1, as in the JAX package."""
        if ssc is not None:
            raise NotImplementedError(f"streaming contexts come with "
                                      f"{STREAMING_ITEM}")

        def _watchdog():
            logger.error("shutdown watchdog fired after %ss", timeout)
            self.engine.cancel_all_jobs()
            os._exit(1)

        watchdog = threading.Timer(timeout, _watchdog)
        watchdog.daemon = True
        watchdog.start()
        try:
            t0 = time.perf_counter()
            ids = sorted(m["executor_id"] for m in self.cluster_info)
            self.engine.parallelize(ids, len(ids)).foreach_partition(
                node.shutdown(self.cluster_info, self.queues, grace_secs),
                placement=ids)
            if self._launcher is not None:
                self._launcher.join(timeout=timeout)
            telemetry.record_span("cluster/shutdown",
                                  time.perf_counter() - t0)
            if tf_status.get("error"):
                logger.error("cluster failed: %s", tf_status["error"])
                self.engine.cancel_all_jobs()
                sys.exit(1)
        finally:
            watchdog.cancel()
            self.server.stop()
            telemetry.flush()
        logger.info("cluster shut down")


def _launch(nodes_ds, node_fn, node_ids):
    """The node job, run on a background thread: node tasks of background
    trainers return at once, foreground ones when ``main_fun`` does."""
    try:
        nodes_ds.foreach_partition(node_fn, placement=node_ids)
    except Exception as e:  # noqa: BLE001 - reported through tf_status
        logger.exception("node launch failed")
        tf_status["error"] = str(e)


def run(sc, map_fun, tf_args, num_executors, num_ps=0, tensorboard=False,
        input_mode=InputMode.TENSORFLOW, log_dir=None,
        driver_ps_nodes=False, master_node=None, reservation_timeout=600,
        queues=("input", "output", "error", "control"), eval_node=False,
        num_gpus=0, background=None, restarts=0, data_workers=0,
        data_dispatch=None, min_executors=0):
    """Start the cluster and return a :class:`TFCluster`.

    ``sc`` is a ``LocalEngine``.  ``map_fun(args, ctx)`` is a
    module-level function (executors import it); it runs in a trainer
    forked from each executor for ``InputMode.SPARK``, in the executor
    itself otherwise (``background`` other than None raises
    NotImplementedError: ROADMAP.md queue 1, item 14).  ``num_gpus``:
    GPUs each executor claims (``CUDA_VISIBLE_DEVICES`` by same-host
    worker index); 0 leaves the environment as it is, as the CPU runs
    do.  ``master_node``: "chief" or "master" takes executor 0.
    ``reservation_timeout`` bounds the wait for the nodes to register
    and, in each trainer, the process group's collectives."""
    if num_ps or driver_ps_nodes or eval_node:
        raise NotImplementedError(f"ps/evaluator nodes come with "
                                  f"{ROLES_ITEM}")
    if tensorboard or log_dir is not None:
        raise NotImplementedError(f"TensorBoard comes with {ROLES_ITEM}")
    if restarts or min_executors:
        raise NotImplementedError(
            f"restarts and min_executors come with {engine_mod.RESTARTS_ITEM}")
    if background is not None:
        raise NotImplementedError(
            "a trainer process chosen apart from input_mode comes with "
            "ROADMAP.md queue 1, item 14")
    if data_workers or data_dispatch is not None:
        raise NotImplementedError(f"the data service comes with "
                                  f"{DATA_SERVICE_ITEM}")
    start_t0 = time.perf_counter()
    eng = engine_mod.as_engine(sc)
    queues = list(queues)
    if num_executors > eng.num_executors:
        raise ValueError(f"num_executors {num_executors} > the engine's "
                         f"{eng.num_executors}")

    ids = list(range(num_executors))
    template = {}
    if master_node:
        if master_node not in ("chief", "master"):
            raise ValueError("master_node must be 'chief' or 'master'")
        template[master_node] = [ids.pop(0)]
    if ids:
        template["worker"] = ids
    logger.info("cluster template: %s", template)

    server = rendezvous.Server(num_executors)
    server_addr = server.start()
    cluster_meta = {
        "id": random.getrandbits(64),
        "cluster_template": template,
        "num_executors": num_executors,
        "default_fs": eng.default_fs,
        "working_dir": os.getcwd(),
        "server_addr": list(server_addr),
        "authkey": secrets.token_hex(16),
        "reservation_timeout": reservation_timeout,
    }
    tf_status.clear()
    node_fn = node.run(map_fun, tf_args, cluster_meta, queues=queues,
                       background=input_mode == InputMode.SPARK,
                       num_gpus=num_gpus)
    node_ids = list(range(num_executors))

    c = TFCluster()
    c.engine = eng
    c.meta = c.cluster_meta = cluster_meta
    c.input_mode = input_mode
    c.queues = queues
    c.server = server
    c._node_ids = node_ids
    c._launcher = threading.Thread(
        target=_launch, name="tfos-launcher", daemon=True,
        args=(eng.parallelize(node_ids, len(node_ids)), node_fn, node_ids))
    c._launcher.start()
    try:
        c.cluster_info = server.await_reservations(tf_status,
                                                   reservation_timeout)
    except BaseException:
        server.stop()
        raise
    seen = set()
    for m in c.cluster_info:
        key = (m["host"], m["executor_id"])
        if key in seen:
            raise RuntimeError(f"duplicate node registration for {key}")
        seen.add(key)
    telemetry.record_span("cluster/start", time.perf_counter() - start_t0,
                          executors=num_executors,
                          nodes=len(c.cluster_info))
    return c
