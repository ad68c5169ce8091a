"""Driver-side cluster orchestration.

An own copy of ``tensorflowonspark_tpu/cluster.py``: ``run()`` computes the cluster template
(which executor is ps, evaluator, chief or worker), starts the
rendezvous server, launches one node per executor on a background
thread (and ps nodes on driver threads with ``driver_ps_nodes``) and
waits for all of them to register; the ``TFCluster`` it returns feeds a
dataset into the trainers (``train``), maps one through them
(``inference``) and stops them (``shutdown``: end-of-feed to the
compute nodes, then a stop message to each ps and evaluator node's
remote manager).

``num_gpus`` is the per-executor GPU claim (``gpu_info``), the
counterpart of the JAX package's ``num_chips``; ps and evaluator nodes
claim none.  ``sc`` is a ``LocalEngine`` or a pyspark ``SparkContext``
(``engine.SparkEngine``).

Supervised recovery, as in the JAX package: with ``run(restarts=N)``,
``train()`` survives a lost executor up to N times.  The feed job fails,
and ``_recover`` quiesces the surviving nodes, heals the engine's pool,
bumps the cluster epoch (``meta["epoch"]``, the rendezvous server's
fence), relaunches the nodes and waits for them; the trainers resume
from their latest checkpoint (``ctx.restore_latest``) and the re-feed
skips the partitions the ledger holds.  With ``min_executors=k`` a pool
that cannot be healed is not fatal: the cluster re-forms over the k or
more executors that survive (``_elastic_template``), and the trainers
fold the missing devices into gradient accumulation
(``elastic.ElasticRuntime``).

Given a ``data.Pipeline``, ``train()`` feeds it through the data
service, as in the JAX package: ``run(data_workers=N,
data_dispatch="static" | "dynamic")`` sets N data workers, engine tasks
that run the pipeline and push its chunks into the trainers' rings,
rank-strided or by first-come-first-served splits from a supervised
split provider (``data.service``, ``data.splits``); a failed worker or
trainer goes through the same recovery.  The workers run on the
executors that host no node first, so that a worker's death does not
take a trainer with it.

Streaming feeds, as in the JAX package: ``train_stream`` feeds an
iterable of datasets (micro-batches), ``train`` a pyspark DStream
(``foreachRDD``), and ``shutdown(ssc=)`` stops the streaming context once
a consumer's STOP reached the rendezvous server.  Streaming feeds are
not supervised: ``run(restarts=)`` recovers ``train()`` jobs only.
``serve()`` stands up the online serving tier on the cluster's engine
after ``shutdown()``.

Observability, as in the JAX package: with ``TFOS_TELEMETRY_DIR`` set
the driver records as ``driver`` and roots the run's trace
(``cluster/run``, exported on ``TFOS_TRACE_PARENT``), each node spools
into a directory of its own, and ``shutdown()`` drains every spool and
flight dump, the driver's own records too, into
``<TFOS_TELEMETRY_DIR>/run-<cluster id>/`` (on the clean and the error
path alike).  With ``TFOS_OBS_PORT`` set, ``run()`` starts the driver's
``obs.ObsServer`` (``TFCluster.obs``: ``/metrics``, ``/healthz``,
``/statusz``, ``/slo``, ``POST /profilez`` and ``/flightz``), which
``shutdown()`` stops last.
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
from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch import node, rendezvous
from tensorflowonspark_tpu_torch.utils import (
    get_ip_address,
    kill_pid,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)


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
    restarts = 0        # recoveries train() may make
    min_executors = 0   # the elastic floor; 0: heal to full strength
    _restarts_used = 0
    _node_fn = None
    _nodes_ds = None
    _node_ids = None    # the executors that host a node
    _all_node_ids = None  # those of the first incarnation
    _feed_ids = None    # those of them that host a compute node
    _template0 = None   # the first incarnation's template
    _launcher = None
    _driver_ps = ()     # threads of the ps nodes hosted by the driver
    obs = None          # the ObsServer, with TFOS_OBS_PORT set
    data_status = None  # the split provider's status after a dynamic feed

    def train(self, dataset, num_epochs=1, feed_timeout=600, qname="input"):
        """Feed ``dataset`` into the trainers.  Epochs are the dataset
        unioned with itself.  Partition i goes to the i-th compute node
        (modulo their number; ps and evaluator nodes are fed nothing), so
        every trainer gets a balanced share; a
        partition counts as fed once its trainer consumed it (the
        rendezvous server's feed ledger, ``server.fed_partitions``).
        A re-feed deals the partitions the ledger does not hold round
        robin over the compute nodes, in order, so the trainers' shares
        differ by one partition at most, as in a fresh job over them.

        With ``run(restarts=N)`` this call supervises the job: a lost
        executor fails the feed job, :meth:`_recover` brings the next
        incarnation up, and the partitions the ledger does not hold are
        fed again, up to N times; then the error raises.

        A ``data.Pipeline`` goes through the data service instead
        (:meth:`_train_data_service`).  A pyspark DStream registers the
        feeder on each of its micro-batch RDDs (``foreachRDD``) and
        returns; the streaming context drives it, and
        ``shutdown(ssc=)`` stops it (no supervision, as in the JAX
        package)."""
        if self.input_mode != InputMode.SPARK:
            raise ValueError("train() requires InputMode.SPARK")
        if hasattr(dataset, "_blocks") and hasattr(dataset, "chunks"):
            return self._train_data_service(dataset, num_epochs,
                                            feed_timeout, qname)
        if hasattr(dataset, "foreachRDD"):
            feeder = node.train(self.cluster_info, self.cluster_meta,
                                feed_timeout, qname)
            dataset.foreachRDD(lambda rdd: rdd.foreachPartition(feeder))
            return
        ds = engine_mod.as_dataset(dataset)
        if num_epochs < 0:
            raise ValueError("num_epochs cannot be negative")
        if num_epochs > 1:
            ds = ds.union(*[ds for _ in range(num_epochs - 1)])
        # this train() owns the ledger's scope
        self.server.reset_feed(qname)
        while True:
            # partitions consumed in full before a failure are not fed
            # again (exactly once a partition)
            done = set(self.server.fed_partitions(qname))
            if done:
                logger.info("resuming feed: %d partitions already "
                            "consumed: %s", len(done), sorted(done))
            feeder = node.train(self.cluster_info, self.cluster_meta,
                                feed_timeout, qname, skip=done)
            try:
                ds.foreach_partition(
                    feeder, placement=_feed_placement(
                        ds.num_partitions, done, self._feed_ids),
                    retryable=self.restarts > 0)
                return
            except (engine_mod.TaskError, RuntimeError, TimeoutError) as e:
                if self._restarts_used >= self.restarts:
                    raise
                self._recover(e)

    def _data_placement(self, n_workers):
        """The executor of each of ``n_workers`` data workers: the live
        executors that host no node first, then the nodes' own, round
        robin.  A worker shares its host's ring either way; on an
        executor of its own, its death does not reap a trainer (the
        engine kills a dead executor's children before it respawns)."""
        alive = getattr(self.engine, "alive_executors", None)
        pool = (list(alive()) if alive is not None
                else list(range(self.engine.num_executors)))
        nodes = set(self._node_ids)
        order = [i for i in pool if i not in nodes] + \
            [i for i in pool if i in nodes]
        return [order[j % len(order)] for j in range(n_workers)]

    def _train_data_service(self, pipeline, num_epochs, feed_timeout,
                            qname):
        """Feed the trainers from a ``data.Pipeline`` through the data
        service: ``data_workers`` engine tasks each run the pipeline and
        push their trainers' shares over the feed's wire
        (``data/service.py``).  The supervision of feeder-mode
        ``train()``: a failed task or worker triggers a recovery, up to
        ``restarts`` times, and the re-served streams resume at the unit
        ledger instead of feeding consumed data again.

        Dispatch is **dynamic** (first-come-first-served splits,
        ``data/splits.py``) by default; ``TFOS_DATA_DISPATCH=static`` or
        ``run(..., data_dispatch="static")`` selects the rank-strided
        shards of this method's body."""
        from tensorflowonspark_tpu_torch.data import service as data_service

        if data_service.dispatch_mode(self.meta) == "dynamic":
            return self._train_data_service_dynamic(
                pipeline, num_epochs, feed_timeout, qname)
        n_workers = int(self.meta.get("data_workers") or
                        data_service.default_workers())
        if num_epochs < 0:
            raise ValueError("num_epochs cannot be negative")
        if num_epochs > 1:
            pipeline = pipeline.repeat(num_epochs)
        # this train() owns the unit ledgers' scope
        for rank, _m in data_service.trainer_ranks(self.cluster_info):
            self.server.reset_feed(data_service.ledger_feed(qname, rank))
        logger.info("data service: %d worker task(s) feeding %d trainers",
                    n_workers,
                    len(data_service.trainer_ranks(self.cluster_info)))
        while True:
            fn = data_service.serve_task(
                pipeline, self.cluster_info, self.cluster_meta,
                qname=qname, num_workers=n_workers,
                feed_timeout=feed_timeout)
            try:
                self.engine.parallelize(
                    list(range(n_workers)), n_workers
                ).foreach_partition(
                    fn, placement=self._data_placement(n_workers),
                    retryable=self.restarts > 0)
                return
            except (engine_mod.TaskError, RuntimeError, TimeoutError) as e:
                if self._restarts_used >= self.restarts:
                    raise
                self._recover(e)

    def _train_data_service_dynamic(self, pipeline, num_epochs,
                                    feed_timeout, qname):
        """The data service with dynamic dispatch.  Each attempt: a new
        ``ActorSystem`` in the driver (one executor of its own) holds
        the split board (its manager's KV and queues) and the supervised
        ``SplitProvider``; ``data_workers`` dynamic worker tasks claim
        splits from it and push each to the least backlogged trainer
        they own.  Exactly once is a split id on the durable
        ``split_feed`` ledger: a recovery's attempt builds a new board,
        and the provider posts only what the ledger lacks.  Where
        ``TFOS_DATA_MAX_WORKERS`` leaves room, a stall-driven autoscaler
        (``data/autoscale.py``) adds and retires worker tasks through
        the board's plan."""
        from tensorflowonspark_tpu_torch.actors.runtime import ActorSystem
        from tensorflowonspark_tpu_torch.data import autoscale as data_autoscale
        from tensorflowonspark_tpu_torch.data import service as data_service
        from tensorflowonspark_tpu_torch.data import splits as data_splits

        n_workers = int(self.meta.get("data_workers") or
                        data_service.default_workers())
        if num_epochs < 0:
            raise ValueError("num_epochs cannot be negative")
        num_epochs = max(1, int(num_epochs))
        n_trainers = len(data_service.trainer_ranks(self.cluster_info))
        # this train() owns the split ledger's scope
        self.server.reset_feed(data_splits.split_feed(qname))
        try:
            max_workers = int(
                os.environ.get(data_autoscale.MAX_WORKERS_ENV, "0"))
        except ValueError:
            max_workers = 0
        max_workers = max(n_workers, max_workers)
        try:
            window = int(os.environ.get(data_splits.WINDOW_ENV, "0"))
        except ValueError:
            window = 0
        window = window or max(16, 4 * max(1, n_trainers))
        logger.info("data service (dynamic): %d worker task(s) feeding "
                    "%d trainers, split window %d, max workers %d",
                    n_workers, n_trainers, window, max_workers)
        while True:
            system = ActorSystem(capacity=1)
            scaler = None
            try:
                board = data_splits.SplitBoard(system._mgr, qname)
                board.set_plan(range(n_workers))
                system.spawn(
                    data_splits.SplitProvider(
                        qname,
                        server_addr=self.cluster_meta["server_addr"],
                        num_epochs=num_epochs, window=window),
                    "split-provider")
                meta = dict(self.cluster_meta)
                meta[data_service.SPLIT_BOARD_META] = {
                    "address": tuple(system._mgr.address),
                    "authkey": system._authkey,
                }
                fn = data_service.dynamic_serve_task(
                    pipeline, self.cluster_info, meta, qname=qname,
                    feed_timeout=feed_timeout)
                if max_workers > n_workers:
                    scaler = self._start_data_autoscaler(
                        board, fn, n_workers, max_workers)
                self.engine.parallelize(
                    list(range(n_workers)), n_workers
                ).foreach_partition(
                    fn, placement=self._data_placement(n_workers),
                    retryable=self.restarts > 0)
                # the provider's last word: its cursor, the eof, and the
                # splits it requeued (a dead worker's)
                self.data_status = system.group("split-provider").ask(
                    "status").result(60)
                return
            except (engine_mod.TaskError, RuntimeError, TimeoutError) as e:
                if self._restarts_used >= self.restarts:
                    raise
                self._recover(e)
            finally:
                if scaler is not None:
                    scaler.stop()
                system.stop()

    def _start_data_autoscaler(self, board, serve_fn, n_workers,
                               max_workers):
        """A ``StallAutoscaler`` wired to this cluster: the signal is the
        trainers' published feed-wait counters (read through their
        managers); scaling up launches one more dynamic worker task and
        grows the board's plan, scaling down shrinks the plan (the
        worker drains and exits)."""
        from tensorflowonspark_tpu_torch.data import autoscale as data_autoscale
        from tensorflowonspark_tpu_torch.data import service as data_service

        mgrs = {}

        def _snapshots():
            out = {}
            for rank, m in data_service.trainer_ranks(self.cluster_info):
                try:
                    mgr = mgrs.get(rank)
                    if mgr is None:
                        mgr = mgrs[rank] = node._get_manager(
                            self.cluster_info, m["executor_id"])
                    for k, v in mgr.obs_snapshots().items():
                        out[f"{rank}:{k}"] = v
                except Exception:  # noqa: BLE001 - trainer mid-restart
                    mgrs.pop(rank, None)
            return out

        def _scale_up(widx):
            board.set_plan(board.plan() + [widx])
            threading.Thread(
                target=_run_scaled_worker, args=(self.engine, widx,
                                                 serve_fn),
                name=f"tfos-data-scale-{widx}", daemon=True).start()

        def _scale_down(widx):
            board.set_plan([w for w in board.plan() if w != widx])

        return data_autoscale.StallAutoscaler(
            data_autoscale.obs_stall_reader(_snapshots),
            _scale_up, _scale_down,
            min_workers=n_workers, max_workers=max_workers).start()

    def _spawn_launcher(self):
        """Launch the node job on a background thread; also the
        relaunch half of a recovery."""
        t = threading.Thread(
            target=_launch, name="tfos-launcher", daemon=True,
            args=(self._nodes_ds, self._node_fn, self._node_ids,
                  self.restarts > 0))
        t.start()
        return t

    def _recover(self, err):
        """One supervised restart, in the JAX package's order:

        1. quiesce every node of the failed incarnation (state
           terminating, a poison on its error queue, so that feeders
           still waiting on consumption fail and free their executors,
           and its trainer killed), and unlink its feed rings, which no
           later node opens (their names carry the epoch);
        2. respawn the dead executors; with ``min_executors``, a heal
           that falls short re-forms the cluster over the survivors;
        3. bump the epoch on the rendezvous server before joining the
           old launcher, so that a stale registration is rejected;
        4. relaunch the nodes and wait for them."""
        self._restarts_used += 1
        epoch = int(self.meta.get("epoch", 0)) + 1
        telemetry.event("cluster/recover_begin", epoch=epoch,
                        restart=self._restarts_used, restarts=self.restarts,
                        error=str(err)[:400])
        logger.warning("cluster failure (%s); recovery %d/%d -> epoch %d",
                       str(err)[:200], self._restarts_used, self.restarts,
                       epoch)
        t0 = time.perf_counter()
        for m in self.cluster_info:
            _quiesce_node(m)
            _unlink_ring(self.meta, m)
        heal_err = None
        if hasattr(self.engine, "ensure_executors"):
            try:
                self.engine.ensure_executors()
            except Exception as e:  # noqa: BLE001 - the budget is spent
                if not self.min_executors:
                    raise
                heal_err = e
                logger.warning("pool heal failed (%s); re-forming over "
                               "the surviving executors", str(e)[:200])
        if self.min_executors:
            alive = self._alive_node_ids()
            if len(alive) < self.min_executors:
                raise RuntimeError(
                    f"elastic recovery impossible: {len(alive)} "
                    f"executor(s) survive, min_executors="
                    f"{self.min_executors}") from (heal_err or err)
            if set(alive) != set(self._node_ids):
                self._resize_cluster(alive)
        self.meta["epoch"] = epoch  # the node tasks carry this dict
        self.server.reset(epoch)
        if self._launcher is not None:
            self._launcher.join(timeout=60)
            if self._launcher.is_alive():
                logger.warning("the old launcher still runs after 60 s; "
                               "relaunching (its registrations are "
                               "fenced by the epoch)")
        tf_status.pop("error", None)
        self._launcher = self._spawn_launcher()
        self.cluster_info = _await_cluster(
            self.server, tf_status, self.meta["reservation_timeout"])
        telemetry.record_span("cluster/recover", time.perf_counter() - t0,
                              epoch=epoch, restart=self._restarts_used)
        telemetry.event("cluster/recover_done", epoch=epoch,
                        nodes=len(self.cluster_info))
        logger.info("recovery complete: epoch %d with %d nodes", epoch,
                    len(self.cluster_info))

    def _alive_node_ids(self):
        """The first incarnation's node ids whose executor is alive, so
        that a healed pool re-grows the cluster.  An engine that cannot
        report liveness (pyspark) keeps the current ids."""
        alive_fn = getattr(self.engine, "alive_executors", None)
        if alive_fn is None:
            return list(self._node_ids)
        alive = set(alive_fn())
        return sorted(i for i in self._all_node_ids if i in alive)

    def _resize_cluster(self, alive_ids):
        """Re-form the template over ``alive_ids`` (a shrink, or a
        re-grow after the pool came back): the node tasks read it from
        the meta dict, the engine retires the other slots, and the
        rendezvous server awaits that many nodes, set before the epoch
        reset."""
        template = _elastic_template(self._template0, alive_ids)
        old_n = len(self._node_ids)
        self.meta["cluster_template"] = template
        self.meta["num_executors"] = len(alive_ids)
        self._node_ids = sorted(alive_ids)
        side = {i for job in node.SIDE_JOBS for i in template.get(job, ())}
        self._feed_ids = [i for i in self._node_ids if i not in side]
        retire = getattr(self.engine, "retire_executors", None)
        if retire is not None:
            retire(sorted(set(self._all_node_ids) - set(alive_ids)))
        self._nodes_ds = self.engine.parallelize(self._node_ids,
                                                 len(self._node_ids))
        self.server.resize(len(self._node_ids))
        telemetry.event("cluster/resize", from_nodes=old_n,
                        to_nodes=len(self._node_ids),
                        template={k: list(v) for k, v in template.items()})
        metrics_registry.inc("tfos_elastic_resizes_total", scope="cluster")
        logger.warning("elastic resize: %d -> %d node(s), template %s",
                       old_n, len(self._node_ids), template)

    def train_stream(self, stream, feed_timeout=600, qname="input"):
        """Feed a stream, an iterable of datasets (micro-batches): each
        one's partitions go through ``node.train``'s feeder, dealt round
        robin over the compute nodes, one micro-batch after the other;
        the deal carries on from one micro-batch to the next, so
        micro-batches of fewer partitions than nodes feed every node.
        The loop ends after the micro-batch in flight once the
        rendezvous server's ``done`` is set: a consumer's
        ``DataFeed.terminate()`` (its feeder sends STOP) or a STOP from
        outside (``examples/stop_streaming.py``).  Not supervised, as in
        the JAX package: a failure raises, ``run(restarts=)`` does not
        recover it, and the micro-batches go into no feed ledger."""
        if self.input_mode != InputMode.SPARK:
            raise ValueError("train_stream() requires InputMode.SPARK")
        feeder = node.train(self.cluster_info, self.cluster_meta,
                            feed_timeout, qname)
        turn = 0   # the deal goes on across micro-batches
        for micro in stream:
            if self.server.done.is_set():
                logger.info("train_stream: STOP received, ending the "
                            "stream's feed")
                break
            ds = engine_mod.as_dataset(micro)
            ids = self._feed_ids
            k = turn % len(ids)
            ds.foreach_partition(feeder, placement=_feed_placement(
                ds.num_partitions, (), ids[k:] + ids[:k]))
            turn = k + ds.num_partitions

    def inference(self, dataset, feed_timeout=600, qname="input"):
        """``dataset`` mapped through the trainers, lazily: a dataset
        whose partition i holds, in order, the results the trainer that
        consumed partition i returned through ``DataFeed.batch_results``,
        one a record (``node.inference``).  Collect it to run it."""
        if self.input_mode != InputMode.SPARK:
            raise ValueError("inference() requires InputMode.SPARK")
        ds = engine_mod.as_dataset(dataset)
        return ds.map_partitions(node.inference(
            self.cluster_info, self.cluster_meta, feed_timeout, qname))

    def tensorboard_url(self):
        """The dashboard node's TensorBoard URL, or None when none runs."""
        for m in self.cluster_info:
            if m.get("tb_port"):
                return f"http://{m['host']}:{m['tb_port']}"
        return None

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
        """Stop the cluster: end-of-feed to every compute node and the
        trainers reaped (the shutdown task), then a stop message to each
        ps and evaluator node's control queue, which frees its slot, then
        the launcher joined.  A node's failure raises ``TaskError``, a
        failure the launcher saw exits the driver with 1, as in the JAX
        package.  ``ssc``: a pyspark ``StreamingContext`` feeding the
        cluster (``train(<DStream>)``); this waits until it terminates,
        and stops it gracefully, leaving the SparkContext running, once
        a consumer's STOP reached the rendezvous server."""

        def _watchdog():
            logger.error("shutdown watchdog fired after %ss", timeout)
            self.engine.cancel_all_jobs()
            os._exit(1)

        watchdog = threading.Timer(timeout, _watchdog)
        watchdog.daemon = True
        watchdog.start()
        drained = []

        def _drain_once():
            # one drain a shutdown, clean or failed: a failed run's
            # timeline is the one most worth keeping
            if not drained:
                drained.append(True)
                try:
                    self._drain_telemetry()
                except Exception as e:  # noqa: BLE001 - best effort
                    logger.warning("telemetry drain failed: %s", e)

        try:
            with telemetry.span("cluster/shutdown", grace_secs=grace_secs):
                try:
                    if ssc is not None:
                        while not ssc.awaitTerminationOrTimeout(1):
                            if self.server.done.is_set():
                                logger.info("STOP received: stopping the "
                                            "streaming context")
                                ssc.stop(stopSparkContext=False,
                                         stopGraceFully=True)
                                break
                    ids = list(self._feed_ids)
                    if ids:
                        self.engine.parallelize(ids, len(ids)) \
                            .foreach_partition(
                                node.shutdown(self.cluster_info,
                                              self.queues, grace_secs),
                                placement=ids)
                    # ps and evaluator nodes hold their slots until told
                    # to stop, so the launcher's job ends only after this
                    for m in self.cluster_info:
                        if m["job_name"] in node.SIDE_JOBS:
                            _stop_remote_node(m)
                    if self._launcher is not None:
                        self._launcher.join(timeout=timeout)
                    for t in self._driver_ps:
                        t.join(timeout=timeout)
                except BaseException:
                    _drain_once()
                    raise
                _drain_once()
                if tf_status.get("error"):
                    logger.error("cluster failed: %s", tf_status["error"])
                    telemetry.event("cluster/error",
                                    error=str(tf_status["error"])[:500])
                    self.engine.cancel_all_jobs()
                    sys.exit(1)
        finally:
            watchdog.cancel()
            if self.obs is not None:
                try:
                    self.obs.stop()
                except Exception:  # noqa: BLE001 - teardown
                    pass
                self.obs = None
            self.server.stop()
            telemetry.flush()
        logger.info("cluster shut down")

    def _drain_telemetry(self):
        """Collect every node's spools and flight dumps, and the driver's
        own records, into ``telemetry.run_dir(cluster id)``; returns the
        directory, or None when telemetry is off.  The executor half is
        ``node.drain_telemetry``, run on every node's executor that is
        alive."""
        from tensorflowonspark_tpu_torch.obs import flight

        rdir = telemetry.run_dir(self.meta["id"])
        if rdir is None:
            return None
        alive = set(getattr(self.engine, "alive_executors",
                            lambda: self._node_ids)())
        ids = [i for i in self._node_ids if i in alive]
        with telemetry.span("cluster/telemetry_drain",
                            executors=len(ids)) as sp:
            rows = self.engine.parallelize(ids, len(ids)).map_partitions(
                node.drain_telemetry(self.cluster_info)).collect(
                    placement=ids) if ids else []
            os.makedirs(rdir, exist_ok=True)
            for executor_id, name, text in rows:
                # a dump keeps its name, which postmortem tools glob for
                if not name.startswith(flight.PREFIX):
                    name = f"exec{executor_id}-{name}"
                with open(os.path.join(rdir, name), "a",
                          encoding="utf-8") as f:
                    f.write(text)
            # the driver's file, as it stands now
            telemetry.flush()
            own = telemetry.sink_path()
            for name, text in telemetry.read_spool(os.path.dirname(own)):
                if name == os.path.basename(own):
                    with open(os.path.join(rdir, name), "w",
                              encoding="utf-8") as f:
                        f.write(text)
            sp.add(files=len(rows))
        logger.info("telemetry: drained %d node files into %s", len(rows),
                    rdir)
        return rdir


def _run_scaled_worker(engine, widx, serve_fn):
    """One data worker the autoscaler added, on an idle executor."""
    try:
        engine.parallelize([widx], 1).foreach_partition(serve_fn)
    except Exception:  # noqa: BLE001 - scaling is best effort
        logger.exception("data worker %d (scaled up) failed", widx)


def _feed_placement(n, done, ids):
    """The executor of each of ``n`` partitions: those not in ``done``
    dealt round robin over ``ids`` in partition order; a partition in
    ``done`` (its feeder only drains it) goes where its index names."""
    placement = [ids[i % len(ids)] for i in range(n)]
    for k, i in enumerate(i for i in range(n) if i not in done):
        placement[i] = ids[k % len(ids)]
    return placement


def _manager_candidates(m):
    """A node's manager address, and the loopback one where the
    advertised address does not answer."""
    addr = tuple(m["addr"])
    if addr[0] in ("127.0.0.1", "localhost"):
        return [addr]
    return [addr, ("127.0.0.1", addr[1])]


def _quiesce_node(m):
    """Drive one node of a failed incarnation, perhaps already dead, to
    a terminal state: state terminating, a poison on its error queue
    (feeders waiting on consumption raise and free their executor) and
    its trainer killed.  Best effort, with a 5 s socket timeout: the
    manager may have died with its executor, whose children the respawn
    killed."""
    import socket

    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(5)
    try:
        for cand in _manager_candidates(m):
            try:
                mgr = tfmanager.connect(cand, bytes.fromhex(m["authkey"]))
            except Exception:  # noqa: BLE001 - dead with its executor
                continue
            try:
                mgr.set("state", "terminating")
                mgr.get_queue("error").put(
                    "cluster recovery: node quiesced (epoch fence)")
                bg = mgr.get("bg_pid")
                if bg:
                    kill_pid(int(str(bg)))
                    mgr.set("bg_pid", None)
            except Exception as e:  # noqa: BLE001 - best effort
                logger.warning("quiesce executor %s: %s", m["executor_id"],
                               e)
            return
        logger.info("quiesce: no manager reachable for executor %s (the "
                    "node is dead)", m["executor_id"])
    finally:
        socket.setdefaulttimeout(old)


def _unlink_ring(meta, m):
    """Unlink a quiesced compute node's feed ring when the node ran on
    this host: one that died with its executor would leave it in
    ``/dev/shm`` for good (a survivor's unmaps it at its teardown)."""
    if m["job_name"] not in node.COMPUTE_JOBS or \
            m["host"] != get_ip_address():
        return
    from tensorflowonspark_tpu_torch.recordio import shm

    name = node.feed_ring_name(meta["id"], m["executor_id"],
                               int(meta.get("epoch", 0)))
    if shm.unlink(name):
        logger.info("unlinked the feed ring %s", name)


def _elastic_template(template, alive_ids):
    """``template`` shrunk (or re-grown) to the executors in
    ``alive_ids``: every job keeps its surviving ids; a lost chief or
    master seat goes to the lowest surviving worker (some node must be
    the coordinator's task 0); dead ps and evaluator seats are dropped
    (their state lives in checkpoints); jobs left empty go."""
    alive = set(alive_ids)
    out = {job: [i for i in ids if i in alive]
           for job, ids in template.items()}
    for coord in ("chief", "master"):
        if coord in template and not out.get(coord):
            workers = out.get("worker") or []
            if workers:
                out[coord] = [workers.pop(0)]
    return {job: ids for job, ids in out.items() if ids}


def _await_cluster(server, status, timeout):
    """Wait until every node of the (re)launched incarnation registered,
    then refuse a duplicate (host, executor) registration."""
    cluster_info = server.await_reservations(status, timeout)
    seen = set()
    for m in cluster_info:
        key = (m["host"], m["executor_id"])
        if key in seen:
            raise RuntimeError(f"duplicate node registration for {key}")
        seen.add(key)
    return cluster_info


def _stop_remote_node(m):
    """None on a ps or evaluator node's control queue, through its
    remote manager (a 15 s connect timeout; the loopback address too,
    where the advertised one does not answer)."""
    import socket

    candidates = _manager_candidates(m)
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(15)
    last = None
    try:
        for cand in candidates:
            try:
                mgr = tfmanager.connect(cand, bytes.fromhex(m["authkey"]))
                mgr.get_queue("control").put(None, block=True)
                return
            except Exception as e:  # noqa: BLE001 - try the next address
                last = e
        logger.warning("could not stop %s:%s at %s: %s", m["job_name"],
                       m["task_index"], candidates, last)
    finally:
        socket.setdefaulttimeout(old)


def _run_driver_ps(node_fn, ps_id):
    """A ps node on a driver thread; its failure goes to ``tf_status``."""
    try:
        node_fn([ps_id])
    except Exception as e:  # noqa: BLE001 - reported through tf_status
        logger.exception("driver ps node %d failed", ps_id)
        tf_status["error"] = str(e)


def _launch(nodes_ds, node_fn, node_ids, retryable=False):
    """The node job, run on a background thread: node tasks of background
    trainers return at once, foreground ones when ``main_fun`` does.
    Retryable under supervision (``run(restarts=)``)."""
    try:
        nodes_ds.foreach_partition(node_fn, placement=node_ids,
                                   retryable=retryable)
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

    ``sc`` is a ``LocalEngine`` or a pyspark ``SparkContext``.
    ``map_fun(args, ctx)`` is a module-level function (executors import
    it); it runs in a process forked from each executor with
    ``background=True`` (the default for ``InputMode.SPARK``), in the
    executor itself with ``background=False`` (the default for
    ``InputMode.TENSORFLOW``), and in a forked process on ps and
    evaluator nodes whatever ``background`` says.  A forked trainer needs
    an executor that never touched CUDA (``node.run`` refuses one that
    did); a foreground SPARK-mode trainer holds its executor, so the
    feeders placed there wait until it returns.
    ``num_ps`` ps nodes take the first executors (or, with
    ``driver_ps_nodes``, which needs ``InputMode.TENSORFLOW``, run on
    driver threads beside the ``num_executors`` executors);
    ``eval_node`` makes the next one an evaluator; ``master_node``
    ("chief" or "master") takes the next; the rest are workers.
    ``num_gpus``: GPUs each compute node claims (``CUDA_VISIBLE_DEVICES``
    by same-host worker index); 0 leaves the environment as it is, as
    the CPU runs do.  ``tensorboard``: the dashboard node (the chief, or
    worker 0) starts TensorBoard on ``log_dir`` (default
    ``<cwd>/tensorboard/cluster-<id>``); see :meth:`TFCluster.
    tensorboard_url`.  ``reservation_timeout`` bounds the wait for the
    nodes to register and, in each trainer, the process group's
    collectives.

    ``restarts``: how many times ``train()`` may recover the cluster
    from a failed feed job (a lost executor, a trainer's error) before
    the error raises; 0 fails at once, with the remote traceback.
    Streaming feeds (``train_stream``, a DStream) and
    ``InputMode.TENSORFLOW`` jobs are not recovered, as in the JAX
    package.
    ``min_executors``: the elastic floor; 0 requires a recovery to heal
    the pool to full strength, ``k > 0`` lets it re-form the cluster
    over the k or more executors that survive when the respawn budget
    is spent, and re-grow it at a later recovery when the pool came
    back.  The trainers read the new shape from ``ctx`` and place their
    state through ``ctx.elastic_runtime``.

    ``data_workers``: the data service's worker count when ``train()``
    is given a ``data.Pipeline`` (0: ``TFOS_DATA_WORKERS``, default 1);
    ``data_dispatch``: ``"dynamic"`` (the default: first-come-first-
    served splits) or ``"static"`` (rank-strided shards);
    ``TFOS_DATA_DISPATCH`` overrides it."""
    if background is None:
        background = input_mode == InputMode.SPARK
    if driver_ps_nodes and input_mode != InputMode.TENSORFLOW:
        raise ValueError("driver_ps_nodes requires InputMode.TENSORFLOW")
    if num_ps >= num_executors and not driver_ps_nodes:
        raise ValueError("num_ps must be less than num_executors (or use "
                         "driver_ps_nodes)")
    start_t0 = time.perf_counter()
    if os.environ.get(telemetry.DIR_ENV):
        # the driver's identity before any node runs in this process
        # (driver ps nodes keep it), and the run's root trace
        telemetry.configure(node_id="driver", role="driver")
        telemetry.trace_root(telemetry.CLUSTER_RUN, executors=num_executors)
    eng = engine_mod.as_engine(sc)
    queues = list(queues)
    if num_executors > eng.num_executors:
        raise ValueError(f"num_executors {num_executors} > the engine's "
                         f"{eng.num_executors}")

    # ids past the executors are the driver's ps nodes
    cluster_size = num_executors + (num_ps if driver_ps_nodes else 0)
    ids = list(range(cluster_size))
    template = {}
    if driver_ps_nodes:
        template["ps"] = ids[num_executors:]
        pool = ids[:num_executors]
    else:
        if num_ps:
            template["ps"] = ids[:num_ps]
        pool = ids[num_ps:]
    if eval_node:
        template["evaluator"] = [pool.pop(0)]
    if master_node:
        if master_node not in ("chief", "master"):
            raise ValueError("master_node must be 'chief' or 'master'")
        template[master_node] = [pool.pop(0)]
    if pool:
        template["worker"] = pool
    logger.info("cluster template: %s", template)

    server = rendezvous.Server(cluster_size)
    server_addr = server.start()
    cluster_meta = {
        "id": random.getrandbits(64),
        "epoch": 0,  # the cluster incarnation; _recover bumps it in place
        "cluster_template": template,
        "num_executors": num_executors,
        "default_fs": eng.default_fs,
        "working_dir": os.getcwd(),
        "server_addr": list(server_addr),
        "authkey": secrets.token_hex(16),
        "reservation_timeout": reservation_timeout,
        "data_workers": int(data_workers),
        "data_dispatch": data_dispatch,
    }
    tf_status.clear()
    node_args = dict(tensorboard=tensorboard, log_dir=log_dir,
                     queues=queues, num_gpus=num_gpus,
                     background=bool(background))
    node_fn = node.run(map_fun, tf_args, cluster_meta, **node_args)
    node_ids = list(range(num_executors))
    side = {i for job in node.SIDE_JOBS for i in template.get(job, ())}

    c = TFCluster()
    c.engine = eng
    c.meta = c.cluster_meta = cluster_meta
    c.input_mode = input_mode
    c.queues = queues
    c.server = server
    c.restarts = int(restarts)
    c.min_executors = int(min_executors)
    c._node_fn = node_fn
    c._nodes_ds = eng.parallelize(node_ids, len(node_ids))
    c._node_ids = node_ids
    c._all_node_ids = list(node_ids)
    c._template0 = {k: list(v) for k, v in template.items()}
    c._feed_ids = [i for i in node_ids if i not in side]
    if driver_ps_nodes:
        driver_fn = node.run(map_fun, tf_args, cluster_meta, in_driver=True,
                             **node_args)
        c._driver_ps = [threading.Thread(
            target=_run_driver_ps, args=(driver_fn, ps_id),
            name=f"tfos-driver-ps-{ps_id}", daemon=True)
            for ps_id in template["ps"]]
        for t in c._driver_ps:
            t.start()
    c._launcher = c._spawn_launcher()
    try:
        c.cluster_info = _await_cluster(server, tf_status,
                                        reservation_timeout)
    except BaseException:
        server.stop()
        raise
    telemetry.record_span("cluster/start", time.perf_counter() - start_t0,
                          cluster=f"{cluster_meta['id'] & 0xffffffff:x}",
                          executors=num_executors,
                          nodes=len(c.cluster_info))
    from tensorflowonspark_tpu_torch import obs

    c.obs = obs.start_for_cluster(c)
    return c
