"""Executor-side node runtime.

An own copy of ``tensorflowonspark_tpu/node.py``, less the
observability planes.  One node per engine executor; the node task:

1. derives its job and task index from the cluster template,
2. claims GPUs for a compute node (chief, master, worker) through
   ``gpu_info`` (``CUDA_VISIBLE_DEVICES``, with no CUDA call in the
   executor); ps and evaluator nodes claim none,
3. starts the executor's IPC manager (``manager``; "remote" for ps and
   evaluator nodes, whose control queue the driver reaches), and, on the
   dashboard node, TensorBoard (``utils.profiler``), whose port travels
   in the reservation,
4. reserves a port, registers with the driver's rendezvous server and
   waits for the whole cluster,
5. runs the user's ``main_fun(args, ctx)``: in the foreground, or for
   ``InputMode.SPARK`` in a trainer *forked* from the executor, so the
   executor's slot frees up for the feeder tasks.  The trainer joins the
   job through ``ctx.torch_initialize()``.  A ps or evaluator node runs
   ``main_fun`` in a forked process too, with no GPU visible, and holds
   its slot until the driver's stop message (``_control_wait_loop``).

A trainer forked from a process that holds a CUDA context cannot use
CUDA.  Executors never touch CUDA themselves, but a job run on one may
(``pipeline.TFModel.transform`` predicts in the executor, and
``InputMode.TENSORFLOW`` trains there): a node asked to fork a trainer
in such an executor refuses at once with an error that says so.

The feeder, inference and shutdown tasks reattach to the node's manager
through the executor-id file and move data in chunks.  The 'input'
chunks go through a shared-memory ring (``recordio.shm``) that the node
creates for its executor and advertises in the manager's KV
(``shm_input``), with no trip through the manager process; numeric
records travel as ``marker.ColumnChunk``s (``_make_chunk_encoder``).
Where the ring cannot be made (``TFOS_SHM_FEED=0``, no compiler, too
little ``/dev/shm``), the manager queue carries them, as in the JAX
package.  ``run``, ``train``, ``inference`` and ``shutdown`` are
module-level classes, which the engine ships with plain ``pickle``.

Switches, read where the task runs: ``TFOS_SHM_FEED`` (1; 0 for the
manager queue), ``TFOS_SHM_FEED_BYTES`` (the ring's capacity, 256 MiB),
``TFOS_COLUMNAR_FEED`` (1; 0 keeps row chunks), ``TFOS_FEED_CHUNK``
(records a chunk, 1024), ``TFOS_NODE_PORT`` (the port a node reserves
for the coordinator; a free one by default), ``TFOS_REAP_TIMEOUT``
(shutdown's wait for a healthy trainer, 600 s, at least ``grace_secs``),
and the bring-up health check's ``TFOS_SLICE_HEALTH`` (lenient; strict,
warn) and ``TFOS_SLICE_HEALTH_TIMEOUT`` (60 s).

Cluster recovery relaunches nodes as a new incarnation (the cluster
meta's ``epoch``): a node of an earlier epoch still on the executor is
torn down before the new one boots, the ring's name carries the epoch,
the node registers stamped with it, and its context hands it to
``main_fun`` (``ctx.epoch``, ``ctx.restore_latest``,
``ctx.elastic_runtime``).  The re-fed ``train`` task drains the
partitions consumed before the recovery (``skip``) without feeding
them.

Observability: the node pins its processes' telemetry identity
(``<job>-<task>``) and a spool directory outside the engine's scratch
(``<TFOS_TELEMETRY_DIR>/spool-<cluster>-<job>-<task>``), which it and
its trainer advertise in the manager's KV, where ``drain_telemetry``
finds them at shutdown.  The process that runs ``main_fun`` (the forked
trainer, whose registry and CUDA context live there) runs the metrics
publisher (``obs.publish``) beside the heartbeat.  A ``HealthHalt``
from the health watchtower stops the node cleanly: state
``terminating`` (feeders drain), no exit barrier, a ``health/halt``
event.
"""

from __future__ import annotations

import datetime
import glob
import json
import logging
import multiprocessing
import os
import queue as _queue
import socket
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from tensorflowonspark_tpu_torch import engine, gpu_info, marker, rendezvous
from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.utils import (
    faults,
    get_ip_address,
    read_executor_id,
    reap_child,
    telemetry,
    track_child_pid,
    write_executor_id,
)

logger = logging.getLogger(__name__)

COMPUTE_JOBS = ("chief", "master", "worker")
SIDE_JOBS = ("ps", "evaluator")  # outside the process group; no GPU


FEED_CHUNK_RECORDS = 1024  # records a chunk, unless TFOS_FEED_CHUNK says
SHM_FEED_BYTES = 256 << 20  # the ring's capacity, unless TFOS_SHM_FEED_BYTES
REAP_TIMEOUT_SECS = 600.0  # a healthy trainer's exit; TFOS_REAP_TIMEOUT
FEED_STATS_KEPT = 64  # feeder records kept in the KV's 'feed_stats'
FEED_CHUNK_SPANS_KEPT = 16  # chunks a feeder record times one by one


def _reap_budget(err, grace_secs):
    """Seconds shutdown waits for the trainer to exit: 5 for a trainer
    that failed, else ``max(grace_secs, TFOS_REAP_TIMEOUT)`` (600)."""
    if err is not None:
        return 5.0
    return max(grace_secs, float(os.environ.get("TFOS_REAP_TIMEOUT",
                                                REAP_TIMEOUT_SECS)))


def _reserve_port():
    """A socket bound to the port this node reserves for the job's
    coordinator: ``TFOS_NODE_PORT`` when set, else a free one.  The
    caller closes it just before rank 0's store binds the port."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    port_env = os.environ.get("TFOS_NODE_PORT")
    try:
        sock.bind(("", int(port_env) if port_env else 0))
    except BaseException:
        sock.close()
        raise
    return sock


def _feed_chunk_records():
    """Records a chunk, read where the feeder runs (an executor's env may
    differ from the driver's)."""
    try:
        return int(os.environ.get("TFOS_FEED_CHUNK", "")) or \
            FEED_CHUNK_RECORDS
    except ValueError:
        return FEED_CHUNK_RECORDS


class _NodeState:
    """This executor process's node incarnation."""

    mgr = None
    cluster_id = None
    epoch = 0  # the cluster incarnation this node belongs to
    ring = None  # the shm feed ring this node created, if any
    tb_proc = None  # the dashboard node's TensorBoard


def _close_ring():
    """Close and unlink the node's ring (and stop advertising it)."""
    ring, _NodeState.ring = _NodeState.ring, None
    if ring is None:
        return
    try:
        if _NodeState.mgr is not None and \
                _NodeState.mgr.get("shm_input") == ring.name:
            _NodeState.mgr.set("shm_input", None)
    except Exception:  # noqa: BLE001 - the manager may be gone
        pass
    ring.close()


def feed_ring_name(cluster_id, executor_id, epoch=0):
    """The POSIX shm name of a node's feed ring, the JAX package's
    scheme: the epoch in the name, so that a recovered node never opens
    the segment of a dead incarnation."""
    return (f"/tfos-{cluster_id & 0xffffffff:x}"
            f"{f'-e{epoch}' if epoch else ''}-{executor_id}")


def _make_ring(cluster_id, executor_id, mgr, epoch=0):
    """Create this node's feed ring and advertise it, unless
    ``TFOS_SHM_FEED=0``.  A ring that cannot be made is logged, and the
    manager queue carries the feed."""
    if os.environ.get("TFOS_SHM_FEED", "1") == "0":
        return
    try:
        from tensorflowonspark_tpu_torch.recordio import shm

        name = feed_ring_name(cluster_id, executor_id, epoch)
        cap = int(os.environ.get("TFOS_SHM_FEED_BYTES", "") or
                  SHM_FEED_BYTES)
        _NodeState.ring = shm.ShmQueue(name, cap, create=True)
        mgr.set("shm_input", name)
    except (OSError, RuntimeError, ValueError) as e:
        logger.warning("shm feed ring unavailable, feeding through the "
                       "manager queue: %s", e)


def _teardown_node_state():
    """Dismantle this executor's node (trainer, ring, manager), so that
    the next cluster boots clean on it.  Best-effort: it may be half
    dead."""
    mgr = _NodeState.mgr
    if mgr is not None:
        try:
            bg = mgr.get("bg_pid")
            if bg:
                reap_child(int(bg), timeout=0.2, term_first=False)
        except Exception:  # noqa: BLE001 - manager may be gone
            pass
    try:
        _close_ring()
    except Exception:  # noqa: BLE001
        pass
    if mgr is not None:
        try:
            mgr.shutdown()
        except Exception:  # noqa: BLE001
            pass
    _stop_tensorboard()
    _NodeState.mgr = None
    _NodeState.cluster_id = None
    _NodeState.epoch = 0


def _stop_tensorboard():
    tb, _NodeState.tb_proc = _NodeState.tb_proc, None
    if tb is not None:
        from tensorflowonspark_tpu_torch.utils import profiler

        profiler.stop_tensorboard(tb)


def _cuda_initialized():
    """True when this process holds a CUDA context (checked without
    importing torch: a process that never imported it holds none)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _get_cluster_spec(cluster_info):
    """{job: [node meta sorted by executor id]}; duplicate task indices
    raise."""
    spec = {}
    for meta in sorted(cluster_info, key=lambda m: m["executor_id"]):
        spec.setdefault(meta["job_name"], []).append(meta)
    for job, nodes in spec.items():
        seen = {}
        for n in nodes:
            if n["task_index"] in seen:
                raise RuntimeError(
                    f"duplicate task_index {n['task_index']} in job {job}: "
                    f"{n} vs {seen[n['task_index']]}")
            seen[n["task_index"]] = n
    return spec


def _distributed_env(cluster_info):
    """What joining the job needs: compute processes (chief/master/
    worker) get contiguous ranks with the chief first; the coordinator is
    rank 0's reserved host:port; ``local_ranks`` number the processes
    that share a host, in rank order."""
    compute = [m for m in cluster_info if m["job_name"] in COMPUTE_JOBS]
    compute.sort(key=lambda m: (m["job_name"] not in ("chief", "master"),
                                m["executor_id"]))
    ids = {m["executor_id"]: i for i, m in enumerate(compute)}
    per_host = {}
    local = {}
    for m in compute:
        local[m["executor_id"]] = per_host.get(m["host"], 0)
        per_host[m["host"]] = local[m["executor_id"]] + 1
    coordinator = (f"{compute[0]['host']}:{compute[0]['port']}"
                   if compute else None)
    return {"coordinator_address": coordinator,
            "num_processes": len(compute), "process_ids": ids,
            "local_ranks": local}


HEALTH_MODE_ENV = "TFOS_SLICE_HEALTH"
HEALTH_MODES = ("strict", "lenient", "warn")


def enforce_slice_health(health):
    """Apply ``TFOS_SLICE_HEALTH`` to a ``gpu_info.slice_health`` report,
    as the JAX package's ``jax_initialize`` does: ``lenient`` (the
    default) raises on a definite finding (wrong counts, GPUs CUDA does
    not see, a wrong product) but only warns on a probe that merely timed
    out (``bare_timeout``: a first contact slower than the bound);
    ``strict`` raises on both; ``warn`` only logs.  An unknown mode
    warns and counts as ``lenient``.  The raise reaches the cluster's
    caller through the node's error queue."""
    if health["healthy"]:
        logger.info("slice healthy: %d local / %d global devices (%s)",
                    health["local_devices"], health["global_devices"],
                    health["platform"])
        return
    logger.error("slice health check failed: %s", health["errors"])
    mode = os.environ.get(HEALTH_MODE_ENV, "lenient").strip().lower()
    if mode not in HEALTH_MODES:
        logger.warning("unknown %s=%r; treating as 'lenient' (valid: "
                       "strict|lenient|warn)", HEALTH_MODE_ENV, mode)
        mode = "lenient"
    if mode != "warn" and not (health.get("bare_timeout", False)
                               and mode == "lenient"):
        raise RuntimeError(
            f"unhealthy accelerator slice: {health['errors']}")


class TFNodeContext:
    """Node metadata handed to the user's ``main_fun``."""

    def __init__(self, executor_id, job_name, task_index, cluster_spec,
                 default_fs, working_dir, mgr, cluster_info=None,
                 timeout=600, epoch=0):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.mgr = mgr
        self.cluster_info = cluster_info or []
        self.timeout = timeout  # seconds: the process group's timeout
        self.epoch = epoch  # the cluster incarnation (recovery bumps it)
        self.device = None  # torch_initialize's device
        self._torch_distributed = False

    @property
    def num_workers(self):
        """The compute nodes (chief, master, workers) of the cluster."""
        return sum(len(v) for k, v in self.cluster_spec.items()
                   if k in COMPUTE_JOBS)

    def absolute_path(self, path):
        """``path`` against the cluster's default filesystem
        (``feed.hdfs_path``)."""
        from tensorflowonspark_tpu_torch import feed

        return feed.hdfs_path(self, path)

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None, metrics=None):
        from tensorflowonspark_tpu_torch.feed import DataFeed

        return DataFeed(self.mgr, train_mode, qname_in, qname_out,
                        input_mapping, metrics)

    def restore_latest(self, ckpt_dir, target_shardings=None):
        """``(tree, step)`` from the newest restorable checkpoint in
        ``ckpt_dir``, or ``(None, 0)``: a training ``main_fun`` calls it
        at start, so a relaunched incarnation goes on from where the
        dead one last saved.  ``target_shardings`` (a tree of ``(mesh,
        placements)`` or a callable ``tree -> shardings``) places the
        leaves on this incarnation's mesh, as after an elastic resize
        (``utils.checkpoint.restore_any``)."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        tree, step = ckpt.restore_any(ckpt_dir,
                                      target_shardings=target_shardings)
        telemetry.event("node/resume", step=step, epoch=self.epoch,
                        found=tree is not None,
                        resharded=target_shardings is not None)
        if tree is not None:
            logger.info("node %s:%s resuming from step %d (epoch %d)",
                        self.job_name, self.task_index, step, self.epoch)
        return tree, step

    def elastic_runtime(self, mesh_axes, devices=None, global_batch=0,
                        accum_axis="data"):
        """An ``elastic.ElasticRuntime`` for this node: the logical mesh
        ``mesh_axes`` resolved over this incarnation's devices (default:
        one a rank of the job, this rank's being the one
        :meth:`torch_initialize` took), the deficit of a shrunk cluster
        made up by gradient accumulation."""
        from tensorflowonspark_tpu_torch import elastic

        return elastic.from_context(
            self, elastic.TrainSpec(mesh_axes=dict(mesh_axes),
                                    global_batch=int(global_batch),
                                    accum_axis=accum_axis),
            devices=devices)

    def distributed_env(self):
        """``{coordinator_address, num_processes, process_id,
        local_rank}``; process_id None for a node outside the job."""
        env = _distributed_env(self.cluster_info)
        return {"coordinator_address": env["coordinator_address"],
                "num_processes": env["num_processes"],
                "process_id": env["process_ids"].get(self.executor_id),
                "local_rank": env["local_ranks"].get(self.executor_id)}

    def torch_initialize(self, device=None, backend=None):
        """Check the devices and join the job's process group.

        ``device``: None or ``"cuda"`` takes CUDA device ``local_rank``
        modulo the visible count (0 after a ``num_gpus`` claim, which
        left this worker only its own).  Pass ``"cpu"`` for the CPU.

        First the bring-up health check, ``gpu_info.slice_health``, on
        the device this rank takes: the process's first CUDA contact, on
        a thread bounded by ``TFOS_SLICE_HEALTH_TIMEOUT`` (60 s), so that
        a wedged card shows as a report and not as a hang; the ranks'
        device counts meet in the job's key-value store, under keys of
        this cluster epoch.  ``TFOS_SLICE_HEALTH`` (strict, lenient,
        warn) decides what is fatal, as in the JAX package
        (:func:`enforce_slice_health`), before this thread makes any CUDA
        call of its own.  Under lenient, a probe still stuck at its
        timeout is let through with a warning, and this thread's first
        CUDA call (``resolve_device``, ``set_device``) then waits for the
        probe's first contact to end.

        The port's device rule wins over ``warn``: a job asked onto the
        card with no CUDA raises (``resolve_device``) whatever the mode;
        it never runs on the CPU unasked.

        A job of more than one process then calls ``init_process_group``
        over a ``TCPStore`` on the coordinator's address, with the node's
        rank and ``backend``: by default NCCL on CUDA and gloo on the CPU;
        ``backend="gloo"`` on CUDA lets ranks share one card, which NCCL
        refuses.  Returns :meth:`distributed_env` with ``device`` and the
        report, ``slice_health``, added.

        A ps or evaluator node is outside the job (``process_id``
        None): it joins no group, claims no device and gets
        :meth:`distributed_env` back as it is, as the JAX package's
        ``jax_initialize`` does; its process sees no GPU."""
        import torch

        from tensorflowonspark_tpu_torch import resolve_device

        env = self.distributed_env()
        if env["process_id"] is None:
            return env
        want = torch.device("cuda" if device is None else device)
        store = health_store = None
        if env["num_processes"] > 1:
            import torch.distributed as dist

            host, port = env["coordinator_address"].rsplit(":", 1)
            # not waiting for the workers here: a peer that never comes
            # shows in the bounded probe's count
            store = dist.TCPStore(
                host, int(port), env["num_processes"],
                env["process_id"] == 0,
                timeout=datetime.timedelta(seconds=self.timeout),
                wait_for_workers=False, multi_tenant=True)
            # the epoch's own keys: a group re-formed after a recovery
            # never reads an earlier incarnation's counts
            health_store = dist.PrefixStore(
                f"tfos/slice_health/e{self.epoch}", store)
        health = gpu_info.slice_health(
            expected_processes=env["num_processes"], device=want,
            store=health_store, rank=env["process_id"],
            world_size=env["num_processes"], local_rank=env["local_rank"])
        # before any CUDA call of this thread, which a wedged card would
        # hang: a fatal report raises here
        enforce_slice_health(health)
        dev = want
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)  # raises without a card, even under warn
            dev = torch.device(
                "cuda", env["local_rank"] % torch.cuda.device_count())
        dev = resolve_device(dev)
        self.device = dev
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if store is not None:
            import torch.distributed as dist

            if backend is None:
                backend = "nccl" if dev.type == "cuda" else "gloo"
            dist.init_process_group(
                backend, store=store, world_size=env["num_processes"],
                rank=env["process_id"],
                timeout=datetime.timedelta(seconds=self.timeout))
            self._torch_distributed = True
        logger.info("rank %d of %d on %s (%s)", env["process_id"],
                    env["num_processes"], dev, health["kind"])
        env.update(device=dev, slice_health=health)
        return env

    def sync_exit_barrier(self):
        """Run after the user's code returns: every process waits for
        its peers, then leaves the process group, so a process that
        finishes first does not tear down a peer's last collective.
        Does nothing unless :meth:`torch_initialize` started a group."""
        if not self._torch_distributed:
            return
        import torch
        import torch.distributed as dist

        try:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()
        except Exception as e:  # noqa: BLE001 - best-effort on teardown
            logger.warning("exit barrier failed: %s", e)
        finally:
            self._leave_group()

    def _leave_group(self):
        if self._torch_distributed:
            import torch.distributed as dist

            self._torch_distributed = False
            dist.destroy_process_group()

    def export_env(self):
        """Export the job's bootstrap values for subprocesses."""
        env = self.distributed_env()
        os.environ["TFOS_COORDINATOR"] = env["coordinator_address"] or ""
        os.environ["TFOS_NUM_PROCESSES"] = str(env["num_processes"])
        os.environ["TFOS_PROCESS_ID"] = str(
            env["process_id"] if env["process_id"] is not None else -1)
        os.environ["TFOS_CLUSTER_SPEC"] = json.dumps(
            {k: [f"{m['host']}:{m['port']}" for m in v]
             for k, v in self.cluster_spec.items()})


def _job_for_executor(cluster_template, executor_id):
    for job, ids in cluster_template.items():
        if executor_id in ids:
            return job, sorted(ids).index(executor_id)
    raise RuntimeError(f"executor {executor_id} not in template "
                       f"{cluster_template}")


def _same_host_index(executor_id):
    """This worker's index among the executors of its host."""
    try:
        return int(os.environ.get("TFOS_EXECUTOR_INDEX", executor_id))
    except (TypeError, ValueError):
        return executor_id


def _run_main(fn, args, ctx, mgr):
    """The user's ``main_fun`` with the heartbeat, the metrics publisher,
    the exit barrier and a final telemetry flush around it.  A
    ``HealthHalt`` (the watchtower's ``halt``, its checkpoint written)
    stops the node cleanly: state terminating, so that the feeders
    drain, and no exit barrier."""
    from tensorflowonspark_tpu_torch.obs import health, publish

    if isinstance(args, list):
        sys.argv = args
    hb = tfmanager.start_heartbeat(mgr)
    obs_id = f"{ctx.job_name}-{ctx.task_index}"
    pub = publish.start_publisher(mgr, obs_id, role=ctx.job_name)
    try:
        with telemetry.span("node/main", job=ctx.job_name,
                            task=ctx.task_index):
            faults.check("node.main", job=ctx.job_name, task=ctx.task_index)
            fn(args, ctx)
        ctx.sync_exit_barrier()
    except health.HealthHalt as e:
        logger.warning("node %s:%d health halt: %s", ctx.job_name,
                       ctx.task_index, e)
        telemetry.event("health/halt", job=ctx.job_name,
                        task=ctx.task_index, reason=str(e))
        try:
            mgr.set("state", "terminating")
        except Exception:  # noqa: BLE001 - the manager is tearing down
            pass
    finally:
        hb.set()
        if pub is not None:
            pub.set()
            # the thread's last publish races the exit: land it here
            publish.publish_once(mgr, obs_id, role=ctx.job_name)
        try:
            ctx._leave_group()  # after a failure: no barrier, just leave
        finally:
            telemetry.flush()


def _run_background(fn, args, ctx, mgr):
    """The forked trainer: its own spool file advertised for the drain,
    and a failure put on the error queue, where the feeders and the
    shutdown task find it."""
    telemetry.register_with(mgr)
    try:
        _run_main(fn, args, ctx, mgr)
    except Exception:  # noqa: BLE001 - forwarded through the error queue
        mgr.get_queue("error").put(traceback.format_exc())


def _run_side_role(fn, args, ctx, mgr):
    """A ps or evaluator node's forked process: no GPU visible (the role
    owns no accelerator, and its parent may hold a CUDA context, which a
    forked child cannot use), then the user's code, whose failure goes
    to the error queue that the node's control loop watches."""
    os.environ[gpu_info.MASK_ENV] = ""
    _run_background(fn, args, ctx, mgr)


def _control_wait_loop(mgr, job_name, bg_pid, poll=0.2):
    """Hold a ps or evaluator node's slot until the driver puts None on
    its control queue; then reap its process (it has had until then to
    finish) and mark the node stopped.  The process's error raises."""
    queue = mgr.queue("control")
    equeue = mgr.queue("error")
    while True:
        if not equeue.empty():
            err = equeue.get()
            reap_child(bg_pid, timeout=0.2)
            raise RuntimeError(f"exception in {job_name}:\n{err}")
        try:
            msg = queue.get(timeout=poll)
        except _queue.Empty:
            continue
        logger.info("%s got control message %r", job_name, msg)
        if msg is None:
            break
    if not reap_child(bg_pid, timeout=5.0):
        logger.warning("%s: process %s did not exit and was killed",
                       job_name, bg_pid)
    mgr.set("bg_pid", None)
    mgr.set("state", "stopped")


def _dashboard(template, job_name, task_index):
    """True for the node that hosts TensorBoard: task 0 of the chief or
    master job, or worker 0 when the cluster has neither."""
    if task_index != 0 or job_name not in COMPUTE_JOBS:
        return False
    has_chief = "chief" in template or "master" in template
    return job_name in ("chief", "master") or not has_chief


class run:  # noqa: N801 - named as the JAX package's node.run
    """The node-startup task: ``run(fn, tf_args, cluster_meta, ...)``
    is called by the engine with the iterator of its one partition (the
    executor id).

    ``in_driver``: the node is a ps node hosted on a driver thread
    (``cluster.run(driver_ps_nodes=True)``): it keeps no per-process
    node state and writes no executor-id file, since the driver may host
    several, and shuts its manager down when it stops."""

    def __init__(self, fn, tf_args, cluster_meta, tensorboard=False,
                 log_dir=None, queues=None, background=False, num_gpus=0,
                 in_driver=False):
        self.fn = fn
        self.tf_args = tf_args
        self.cluster_meta = cluster_meta
        self.tensorboard = tensorboard
        self.log_dir = log_dir
        self.queues = list(queues or ["input", "output", "error",
                                      "control"])
        self.background = background
        self.num_gpus = int(num_gpus)
        self.in_driver = in_driver

    def __call__(self, iterator):
        boot_t0 = time.perf_counter()
        executor_id = None
        for item in iterator:  # one element per spread partition
            executor_id = item
        if executor_id is None:
            raise RuntimeError("empty node partition")
        meta = self.cluster_meta

        # (1) role from the template
        job_name, task_index = _job_for_executor(meta["cluster_template"],
                                                 executor_id)
        side = job_name in SIDE_JOBS
        forks_trainer = self.background and not side
        if forks_trainer and _cuda_initialized():
            raise RuntimeError(
                f"executor {executor_id} holds a CUDA context (a job on it "
                "used CUDA in the executor process: TFModel.transform, "
                "TFCluster.serve, an InputMode.TENSORFLOW main_fun), and a "
                "trainer forked from it cannot use CUDA; run this cluster "
                "on an engine whose executors never touched CUDA")
        # (2) GPUs for a compute node, before the trainer forked below
        # reads the env; ps and evaluator nodes own none
        if not side:
            gpu_info.claim_gpus(self.num_gpus, _same_host_index(executor_id))
        # telemetry identity and spool for this process and the trainer
        # it forks, outside the engine's scratch (which stop() deletes:
        # a flight dump written before a crash must survive it)
        if not self.in_driver and \
                os.environ.get(telemetry.ROLE_ENV) != "driver":
            base = os.environ.get(telemetry.DIR_ENV) or os.path.join(
                tempfile.gettempdir(), ".tfos_telemetry")
            telemetry.configure(
                node_id=f"{job_name}-{task_index}", role=job_name,
                spool=os.path.join(
                    os.path.abspath(base),
                    f"spool-{meta['id'] & 0xffffffff:x}-{job_name}-"
                    f"{task_index}"))
        faults.check("node.boot", executor=executor_id, job=job_name)

        # (3) one node per executor: a live node of this cluster and
        # epoch here is a duplicate placement; one of an earlier cluster
        # or epoch (recovery relaunched this node) is torn down
        epoch = int(meta.get("epoch", 0))
        if not self.in_driver and _NodeState.mgr is not None:
            if _NodeState.cluster_id == meta["id"]:
                try:
                    state = str(_NodeState.mgr.get("state"))
                except Exception:  # noqa: BLE001 - its server is dead
                    state = None
                if _NodeState.epoch == epoch and \
                        state in ("running", "terminating"):
                    raise RuntimeError(f"executor already hosts a node of "
                                       f"cluster {meta['id']}")
                logger.info("tearing down the node of epoch %d (state %s) "
                            "before booting epoch %d", _NodeState.epoch,
                            state, epoch)
            _teardown_node_state()
        mgr = tfmanager.start(bytes.fromhex(meta["authkey"]), self.queues,
                              "remote" if side else "local")
        if self.in_driver:
            try:
                self._boot_and_run(mgr, executor_id, job_name, task_index,
                                   boot_t0)
            finally:
                mgr.shutdown()
            return
        _NodeState.mgr = mgr
        _NodeState.cluster_id = meta["id"]
        _NodeState.epoch = epoch
        write_executor_id(executor_id)
        self._boot_and_run(mgr, executor_id, job_name, task_index, boot_t0)

    def _boot_and_run(self, mgr, executor_id, job_name, task_index,
                      boot_t0):
        meta = self.cluster_meta
        epoch = int(meta.get("epoch", 0))
        # everything up to the user's code is boot: a failure (a REJECT
        # of a stale epoch among them) releases the node, so that the
        # executor can host another
        try:
            # the 'input' feed's ring, before any feeder or the trainer
            # looks for it; ps and evaluator nodes are fed nothing
            if job_name in COMPUTE_JOBS and not self.in_driver:
                _make_ring(meta["id"], executor_id, mgr, epoch)
            # (4) reserve the coordinator's port, register, await peers
            client = rendezvous.Client(meta["server_addr"])
            host = get_ip_address()
            tmp_sock = _reserve_port()
            addr = list(mgr.address)
            if addr[0] in ("", "0.0.0.0"):
                addr[0] = host  # a remote manager: a dialable address
            node_meta = {
                "executor_id": executor_id, "host": host,
                "job_name": job_name, "task_index": task_index,
                "port": tmp_sock.getsockname()[1],
                "addr": addr, "authkey": meta["authkey"],
            }
            # the dashboard's port travels with the reservation; its pid
            # goes to the KV, where the shutdown task finds it
            if self.tensorboard and _dashboard(meta["cluster_template"],
                                               job_name, task_index):
                from tensorflowonspark_tpu_torch.utils import profiler

                tb_dir = self.log_dir or os.path.join(
                    meta["working_dir"], "tensorboard",
                    f"cluster-{meta['id'] & 0xffffffff:x}")
                tb, tb_port = profiler.launch_tensorboard(tb_dir)
                if tb is not None:
                    telemetry.event("node/tb_spawn", port=tb_port,
                                    pid=tb.pid)
                    _NodeState.tb_proc = tb
                    node_meta["tb_port"] = tb_port
                    mgr.set("tb_pid", tb.pid)
                    track_child_pid(tb.pid)
            client.register(node_meta, epoch=epoch)
            cluster_info = client.await_reservations(
                timeout=meta["reservation_timeout"])
            client.close()
            ctx = TFNodeContext(
                executor_id, job_name, task_index,
                _get_cluster_spec(cluster_info), meta["default_fs"],
                meta["working_dir"], mgr, cluster_info,
                timeout=meta["reservation_timeout"], epoch=epoch)
            if not self.in_driver:
                ctx.export_env()
            # released as late as possible: rank 0's store binds it next
            tmp_sock.close()
            # the spool, advertised for the shutdown's drain
            telemetry.register_with(mgr)
            telemetry.record_span("node/boot",
                                  time.perf_counter() - boot_t0,
                                  executor=executor_id,
                                  nodes=len(cluster_info))
        except BaseException:
            telemetry.flush()
            if not self.in_driver:
                _teardown_node_state()
            raise

        # (5) execute
        side = job_name in SIDE_JOBS
        if side or self.background:
            # fork, not spawn: the child inherits the node's context and
            # manager; a trainer's executor never touched CUDA (checked
            # above), so the trainer can
            p = multiprocessing.get_context("fork").Process(
                target=_run_side_role if side else _run_background,
                args=(self.fn, self.tf_args, ctx, mgr),
                name=f"tfos-{job_name}-{executor_id}", daemon=side)
            p.start()
            # the shutdown task (manager KV) and the engine's teardown
            # (pid file) can both find the child
            mgr.set("bg_pid", p.pid)
            track_child_pid(p.pid)
            if side:
                _control_wait_loop(mgr, job_name, p.pid)
        else:
            _run_main(self.fn, self.tf_args, ctx, mgr)


def _get_manager(cluster_info, executor_id):
    """This executor's manager: the node's own when this process hosts
    it (feeder and shutdown tasks run where the node runs), whose KV and
    queue proxies are made once, else a new connection.  A connection
    and each proxy cost handshakes over loopback TCP, up to a few hundred
    ms a task, where a step may take 0.2 s."""
    for meta in cluster_info:
        if meta["executor_id"] == executor_id:
            mgr = _NodeState.mgr
            if mgr is not None and \
                    tuple(mgr.address) == tuple(meta["addr"]):
                return mgr
            return tfmanager.connect(tuple(meta["addr"]),
                                     bytes.fromhex(meta["authkey"]))
    raise RuntimeError(f"no node of this cluster on executor {executor_id}")


def _raise_if_consumer_lost(mgr, equeue):
    """Fail the feeder fast when the consumer errored or died.  The error
    queue is peeked (get, put back), so the shutdown task still sees the
    failure."""
    if not equeue.empty():
        e_str = equeue.get()
        equeue.task_done()
        equeue.put(e_str)
        raise RuntimeError(f"exception in worker:\n{e_str}")
    age = tfmanager.heartbeat_age(mgr)
    if age is not None and age > tfmanager.HEARTBEAT_STALE_SECS:
        raise RuntimeError(f"consumer appears dead: no heartbeat for "
                           f"{age:.0f}s (stale after "
                           f"{tfmanager.HEARTBEAT_STALE_SECS:.0f}s)")


def _await_consumption(mgr, waiter, feed_timeout, poll=0.05):
    """Wait while ``waiter()`` is True (data still queued), polling the
    error queue and the consumer's heartbeat; True once consumed, False
    when the node turned ``terminating`` first (its consumer stopped,
    a health halt among the causes: what is queued stays unconsumed)."""
    equeue = mgr.queue("error")
    deadline = time.monotonic() + feed_timeout
    polls = 0
    while waiter():
        _raise_if_consumer_lost(mgr, equeue)
        if time.monotonic() > deadline:
            raise TimeoutError("timed out waiting for consumption of "
                               "partition")
        polls += 1
        if polls % 20 == 0 and str(mgr.get("state")) == "terminating":
            return False
        time.sleep(poll)
    return True


def _partition_index():
    """This feed task's partition id: Spark's ``TaskContext`` under
    pyspark, else the one the engine exported; -1 when neither knows."""
    if "pyspark" in sys.modules:
        try:
            from pyspark import TaskContext

            tc = TaskContext.get()
            if tc is not None:
                return int(tc.partitionId())
        except Exception:  # noqa: BLE001 - no Spark task here
            pass
    try:
        return int(os.environ.get("TFOS_PARTITION_INDEX", "-1"))
    except ValueError:
        return -1


def _make_chunk_encoder():
    """Per-partition chunk encoder: all-numeric row chunks become
    ``marker.ColumnChunk``s (``recordio.marshal.rows_to_columns``), whose
    columns the ring carries as raw bytes; chunks with string, object
    or ragged fields stay row lists, and so does every later chunk of
    the partition.  ``TFOS_COLUMNAR_FEED=0`` keeps every chunk a row
    list.

    n-D array fields (images: [H, W, C] uint8) become width-H*W*C
    columns through reshape views, their shapes carried in
    ``ColumnChunk.shapes``.  A record that is a bare array (a token
    sequence) is one field, and the chunk says so
    (``meta=marker.BARE``), so that row consumers get arrays back."""
    if os.environ.get("TFOS_COLUMNAR_FEED", "1") == "0":
        return lambda chunk: chunk
    from tensorflowonspark_tpu_torch.recordio import marshal

    state = {"spec": None, "off": False, "shapes": None, "bare": False}

    def fields(record):
        if state["bare"]:
            if not isinstance(record, np.ndarray):
                raise TypeError("bare-array records drifted to "
                                f"{type(record).__name__}")
            record = (record,)
        shapes = state["shapes"]
        if shapes is None:
            return record
        out = []
        for i, v in enumerate(record):
            if shapes[i] is not None:
                if not (isinstance(v, np.ndarray) and v.shape == shapes[i]):
                    raise TypeError(
                        f"field {i} shape drift: expected {shapes[i]}, "
                        f"got {getattr(v, 'shape', type(v).__name__)}")
                v = v.reshape(-1)
            out.append(v)
        return tuple(out)

    def encode(chunk):
        if state["off"]:
            return chunk
        try:
            if state["spec"] is None:
                row = chunk[0]
                state["bare"] = isinstance(row, np.ndarray) and row.ndim > 0
                if state["bare"]:
                    row = (row,)
                elif not isinstance(row, (tuple, list)):
                    raise TypeError("non-tuple row")
                shapes = tuple(v.shape if isinstance(v, np.ndarray)
                               and v.ndim > 1 else None for v in row)
                state["shapes"] = (shapes if any(s is not None
                                                 for s in shapes) else None)
                spec = marshal.infer_spec(fields(chunk[0]))
                if any(c == "O" for c, _ in spec):
                    raise TypeError("object column")
                state["spec"] = spec
            return marker.ColumnChunk(
                state["spec"],
                marshal.rows_to_columns([fields(r) for r in chunk],
                                        state["spec"]),
                shapes=state["shapes"],
                meta=marker.BARE if state["bare"] else None)
        except (TypeError, ValueError, OverflowError) as e:
            state["off"] = True
            logger.info("feed: row chunks (columnar does not apply: %s)", e)
            return chunk

    return encode


def _record_feed_stats(mgr, stats):
    """Append one feeder's record to the KV's 'feed_stats' (the latest
    ``FEED_STATS_KEPT``), where the trainer's report can read it."""
    try:
        kept = list(mgr.get("feed_stats") or [])[-(FEED_STATS_KEPT - 1):]
        mgr.set("feed_stats", kept + [stats])
    except Exception as e:  # noqa: BLE001 - accounting only
        logger.warning("feeder: could not record its timings: %s", e)


class train:  # noqa: N801 - named as the JAX package's node.train
    """The feeder task: push a partition's records as chunks into the
    node's ring (or its manager queue), wait until the trainer consumed
    them, and record the partition in the rendezvous server's feed
    ledger.  Its timings land in the KV's 'feed_stats', each part as
    ``[start wall, ms]`` and, with telemetry on, as the span
    ``feed/<part>`` under the task's ``feed/partition``: ``read`` (the
    lineage's stages that ran before the feeder, ``map_partitions``
    reads), ``encode`` and ``put`` (a chunk each, a put with its waits
    for ring space; the first ``FEED_CHUNK_SPANS_KEPT`` in the record),
    ``drain`` (the wait until the trainer consumed the partition) and
    ``partition`` (from the read to the ledger's write).

    ``skip``: partition indices consumed in full before a cluster
    recovery (the ledger's): the re-fed job drains them without feeding
    them, so a resumed trainer never sees a record twice."""

    def __init__(self, cluster_info, cluster_meta, feed_timeout=600,
                 qname="input", skip=None):
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.feed_timeout = feed_timeout
        self.qname = qname
        self.skip = frozenset(skip or ())

    def __call__(self, iterator):
        start_wall = time.time()
        # the lineage's stages but the last ran before this call; the
        # last runs as the feeder takes the records
        read_ms = sum(engine.task_report.get("lineage_ms", [])[:-1])
        pidx = _partition_index()
        if pidx >= 0 and pidx in self.skip:
            count = sum(1 for _ in iterator)
            logger.info("feeder: partition %d consumed before the "
                        "recovery, skipping its %d records", pidx, count)
            telemetry.event("feed/partition_skipped", part=pidx,
                            records=count)
            return
        executor = read_executor_id()
        mgr = _get_manager(self.cluster_info, executor)
        state = str(mgr.get("state"))
        if state in ("terminating", "stopped"):
            count = sum(1 for _ in iterator)
            logger.info("feeder: state=%s, discarded %d records", state,
                        count)
            return
        from tensorflowonspark_tpu_torch.feed import open_feed_ring

        ring = open_feed_ring(mgr, self.qname, producer=True)
        try:
            self._feed(iterator, pidx, mgr, ring, start_wall, executor,
                       read_ms)
        finally:
            if ring is not None:
                ring.close()

    def _feed(self, iterator, pidx, mgr, ring, start_wall, executor,
              read_ms):
        from tensorflowonspark_tpu_torch.recordio import marshal

        queue = None if ring is not None else mgr.queue(self.qname)
        equeue = mgr.queue("error")
        encode = _make_chunk_encoder()
        read = [start_wall - read_ms / 1e3, read_ms]
        stats = {"part": pidx, "executor": executor,
                 "transport": "shm" if ring is not None else "manager",
                 "start_wall": start_wall,
                 "recv_ms": float(os.environ.get("TFOS_TASK_RECV_MS", "nan")),
                 "loads_ms": float(os.environ.get("TFOS_TASK_LOADS_MS",
                                                  "nan")),
                 "encode_ms": 0.0, "put_ms": 0.0, "chunks": 0,
                 "columnar_chunks": 0, "marshal": None,
                 "first_put_wall": None, "read": read, "encode": [],
                 "put": []}
        ids = telemetry.span_ids()  # the partition's span (None: off)

        def span(part, wall, ms):
            """A part's span, from the measurement its record keeps."""
            if ids is not None:
                telemetry.record_span_at(
                    f"feed/{part}", wall, ms / 1e3,
                    trace_id=ids["trace_id"], parent_id=ids["span_id"])

        span("read", *read)

        def put(chunk):
            """False once the trainer asked to terminate mid-feed: a put
            blocked on a full ring re-checks the state every second, and
            fails fast when the trainer errored or stopped beating."""
            faults.check("feed.put", part=pidx)
            w0, t0 = time.time(), time.perf_counter()
            chunk = encode(chunk)
            t1 = time.perf_counter()
            w1 = time.time()
            if stats["first_put_wall"] is None:
                stats["first_put_wall"] = w1
            if ring is not None:
                while True:
                    try:
                        ring.put(chunk, timeout_ms=1000)
                        break
                    except TimeoutError:
                        if str(mgr.get("state")) == "terminating":
                            return False
                        _raise_if_consumer_lost(mgr, equeue)
            else:
                queue.put(chunk, block=True)
            encode_ms = 1e3 * (t1 - t0)
            put_ms = 1e3 * (time.perf_counter() - t1)
            stats["encode_ms"] += encode_ms
            stats["put_ms"] += put_ms
            if stats["chunks"] < FEED_CHUNK_SPANS_KEPT:
                stats["encode"].append([w0, encode_ms])
                stats["put"].append([w1, put_ms])
            span("encode", w0, encode_ms)
            span("put", w1, put_ms)
            stats["chunks"] += 1
            if isinstance(chunk, marker.ColumnChunk):
                stats["columnar_chunks"] += 1
                stats["marshal"] = marshal.path_for(chunk.spec)
            return True

        total, terminated, chunk = 0, False, []
        chunk_records = _feed_chunk_records()
        for item in iterator:
            chunk.append(item)
            if len(chunk) >= chunk_records:
                if not put(chunk):
                    terminated = True
                    break
                total += len(chunk)
                chunk = []
                if str(mgr.get("state")) == "terminating":
                    terminated = True
                    break
        if chunk and not terminated:
            if put(chunk):
                total += len(chunk)
            else:
                terminated = True
        # a feeder that passed the state check before terminate() may
        # have queued a whole small partition: check again
        if str(mgr.get("state")) == "terminating":
            terminated = True
        if terminated:
            logger.info("feeder: termination mid-feed, discarded %d records",
                        sum(1 for _ in iterator))
        telemetry.event("feed/partition_queued", part=pidx, records=total,
                        path=stats["transport"], terminated=terminated)
        w0, t0 = time.time(), time.perf_counter()
        if ring is not None:
            # terminate()'s drain pops while this feeder holds the
            # producer flock, so the ring empties, unless the trainer
            # stopped without draining (a health halt)
            if not terminated and not _await_consumption(
                    mgr, lambda: ring.qsize_bytes() > 0, self.feed_timeout):
                terminated = True
        else:
            joining = threading.Thread(target=queue.join, daemon=True)
            joining.start()
            if not _await_consumption(mgr, joining.is_alive,
                                      self.feed_timeout):
                terminated = True
        stats["drain"] = [w0, 1e3 * (time.perf_counter() - t0)]
        span("drain", *stats["drain"])
        stats["consumed_wall"] = time.time()

        # consumed in full, not cut short: into the feed ledger
        if not terminated and pidx >= 0:
            client = rendezvous.Client(self.cluster_meta["server_addr"])
            try:
                client.partition_done(self.qname, pidx)
            finally:
                client.close()
        # the partition's map_partitions stages, in this executor (dfutil's
        # read, a decode), and the codec dfutil's reader ran
        done_wall = time.time()
        stats.update(records=total, terminated=terminated,
                     done_wall=done_wall,
                     partition=[read[0], 1e3 * (done_wall - read[0])],
                     lineage_ms=list(engine.task_report.get("lineage_ms",
                                                            [])),
                     codec=engine.task_report.get("codec"),
                     jpeg=engine.task_report.get("jpeg"))
        if ids is not None:
            telemetry.record_span_at("feed/partition", read[0],
                                     done_wall - read[0], part=pidx,
                                     records=total, terminated=terminated,
                                     **ids)
        _record_feed_stats(mgr, stats)
        if str(mgr.get("state")) == "terminating":
            logger.info("feeder: consumer requested termination")
            rendezvous.Client(self.cluster_meta["server_addr"]).request_stop()


class inference:  # noqa: N801 - named as the JAX package's node.inference
    """The inference task, a ``map_partitions`` function: feed the
    partition's records into the node's ring (or its manager queue),
    then an ``EndPartition``, wait until the trainer consumed them, and
    collect exactly as many results from the node's 'output' queue,
    where the trainer's ``DataFeed.batch_results`` puts them."""

    def __init__(self, cluster_info, cluster_meta, feed_timeout=600,
                 qname="input"):
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.feed_timeout = feed_timeout
        self.qname = qname

    def __call__(self, iterator):
        mgr = _get_manager(self.cluster_info, read_executor_id())
        from tensorflowonspark_tpu_torch.feed import open_feed_ring

        ring = open_feed_ring(mgr, self.qname, producer=True)
        try:
            return self._infer(iterator, mgr, ring)
        finally:
            if ring is not None:
                ring.close()

    def _infer(self, iterator, mgr, ring):
        queue = None if ring is not None else mgr.queue(self.qname)
        equeue = mgr.queue("error")
        encode = _make_chunk_encoder()

        def put(item):
            if isinstance(item, list):
                item = encode(item)
            if ring is None:
                queue.put(item, block=True)
                return
            while True:
                try:
                    ring.put(item, timeout_ms=1000)
                    return
                except TimeoutError:
                    _raise_if_consumer_lost(mgr, equeue)

        count, chunk = 0, []
        chunk_records = _feed_chunk_records()
        for item in iterator:
            chunk.append(item)
            if len(chunk) >= chunk_records:
                put(chunk)
                count += len(chunk)
                chunk = []
        if chunk:
            put(chunk)
            count += len(chunk)
        put(marker.EndPartition())
        if ring is not None:
            _await_consumption(mgr, lambda: ring.qsize_bytes() > 0,
                               self.feed_timeout)
        else:
            joining = threading.Thread(target=queue.join, daemon=True)
            joining.start()
            _await_consumption(mgr, joining.is_alive, self.feed_timeout)
        results = []
        out_q = mgr.queue("output")
        deadline = time.monotonic() + self.feed_timeout
        while len(results) < count:
            try:
                got = out_q.get(block=True, timeout=1.0)
            except _queue.Empty:
                _raise_if_consumer_lost(mgr, equeue)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"inference: {len(results)} of {count} results "
                        f"after {self.feed_timeout}s") from None
                continue
            out_q.task_done()
            if isinstance(got, list):
                results.extend(got)
            else:
                results.append(got)
        if len(results) != count:
            raise RuntimeError(f"inference: {len(results)} results for "
                               f"{count} records")
        return results


def _put_end_of_feed(ring, mgr):
    """End-of-feed into the ring.  A full ring waits for the trainer to
    pop, unless the trainer errored or stopped beating: then the reap
    below ends it anyway."""
    equeue = mgr.queue("error")
    while True:
        try:
            ring.put(None, timeout_ms=1000)
            return
        except TimeoutError:
            try:
                _raise_if_consumer_lost(mgr, equeue)
            except RuntimeError as e:
                logger.warning("shutdown: no end-of-feed into the full "
                               "ring: %s", e)
                return


class shutdown:  # noqa: N801 - named as the JAX package's node.shutdown
    """The worker-shutdown task: end-of-feed on the data queues, then
    reap the trainer; a trainer's error raises here."""

    def __init__(self, cluster_info, queues, grace_secs=0):
        self.cluster_info = cluster_info
        self.queues = list(queues)
        self.grace_secs = grace_secs

    def __call__(self, iterator):
        list(iterator)
        executor_id = read_executor_id()
        mgr = _get_manager(self.cluster_info, executor_id)
        logger.info("shutdown: end-of-feed on executor %s", executor_id)
        tb_pid = mgr.get("tb_pid")
        if tb_pid:
            # this process started it (the node task ran here)
            if _NodeState.tb_proc is not None and \
                    _NodeState.tb_proc.pid == int(tb_pid):
                _stop_tensorboard()
            else:
                reap_child(int(tb_pid), timeout=0, term_first=False)
            mgr.set("tb_pid", None)
        from tensorflowonspark_tpu_torch.feed import open_feed_ring

        ring = open_feed_ring(mgr, "input", producer=True)
        try:
            for qname in self.queues:
                if qname in ("error", "control"):
                    continue  # end-of-feed applies to data queues only
                if qname == "input" and ring is not None:
                    _put_end_of_feed(ring, mgr)
                else:
                    mgr.queue(qname).put(None, block=True)
        finally:
            if ring is not None:
                ring.close()
        if self.grace_secs:
            time.sleep(self.grace_secs)
        # peek, so that a retried shutdown still sees the failure
        equeue = mgr.queue("error")
        err = None
        if not equeue.empty():
            err = equeue.get()
            equeue.put(err)
        # the trainer got end-of-feed and exits on its own; one still
        # alive past the budget is stuck and is killed.  The healthy
        # budget is long (it may still be stepping on queued batches); an
        # errored trainer is reaped fast
        bg_pid = mgr.get("bg_pid")
        if bg_pid:
            budget = _reap_budget(err, self.grace_secs)
            if not reap_child(int(bg_pid), timeout=budget):
                logger.warning("shutdown: trainer %s did not exit cleanly "
                               "and was killed", bg_pid)
            mgr.set("bg_pid", None)
        # the trainer is gone and every feeder has finished: unlink the
        # ring, so that no segment outlives the cluster
        _close_ring()
        if err is not None:
            raise RuntimeError(f"exception in worker:\n{err}")
        mgr.set("state", "stopped")


class drain_telemetry:  # noqa: N801 - named as the JAX package's function
    """The executor half of the telemetry drain, a ``map_partitions``
    function: flush this process, then read every spool the node's
    processes advertised in its manager's KV and return ``(executor_id,
    name, text)`` rows: each ``*.jsonl`` file (``telemetry.read_spool``)
    and each flight dump.  Best effort: a drain never fails a
    shutdown."""

    def __init__(self, cluster_info):
        self.cluster_info = cluster_info

    def __call__(self, iterator):
        list(iterator)
        telemetry.flush()
        out = []
        try:
            executor_id = read_executor_id()
            spools = _get_manager(self.cluster_info,
                                  executor_id).telemetry_spools()
        except Exception as e:  # noqa: BLE001 - the drain is best-effort
            logger.warning("telemetry drain: no manager/spools: %s", e)
            return out
        for spool in spools:
            out += [(executor_id, name, text)
                    for name, text in telemetry.read_spool(spool)]
            for path in sorted(glob.glob(os.path.join(spool,
                                                      "flight-*.json"))):
                try:
                    with open(path, encoding="utf-8",
                              errors="replace") as f:
                        out.append((executor_id, os.path.basename(path),
                                    f.read()))
                except OSError:
                    continue
        return out
