"""Executor-side node runtime.

An own copy of the part of ``tensorflowonspark_tpu/node.py`` that the
SPARK-fed training path calls.  One node per engine executor; the node
task:

1. claims GPUs for this worker (``gpu_info``: ``CUDA_VISIBLE_DEVICES``,
   with no CUDA call in the executor),
2. derives its job and task index from the cluster template,
3. starts the executor's IPC manager (``manager``),
4. reserves a port, registers with the driver's rendezvous server and
   waits for the whole cluster,
5. runs the user's ``main_fun(args, ctx)``: in the foreground, or for
   ``InputMode.SPARK`` in a trainer *forked* from the executor, so the
   executor's slot frees up for the feeder tasks.  The trainer joins the
   job through ``ctx.torch_initialize()``.

The feeder and shutdown tasks reattach to the node's manager through the
executor-id file and move data in chunks.  ``run``, ``train`` and
``shutdown`` return instances of module-level classes, which the
engine ships with plain ``pickle``.

Left out (each raises NotImplementedError where it would be asked for):
ps/evaluator nodes, ``inference`` and TensorBoard (ROADMAP.md queue 1,
item 20); recovery epochs (item 15); the shared-memory feed ring and the
columnar marshal (item 16); the telemetry drain and live metrics
(item 21).
"""

from __future__ import annotations

import datetime
import json
import logging
import multiprocessing
import os
import socket
import sys
import threading
import time
import traceback

from tensorflowonspark_tpu_torch import gpu_info, rendezvous
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
ROLES_ITEM = "ROADMAP.md queue 1, item 20 (ps/evaluator, inference, " \
    "TensorBoard)"


FEED_CHUNK_RECORDS = 1024  # records per manager-queue chunk
REAP_TIMEOUT_SECS = 600.0  # shutdown's wait for a healthy trainer to exit


class _NodeState:
    """This executor process's node incarnation."""

    mgr = None
    cluster_id = None


def _teardown_node_state():
    """Dismantle this executor's node (trainer, manager), so that the
    next cluster boots clean on it.  Best-effort: it may be half dead."""
    mgr = _NodeState.mgr
    if mgr is not None:
        try:
            bg = mgr.get("bg_pid")
            if bg:
                reap_child(int(bg), timeout=0.2, term_first=False)
        except Exception:  # noqa: BLE001 - manager may be gone
            pass
        try:
            mgr.shutdown()
        except Exception:  # noqa: BLE001
            pass
    _NodeState.mgr = None
    _NodeState.cluster_id = None


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


def _health_check(device):
    """The device count and one small matmul on ``device``, held against
    the same product on the CPU (small integers: exact in f32)."""
    import torch

    count = torch.cuda.device_count() if device.type == "cuda" else 1
    errors = []
    if device.type == "cuda" and device.index >= count:
        errors.append(f"device {device} but {count} visible")
    if not errors:
        a = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        got = (a.to(device) @ a.to(device)).cpu()
        if not torch.equal(got, a @ a):
            errors.append(f"4x4 matmul on {device} gave {got.tolist()}")
    return {"healthy": not errors, "errors": errors,
            "device": str(device), "device_count": count,
            "name": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")}


class TFNodeContext:
    """Node metadata handed to the user's ``main_fun``."""

    def __init__(self, executor_id, job_name, task_index, cluster_spec,
                 default_fs, working_dir, mgr, cluster_info=None,
                 timeout=600):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.mgr = mgr
        self.cluster_info = cluster_info or []
        self.timeout = timeout  # seconds: the process group's timeout
        self._torch_distributed = False

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None, metrics=None):
        from tensorflowonspark_tpu_torch.feed import DataFeed

        return DataFeed(self.mgr, train_mode, qname_in, qname_out,
                        input_mapping, metrics)

    def distributed_env(self):
        """``{coordinator_address, num_processes, process_id,
        local_rank}``; process_id None for a node outside the job."""
        env = _distributed_env(self.cluster_info)
        return {"coordinator_address": env["coordinator_address"],
                "num_processes": env["num_processes"],
                "process_id": env["process_ids"].get(self.executor_id),
                "local_rank": env["local_ranks"].get(self.executor_id)}

    def torch_initialize(self, device=None):
        """Join the job's process group and check the device.

        ``device``: None or ``"cuda"`` takes CUDA device ``local_rank``
        modulo the visible count (0 after a ``num_gpus`` claim, which
        left this worker only its own); raises without a card.  Pass
        ``"cpu"`` for the CPU.  A job of more than one process calls
        ``init_process_group`` with ``tcp://<coordinator>``, NCCL on CUDA
        and gloo on the CPU, and the node's rank; a one-process job
        skips the group but still runs the health check (device count,
        one small matmul), which raises when it fails.  Returns
        :meth:`distributed_env` with ``device`` and ``health`` added."""
        import torch

        from tensorflowonspark_tpu_torch import resolve_device

        env = self.distributed_env()
        if env["process_id"] is None:
            return env
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)  # raises without a card
            dev = torch.device(
                "cuda", env["local_rank"] % torch.cuda.device_count())
        dev = resolve_device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if env["num_processes"] > 1:
            import torch.distributed as dist

            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{env['coordinator_address']}",
                world_size=env["num_processes"], rank=env["process_id"],
                timeout=datetime.timedelta(seconds=self.timeout))
            self._torch_distributed = True
        health = _health_check(dev)
        if not health["healthy"]:
            raise RuntimeError(f"unhealthy device: {health['errors']}")
        logger.info("rank %d of %d on %s (%s)", env["process_id"],
                    env["num_processes"], dev, health["name"])
        env.update(device=dev, health=health)
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
    """The user's ``main_fun`` with the heartbeat, the exit barrier and a
    final telemetry flush around it."""
    if isinstance(args, list):
        sys.argv = args
    hb = tfmanager.start_heartbeat(mgr)
    try:
        faults.check("node.main", job=ctx.job_name, task=ctx.task_index)
        t0 = time.perf_counter()
        fn(args, ctx)
        telemetry.record_span("node/main", time.perf_counter() - t0,
                              job=ctx.job_name, task=ctx.task_index)
        ctx.sync_exit_barrier()
    finally:
        hb.set()
        try:
            ctx._leave_group()  # after a failure: no barrier, just leave
        finally:
            telemetry.flush()


def _run_background(fn, args, ctx, mgr):
    """The forked trainer: a failure goes to the error queue, where the
    feeders and the shutdown task find it."""
    try:
        _run_main(fn, args, ctx, mgr)
    except Exception:  # noqa: BLE001 - forwarded through the error queue
        mgr.get_queue("error").put(traceback.format_exc())


class run:  # noqa: N801 - named as the JAX package's node.run
    """The node-startup task: ``run(fn, tf_args, cluster_meta, ...)``
    is called by the engine with the iterator of its one partition (the
    executor id)."""

    def __init__(self, fn, tf_args, cluster_meta, tensorboard=False,
                 log_dir=None, queues=None, background=False, num_gpus=0):
        if tensorboard or log_dir is not None:
            raise NotImplementedError(f"TensorBoard comes with {ROLES_ITEM}")
        self.fn = fn
        self.tf_args = tf_args
        self.cluster_meta = cluster_meta
        self.queues = list(queues or ["input", "output", "error",
                                      "control"])
        self.background = background
        self.num_gpus = int(num_gpus)

    def __call__(self, iterator):
        boot_t0 = time.perf_counter()
        executor_id = None
        for item in iterator:  # one element per spread partition
            executor_id = item
        if executor_id is None:
            raise RuntimeError("empty node partition")
        meta = self.cluster_meta

        # (1) GPUs first: the trainer forked below reads the env
        gpu_info.claim_gpus(self.num_gpus, _same_host_index(executor_id))

        # (2) role from the template
        job_name, task_index = _job_for_executor(meta["cluster_template"],
                                                 executor_id)
        if job_name not in COMPUTE_JOBS:
            raise NotImplementedError(f"{job_name} nodes come with "
                                      f"{ROLES_ITEM}")
        # telemetry identity for this process and the trainer it forks
        if os.environ.get(telemetry.ROLE_ENV) != "driver":
            os.environ[telemetry.NODE_ENV] = f"{job_name}-{task_index}"
            os.environ[telemetry.ROLE_ENV] = job_name
        faults.check("node.boot", executor=executor_id, job=job_name)

        # (3) one node per executor: a live node of this cluster here is
        # a duplicate placement; one of an earlier cluster is torn down
        if _NodeState.mgr is not None:
            if _NodeState.cluster_id == meta["id"]:
                raise RuntimeError(f"executor already hosts a node of "
                                   f"cluster {meta['id']}")
            _teardown_node_state()
        mgr = tfmanager.start(bytes.fromhex(meta["authkey"]), self.queues)
        _NodeState.mgr = mgr
        _NodeState.cluster_id = meta["id"]
        write_executor_id(executor_id)

        # everything up to the user's code is boot: a failure releases
        # the node, so that the executor can host another
        try:
            # (4) reserve the coordinator's port, register, await peers
            client = rendezvous.Client(meta["server_addr"])
            host = get_ip_address()
            tmp_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            tmp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            tmp_sock.bind(("", 0))
            node_meta = {
                "executor_id": executor_id, "host": host,
                "job_name": job_name, "task_index": task_index,
                "port": tmp_sock.getsockname()[1],
                "addr": list(mgr.address), "authkey": meta["authkey"],
            }
            client.register(node_meta)
            cluster_info = client.await_reservations(
                timeout=meta["reservation_timeout"])
            client.close()
            ctx = TFNodeContext(
                executor_id, job_name, task_index,
                _get_cluster_spec(cluster_info), meta["default_fs"],
                meta["working_dir"], mgr, cluster_info,
                timeout=meta["reservation_timeout"])
            ctx.export_env()
            # released as late as possible: rank 0's process group binds
            # it next
            tmp_sock.close()
            telemetry.record_span("node/boot",
                                  time.perf_counter() - boot_t0,
                                  executor=executor_id,
                                  nodes=len(cluster_info))
        except BaseException:
            telemetry.flush()
            _teardown_node_state()
            raise

        # (5) execute
        if self.background:
            # fork, not spawn: the trainer inherits the node's context and
            # manager; the executor never touched CUDA, so it can
            p = multiprocessing.get_context("fork").Process(
                target=_run_background,
                args=(self.fn, self.tf_args, ctx, mgr),
                name=f"tfos-trainer-{executor_id}")
            p.start()
            # the shutdown task (manager KV) and the engine's teardown
            # (pid file) can both find the trainer
            mgr.set("bg_pid", p.pid)
            track_child_pid(p.pid)
        else:
            _run_main(self.fn, self.tf_args, ctx, mgr)


def _get_manager(cluster_info, executor_id):
    """Reattach to this executor's manager."""
    for meta in cluster_info:
        if meta["executor_id"] == executor_id:
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
    error queue and the consumer's heartbeat."""
    equeue = mgr.get_queue("error")
    deadline = time.monotonic() + feed_timeout
    while waiter():
        _raise_if_consumer_lost(mgr, equeue)
        if time.monotonic() > deadline:
            raise TimeoutError("timed out waiting for consumption of "
                               "partition")
        time.sleep(poll)


def _partition_index():
    """This feed task's partition id (exported by the engine), or -1."""
    try:
        return int(os.environ.get("TFOS_PARTITION_INDEX", "-1"))
    except ValueError:
        return -1


class train:  # noqa: N801 - named as the JAX package's node.train
    """The feeder task: push a partition's records as chunks through the
    manager queue, wait until the trainer consumed them, and record the
    partition in the rendezvous server's feed ledger."""

    def __init__(self, cluster_info, cluster_meta, feed_timeout=600,
                 qname="input", skip=None):
        if skip:
            raise NotImplementedError("skipping partitions consumed before "
                                      "a recovery comes with ROADMAP.md "
                                      "queue 1, item 15")
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.feed_timeout = feed_timeout
        self.qname = qname

    def __call__(self, iterator):
        pidx = _partition_index()
        mgr = _get_manager(self.cluster_info, read_executor_id())
        state = str(mgr.get("state"))
        if state in ("terminating", "stopped"):
            count = sum(1 for _ in iterator)
            logger.info("feeder: state=%s, discarded %d records", state,
                        count)
            return
        queue = mgr.get_queue(self.qname)
        total, terminated, chunk = 0, False, []
        for item in iterator:
            chunk.append(item)
            if len(chunk) >= FEED_CHUNK_RECORDS:
                faults.check("feed.put", part=pidx)
                queue.put(chunk, block=True)
                total += len(chunk)
                chunk = []
                if str(mgr.get("state")) == "terminating":
                    terminated = True
                    break
        if chunk and not terminated:
            faults.check("feed.put", part=pidx)
            queue.put(chunk, block=True)
            total += len(chunk)
        # a feeder that passed the state check before terminate() may
        # have queued a whole small partition: check again
        if str(mgr.get("state")) == "terminating":
            terminated = True
        if terminated:
            logger.info("feeder: termination mid-feed, discarded %d records",
                        sum(1 for _ in iterator))
        telemetry.event("feed/partition_queued", part=pidx, records=total,
                        terminated=terminated)
        joining = threading.Thread(target=queue.join, daemon=True)
        joining.start()
        _await_consumption(mgr, joining.is_alive, self.feed_timeout)

        # consumed in full, not cut short: into the feed ledger
        if not terminated and pidx >= 0:
            client = rendezvous.Client(self.cluster_meta["server_addr"])
            try:
                client.partition_done(self.qname, pidx)
            finally:
                client.close()
        if str(mgr.get("state")) == "terminating":
            logger.info("feeder: consumer requested termination")
            rendezvous.Client(self.cluster_meta["server_addr"]).request_stop()


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
        for qname in self.queues:
            if qname in ("error", "control"):
                continue  # end-of-feed applies to data queues only
            mgr.get_queue(qname).put(None, block=True)
        if self.grace_secs:
            time.sleep(self.grace_secs)
        # peek, so that a retried shutdown still sees the failure
        equeue = mgr.get_queue("error")
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
            budget = 5.0 if err is not None else max(self.grace_secs,
                                                     REAP_TIMEOUT_SECS)
            if not reap_child(int(bg_pid), timeout=budget):
                logger.warning("shutdown: trainer %s did not exit cleanly "
                               "and was killed", bg_pid)
            mgr.set("bg_pid", None)
        if err is not None:
            raise RuntimeError(f"exception in worker:\n{err}")
        mgr.set("state", "stopped")
