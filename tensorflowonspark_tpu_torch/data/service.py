"""Disaggregated data service: data workers run the pipeline and feed
the trainers over the feed's wire.

An own copy of ``tensorflowonspark_tpu/data/service.py``.
``cluster.run(..., data_workers=N)`` keeps the trainers as they are and
runs N long-lived **data workers** as engine tasks.  The trainers (the
compute nodes of ``cluster_info``) are ranked 0..T-1 by executor id.

**Static dispatch** (:class:`DataService`): worker ``j`` serves every
trainer whose ``rank % N == j``; a trainer's stream is the pipeline's
``shard(rank, T)``, the strided exactly-once split, as
``marker.ColumnChunk``s through the feeder's own handshake
(``feed.open_feed_ring``: the node's shm ring when it advertises one,
its manager queue otherwise) and backpressure (a put blocked on a full
ring re-checks the consumer's state and heartbeat every second, so a
dead trainer fails the worker instead of wedging it).  Exactly once
rides the rendezvous feed ledger (PDONE/PQUERY), keyed a trainer
``"<qname>:data:<rank>"``: the stream is cut into **units** of
``unit_blocks`` blocks, and a unit is recorded once every chunk of it
was pushed and the trainer drained its ring.  A killed worker
(``TFOS_FAULT_PLAN="data.serve:kill"``; the engine's retryable
supervision respawns the task) asks the ledger and resumes at the first
unit not done, recomputing and skipping, which the pipeline's
determinism makes exact; a unit cut mid-push is pushed again whole.

**Dynamic dispatch** (:class:`DynamicDataService`, the default): the
workers claim splits first come, first served from the split board
(``data/splits.py``) and serve each to the least backlogged trainer they
own; see that class.

End-of-feed stays ``cluster.shutdown``'s (``node.shutdown`` pushes the
terminal ``None``), as in feeder mode.  Data workers are CPU code in
the engine's executors: nothing here touches CUDA, so a worker's
executor can still fork a SPARK-mode trainer later.
"""

from __future__ import annotations

import logging
import os
import time

from tensorflowonspark_tpu_torch import marker, rendezvous
from tensorflowonspark_tpu_torch import node as tfnode
from tensorflowonspark_tpu_torch.actors.ledger import (
    NullLedgerClient,
    resume_cursor,
)
from tensorflowonspark_tpu_torch.feed import open_feed_ring
from tensorflowonspark_tpu_torch.obs import publish as obs_publish
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

WORKERS_ENV = "TFOS_DATA_WORKERS"


def trainer_ranks(cluster_info):
    """[(rank, node_meta)] for the feedable compute nodes of a cluster,
    rank-ordered by executor id (the stable order both the service and
    the shard split key on)."""
    metas = sorted(
        (m for m in cluster_info if m["job_name"] in tfnode.COMPUTE_JOBS),
        key=lambda m: m["executor_id"])
    return list(enumerate(metas))


def ledger_feed(qname, rank):
    """The per-trainer feed-ledger key (PDONE/PQUERY namespace)."""
    return f"{qname}:data:{rank}"


class DataService:
    """One data worker's serving loop (see module docstring).

    ``run()`` serves every assigned trainer round-robin — one bounded
    push attempt each per round — so a trainer with a full ring never
    starves its siblings, and returns when every assigned stream is
    fully pushed and consumed.
    """

    def __init__(self, pipeline, cluster_info, cluster_meta, qname="input",
                 num_workers=1, worker_index=0, unit_blocks=8,
                 feed_timeout=600):
        if not 0 <= worker_index < num_workers:
            raise ValueError(
                f"need 0 <= worker_index < num_workers, "
                f"got {worker_index}/{num_workers}")
        self.pipeline = pipeline
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname
        self.num_workers = int(num_workers)
        self.worker_index = int(worker_index)
        self.unit_blocks = max(1, int(unit_blocks))
        self.feed_timeout = feed_timeout

    # -- per-trainer stream state -----------------------------------------

    class _Stream:
        __slots__ = ("rank", "meta", "mgr", "ring", "queue", "equeue",
                     "chunks", "unit", "unit_off", "pending", "pushed",
                     "done", "client_done")

        def __init__(self, rank, meta):
            self.rank = rank
            self.meta = meta
            self.mgr = None
            self.ring = None
            self.queue = None
            self.equeue = None
            self.chunks = None
            self.unit = 0        # current unit index
            self.unit_off = 0    # blocks pushed within the current unit
            self.pending = None  # chunk that timed out on a full ring
            self.pushed = 0      # records pushed (telemetry)
            self.done = False    # stream exhausted and consumption-safe
            self.client_done = False  # trainer went terminating/stopped

    def _open(self, st, client):
        """Connect to the trainer's manager, resolve the resume cursor
        from the ledger, and open the sharded chunk stream."""
        st.mgr = tfnode._get_manager(self.cluster_info,
                                     st.meta["executor_id"])
        telemetry.register_with(st.mgr)
        state = str(st.mgr.get("state"))
        if state in ("terminating", "stopped"):
            logger.info("data worker %d: trainer %d state=%s, skipping",
                        self.worker_index, st.rank, state)
            st.client_done = st.done = True
            return
        st.ring = open_feed_ring(st.mgr, self.qname, producer=True)
        st.queue = (None if st.ring is not None
                    else st.mgr.queue(self.qname))
        st.equeue = st.mgr.queue("error")
        consumed = ()
        try:
            consumed = client.fed_partitions(ledger_feed(self.qname, st.rank))
        except Exception as e:  # noqa: BLE001 - no ledger in standalone use
            logger.debug("data worker: no feed ledger (%s)", e)
        st.unit = resume_cursor(consumed, start=st.unit)
        skip = st.unit * self.unit_blocks
        if skip:
            logger.info(
                "data worker %d: trainer %d resumes at unit %d "
                "(skipping %d blocks already consumed)",
                self.worker_index, st.rank, st.unit, skip)
            telemetry.event("data/serve_resume", trainer=st.rank,
                            unit=st.unit, skip_blocks=skip)
            metrics_registry.inc("tfos_data_resumes_total")
        n_trainers = len(trainer_ranks(self.cluster_info))
        st.chunks = self.pipeline.shard(st.rank, n_trainers).chunks(
            skip_blocks=skip)

    def _push(self, st, chunk):
        """One bounded push attempt; returns True when the chunk landed.
        False means the ring stayed full for the slice — the caller
        round-robins on.  Raises when the trainer errored or died."""
        if st.ring is not None:
            try:
                st.ring.put(chunk, timeout_ms=1000)
                return True
            except TimeoutError:
                if str(st.mgr.get("state")) == "terminating":
                    st.client_done = True
                    return True  # consumer stopped draining: drop + finish
                tfnode._raise_if_consumer_lost(st.mgr, st.equeue)
                return False
        st.queue.put(chunk, block=True)
        return True

    def _advance(self, st, client):
        """Push up to one unit boundary for one trainer; updates the
        ledger when a unit completes."""
        if st.pending is None:
            if st.unit_off == 0:
                faults.check("data.serve", worker=self.worker_index,
                             trainer=st.rank, unit=st.unit)
            nxt = next(st.chunks, None)
            if nxt is None:
                # stream exhausted: the final (short) unit is recorded
                # done only after the trainer drained it, so a crash in
                # this window re-pushes instead of losing the tail
                if st.ring is not None and not tfnode._await_consumption(
                        st.mgr, lambda: st.ring.qsize_bytes() > 0,
                        self.feed_timeout, poll=0.2):
                    st.client_done = True  # the trainer stopped draining
                if st.unit_off and not st.client_done:
                    self._record_done(st, client)
                st.done = True
                return
            st.pending = nxt
        chunk = st.pending
        if not self._push(st, chunk):
            return  # ring full: retry next round
        st.pending = None
        if st.client_done:
            st.done = True
            return
        st.pushed += len(chunk)
        metrics_registry.inc("tfos_data_records_total", len(chunk),
                             trainer=st.rank)
        st.unit_off += 1
        if st.unit_off >= self.unit_blocks:
            # exactly-once barrier: a unit enters the ledger only after
            # the trainer drained it from the ring.  Recording on push
            # would lose the whole in-flight window when a recovery
            # tears down the trainer manager (ring contents die with
            # it) — the resumed worker would skip data nobody trained
            # on.  Amortized over unit_blocks; raises if the trainer
            # died, which routes into the engine retry path.
            if st.ring is not None and not tfnode._await_consumption(
                    st.mgr, lambda: st.ring.qsize_bytes() > 0,
                    self.feed_timeout, poll=0.2):
                st.client_done = st.done = True  # stopped draining
                return
            self._record_done(st, client)
            st.unit += 1
            st.unit_off = 0

    def _record_done(self, st, client):
        try:
            client.partition_done(ledger_feed(self.qname, st.rank), st.unit)
            metrics_registry.inc("tfos_data_units_total")
            # one exactly-once unit delivered; joins the run trace via
            # the TFOS_TRACE_PARENT env the engine task exported
            telemetry.event(telemetry.DATA_UNIT, worker=self.worker_index,
                            trainer=st.rank, unit=st.unit,
                            blocks=st.unit_off or self.unit_blocks)
        except Exception as e:  # noqa: BLE001 - accounting only
            logger.warning("data worker: could not record unit %d for "
                           "trainer %d: %s", st.unit, st.rank, e)

    def _publish_obs(self, assigned):
        """Ship this worker's registry snapshot through the first live
        trainer manager (any reachable manager KV works — the driver's
        ObsServer sweeps every ``obs:*`` key it can see)."""
        if not metrics_registry.enabled():
            return
        for st in assigned:
            if st.mgr is not None:
                if obs_publish.publish_once(
                        st.mgr, f"data-{self.worker_index}", role="data"):
                    return

    def run(self):
        """Serve all assigned trainers to completion; returns a summary
        dict {trainer_rank: records_pushed}."""
        assigned = [DataService._Stream(r, m)
                    for r, m in trainer_ranks(self.cluster_info)
                    if r % self.num_workers == self.worker_index]
        if not assigned:
            logger.info("data worker %d: no trainers assigned (of %d "
                        "workers)", self.worker_index, self.num_workers)
            return {}
        client = None
        try:
            client = rendezvous.Client(self.cluster_meta["server_addr"])
        except Exception as e:  # noqa: BLE001 - standalone use, no ledger
            logger.debug("data worker: rendezvous unavailable (%s)", e)
            client = _NullClient()
        t0 = time.perf_counter()
        next_pub = 0.0
        try:
            for st in assigned:
                self._open(st, client)
            while not all(st.done for st in assigned):
                for st in assigned:
                    if not st.done:
                        self._advance(st, client)
                if (metrics_registry.enabled()
                        and time.monotonic() >= next_pub):
                    next_pub = (time.monotonic()
                                + metrics_registry.interval())
                    self._publish_obs(assigned)
        finally:
            self._publish_obs(assigned)
            for st in assigned:
                if st.ring is not None:
                    try:
                        st.ring.close()
                    except Exception:  # noqa: BLE001 - teardown
                        pass
            try:
                client.close()
            except Exception:  # noqa: BLE001 - teardown
                pass
        summary = {st.rank: st.pushed for st in assigned}
        telemetry.record_span(
            "data/serve", time.perf_counter() - t0,
            worker=self.worker_index,
            trainers=[st.rank for st in assigned],
            records=sum(summary.values()))
        logger.info("data worker %d served %s", self.worker_index, summary)
        return summary


# the ledger's stand-in when no rendezvous server answers (a data
# service run alone, in tests)
_NullClient = NullLedgerClient


# --------------------------------------------------------------------------
# dynamic FCFS split dispatch (data/splits.py is the control plane)


SPLIT_BOARD_META = "split_board"  # cluster_meta key carrying board coords
DISPATCH_ENV = "TFOS_DATA_DISPATCH"
SHARED_CACHE_ENV = "TFOS_DATA_SHARED_CACHE"
QUEUE_CAP_ENV = "TFOS_DATA_QUEUE_CAP"


def default_split_blocks():
    """Split width in blocks: ``TFOS_DATA_SPLIT_BLOCKS`` (8)."""
    from tensorflowonspark_tpu_torch.data import splits as _splits

    try:
        return max(1, int(os.environ.get(_splits.SPLIT_BLOCKS_ENV, "8")))
    except ValueError:
        return 8


def dispatch_mode(cluster_meta=None):
    """``"dynamic"`` (default) or ``"static"`` — env beats the
    ``data_dispatch`` cluster-meta key beats the default."""
    mode = os.environ.get(DISPATCH_ENV)
    if not mode and cluster_meta:
        mode = cluster_meta.get("data_dispatch")
    mode = (mode or "dynamic").strip().lower()
    if mode not in ("static", "dynamic"):
        raise ValueError(f"unknown {DISPATCH_ENV}={mode!r} "
                         "(want static|dynamic)")
    return mode


class DynamicDataService:
    """One dynamic data worker: claim splits FCFS from the board, serve
    their blocks to the least-loaded owned trainer, record each split in
    the PDONE ledger once its records are consumption-safe.

    Differences from the static :class:`DataService`:

    - **what** to serve comes from the split queue (``data/splits.py``),
      not a rank-strided shard — a slow trainer claims fewer splits
      instead of stretching the epoch;
    - **where** it goes is chosen per split: the least-loaded trainer
      among those this worker owns under the board *plan* (the shm ring
      is single-producer, so trainer rings are partitioned across the
      live workers; the plan changing re-partitions them, which is how
      autoscaling adds serving capacity);
    - exactly-once is per split id on the ``split_feed`` ledger:
      record-on-drain as before, plus chunk-level ``("split", sid, seq,
      n)`` tags so a re-served split's already-consumed prefix is
      dropped by the trainer's DataFeed instead of trained on twice;
    - epoch replay reads the shared :mod:`data.cache` epoch cache
      (decode once, replay from memory/spill) unless
      ``TFOS_DATA_SHARED_CACHE=0``.
    """

    def __init__(self, pipeline, cluster_info, cluster_meta, qname="input",
                 worker_index=0, split_blocks=None, feed_timeout=600,
                 use_cache=None):
        self.pipeline = pipeline
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname
        self.worker_index = int(worker_index)
        self.split_blocks = (default_split_blocks() if split_blocks is None
                             else max(1, int(split_blocks)))
        self.feed_timeout = feed_timeout
        if use_cache is None:
            use_cache = os.environ.get(SHARED_CACHE_ENV, "1") != "0"
        self.use_cache = bool(use_cache)
        try:
            self.queue_cap = max(
                1, int(os.environ.get(QUEUE_CAP_ENV, "32")))
        except ValueError:
            self.queue_cap = 32
        self._source = None

    class _Sink:
        __slots__ = ("rank", "meta", "mgr", "ring", "queue", "equeue",
                     "pending", "lost")

        def __init__(self, rank, meta):
            self.rank = rank
            self.meta = meta
            self.mgr = None
            self.ring = None
            self.queue = None
            self.equeue = None
            self.pending = []   # sids pushed, awaiting drain before record
            self.lost = False   # trainer terminating/stopped

    # -- plan / ownership --------------------------------------------------

    def _owned_ranks(self, plan, ranks):
        """Trainer ranks this worker serves under ``plan`` (the board's
        active-worker list): position-strided, so every trainer has
        exactly one producer for its ring."""
        if self.worker_index not in plan:
            return []
        pos = plan.index(self.worker_index)
        return [r for r in ranks if r % len(plan) == pos]

    def _open_sink(self, sink):
        sink.mgr = tfnode._get_manager(self.cluster_info,
                                       sink.meta["executor_id"])
        telemetry.register_with(sink.mgr)
        if str(sink.mgr.get("state")) in ("terminating", "stopped"):
            sink.lost = True
            return
        # ring handover: the previous owner's producer flock may linger
        # a beat after a plan change — retry instead of wedging on it
        deadline = time.monotonic() + float(self.feed_timeout)
        while True:
            try:
                sink.ring = open_feed_ring(sink.mgr, self.qname,
                                           producer=True,
                                           producer_nonblock=True)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        sink.queue = (None if sink.ring is not None
                      else sink.mgr.queue(self.qname))
        sink.equeue = sink.mgr.queue("error")

    def _close_sink(self, sink):
        if sink.ring is not None:
            try:
                sink.ring.close()
            except Exception:  # noqa: BLE001 - teardown
                pass
            sink.ring = None

    def _depth(self, sink):
        """Backlog of one sink, for least-loaded target choice (bytes
        for rings, queued-chunk count for manager queues — only ever
        compared within one transport)."""
        try:
            if sink.ring is not None:
                return sink.ring.qsize_bytes()
            return sink.queue.qsize()
        except Exception:  # noqa: BLE001 - depth is best-effort
            return 0

    # -- serving -----------------------------------------------------------

    def _blocks_of(self, sid):
        k = sid[1]
        return self._source.blocks_range(k * self.split_blocks,
                                         self.split_blocks)

    def _push_pinned(self, sink, chunk):
        """Push one chunk to its pinned trainer, waiting out a full
        ring/queue; raises when the trainer errored, returns False when
        it is terminating (stop serving, do not record)."""
        while True:
            if sink.ring is not None:
                try:
                    sink.ring.put(chunk, timeout_ms=1000)
                    return True
                except TimeoutError:
                    pass
            else:
                if sink.queue.qsize() < self.queue_cap:
                    sink.queue.put(chunk, block=True)
                    return True
                time.sleep(0.05)
            if str(sink.mgr.get("state")) in ("terminating", "stopped"):
                sink.lost = True
                return False
            tfnode._raise_if_consumer_lost(sink.mgr, sink.equeue)

    def _serve_split(self, board, client, sid, sink):
        """Serve every block of ``sid`` to ``sink``; returns the block
        count (0 = split past end of data)."""
        from tensorflowonspark_tpu_torch.data import splits as _splits
        from tensorflowonspark_tpu_torch.data.pipeline import block_to_chunk

        seq = 0
        pushed_records = 0
        for block in self._blocks_of(sid):
            faults.check("data.split_serve", worker=self.worker_index,
                         sid=_splits.sid_str(sid), seq=seq)
            chunk = block_to_chunk(block)
            chunk.meta = marker.split_tag(sid, seq)
            if not self._push_pinned(sink, chunk):
                return -1  # trainer shutting down: drop, do not record
            seq += 1
            pushed_records += len(chunk)
        if pushed_records:
            metrics_registry.inc("tfos_data_records_total", pushed_records,
                                 trainer=sink.rank)
        return seq

    def _record_split(self, board, client, sid):
        from tensorflowonspark_tpu_torch.data import splits as _splits

        try:
            client.partition_done(_splits.split_feed(self.qname),
                                  _splits.sid_to_part(sid))
        except Exception as e:  # noqa: BLE001 - accounting only
            logger.warning("data worker %d: could not record split %s: %s",
                           self.worker_index, _splits.sid_str(sid), e)
            return
        board.clear_claim(sid)
        metrics_registry.inc("tfos_data_splits_served_total")
        telemetry.event(telemetry.DATA_UNIT, worker=self.worker_index,
                        split=_splits.sid_str(sid), epoch=sid[0])

    def _flush_drained(self, board, client, sinks, block=False):
        """Record pending splits whose ring the trainer drained.  The
        non-blocking form runs once per loop; the blocking form (stream
        end, ownership handoff) waits out the drain."""
        for sink in sinks:
            if not sink.pending:
                continue
            if sink.lost:
                sink.pending = []   # trainer gone: provider requeues
                continue
            if sink.ring is not None:
                if block:
                    if not tfnode._await_consumption(
                            sink.mgr,
                            lambda s=sink: s.ring.qsize_bytes() > 0,
                            self.feed_timeout, poll=0.2):
                        sink.lost = True  # stopped draining: requeued
                        sink.pending = []
                        continue
                elif sink.ring.qsize_bytes() > 0:
                    continue
            for sid in sink.pending:
                self._record_split(board, client, sid)
            sink.pending = []

    # -- main loop ---------------------------------------------------------

    def run(self):
        """Claim-and-serve until the board declares completion (or this
        worker is planned out); returns {"splits": n, "records": n}."""
        from tensorflowonspark_tpu_torch.data import cache as data_cache
        from tensorflowonspark_tpu_torch.data import splits as _splits

        coords = self.cluster_meta[SPLIT_BOARD_META]
        board = _splits.SplitBoard.connect(
            coords["address"], coords["authkey"], self.qname)
        # claims and beats name this incarnation, not just the worker
        # index: a respawned worker beats at once, and beats under the
        # index alone would keep its dead twin's claims alive for good
        # (the JAX worker's), so they would never be requeued
        claimant = f"{self.worker_index}.{os.getpid()}"
        hb = board.start_heartbeat(claimant)
        try:
            client = rendezvous.Client(self.cluster_meta["server_addr"])
        except Exception as e:  # noqa: BLE001 - standalone use, no ledger
            logger.debug("data worker: rendezvous unavailable (%s)", e)
            client = _NullClient()
        self._source = (data_cache.shared(self.pipeline) if self.use_cache
                        else self.pipeline)
        ranks = trainer_ranks(self.cluster_info)
        sinks = {r: DynamicDataService._Sink(r, m) for r, m in ranks}
        all_ranks = sorted(sinks)
        open_ranks = set()
        last_pick = {}
        pick_seq = 0
        served = 0
        t0 = time.perf_counter()
        next_pub = 0.0
        idle_t0 = None
        try:
            while True:
                plan = board.plan() or [self.worker_index]
                if self.worker_index not in plan:
                    # scaled down: hand the rings over cleanly
                    self._flush_drained(board, client,
                                        list(sinks.values()), block=True)
                    logger.info("data worker %d: planned out, exiting",
                                self.worker_index)
                    break
                owned = self._owned_ranks(plan, all_ranks)
                for r in list(open_ranks):
                    if r not in owned:   # disowned: drain, record, release
                        self._flush_drained(board, client, [sinks[r]],
                                            block=True)
                        self._close_sink(sinks[r])
                        open_ranks.discard(r)
                self._flush_drained(board, client,
                                    [sinks[r] for r in open_ranks])
                if board.complete():
                    self._flush_drained(board, client,
                                        [sinks[r] for r in open_ranks],
                                        block=True)
                    break
                if not owned:
                    # more workers than trainers: nothing to serve into,
                    # so leave without a claim (the JAX worker claims a
                    # split first, which then waits out the provider's
                    # stale sweep) and free the executor
                    logger.info("data worker %d owns no trainer under "
                                "plan %s, exiting", self.worker_index, plan)
                    break
                sid = board.claim_next(owned)
                if sid is None:
                    if idle_t0 is None:
                        idle_t0 = time.perf_counter()
                    time.sleep(0.05)
                    continue
                if idle_t0 is not None and telemetry.enabled():
                    telemetry.record_span(
                        "data/stage", 0.0, stage="split_queue_wait",
                        wait_ms=round(
                            (time.perf_counter() - idle_t0) * 1e3, 3),
                        records=0, worker=self.worker_index)
                idle_t0 = None
                board.set_claim(sid, claimant)
                metrics_registry.inc("tfos_data_splits_claimed_total")
                faults.check("data.split_claim", worker=self.worker_index,
                             sid=_splits.sid_str(sid))
                done = ()
                try:
                    done = client.fed_partitions(
                        _splits.split_feed(self.qname))
                except Exception:  # noqa: BLE001 - ledgerless harness
                    pass
                if _splits.sid_to_part(sid) in set(done):
                    board.clear_claim(sid)   # raced a recorded re-serve
                    continue
                pin = board.pin_of(sid)
                if pin is not None and pin in owned:
                    rank = pin
                else:
                    live = [r for r in owned if not sinks[r].lost]
                    if not live:
                        break   # nothing left to serve into
                    # least backlogged first; LRU round-robin breaks the
                    # frequent all-drained tie (depth 0 everywhere) so
                    # equal-speed trainers share splits evenly instead
                    # of min() always electing the lowest rank
                    rank = min(live, key=lambda r: (
                        self._depth(sinks[r]) if r in open_ranks else 0,
                        last_pick.get(r, -1)))
                    last_pick[rank] = pick_seq
                    pick_seq += 1
                board.set_pin(sid, rank)   # pin BEFORE the first push
                sink = sinks[rank]
                if rank not in open_ranks:
                    self._open_sink(sink)
                    if sink.lost:
                        continue   # claim goes stale -> provider requeues
                    open_ranks.add(rank)
                n = self._serve_split(board, client, sid, sink)
                if n < 0:
                    continue   # trainer shutting down mid-split
                if n == 0:
                    board.set_eof(sid[1])
                    # an empty split is trivially consumption-safe
                    self._record_split(board, client, sid)
                    continue
                if n < self.split_blocks:
                    board.set_eof(sid[1] + 1)   # short split = the tail
                served += 1
                if sink.ring is not None:
                    sink.pending.append(sid)
                else:
                    # manager-queue path: the queue lives in the trainer
                    # manager, same exposure as the static queue path
                    self._record_split(board, client, sid)
                if (metrics_registry.enabled()
                        and time.monotonic() >= next_pub):
                    next_pub = (time.monotonic()
                                + metrics_registry.interval())
                    self._publish_obs(sinks, open_ranks)
        finally:
            hb.set()
            self._publish_obs(sinks, open_ranks)
            for r in open_ranks:
                self._close_sink(sinks[r])
            try:
                client.close()
            except Exception:  # noqa: BLE001 - teardown
                pass
        telemetry.record_span(
            "data/serve", time.perf_counter() - t0,
            worker=self.worker_index, splits=served, dispatch="dynamic")
        logger.info("data worker %d served %d splits", self.worker_index,
                    served)
        return {"splits": served}

    def _publish_obs(self, sinks, open_ranks):
        if not metrics_registry.enabled():
            return
        for r in sorted(open_ranks):
            mgr = sinks[r].mgr
            if mgr is not None and obs_publish.publish_once(
                    mgr, f"data-{self.worker_index}", role="data"):
                return


class dynamic_serve_task:  # noqa: N801 - the JAX package's closure's name
    """The engine task of one dynamic data worker a partition, the FCFS
    counterpart of :class:`serve_task`; the autoscaler launches more of
    them one at a time."""

    def __init__(self, pipeline, cluster_info, cluster_meta, qname="input",
                 split_blocks=None, feed_timeout=600):
        self.pipeline = pipeline
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname
        self.split_blocks = split_blocks
        self.feed_timeout = feed_timeout

    def __call__(self, iterator):
        svc = DynamicDataService(
            self.pipeline, self.cluster_info, self.cluster_meta,
            qname=self.qname, worker_index=_worker_index(iterator),
            split_blocks=self.split_blocks, feed_timeout=self.feed_timeout)
        svc.run()


def _worker_index(iterator):
    """The worker index: the partition's element, else the engine's
    ``TFOS_PARTITION_INDEX`` (a respawned retry's)."""
    items = list(iterator)
    if items:
        return int(items[0])
    return int(os.environ.get("TFOS_PARTITION_INDEX", "0"))


def default_workers():
    """Worker count default: ``TFOS_DATA_WORKERS`` (1)."""
    try:
        return max(1, int(os.environ.get(WORKERS_ENV, "1")))
    except ValueError:
        return 1


class serve_task:  # noqa: N801 - the JAX package's closure's name
    """The engine task of one static data worker a partition
    (``engine.parallelize(range(N), N).foreach_partition(...)``)."""

    def __init__(self, pipeline, cluster_info, cluster_meta, qname="input",
                 num_workers=1, unit_blocks=8, feed_timeout=600):
        self.pipeline = pipeline
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname
        self.num_workers = num_workers
        self.unit_blocks = unit_blocks
        self.feed_timeout = feed_timeout

    def __call__(self, iterator):
        svc = DataService(
            self.pipeline, self.cluster_info, self.cluster_meta,
            qname=self.qname, num_workers=self.num_workers,
            worker_index=_worker_index(iterator),
            unit_blocks=self.unit_blocks, feed_timeout=self.feed_timeout)
        svc.run()
