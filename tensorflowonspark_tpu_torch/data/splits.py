"""Dynamic FCFS split dispatch: the control plane of the data service.

An own copy of ``tensorflowonspark_tpu/data/splits.py``.  The
pipeline's block stream is cut into fixed-width **splits**, and data
workers claim them first come, first served, so a fast trainer takes
more splits and a slow one no longer stretches the epoch
(``data.service.DynamicDataService`` is the data plane).

Split identity: ``sid = (epoch, k)``; split ``k`` of one epoch covers
blocks ``[k*B, (k+1)*B)`` of the pipeline (``Pipeline.blocks_range``),
the same in every epoch by the determinism contract, so epochs are id
arithmetic and need no ``repeat()``.  The split count of an epoch is
found, not declared: a worker that claims a split past the data sets
the ``eof`` mark.

Coordination lives in two places:

- **the manager's KV and queues** (the driver's ``ActorSystem``'s
  manager): the ordered split queue (a manager queue, whose ``get()``
  is atomic: that is the FCFS claim), claim marks, trainer pins, the
  eof and complete marks and the worker plan.  All of it can be
  rebuilt, so losing the manager costs re-posting work.
- **the rendezvous PDONE/PQUERY ledger** (durable across a cluster's
  recovery): a split enters it only once its records are consumed
  (record on drain), as the static service's units do.  The provider
  requeues claimed, unrecorded splits whose claimant stopped beating;
  a re-serve is pinned to the trainer first targeted, whose
  ``DataFeed`` drops the prefix it consumed (the ``ColumnChunk.meta``
  split tags).

:class:`SplitProvider` is a supervised actor (``actors.runtime``): its
durable state is the board and the ledger, so a respawned incarnation
resumes from the posting cursor and sweeps the claims again.
"""

from __future__ import annotations

import logging
import queue as _queue
import time

from tensorflowonspark_tpu_torch import manager as tfmanager
from tensorflowonspark_tpu_torch.actors import liveness
from tensorflowonspark_tpu_torch.actors.runtime import Actor
from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)

SPLIT_BLOCKS_ENV = "TFOS_DATA_SPLIT_BLOCKS"
WINDOW_ENV = "TFOS_DATA_SPLIT_WINDOW"


def split_feed(qname):
    """The split ledger's PDONE/PQUERY namespace for one feed queue."""
    return f"{qname}:splits"


def sid_str(sid):
    return f"{sid[0]}.{sid[1]}"


def sid_to_part(sid):
    """Pack a sid into the single int the PDONE ledger stores
    (``rendezvous.Client.partition_done`` coerces parts to int)."""
    return (int(sid[0]) << 32) | int(sid[1])


def part_to_sid(part):
    part = int(part)
    return (part >> 32, part & 0xFFFFFFFF)


class SplitBoard:
    """The manager-KV face of split dispatch — queue handles and typed
    accessors shared by the provider, the workers and the tests.  One
    board per (manager, qname)."""

    def __init__(self, mgr, qname):
        self.mgr = mgr
        self.qname = qname
        self._q = mgr.get_queue(f"splits:{qname}")
        self._pinq = {}  # rank -> pinned-requeue queue handle

    @classmethod
    def connect(cls, address, authkey, qname):
        """Worker-side board over a remote manager."""
        return cls(tfmanager.connect(tuple(address), authkey), qname)

    # -- FCFS queue --------------------------------------------------------

    def post(self, sid):
        self._q.put(sid)

    def claim_next(self, ranks=()):
        """One non-blocking FCFS claim attempt: pinned requeues for the
        given trainer ``ranks`` first (recovery traffic beats new work),
        then the shared queue.  Returns a sid or None."""
        for rank in ranks:
            try:
                sid = self.pin_queue(rank).get(block=False)
            except _queue.Empty:
                continue
            self.pin_queue(rank).task_done()
            return sid
        try:
            sid = self._q.get(block=False)
        except _queue.Empty:
            return None
        self._q.task_done()
        return sid

    def queue_depth(self):
        try:
            return self._q.qsize()
        except Exception:  # noqa: BLE001 - depth is best-effort
            return 0

    def pin_queue(self, rank):
        q = self._pinq.get(rank)
        if q is None:
            q = self._pinq[rank] = self.mgr.get_queue(
                f"splits:{self.qname}:pin:{rank}")
        return q

    # -- claims / pins -----------------------------------------------------

    def set_claim(self, sid, worker):
        self.mgr.set(f"splits:{self.qname}:claim:{sid_str(sid)}",
                     (worker, time.time()))

    def claim_of(self, sid):
        return self.mgr.get(f"splits:{self.qname}:claim:{sid_str(sid)}")

    def clear_claim(self, sid):
        self.mgr.set(f"splits:{self.qname}:claim:{sid_str(sid)}", None)

    def set_pin(self, sid, rank):
        self.mgr.set(f"splits:{self.qname}:pin:{sid_str(sid)}", rank)

    def pin_of(self, sid):
        return self.mgr.get(f"splits:{self.qname}:pin:{sid_str(sid)}")

    # -- end-of-data / completion -----------------------------------------

    def eof(self):
        """Per-epoch split count once discovered, else None."""
        return self.mgr.get(f"splits:{self.qname}:eof")

    def set_eof(self, k):
        """Record that epoch block space ends at split ``k`` (min wins:
        concurrent discoverers can only tighten the bound)."""
        cur = self.eof()
        if cur is None or k < cur:
            self.mgr.set(f"splits:{self.qname}:eof", int(k))

    def complete(self):
        return bool(self.mgr.get(f"splits:{self.qname}:complete"))

    def set_complete(self):
        self.mgr.set(f"splits:{self.qname}:complete", True)

    # -- worker plan / liveness -------------------------------------------

    def plan(self):
        """Active worker indexes (ownership order).  Empty until the
        driver publishes one."""
        return list(self.mgr.get(f"splits:{self.qname}:plan") or ())

    def set_plan(self, workers):
        self.mgr.set(f"splits:{self.qname}:plan",
                     tuple(int(w) for w in workers))

    def beat_key(self, worker):
        return f"dataw:{self.qname}:{worker}"

    def worker_beat_age(self, worker):
        return liveness.beat_age(self.mgr, self.beat_key(worker))

    def start_heartbeat(self, worker):
        return liveness.start_heartbeat(self.mgr, self.beat_key(worker))


class SplitProvider(Actor):
    """Driver-side split provider (supervised actor): posts split ids in
    a bounded window ahead of consumption, sweeps stale claims back onto
    the queue, and declares completion (see module docstring).

    The posting cursor lives in the actor KV (``ctx.kv_set``) so a
    respawned incarnation resumes instead of re-posting; a fresh manager
    (cluster-level recovery) starts the cursor over, and the done-set
    check skips every split the ledger already has.
    """

    def __init__(self, qname, server_addr=None, num_epochs=1,
                 window=16, stale_secs=None):
        self.qname = qname
        self.server_addr = server_addr
        self.num_epochs = max(1, int(num_epochs))
        self.window = max(1, int(window))
        self.stale_secs = stale_secs

    def on_start(self, ctx):
        from tensorflowonspark_tpu_torch import rendezvous
        from tensorflowonspark_tpu_torch.actors.ledger import NullLedgerClient

        self._board = SplitBoard(ctx.mgr, self.qname)
        if self.stale_secs is None:
            self.stale_secs = tfmanager.stale_after()
        self._client = None
        if self.server_addr is not None:
            try:
                self._client = rendezvous.Client(self.server_addr)
            except Exception as e:  # noqa: BLE001 - ledgerless harnesses
                logger.debug("split provider: rendezvous unavailable "
                             "(%s)", e)
        if self._client is None:
            self._client = NullLedgerClient()
        cursor = ctx.kv_get("split_cursor") or (0, 0)
        self._epoch, self._k = int(cursor[0]), int(cursor[1])
        self._outstanding = set(ctx.kv_get("split_outstanding") or ())
        self._exhausted = False
        self._requeued = 0   # this incarnation's sweeps, for ``status``
        telemetry.event("data/split_provider_start", qname=self.qname,
                        epoch=self._epoch, k=self._k,
                        outstanding=len(self._outstanding))

    def on_message(self, ctx, kind, payload):
        if kind == "status":
            return {"cursor": (self._epoch, self._k),
                    "outstanding": len(self._outstanding),
                    "eof": self._board.eof(),
                    "complete": self._board.complete(),
                    "exhausted": self._exhausted,
                    "requeued": self._requeued}
        raise NotImplementedError(f"unhandled message kind {kind!r}")

    def on_tick(self, ctx):
        board = self._board
        if board.complete():
            return
        done = self._done_set()
        for sid in list(self._outstanding):
            if sid in done:
                self._outstanding.discard(sid)
                board.clear_claim(sid)
        self._sweep(board, done)
        self._top_up(board, done)
        ctx.kv_set("split_cursor", (self._epoch, self._k))
        ctx.kv_set("split_outstanding", tuple(self._outstanding))
        if metrics_registry.enabled():
            metrics_registry.set_gauge("tfos_data_split_queue_depth",
                                       board.queue_depth())
        if self._exhausted and not self._outstanding:
            board.set_complete()
            telemetry.event("data/splits_complete", qname=self.qname,
                            eof=board.eof(), epochs=self.num_epochs)

    def _done_set(self):
        try:
            parts = self._client.fed_partitions(split_feed(self.qname))
        except Exception:  # noqa: BLE001 - ledger momentarily unreachable
            return set()
        return {part_to_sid(p) for p in parts}

    def _sweep(self, board, done):
        """Requeue claimed-but-undone splits of dead claimants: claim
        older than ``stale_secs`` AND the claimant's heartbeat stale (or
        never seen).  Pinned splits go to the pin queue so the owner of
        the originally targeted trainer re-serves them."""
        now = time.time()
        for sid in list(self._outstanding):
            claim = board.claim_of(sid)
            if claim is None:
                continue  # still queued, or already swept
            worker, t_claim = claim
            if now - t_claim <= self.stale_secs:
                continue
            age = board.worker_beat_age(worker)
            if age is not None and age <= self.stale_secs:
                continue  # claimant alive, just slow
            board.clear_claim(sid)
            pin = board.pin_of(sid)
            if pin is not None:
                board.pin_queue(pin).put(sid)
            else:
                board.post(sid)
            self._requeued += 1
            metrics_registry.inc("tfos_data_splits_requeued_total")
            telemetry.event("data/split_requeued", sid=sid_str(sid),
                            worker=worker, pin=pin)
            logger.info("split provider: requeued %s (worker %s dead, "
                        "pin=%s)", sid_str(sid), worker, pin)

    def _top_up(self, board, done):
        """Keep up to ``window`` splits outstanding, advancing epochs as
        the per-epoch split count becomes known.  Splits the durable
        ledger already has (a previous incarnation served them) are
        skipped, never re-posted — the cross-recovery exactly-once
        half."""
        eof = board.eof()
        posted = 0
        while len(self._outstanding) < self.window and not self._exhausted:
            if eof is not None and self._k >= eof:
                if self._epoch + 1 >= self.num_epochs:
                    self._exhausted = True
                    break
                self._epoch += 1
                self._k = 0
                if eof == 0:  # empty dataset: nothing to post, any epoch
                    self._exhausted = True
                    break
            sid = (self._epoch, self._k)
            self._k += 1
            if sid in done:
                continue  # already consumed in a previous incarnation
            board.post(sid)
            self._outstanding.add(sid)
            metrics_registry.inc("tfos_data_splits_posted_total")
            posted += 1
        if posted:
            telemetry.event("data/splits_posted", count=posted,
                            epoch=self._epoch, next_k=self._k)
