"""The trainer's side of the feed: ``DataFeed``.

An own copy of the part of ``tensorflowonspark_tpu/feed.py`` that the
SPARK-fed training path calls (``next_batch``, ``next_batch_columns``,
``should_stop``, ``terminate``, ``poison``, ``batch_results``),
``hdfs_path``, behind ``TFNodeContext.absolute_path``, and the
deprecated TF1-era shims ``start_cluster_server`` and
``export_saved_model``, which warn and forward.  Queue
items are chunks that the feeder tasks push, so a batch costs one hop
per chunk, not per record; a chunk that overfills a batch carries over
to the next call.

Transport: the node advertises its shared-memory ring in the manager's
KV (``shm_input``, ``node.run``); then the 'input' chunks come through
that ring (``recordio.shm``), with no trip through the manager process,
and otherwise through the manager queue.  ``open_feed_ring`` is the one
handshake that producers and the consumer share, so both sides always
use the same transport.  A chunk is a list of records, or a
``marker.ColumnChunk`` (numeric records, which the feeder encodes
column by column, ``node._make_chunk_encoder``): ``next_batch_columns``
slices its columns into dense batches, a view of the popped buffer when
one chunk covers the batch.
"""

from __future__ import annotations

import collections
import logging
import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import marker
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

POLL_MS = 1000  # manager queue: one proxy call a poll
RING_POLL_MS = 100  # ring: a local check; the stop flag is re-read between
POP_LOG = 1024  # pops kept in ``DataFeed.stats()``


def hdfs_path(ctx, path):
    """``path`` normalised against the cluster's default filesystem, as
    the JAX package's ``feed.hdfs_path`` does: a path with a scheme
    passes through; an absolute one gets the default filesystem's
    prefix; a relative one resolves against the working directory
    (``file://``) or the user's home (``hdfs://``, ``gs://``, ...).
    ``recordio.fs`` opens the results (remote ones through fsspec)."""
    if path.startswith(("file://", "hdfs://", "viewfs://", "gs://",
                        "s3://", "s3a://", "har://")):
        return path
    if ctx.default_fs.startswith(("hdfs://", "viewfs://", "gs://",
                                  "s3a://")):
        if path.startswith("/"):
            return ctx.default_fs + path
        import getpass

        return f"{ctx.default_fs}/user/{getpass.getuser()}/{path}"
    if ctx.default_fs.startswith("file://"):
        if path.startswith("/"):
            return ctx.default_fs + path
        return f"file://{ctx.working_dir}/{path}"
    logger.warning("unknown default_fs %s, using path as-is", ctx.default_fs)
    return path


def open_feed_ring(mgr, qname="input", producer=False,
                   producer_nonblock=False):
    """The shm ring the node advertised for ``qname``, opened on this
    side, or None (the manager queue carries the feed).
    ``producer_nonblock``: a producer raises BlockingIOError while
    another one holds the ring's producer flock, instead of waiting
    (a data worker taking a trainer over from another).  An advertised
    ring that this process cannot open raises: a silent one-sided
    fallback would leave producer and consumer on different transports,
    and the feed would hang."""
    if qname != "input":
        return None
    ring_name = mgr.get("shm_input")
    if not ring_name:
        return None
    from tensorflowonspark_tpu_torch.recordio import shm

    try:
        return shm.ShmQueue(str(ring_name), create=False, producer=producer,
                            producer_nonblock=producer_nonblock)
    except BlockingIOError:
        raise
    except (OSError, RuntimeError) as e:
        raise RuntimeError(
            f"node advertised shm feed ring {ring_name!r} but this process "
            f"cannot open it: {e}; set TFOS_SHM_FEED=0 to feed through the "
            "manager queue") from e


def _sliced_column(chunk, i, off, take):
    """Field ``i``'s records [off, off+take) of a ColumnChunk, reshaped
    back to the field's trailing shape where the feeder flattened it: a
    view, no copy.  Every consumer path goes through here."""
    col = chunk.columns[i][off:off + take]
    if chunk.shapes is not None and chunk.shapes[i] is not None:
        col = col.reshape((-1,) + tuple(chunk.shapes[i]))
    return col


class DataFeed:
    """Consumer of an executor's feed: the shm ring or the manager
    queue for 'input' (``open_feed_ring``), the manager for the rest."""

    def __init__(self, mgr, train_mode=True, qname_in="input",
                 qname_out="output", input_mapping=None, metrics=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        self.records = 0  # records handed out, before any tail is dropped
        self.wait_s = 0.0  # every pop's transport wait, in total
        self._wait_acc = 0.0  # this pull's transport wait
        # optional utils.metrics.TrainMetrics: feed-wait time lands in its
        # infeed_wait counter
        self.metrics = metrics
        self.input_tensors = (sorted(input_mapping.values())
                              if input_mapping is not None else None)
        self._buffer = []  # leftover records of a partly consumed chunk
        self._colblock = None  # (ColumnChunk, offset) partly consumed
        self._col_meta = {}  # tensor -> (dtype, trailing shape) last seen
        # dynamic split dispatch: the next chunk seq expected a split id.
        # A re-served split (its worker died mid-split, the provider
        # requeued it pinned to this trainer) replays from seq 0; chunks
        # below the expected seq were consumed and are dropped here, the
        # consumer half of the exactly-once contract (data/splits.py)
        self._split_next = {}
        self.split_dup_chunks = 0
        # single consumer: a prefetch thread and a terminate() caller
        # must never pop at once; gets poll under this lock in slices and
        # re-check the stop flag between them
        self._lock = threading.Lock()
        self._stop_requested = False
        self._queue = None  # manager queue proxy, made once
        self._ring = open_feed_ring(mgr, qname_in)
        self.transport = "shm" if self._ring is not None else "manager"
        self.columnar_chunks = 0
        self.row_chunks = 0
        # of the latest pops: (wall time after the pop, ms the call took,
        # ms of its copy and decode once the message was there; None on
        # the manager queue, where the call's time includes both)
        self.pops = collections.deque(maxlen=POP_LOG)

    def _get_once(self, timeout_ms, honor_stop=False):
        """One bounded pop; raises TimeoutError when nothing came.
        ``honor_stop``: re-check the stop flag after taking the lock, so
        a consumer queued behind terminate()'s drain does not pop a chunk
        the drain was meant to absorb."""
        with self._lock:
            if honor_stop and self._stop_requested:
                raise TimeoutError("feed terminating")
            if self._ring is not None:
                return self._ring.get(timeout_ms)
            if self._queue is None:
                self._queue = self.mgr.get_queue(self.qname_in)
            try:
                chunk = self._queue.get(block=True,
                                        timeout=timeout_ms / 1000.0)
            except _queue.Empty:
                raise TimeoutError("feed queue empty") from None
            self._queue.task_done()
            return chunk

    def _pop(self, timeout_ms):
        """One honouring pop, logged in ``pops`` with its own time."""
        t0 = time.perf_counter()
        chunk = self._get_once(timeout_ms, honor_stop=True)
        copy_s = self._ring.last_pop_s if self._ring is not None else None
        self.pops.append((time.time(), 1e3 * (time.perf_counter() - t0),
                          None if copy_s is None else 1e3 * copy_s))
        return chunk

    def _get_chunk(self):
        """The next chunk: blocks until data arrives, or reports
        end-of-feed (None) once terminate() or poison() was called."""
        t0 = time.perf_counter()
        slice_ms = RING_POLL_MS if self._ring is not None else POLL_MS
        while True:
            if self._stop_requested:
                chunk = None
                break
            try:
                chunk = self._pop(slice_ms)
            except TimeoutError:
                continue
            faults.check("feed.get", eof=chunk is None)
            tag = getattr(chunk, "meta", None)
            if marker.is_split_tag(tag):
                _kind, sid, seq, _nblocks = tag
                if seq < self._split_next.get(sid, 0):
                    # a re-served split's prefix: consumed already
                    self.split_dup_chunks += 1
                    metrics_registry.inc("tfos_data_split_dup_chunks_total")
                    continue
                self._split_next[sid] = seq + 1
            break
        if isinstance(chunk, marker.ColumnChunk):
            self.columnar_chunks += 1
        elif isinstance(chunk, list):
            self.row_chunks += 1
        # one measurement feeds the totals, the counter and the span, so
        # the stall fractions they give agree
        dt = time.perf_counter() - t0
        self.wait_s += dt
        self._wait_acc += dt
        if self.metrics is not None:
            self.metrics.infeed_wait(dt)
        telemetry.record_span("feed/wait", dt, eof=chunk is None)
        if metrics_registry.enabled():
            metrics_registry.inc("tfos_feed_wait_seconds_total", dt)
            metrics_registry.inc("tfos_feed_chunks_total")
            try:
                metrics_registry.inc("tfos_feed_records_total", len(chunk))
            except TypeError:  # end-of-feed, or a marker with no length
                pass
            try:  # the depth is best effort
                if self._ring is not None:
                    metrics_registry.set_gauge("tfos_feed_ring_bytes",
                                               self._ring.qsize_bytes())
                elif self._queue is not None:
                    metrics_registry.set_gauge("tfos_feed_queue_depth",
                                               self._queue.qsize())
            except Exception:  # noqa: BLE001 - a proxy may be gone
                pass
        return chunk

    def stats(self):
        """What this feed saw: its transport (``"shm"`` or
        ``"manager"``), whether every data chunk was columnar, the chunk
        counts, the split-tagged chunks (each split's count, and the
        re-served ones dropped), the seconds every pop waited in all,
        and the latest pops as ``[wall time, ms, copy ms]``."""
        return {"transport": self.transport,
                "columnar": self.columnar_chunks > 0 and not self.row_chunks,
                "columnar_chunks": self.columnar_chunks,
                "row_chunks": self.row_chunks,
                "split_dup_chunks": self.split_dup_chunks,
                # each split id seen and the chunks of it handed out
                "split_chunks": {f"{sid[0]}.{sid[1]}": n for sid, n in
                                 sorted(self._split_next.items())},
                "wait_s": self.wait_s,
                "pops": [list(p) for p in self.pops]}

    def _rows_of(self, chunk, off, take):
        """Records [off, off+take) of a ColumnChunk as the row path gives
        them: a bare record as its array, else a tuple with Python
        scalars for 1-D columns, lists for width columns and arrays for
        flattened n-D fields.  Arrays are copies: a record a consumer
        keeps must not pin the whole popped buffer."""
        if chunk.meta == marker.BARE:
            return [r.copy() for r in _sliced_column(chunk, 0, off, take)]
        if chunk.shapes is None:
            from tensorflowonspark_tpu_torch.recordio import marshal

            return marshal.columns_to_rows(
                [c[off:off + take] for c in chunk.columns])
        cols = [_sliced_column(chunk, i, off, take)
                for i in range(len(chunk.columns))]

        def value(i, c, j):
            if chunk.shapes[i] is not None:
                return c[j].copy()
            return c[j].item() if c.ndim == 1 else c[j].tolist()

        return [tuple(value(i, c, j) for i, c in enumerate(cols))
                for j in range(take)]

    def _consumer_span(self, t0, out):
        """The pull's ``data/stage`` span (stage ``fed_consumer``), as the
        JAX package records it: the pull's wall time less the transport
        wait ``_get_chunk`` accumulated is the consumer's own assembly
        (slices, concatenation, lists), with ``wait_ms`` and the
        ``records`` it handed out."""
        dur = time.perf_counter() - t0
        wait = min(self._wait_acc, dur)
        if isinstance(out, dict):
            n = len(next(iter(out.values()))) if out else 0
        else:
            n = len(out)
        telemetry.record_span("data/stage", max(dur - wait, 0.0),
                              stage="fed_consumer",
                              wait_ms=round(wait * 1e3, 3), records=n)

    def _timed_pull(self, pull, batch_size):
        """``pull(batch_size)``, with the consumer's span when telemetry
        is on."""
        if not telemetry.enabled():
            return pull(batch_size)
        t0 = time.perf_counter()
        self._wait_acc = 0.0
        out = pull(batch_size)
        self._consumer_span(t0, out)
        return out

    def next_batch(self, batch_size):
        """Up to ``batch_size`` records: a list, or with
        ``input_mapping`` a dict ``{tensor: [column values]}``.  A None
        chunk is end-of-feed; an ``EndPartition`` ends the batch early
        in inference mode."""
        return self._timed_pull(self._next_batch, batch_size)

    def _next_batch(self, batch_size):
        tensors = ([] if self.input_tensors is None
                   else {t: [] for t in self.input_tensors})
        count = 0

        def append(record):
            nonlocal count
            if self.input_tensors is None:
                tensors.append(record)
            else:
                for i, t in enumerate(self.input_tensors):
                    tensors[t].append(record[i])
            count += 1

        while count < batch_size:
            if self._buffer:
                append(self._buffer.pop(0))
                continue
            if self._colblock is not None:
                chunk, off = self._colblock
                take = min(batch_size - count, len(chunk) - off)
                if self.input_tensors is None:
                    self._buffer.extend(self._rows_of(chunk, off, take))
                else:
                    # column slices extend the lists directly: no
                    # per-record Python work
                    for i, t in enumerate(self.input_tensors):
                        tensors[t].extend(_sliced_column(chunk, i, off, take))
                    count += take
                off += take
                self._colblock = (chunk, off) if off < len(chunk) else None
                continue
            chunk = self._get_chunk()
            if chunk is None:
                logger.info("next_batch() got None: end of feed")
                self.done_feeding = True
                break
            if isinstance(chunk, marker.EndPartition):
                if not self.train_mode and count > 0:
                    break
                continue
            if isinstance(chunk, marker.ColumnChunk):
                self._colblock = (chunk, 0)
            elif isinstance(chunk, list):
                self._buffer.extend(chunk)
            else:
                append(chunk)
        self.records += count
        return tensors

    def next_batch_columns(self, batch_size):
        """Up to ``batch_size`` records as dense per-tensor arrays,
        ``{tensor: ndarray[n, ...]}`` (requires ``input_mapping``).

        ColumnChunks are consumed as array segments: an aligned chunk
        that covers the whole batch passes through as a view of the
        popped buffer, a batch that spans chunks costs one
        ``np.concatenate``; row chunks cost one ``np.asarray`` per
        column.  Flattened n-D fields come back in their own shape."""
        if self.input_tensors is None:
            raise ValueError("next_batch_columns requires input_mapping")
        return self._timed_pull(self._next_batch_columns, batch_size)

    def _next_batch_columns(self, batch_size):
        segments = {t: [] for t in self.input_tensors}
        count = 0

        def rows_segment(rows):
            nonlocal count
            for i, t in enumerate(self.input_tensors):
                segments[t].append(np.asarray([r[i] for r in rows]))
            count += len(rows)

        while count < batch_size:
            if self._buffer:
                take = min(batch_size - count, len(self._buffer))
                rows, self._buffer = (self._buffer[:take],
                                      self._buffer[take:])
                rows_segment(rows)
                continue
            if self._colblock is not None:
                chunk, off = self._colblock
                take = min(batch_size - count, len(chunk) - off)
                for i, t in enumerate(self.input_tensors):
                    segments[t].append(_sliced_column(chunk, i, off, take))
                count += take
                off += take
                self._colblock = (chunk, off) if off < len(chunk) else None
                continue
            chunk = self._get_chunk()
            if chunk is None:
                logger.info("next_batch_columns() got None: end of feed")
                self.done_feeding = True
                break
            if isinstance(chunk, marker.EndPartition):
                if not self.train_mode and count > 0:
                    break
                continue
            if isinstance(chunk, marker.ColumnChunk):
                self._colblock = (chunk, 0)
            elif isinstance(chunk, list):
                self._buffer.extend(chunk)
            else:
                rows_segment([chunk])
        self.records += count
        out = {}
        for t in self.input_tensors:
            parts = segments[t]
            if not parts:
                # an empty pull keeps the dtype and trailing shape last
                # seen, so callers can concatenate tails
                dtype, trail = self._col_meta.get(t, (None, ()))
                out[t] = np.empty((0,) + tuple(trail), dtype=dtype)
                continue
            out[t] = parts[0] if len(parts) == 1 else \
                np.concatenate(parts, axis=0)
            self._col_meta[t] = (out[t].dtype, out[t].shape[1:])
        return out

    def should_stop(self):
        """True once the end-of-feed None arrived."""
        return self.done_feeding

    def batch_results(self, results):
        """Push one batch of results to the output queue, through the
        manager's cached proxy (a new one costs a connection)."""
        self.mgr.queue(self.qname_out).put(list(results))

    def poison(self):
        """End the feed for its consumer without the producer handshake:
        the next poll reports end-of-feed.  A prefetch worker that was
        abandoned mid-stream exits within one poll this way."""
        self._stop_requested = True

    def terminate(self):
        """Stop early: set the node's state to 'terminating' (feeders
        that arrive later drain their partitions without queueing them)
        and drain what is queued, so every feeder's wait for consumption
        returns.  Safe while another thread is blocked in next_batch.

        On the ring, "drained" is decided by the producer flock, not a
        timeout: an empty ring ends the drain only once no feeder holds
        the flock, so a slow feeder mid-partition cannot strand data."""
        logger.info("terminate() invoked")
        self._stop_requested = True
        self.mgr.set("state", "terminating")
        if self._ring is not None:
            from tensorflowonspark_tpu_torch.recordio import shm

            empty_checks = 0
            while True:
                try:
                    if self._get_once(POLL_MS) is None:
                        break  # the producer closed the ring
                    empty_checks = 0
                except TimeoutError:
                    if (self._ring.qsize_bytes() == 0
                            and not shm.producer_active(self._ring.name)):
                        empty_checks += 1
                        if empty_checks >= 2:
                            break
            return
        while True:
            try:
                self._get_once(POLL_MS)
            except Exception:  # noqa: BLE001 - empty, or manager gone
                break


class _ClusterServer:
    """What ``start_cluster_server`` returns, in place of a
    ``tf.train.Server``: the coordinator's address as ``target``."""

    def __init__(self, target):
        self.target = target

    @staticmethod
    def join():
        raise RuntimeError(
            "server.join() has no counterpart: a ps node holds its slot "
            "through the framework's control queue")


def start_cluster_server(ctx, num_gpus=1, rdma=False):
    """Deprecated TF1-era API: joins the job through
    ``ctx.torch_initialize()`` and returns an object whose ``target`` is
    the coordinator's address and whose ``join()`` raises.  Kept so
    ported ``main_fun``s run."""
    import warnings

    del num_gpus, rdma
    warnings.warn("start_cluster_server is deprecated; use "
                  "ctx.torch_initialize()", DeprecationWarning, stacklevel=2)
    env = ctx.torch_initialize()
    return _ClusterServer(env.get("coordinator_address"))


def export_saved_model(sess=None, export_dir=None, tag_set=None,
                       signatures=None, params=None, ctx=None,
                       metadata=None):
    """Deprecated TF1-era export: forwards to
    ``utils.checkpoint.export_model(export_dir, params, ctx,
    metadata=metadata)`` (chief only), after a warning."""
    import warnings

    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    del sess, tag_set, signatures
    warnings.warn("TFNode.export_saved_model is deprecated; use "
                  "utils.checkpoint.export_model", DeprecationWarning,
                  stacklevel=2)
    if export_dir is None or params is None:
        raise ValueError("export_saved_model needs export_dir and params")
    return ckpt.export_model(export_dir, params, ctx, metadata=metadata)
