"""The trainer's side of the feed: ``DataFeed``.

An own copy of the part of ``tensorflowonspark_tpu/feed.py`` that the
SPARK-fed training path calls (``next_batch``, ``next_batch_columns``,
``should_stop``, ``terminate``, ``poison``, ``batch_results``).  Queue
items are chunks (lists of records) that the feeder tasks push, so a
batch costs one IPC hop per chunk, not per record; a chunk that
overfills a batch carries over to the next call.

Transport: the executor's manager queue only.  The JAX package turns on
a shared-memory ring and a native columnar marshal by default
(``node.py:446``, through ``native/``); the port has neither yet
(ROADMAP.md queue 1, item 16), so every chunk is a pickled list of rows
through the manager queue, the transport the JAX package falls back to.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import marker
from tensorflowonspark_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)

POLL_MS = 1000  # one bounded get per poll; the stop flag is re-read between


class DataFeed:
    """Consumer of an executor's feed queues."""

    def __init__(self, mgr, train_mode=True, qname_in="input",
                 qname_out="output", input_mapping=None, metrics=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        self.records = 0  # records handed out, before any tail is dropped
        # optional utils.metrics.TrainMetrics: feed-wait time lands in its
        # infeed_wait counter
        self.metrics = metrics
        self.input_tensors = (sorted(input_mapping.values())
                              if input_mapping is not None else None)
        self._buffer = []  # leftover records of a partly consumed chunk
        self._col_meta = {}  # tensor -> (dtype, trailing shape) last seen
        # single consumer: a prefetch thread and a terminate() caller
        # must never pop at once; gets poll under this lock in slices and
        # re-check the stop flag between them
        self._lock = threading.Lock()
        self._stop_requested = False
        self._queue = None  # manager queue proxy, made once

    def _get_once(self, timeout_ms, honor_stop=False):
        """One bounded pop; raises TimeoutError when the queue stays
        empty.  ``honor_stop``: re-check the stop flag after taking the
        lock, so a consumer queued behind terminate()'s drain does not
        pop a chunk the drain was meant to absorb."""
        with self._lock:
            if honor_stop and self._stop_requested:
                raise TimeoutError("feed terminating")
            if self._queue is None:
                self._queue = self.mgr.get_queue(self.qname_in)
            try:
                chunk = self._queue.get(block=True,
                                        timeout=timeout_ms / 1000.0)
            except _queue.Empty:
                raise TimeoutError("feed queue empty") from None
            self._queue.task_done()
            return chunk

    def _get_chunk(self):
        """The next chunk: blocks until data arrives, or reports
        end-of-feed (None) once terminate() or poison() was called."""
        timed = self.metrics is not None or telemetry.enabled()
        t0 = time.perf_counter() if timed else None
        while True:
            if self._stop_requested:
                chunk = None
                break
            try:
                chunk = self._get_once(POLL_MS, honor_stop=True)
            except TimeoutError:
                continue
            faults.check("feed.get", eof=chunk is None)
            break
        if t0 is not None:
            # one measurement feeds both the counter and the span, so the
            # stall fractions they give agree
            dt = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.infeed_wait(dt)
            telemetry.record_span("feed/wait", dt, eof=chunk is None)
        return chunk

    def next_batch(self, batch_size):
        """Up to ``batch_size`` records: a list, or with
        ``input_mapping`` a dict ``{tensor: [column values]}``.  A None
        chunk is end-of-feed; an ``EndPartition`` ends the batch early
        in inference mode."""
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
            chunk = self._get_chunk()
            if chunk is None:
                logger.info("next_batch() got None: end of feed")
                self.done_feeding = True
                break
            if isinstance(chunk, marker.EndPartition):
                if not self.train_mode and count > 0:
                    break
                continue
            if isinstance(chunk, list):
                self._buffer.extend(chunk)
            else:
                append(chunk)
        self.records += count
        return tensors

    def next_batch_columns(self, batch_size):
        """Up to ``batch_size`` records as dense per-tensor arrays,
        ``{tensor: ndarray[n, ...]}`` (requires ``input_mapping``).  Over
        row chunks each column is one ``np.asarray`` of its values."""
        if self.input_tensors is None:
            raise ValueError("next_batch_columns requires input_mapping")
        rows = []
        while len(rows) < batch_size:
            if self._buffer:
                take = batch_size - len(rows)
                rows.extend(self._buffer[:take])
                del self._buffer[:take]
                continue
            chunk = self._get_chunk()
            if chunk is None:
                logger.info("next_batch_columns() got None: end of feed")
                self.done_feeding = True
                break
            if isinstance(chunk, marker.EndPartition):
                if not self.train_mode and rows:
                    break
                continue
            if isinstance(chunk, list):
                self._buffer.extend(chunk)
            else:
                rows.append(chunk)
        self.records += len(rows)
        out = {}
        for i, t in enumerate(self.input_tensors):
            if rows:
                out[t] = np.asarray([r[i] for r in rows])
                self._col_meta[t] = (out[t].dtype, out[t].shape[1:])
            else:
                # an empty pull keeps the dtype and trailing shape last
                # seen, so callers can concatenate tails
                dtype, trail = self._col_meta.get(t, (None, ()))
                out[t] = np.empty((0,) + tuple(trail), dtype=dtype)
        return out

    def should_stop(self):
        """True once the end-of-feed None arrived."""
        return self.done_feeding

    def batch_results(self, results):
        """Push one batch of results to the output queue."""
        self.mgr.get_queue(self.qname_out).put(list(results))

    def poison(self):
        """End the feed for its consumer without the producer handshake:
        the next poll reports end-of-feed.  A prefetch worker that was
        abandoned mid-stream exits within one poll this way."""
        self._stop_requested = True

    def terminate(self):
        """Stop early: set the node's state to 'terminating' (feeders
        that arrive later drain their partitions without queueing them)
        and drain what is queued, so every feeder's ``queue.join()``
        returns.  Safe while another thread is blocked in next_batch."""
        logger.info("terminate() invoked")
        self._stop_requested = True
        self.mgr.set("state", "terminating")
        while True:
            try:
                self._get_once(POLL_MS)
            except Exception:  # noqa: BLE001 - empty, or manager gone
                break
