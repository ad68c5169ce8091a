"""Infeed pipelining: overlap host batch preparation with device compute.

Counterpart of ``tensorflowonspark_tpu/infeed.py``: ``batch_iterator``
(a ``DataFeed`` -> collated host batches), ``prefetch_to_device`` (a
background thread stages batches ``depth`` ahead of the consumer, so the
card computes on batch t while t+1..t+depth are already in device
memory), ``device_feed`` (the two composed) and ``synchronized`` (every
process of the job stops on the same step).  On a CUDA device each batch
is copied from pinned host memory with a non-blocking copy on a side
stream; the consumer's stream waits on that copy's event before it
touches the batch.  ``tfrecord_device_feed`` waits in ROADMAP.md
(queue 1, item 8).
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time as _time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tensorflowonspark_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

_END = object()


def _to_tensor(x):
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) \
        else x


class _Staged:
    """A batch on the card, and the event its copy recorded there."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event=None, device=None):
        self.batch = batch
        self.event = event
        self.device = device

    def ready(self):
        """The batch, once the current stream has waited for the copy."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            # the copy's memory was allocated on the side stream: tell the
            # allocator it is in use on this one too
            for x in pytree.tree_leaves(self.batch):
                if torch.is_tensor(x) and x.is_cuda:
                    x.record_stream(stream)
        return self.batch


def _device_placer(device):
    """``place(batch) -> _Staged``: numpy leaves become tensors, tensor
    leaves go to ``device``; on CUDA through pinned memory and a side
    stream."""
    cuda = device.type == "cuda"
    side = {}

    def copy(x):
        x = _to_tensor(x)
        if not torch.is_tensor(x):
            return x
        if cuda and x.device.type == "cpu" and not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=cuda)

    def place(batch):
        if not cuda:
            return _Staged(pytree.tree_map(copy, batch))
        # the worker thread's own stream, made on first use
        stream = side.get("s")
        if stream is None:
            stream = side["s"] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            staged = pytree.tree_map(copy, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(staged, event, device)

    return place


def batch_iterator(feed, batch_size, collate=None, columnar=False):
    """``DataFeed`` -> iterator of collated host batches.

    ``collate(records) -> tree of numpy arrays or tensors`` (default: the
    records as they are).  Tails shorter than ``batch_size`` are always
    dropped (the JAX package's ``min_batch`` is left out), so every step
    sees a full batch: with gradients averaged over the processes
    (``sum / world_size``), equal per-process batches are what make that
    the global mean.
    ``columnar=True`` pulls with ``feed.next_batch_columns``: collate
    gets ``{tensor: ndarray[n, ...]}`` (requires ``input_mapping``)."""
    pull = feed.next_batch_columns if columnar else feed.next_batch
    while not feed.should_stop():
        records = pull(batch_size)
        n = (len(next(iter(records.values()))) if isinstance(records, dict)
             else len(records))
        if n < batch_size:
            continue
        yield collate(records) if collate is not None else records


def prefetch_to_device(it, depth=2, placement=None, on_abandon=None):
    """Stage ``it``'s batches onto the device ``depth`` ahead.

    ``it`` yields trees (tuples, lists, dicts) of numpy arrays or
    tensors.  ``placement``: None (the current CUDA device, through
    :func:`resolve_device`: raises without a card), a ``torch.device``
    or device string, or a callable ``batch -> batch`` that places the
    batch itself.  Exceptions on the worker thread re-raise at the
    consuming iteration.

    ``on_abandon``: called once if the consumer abandons the stream
    while the worker is still running (early ``break`` / ``close()``);
    its job is to make the source iterator return promptly.  Without
    it, a worker blocked in the source is left as a daemon.  Once the
    stream is abandoned the worker stages nothing more.
    """
    if callable(placement):
        def place(batch):
            return _Staged(placement(batch))
    else:
        place = _device_placer(resolve_device(placement))

    q = _queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def worker():
        try:
            for batch in it:
                # check before place(): a cancelled worker must not stage
                # one more batch onto the card just for the drain to drop
                if cancelled.is_set():
                    break
                staged = place(batch)
                # re-check after place(): the consumer may have abandoned
                # the stream during the copy; dropping the reference frees
                # the device memory, an abandoned queue would pin it
                if cancelled.is_set():
                    del staged
                    break
                q.put(staged)
        except Exception as e:  # noqa: BLE001 - forwarded to consumer
            q.put(("__prefetch_error__", e))
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True, name="tfos-prefetch")
    t.start()

    finished = False
    try:
        while True:
            item = q.get()
            if item is _END:
                finished = True
                return
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] == "__prefetch_error__":
                raise item[1]
            yield item.ready()
    finally:
        cancelled.set()
        if not finished:
            # abandoned mid-stream (or error raised): ask the source to
            # unblock, release a worker blocked on the full queue, and
            # drop staged batches so they don't pin device memory
            if on_abandon is not None:
                try:
                    on_abandon()
                except Exception:  # noqa: BLE001 - cleanup must not mask
                    logger.exception("prefetch on_abandon hook failed")
            deadline = _time.monotonic() + 3
            idle_polls = 0
            while _time.monotonic() < deadline:
                try:
                    item = q.get(timeout=0.2)
                except _queue.Empty:
                    if not t.is_alive():
                        break
                    # a live-but-idle worker is blocked in the source; give
                    # an on_abandon hook one extra poll, never the deadline
                    idle_polls += 1
                    if idle_polls >= (3 if on_abandon is not None else 2):
                        break
                    continue
                idle_polls = 0
                if item is _END:
                    break
        t.join(timeout=2)
        if t.is_alive():
            logger.warning("prefetch worker did not exit (blocked in the "
                           "source iterator or mid-transfer); left as daemon")
        # final sweep: drop anything enqueued between the drain loop's
        # last poll and the worker's exit
        while True:
            try:
                q.get_nowait()
            except _queue.Empty:
                break


def device_feed(feed, batch_size, *, collate=None, depth=2, placement=None,
                columnar=False):
    """The composed fast path: ``DataFeed`` -> ``collate`` ->
    double-buffered device staging (:func:`prefetch_to_device`, whose
    ``placement`` rules apply: None is the current CUDA device).
    Abandoning the stream poisons the feed, so the prefetch worker exits
    instead of polling the queue; call ``feed.terminate()`` afterwards
    for the producer-drain handshake."""
    return prefetch_to_device(
        batch_iterator(feed, batch_size, collate, columnar),
        depth=depth, placement=placement,
        on_abandon=getattr(feed, "poison", None))


def synchronized(it, feed=None):
    """Yield from ``it`` only while EVERY process of the job still has a
    next item.

    At the end of a feed the processes hold different numbers of full
    batches; one that stepped once more would wait forever in a gradient
    all-reduce its peers never join.  So before each item every process
    all-reduces a has-data flag with MIN over the process group (once
    per item: skipping an exchange would bring that hang back), and all
    stop on the same step.  ``feed``: the ``DataFeed`` behind ``it``; a
    process that stops with batches left drains it
    (``feed.terminate()``), keeping the feeders' handshake intact.

    Scope, as in the JAX package: this aligns the end-of-feed tail.  A
    process starved in mid-feed blocks on its feed before it reaches the
    exchange; the engine's partitioning keeps the per-process record
    counts balanced.  Outside a process group of more than one process
    it passes the items straight through."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        yield from it
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    while True:
        item = next(it, None)
        flag = torch.tensor([int(item is not None)], dtype=torch.int32,
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not int(flag.item()):
            if item is not None:
                logger.info("synchronized: a peer's feed ended; draining "
                            "the local remainder")
                if feed is not None:
                    feed.terminate()
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # reap the prefetch thread and staged batches
            return
        yield item
