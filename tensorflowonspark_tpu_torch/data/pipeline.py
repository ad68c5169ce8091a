"""Lazy, composable dataset-pipeline graph over columnar blocks.

An own copy of ``tensorflowonspark_tpu/data/pipeline.py``.  A
:class:`Pipeline` is an immutable graph of nodes whose elements are
**columnar blocks**, ``{name: ndarray[b, ...] | list}``, the shape
:func:`dfutil.iter_tfrecords_columnar` yields, so record streams stay
dense end to end and become the ring's wire format
(``marker.ColumnChunk``) with no per-record Python loop.

Stages (all lazy; nothing runs until a terminal is iterated):

==================  =====================================================
``map``             block-wise transform (vectorised over the block)
``parallel_map``    the same, in a spawn process pool (ordered or not)
``batch``           re-chunk to blocks of exactly N records
``shuffle``         seeded windowed record shuffle (deterministic)
``interleave``      round robin over the source's shard files
``cache``           memory cache with a spill file past its budget
``prefetch``        a background thread stages blocks (host side)
``repeat``          epochs
``shard``           strided exactly-once record split over consumers
==================  =====================================================

Terminals: :meth:`Pipeline.blocks` (host blocks), :meth:`Pipeline.
chunks` (``ColumnChunk``s, what the data service pushes) and
:meth:`Pipeline.to_device` (``infeed.prefetch_to_device``: the card
unless a ``placement`` says otherwise).

Determinism: a pipeline with a seeded ``shuffle`` yields the same
blocks on every fresh iteration, so two runs with one seed see the same
batch order, ``shard(i, n)`` consumers split every record exactly once
an epoch, and a restarted consumer resumes by skipping ``skip_blocks``
blocks (``data.service``).  Shuffle, shard and interleave orders are
numpy- and index-based, the JAX package's to the element.

What crosses a process (the data service ships a pipeline to its
workers) is pickled with plain pickle, as every engine task of the
port: a ``map``/``parallel_map`` function is a module-level function or
an instance of a module-level class, never a lambda or closure.

Per-stage telemetry (``TFOS_TELEMETRY_DIR``): every stage emits one
``data/stage`` span a block it produces, with ``stage``, ``wait_ms``
(time blocked in its upstream) and ``records``.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import pickle
import queue as _queue
import tempfile
import threading
import time
import weakref

from tensorflowonspark_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

PREFETCH_ENV = "TFOS_DATA_PREFETCH"
CHUNKSIZE_ENV = "TFOS_DATA_CHUNKSIZE"

_tls = threading.local()

# Serializes the PYTHONPATH save/clear/restore around spawn-pool
# construction (_ParallelMap): two pipelines building pools concurrently
# would otherwise race the env mutation and could leak an empty
# PYTHONPATH into one of them permanently.
_SPAWN_ENV_LOCK = threading.Lock()


def _pool_chunksize():
    """``imap`` chunksize for parallel_map pools: ``TFOS_DATA_CHUNKSIZE``
    (default 1).  chunksize=1 is one IPC round-trip per block — pure
    overhead for small blocks; raising it batches blocks per worker
    dispatch at the cost of coarser load balance."""
    try:
        return max(1, int(os.environ.get(CHUNKSIZE_ENV, "1")))
    except ValueError:
        return 1


# --------------------------------------------------------------------------
# block helpers: a block is {name: ndarray[b, ...] | list-of-objects}


def block_len(block):
    """Record count of a columnar block."""
    return len(next(iter(block.values())))


def _slice_block(block, lo, hi):
    return {name: col[lo:hi] for name, col in block.items()}


def _take_rows(block, idx):
    """Row subset/permutation ``idx`` (ndarray of indices) of a block."""
    import numpy as np

    out = {}
    for name, col in block.items():
        if isinstance(col, np.ndarray):
            out[name] = col[idx]
        else:
            out[name] = [col[i] for i in idx]
    return out


def _concat_columns(parts):
    import numpy as np

    if isinstance(parts[0], np.ndarray):
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
    out = []
    for p in parts:
        out.extend(p)
    return out


def _concat_blocks(blocks):
    if len(blocks) == 1:
        return blocks[0]
    names = blocks[0].keys()
    return {n: _concat_columns([b[n] for b in blocks]) for n in names}


def _rows_to_block(rows):
    """List of rows -> one columnar block (ndarray where dense).

    Rows are dicts (``{name: value}``) or positional tuples — the
    feeder-RDD convention of ``(features, label)`` — which get synthetic
    ``c000..`` names so positional order survives ``block_to_chunk``'s
    sorted-by-name wire order."""
    import numpy as np

    first_row = rows[0]
    if not isinstance(first_row, dict):
        if not isinstance(first_row, (tuple, list)):
            rows = [(r,) for r in rows]
        rows = [{f"c{i:03d}": v for i, v in enumerate(r)} for r in rows]
    names = list(rows[0].keys())
    block = {}
    for n in names:
        vals = [r[n] for r in rows]
        first = vals[0]
        if isinstance(first, (bytes, str)):
            block[n] = vals
        else:
            try:
                block[n] = np.asarray(vals)
            except Exception:  # noqa: BLE001 - ragged: keep the list column
                block[n] = vals
    return block


def block_to_chunk(block):
    """Columnar block -> ``marker.ColumnChunk`` wire chunk, zero-copy.

    Field order is sorted by name — the same convention
    ``DataFeed.input_tensors`` uses (``sorted(input_mapping.values())``),
    so service-pushed chunks slice straight into
    ``next_batch_columns``.  n-D columns (images ``[b, H, W, C]``) are
    flattened to ``[b, H*W*C]`` reshape views with the trailing shape in
    ``ColumnChunk.shapes`` (the wire shape contract of
    ``feed._sliced_column``); object columns (bytes) ride as lists.
    """
    import numpy as np

    from tensorflowonspark_tpu_torch import marker
    from tensorflowonspark_tpu_torch.recordio import marshal

    spec = []
    columns = []
    shapes = []
    for name in sorted(block):
        col = block[name]
        if isinstance(col, np.ndarray):
            code = marshal._ndarray_code(col.dtype)
            if col.ndim == 1:
                spec.append((code, 0))
                shapes.append(None)
            elif col.ndim == 2:
                spec.append((code, col.shape[1]))
                shapes.append(None)
            else:
                trail = col.shape[1:]
                col = col.reshape(len(col), -1)
                spec.append((code, col.shape[1]))
                shapes.append(trail)
        else:
            spec.append(("O", 0))
            shapes.append(None)
        columns.append(col)
    shp = tuple(shapes) if any(s is not None for s in shapes) else None
    return marker.ColumnChunk(spec, columns, shapes=shp)


# --------------------------------------------------------------------------
# stage instrumentation: nested self/wait decomposition


def _instrumented(name, gen, total_is_wait=False):
    """Wrap a stage generator with per-block ``data/stage`` spans.

    Accounting is a thread-local span stack: the wall time of one
    ``next()`` on THIS stage, minus the wall time its direct upstream
    ``next()`` calls recorded into our stack slot, is this stage's
    *self* (produce) time; the remainder is *wait*.  Cardinality changes
    (batch consuming k upstream blocks per emitted block) fall out
    naturally because every upstream pull lands in the same slot.

    ``total_is_wait``: stages whose work happens elsewhere (prefetch's
    background thread) report their whole blocked time as wait.
    """
    it = iter(gen)
    while True:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            block = next(it)
            alive = True
        except StopIteration:
            alive = False
        total = time.perf_counter() - t0
        child = stack.pop()
        if stack:
            stack[-1] += total
        if not alive:
            return
        if telemetry.enabled():
            wait = total if total_is_wait else min(child, total)
            telemetry.record_span(
                "data/stage", max(total - wait, 0.0), stage=name,
                wait_ms=round(wait * 1e3, 3), records=block_len(block))
        yield block


# --------------------------------------------------------------------------
# parallel_map function shipping (spawn-safe)


def _shippable(fn):
    """``fn`` itself once it pickles (spawn pools and engine tasks
    unpickle it in the child); ValueError otherwise."""
    try:
        pickle.dumps(fn)
    except Exception as e:  # noqa: BLE001 - say what to do instead
        raise ValueError(
            "a pipeline function must pickle (a module-level function or "
            f"an instance of a module-level class), not {fn!r}: {e}") from e
    return fn


# --------------------------------------------------------------------------
# the graph


class Pipeline:
    """One node of the lazy pipeline DAG.  Construct via the module
    sources (:func:`from_tfrecords` / :func:`from_arrays` /
    :func:`from_dataset`) and chain transforms; every transform returns
    a NEW node (nodes are immutable and reusable)."""

    stage_name = "pipeline"
    _total_is_wait = False

    def __init__(self, parent=None):
        self.parent = parent

    # -- structure ---------------------------------------------------------

    def _blocks(self):
        raise NotImplementedError

    def _iter(self):
        """Instrumented block iterator for THIS node (internal)."""
        if not telemetry.enabled():
            return self._blocks()
        return _instrumented(self.stage_name, self._blocks(),
                             self._total_is_wait)

    def _substreams(self):
        """Per-shard sub-iterators for interleave; sources that have a
        natural file split override this."""
        raise ValueError(
            f"interleave() needs a multi-shard source upstream; "
            f"{type(self).__name__} has no sub-streams")

    def _skip_fast(self, skip_blocks):
        """Iterator starting at block ``skip_blocks`` WITHOUT recomputing
        the prefix, or None when this node cannot (the generic path then
        recomputes and discards).  Sources with O(1) random block access
        (in-memory arrays) and completed caches override this — the
        split-aware fast path dynamic split dispatch leans on so serving
        split k is O(split), not O(k) (docs/data.md)."""
        return None

    def _skip_iter(self, skip_blocks):
        """Block iterator from ``skip_blocks`` on: the fast path when the
        node supports it, recompute-and-discard otherwise."""
        if skip_blocks:
            fast = self._skip_fast(skip_blocks)
            if fast is not None:
                if not telemetry.enabled():
                    return fast
                return _instrumented(self.stage_name, fast,
                                     self._total_is_wait)
        it = self._iter()
        for _ in range(skip_blocks):
            if next(it, None) is None:
                return iter(())
        return it

    # -- identity ----------------------------------------------------------

    def signature(self):
        """Stable structural digest of the pipeline graph — stage chain +
        content-relevant parameters — used to key the shared epoch cache
        (``data.cache``): two pipeline objects with the same signature
        produce the same block sequence (determinism contract), so M
        consumers can share one materialized epoch.  Parameters that do
        not change the produced records (pool width, prefetch depth) are
        excluded."""
        return hashlib.sha1(
            "|".join(self._sig_parts()).encode()).hexdigest()[:16]

    def _sig_parts(self):
        parts = [] if self.parent is None else self.parent._sig_parts()
        parts.append(self._sig())
        return parts

    def _sig(self):
        return self.stage_name

    # -- transforms --------------------------------------------------------

    def map(self, fn):
        """Block-wise transform: ``fn({name: column}) -> block``.  The
        unit is a BLOCK, not a record — write ``fn`` vectorized (the
        tf.data ``map`` analogue at batch granularity)."""
        return _Map(self, fn)

    def parallel_map(self, fn, num_workers=2, ordered=True):
        """``map`` in a spawn-context process pool.  ``ordered=False``
        trades block order for completion order (throughput when block
        costs vary).  ``fn`` must pickle (module-level) for the spawn
        children."""
        return _ParallelMap(self, fn, num_workers, ordered)

    def batch(self, batch_size, drop_remainder=False):
        """Re-chunk the record stream into exactly-``batch_size`` blocks
        (a short final block is dropped with ``drop_remainder=True`` —
        SPMD steps want full shapes, cf. ``dfutil.iter_tfrecords_columnar``)."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        return _Batch(self, int(batch_size), bool(drop_remainder))

    def shuffle(self, buffer_size, seed=0):
        """Seeded windowed record shuffle: fill a ``buffer_size``-record
        window, emit one full permutation of it, repeat; the tail window
        is permuted too, so every record is emitted exactly once.  A
        buffer at least the dataset size is a global shuffle.  Fresh
        iterations replay the identical order (determinism contract)."""
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        return _Shuffle(self, int(buffer_size), int(seed))

    def interleave(self, cycle_length=2):
        """Round-robin blocks from ``cycle_length`` source shard files at
        a time (the tf.data ``interleave`` analogue over ``part-*``
        files) — hides per-shard open/decode latency behind the other
        open shards.  Requires a multi-shard source as the direct
        upstream."""
        if cycle_length < 1:
            raise ValueError(f"cycle_length must be >= 1, got {cycle_length}")
        return _Interleave(self, int(cycle_length))

    def cache(self, spill_dir=None, memory_bytes=256 << 20):
        """Materialize the upstream once; later iterations replay.  The
        first ``memory_bytes`` of blocks stay in memory, overflow spills
        to one pickle file under ``spill_dir`` (default: tempdir).  The
        cache only becomes authoritative after a COMPLETE first pass —
        an abandoned pass is discarded."""
        return _Cache(self, spill_dir, int(memory_bytes))

    def prefetch(self, depth=2):
        """Stage up to ``depth`` upstream blocks ahead on a background
        thread (host-side; ``to_device`` adds the device half)."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return _Prefetch(self, int(depth))

    def repeat(self, count=None):
        """Repeat the upstream ``count`` times (``None`` = forever).
        Each epoch is a fresh deterministic iteration of the graph."""
        if count is not None and count < 1:
            raise ValueError(f"repeat count must be >= 1, got {count}")
        return _Repeat(self, count)

    def shard(self, index, count):
        """Keep records whose GLOBAL record index ``% count == index`` —
        the exactly-once split for ``count`` consumers (every record
        goes to exactly one shard; deterministic, so it composes with
        seeded ``shuffle`` for fault-tolerant resume)."""
        if not 0 <= index < count:
            raise ValueError(f"need 0 <= index < count, got {index}/{count}")
        return _Shard(self, int(index), int(count))

    # -- terminals ---------------------------------------------------------

    def blocks(self, skip_blocks=0):
        """Iterate host blocks.  ``skip_blocks``: resume support — the
        first N blocks are skipped via the node's fast path when it has
        one (arrays, completed caches), else recomputed and discarded
        (cheap relative to re-feeding a trainer; the determinism
        contract makes the skip land exactly where the previous consumer
        stopped)."""
        return self._skip_iter(skip_blocks)

    def blocks_range(self, skip_blocks=0, num_blocks=None):
        """Iterate at most ``num_blocks`` host blocks starting at block
        ``skip_blocks`` — the split-serving terminal of dynamic split
        dispatch (``data.splits``): split k of width B is
        ``blocks_range(k * B, B)``.  ``num_blocks=None`` reads to the
        end."""
        it = self._skip_iter(skip_blocks)
        if num_blocks is None:
            return it
        return itertools.islice(it, num_blocks)

    def chunks(self, skip_blocks=0):
        """Iterate ``marker.ColumnChunk`` wire chunks (one per block) —
        what the feed ring and data service transport."""
        return (block_to_chunk(b) for b in self.blocks(skip_blocks))

    def to_device(self, depth=None, placement=None, collate=None):
        """Terminate into the existing double-buffered device staging
        (``infeed.prefetch_to_device``): blocks are placed ``depth``
        ahead while the device consumes.  ``collate(block) -> pytree``
        (default: the block dict as-is); ``placement`` as in infeed.
        Default ``depth``: ``TFOS_DATA_PREFETCH`` (2)."""
        from tensorflowonspark_tpu_torch import infeed

        if depth is None:
            depth = int(os.environ.get(PREFETCH_ENV, "2"))
        it = self.blocks()
        if collate is not None:
            it = map(collate, it)
        return infeed.prefetch_to_device(it, depth=depth,
                                         placement=placement)


def _fn_digest(fn):
    """Content digest of a stage callable for ``signature()``: its
    pickle, else its qualified name and identity (this process only)."""
    try:
        payload = pickle.dumps(fn, protocol=4)
    except Exception:  # noqa: BLE001 - a closure: identity only
        return f"{getattr(fn, '__qualname__', repr(fn))}@{id(fn)}"
    return hashlib.sha1(payload).hexdigest()[:12]


class _Map(Pipeline):
    stage_name = "map"

    def __init__(self, parent, fn):
        super().__init__(parent)
        self.fn = fn

    def _blocks(self):
        fn = self.fn
        for block in self.parent._iter():
            yield fn(block)

    def _skip_fast(self, skip_blocks):
        # 1:1 block-wise: a skippable upstream makes this node skippable
        fast = self.parent._skip_fast(skip_blocks)
        if fast is None:
            return None
        return map(self.fn, fast)

    def _sig(self):
        return f"map:{_fn_digest(self.fn)}"


class _ParallelMap(Pipeline):
    stage_name = "parallel_map"

    def __init__(self, parent, fn, num_workers, ordered):
        super().__init__(parent)
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.fn = _shippable(fn)
        self.num_workers = int(num_workers)
        self.ordered = bool(ordered)

    def _blocks(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        # Children get an empty PYTHONPATH, so that no site hook of the
        # parent's runs at their start: the spawn protocol ships the
        # parent's sys.path, so the package still imports.  Under
        # _SPAWN_ENV_LOCK: the mutation is process-global.
        with _SPAWN_ENV_LOCK:
            saved = os.environ.get("PYTHONPATH")
            os.environ["PYTHONPATH"] = ""
            try:
                pool = ctx.Pool(self.num_workers)
            finally:
                if saved is None:
                    os.environ.pop("PYTHONPATH", None)
                else:
                    os.environ["PYTHONPATH"] = saved
        try:
            imap = pool.imap if self.ordered else pool.imap_unordered
            yield from imap(self.fn, self.parent._iter(),
                            chunksize=_pool_chunksize())
        finally:
            pool.terminate()
            pool.join()

    def _sig(self):
        # num_workers does not change the produced records; ordered does
        return f"parallel_map:{_fn_digest(self.fn)}:{int(self.ordered)}"


class _Batch(Pipeline):
    stage_name = "batch"

    def __init__(self, parent, batch_size, drop_remainder):
        super().__init__(parent)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def _blocks(self):
        n = self.batch_size
        pending = []  # [(block, offset)] not yet emitted
        have = 0
        for block in self.parent._iter():
            pending.append((block, 0))
            have += block_len(block)
            while have >= n:
                parts = []
                need = n
                while need:
                    blk, off = pending[0]
                    take = min(need, block_len(blk) - off)
                    parts.append(_slice_block(blk, off, off + take))
                    need -= take
                    if off + take < block_len(blk):
                        pending[0] = (blk, off + take)
                    else:
                        pending.pop(0)
                have -= n
                yield _concat_blocks(parts)
        if have and not self.drop_remainder:
            yield _concat_blocks(
                [_slice_block(b, off, block_len(b)) for b, off in pending])

    def _sig(self):
        return f"batch:{self.batch_size}:{int(self.drop_remainder)}"


class _Shuffle(Pipeline):
    stage_name = "shuffle"

    def __init__(self, parent, buffer_size, seed):
        super().__init__(parent)
        self.buffer_size = buffer_size
        self.seed = seed

    def _blocks(self):
        import numpy as np

        rng = np.random.default_rng(self.seed)
        window = []  # accumulated blocks
        have = 0

        def emit(blocks, count):
            merged = _concat_blocks(blocks)
            perm = rng.permutation(count)
            return _take_rows(merged, perm)

        for block in self.parent._iter():
            window.append(block)
            have += block_len(block)
            while have >= self.buffer_size:
                take = self.buffer_size
                parts, rest = [], []
                for blk in window:
                    if take >= block_len(blk):
                        parts.append(blk)
                        take -= block_len(blk)
                    elif take:
                        parts.append(_slice_block(blk, 0, take))
                        rest.append(_slice_block(blk, take, block_len(blk)))
                        take = 0
                    else:
                        rest.append(blk)
                window = rest
                have -= self.buffer_size
                yield emit(parts, self.buffer_size)
        if have:
            yield emit(window, have)

    def _sig(self):
        return f"shuffle:{self.buffer_size}:{self.seed}"


class _Interleave(Pipeline):
    stage_name = "interleave"

    def __init__(self, parent, cycle_length):
        super().__init__(parent)
        self.cycle_length = cycle_length
        if type(parent)._substreams is Pipeline._substreams:
            parent._substreams()  # eager: raises on unsupported source

    def _blocks(self):
        pending = list(self.parent._substreams())
        live = []
        while pending and len(live) < self.cycle_length:
            live.append(iter(pending.pop(0)()))
        while live:
            nxt = []
            for it in live:
                block = next(it, None)
                if block is None:
                    if pending:
                        nxt.append(iter(pending.pop(0)()))
                    continue
                yield block
                nxt.append(it)
            live = nxt

    def _sig(self):
        return f"interleave:{self.cycle_length}"


class _Cache(Pipeline):
    stage_name = "cache"

    def __init__(self, parent, spill_dir, memory_bytes):
        super().__init__(parent)
        self.spill_dir = spill_dir
        self.memory_bytes = memory_bytes
        self._lock = threading.Lock()
        self._complete = False
        self._mem = []
        self._spill_path = None
        self._spill_offsets = []  # byte offset of each spilled block
        self._finalizer = None

    def __getstate__(self):
        # shipped to another process (a data worker) as its recipe: the
        # copy starts empty and fills there
        state = dict(self.__dict__)
        for k in ("_lock", "_finalizer"):
            state.pop(k, None)
        state.update(_complete=False, _mem=[], _spill_path=None,
                     _spill_offsets=[])
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._finalizer = None

    def _col_bytes(self, block):
        import numpy as np

        total = 0
        for col in block.values():
            if isinstance(col, np.ndarray):
                total += col.nbytes
            else:
                total += sum(len(v) if isinstance(v, (bytes, str)) else 64
                             for v in col)
        return total

    def _blocks(self):
        with self._lock:
            if self._complete:
                replay_mem = list(self._mem)
                spill = self._spill_path
            else:
                replay_mem = None
                spill = None
        if replay_mem is not None:
            yield from replay_mem
            if spill is not None:
                with open(spill, "rb") as f:
                    while True:
                        try:
                            yield pickle.load(f)
                        except EOFError:
                            return
            return

        # first (filling) pass; only a COMPLETE pass publishes the cache
        mem, used, spill_f, spill_path = [], 0, None, None
        offsets = []
        try:
            for block in self.parent._iter():
                if spill_f is None and used + self._col_bytes(block) \
                        <= self.memory_bytes:
                    mem.append(block)
                    used += self._col_bytes(block)
                else:
                    if spill_f is None:
                        fd, spill_path = tempfile.mkstemp(
                            prefix="tfos-data-cache-", suffix=".pkl",
                            dir=self.spill_dir)
                        spill_f = os.fdopen(fd, "wb")
                    offsets.append(spill_f.tell())
                    pickle.dump(block, spill_f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                yield block
        except BaseException:
            if spill_f is not None:
                spill_f.close()
                os.unlink(spill_path)
            raise
        if spill_f is not None:
            spill_f.close()
        with self._lock:
            if not self._complete:
                self._mem, self._spill_path = mem, spill_path
                self._spill_offsets = offsets
                self._complete = True
                if spill_path is not None:
                    self._finalizer = weakref.finalize(
                        self, _unlink_quiet, spill_path)
            elif spill_path is not None:  # raced: keep the first pass
                os.unlink(spill_path)

    def _skip_fast(self, skip_blocks):
        """O(1) skip once the cache is complete: index into the memory
        list, seek the spill file to the recorded per-block offset."""
        with self._lock:
            if not self._complete:
                return None
            replay_mem = list(self._mem)
            spill = self._spill_path
            offsets = list(self._spill_offsets)

        def _replay():
            if skip_blocks < len(replay_mem):
                yield from replay_mem[skip_blocks:]
                spill_at = 0
            else:
                spill_at = skip_blocks - len(replay_mem)
            if spill is None or spill_at >= len(offsets):
                return
            with open(spill, "rb") as f:
                f.seek(offsets[spill_at])
                while True:
                    try:
                        yield pickle.load(f)
                    except EOFError:
                        return

        return _replay()

    def purge(self):
        """Drop cached state (memory + spill file)."""
        with self._lock:
            self._complete = False
            self._mem = []
            if self._finalizer is not None:
                self._finalizer()
                self._finalizer = None
            self._spill_path = None
            self._spill_offsets = []


def _unlink_quiet(path):
    try:
        os.unlink(path)
    except OSError:
        pass


class _Prefetch(Pipeline):
    stage_name = "prefetch"
    _total_is_wait = True  # its work runs on the background thread

    def __init__(self, parent, depth):
        super().__init__(parent)
        self.depth = depth

    def _blocks(self):
        _END = object()
        q = _queue.Queue(maxsize=self.depth)
        cancelled = threading.Event()

        def worker():
            try:
                for block in self.parent._iter():
                    while not cancelled.is_set():
                        try:
                            q.put(block, timeout=0.2)
                            break
                        except _queue.Full:
                            continue
                    if cancelled.is_set():
                        return
            except Exception as e:  # noqa: BLE001 - forwarded to consumer
                q.put(("__data_prefetch_error__", e))
            finally:
                try:
                    q.put(_END, timeout=1)
                except _queue.Full:
                    pass

        t = threading.Thread(target=worker, daemon=True,
                             name="tfos-data-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__data_prefetch_error__":
                    raise item[1]
                yield item
        finally:
            cancelled.set()
            while True:  # unblock a worker stuck on the full queue
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=2)


class _Repeat(Pipeline):
    stage_name = "repeat"

    def __init__(self, parent, count):
        super().__init__(parent)
        self.count = count

    def _blocks(self):
        epoch = 0
        while self.count is None or epoch < self.count:
            yield from self.parent._iter()
            epoch += 1

    def _sig(self):
        return f"repeat:{self.count}"


class _Shard(Pipeline):
    stage_name = "shard"

    def __init__(self, parent, index, count):
        super().__init__(parent)
        self.index = index
        self.count = count

    def _blocks(self):
        import numpy as np

        cursor = 0  # global record index of the next upstream record
        for block in self.parent._iter():
            n = block_len(block)
            first = (self.index - cursor) % self.count
            cursor += n
            if first >= n:
                continue
            idx = np.arange(first, n, self.count)
            yield _take_rows(block, idx)

    def _sig(self):
        return f"shard:{self.index}:{self.count}"


# --------------------------------------------------------------------------
# sources


class _TFRecordSource(Pipeline):
    """TFRecord dir/file/shard-list -> columnar blocks, one shard resident
    at a time (``dfutil.iter_tfrecords_columnar``; reference
    ``dfutil.py:44-81`` / the tensorflow-hadoop input format)."""

    stage_name = "tfrecords"

    def __init__(self, source, block_size):
        super().__init__(None)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        from tensorflowonspark_tpu_torch import dfutil

        self.files = (list(source) if isinstance(source, (list, tuple))
                      else dfutil.part_files(source))
        self.block_size = int(block_size)

    def _blocks(self):
        from tensorflowonspark_tpu_torch import dfutil

        yield from dfutil.iter_tfrecords_columnar(
            self.files, self.block_size, drop_remainder=False)

    def _substreams(self):
        from tensorflowonspark_tpu_torch import dfutil

        def one(f):
            return lambda: dfutil.iter_tfrecords_columnar(
                [f], self.block_size, drop_remainder=False)

        return [one(f) for f in self.files]

    def _sig(self):
        return f"tfrecords:{self.block_size}:" + ",".join(self.files)


class _ArraySource(Pipeline):
    stage_name = "arrays"

    def __init__(self, columns, block_size):
        super().__init__(None)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if not columns:
            raise ValueError("from_arrays needs at least one column")
        lens = {name: len(col) for name, col in columns.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column length mismatch: {lens}")
        self.columns = dict(columns)
        self.block_size = int(block_size)

    def _blocks(self):
        n = len(next(iter(self.columns.values())))
        for lo in range(0, n, self.block_size):
            yield _slice_block(self.columns, lo, lo + self.block_size)

    def _skip_fast(self, skip_blocks):
        n = len(next(iter(self.columns.values())))
        start = skip_blocks * self.block_size
        return (_slice_block(self.columns, lo, lo + self.block_size)
                for lo in range(start, n, self.block_size))

    def _sig(self):
        import numpy as np

        parts = [f"arrays:{self.block_size}"]
        for name in sorted(self.columns):
            col = self.columns[name]
            if isinstance(col, np.ndarray):
                head = np.ascontiguousarray(col[:64]).tobytes()
                fp = hashlib.sha1(head).hexdigest()[:8]
                parts.append(
                    f"{name}:{col.dtype.str}:{col.shape}:{fp}")
            else:
                parts.append(f"{name}:list:{len(col)}:{id(col)}")
        return ";".join(parts)


class _RowSource(Pipeline):
    stage_name = "rows"

    def __init__(self, rows, block_size):
        super().__init__(None)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.rows = rows
        self.block_size = int(block_size)

    def _blocks(self):
        buf = []
        for row in self.rows:
            buf.append(row)
            if len(buf) >= self.block_size:
                yield _rows_to_block(buf)
                buf = []
        if buf:
            yield _rows_to_block(buf)

    def _sig(self):
        return f"rows:{self.block_size}:{id(self.rows)}"


def from_tfrecords(source, block_size=1024):
    """Pipeline over a TFRecord dir, single file, or explicit shard list
    (``part-*`` convention, ``dfutil.part_files``).  Blocks are dense
    column dicts of up to ``block_size`` records; ``interleave`` on this
    source round-robins across the shard files."""
    return _TFRecordSource(source, block_size)


def from_arrays(columns, block_size=1024):
    """Pipeline over in-memory columns ``{name: ndarray | list}`` (equal
    lengths).  Blocks are zero-copy views of the arrays."""
    return _ArraySource(columns, block_size)


def from_dataset(dataset, block_size=1024):
    """Pipeline over an engine dataset or any iterable of row dicts
    (``dfutil.load_tfrecords`` output shape).  Engine datasets
    (LocalDataset / RDD-likes exposing ``collect``) are collected on the
    driver — use :func:`from_tfrecords` for larger-than-RAM inputs."""
    rows = dataset.collect() if hasattr(dataset, "collect") else dataset
    return _RowSource(rows, block_size)
