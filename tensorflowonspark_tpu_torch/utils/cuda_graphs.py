"""CUDA graphs keyed by signature: one capture per batcher bucket.

The port's counterpart of the JAX package's per-signature executables
(``jax.jit(fn).lower(...).compile()`` in its ``serving/replicas.py``,
the jitted steps of its ``serving/decode/scheduler.py``).  A
:class:`GraphCache` keys a ``torch.cuda.CUDAGraph`` by signature and
keeps, for each :class:`Graph`, its static input and output tensors,
the kernel launches its capture recorded and its capture time.

A signature is captured at its first sight, as JAX compiles there: a
few warm-up calls on a side stream (they run on the device and count as
launches), then ``CUDAGraph.capture_begin``/``capture_end`` on that
stream into the cache's one memory pool, in
``capture_error_mode="thread_local"`` (several engines of one process
step on threads of their own), one capture at a time in a process and
with Python's cyclic collector paused (a collected graph's destruction
would be an operation the capture forbids).  Unlike
``torch.cuda.graph`` it neither synchronises the device nor empties the
allocator's cache first: the side stream waits for the caller's stream
instead.  A replay copies the new inputs into the static inputs and
replays.  A capture that fails raises: the caller decides whether to
step eagerly instead, so there is no eager path hidden here.

What a graph reads besides its inputs (parameters, KV caches) is baked
in: the graph reads those tensors' storage at every replay.  A caller
that replaces such a tensor copies into it in place, or clears the
cache.  Graphs of one cache share its pool, so a graph's static outputs
are valid until the next replay of any graph of the cache: a caller
that keeps an output across another replay clones it.

Launch accounting: a kernel wrapper asks :func:`launch_counted` where
it launches.  During this thread's capture no kernel runs, so the
launch is recorded in the graph instead of counted; each replay adds
the graph's recorded launches to the kernels' counts
(``ops.add_launch_counts``).  So ``ops.launch_counts()`` counts what ran
on the device, captures excluded and replays included.

Module import is stdlib only; torch loads where a graph is captured.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time

__all__ = ["Graph", "GraphCache", "PredictParts", "cuda_capture",
           "is_cuda", "launch_counted", "own", "recording_launches",
           "refill"]

WARMUP = 2   # eager calls on a side stream before a capture

_local = threading.local()
_capture_lock = threading.Lock()   # one capture at a time in a process

#: A predict's parts, as a graph can hold them: ``params(params,
#: device)`` puts the params on the device (once a version), ``inputs(
#: inputs)`` turns the request's numpy columns into host tensors,
#: ``core(device_params, *device_inputs)`` is the device part a graph
#: captures, ``outputs(core_outputs)`` brings them back as the predict's
#: own result.  A predict function carries them as ``predict.parts``.
PredictParts = collections.namedtuple("PredictParts",
                                      "params inputs core outputs")


def is_cuda(device):
    """Whether ``device`` (a ``torch.device``, a string or None) names a
    CUDA device."""
    return str(getattr(device, "type", device) or "").startswith("cuda")


def _leaves(tree):
    from torch.utils import _pytree

    return _pytree.tree_flatten(tree)


def own(tree, source):
    """``tree`` with every tensor leaf that shares storage with a leaf
    of ``source`` cloned: the tensors a graph reads, owned by its caller,
    so that refilling them in place never writes into ``source``."""
    import torch
    from torch.utils import _pytree

    theirs = {t.untyped_storage().data_ptr()
              for t in _leaves(source)[0] if torch.is_tensor(t)}
    return _pytree.tree_map(
        lambda t: (t.clone() if torch.is_tensor(t)
                   and t.untyped_storage().data_ptr() in theirs else t),
        tree)


def refill(dst, src):
    """Copy tree ``src`` into tree ``dst`` in place, where both have the
    same structure and every pair of leaves the same shape, dtype and
    device; True when copied, False (nothing written) otherwise."""
    import torch

    d, dspec = _leaves(dst)
    s, sspec = _leaves(src)
    if dspec != sspec or any(
            not (torch.is_tensor(a) and torch.is_tensor(b))
            or a.shape != b.shape or a.dtype != b.dtype
            or a.device != b.device for a, b in zip(d, s)):
        return False
    for a, b in zip(d, s):
        a.copy_(b)
    return True


def launch_counted(name):
    """Called by a kernel wrapper where it launches kernel ``name``:
    True when the launch counts now; False when this thread is capturing
    a graph, which then records the launch (it runs at each replay)."""
    rec = getattr(_local, "launches", None)
    if rec is None:
        return True
    rec[name] = rec.get(name, 0) + 1
    return False


@contextlib.contextmanager
def recording_launches():
    """Record this thread's kernel launches in the yielded dict
    (``{kernel name: launches}``) instead of counting them."""
    prev = getattr(_local, "launches", None)
    rec = {}
    _local.launches = rec
    try:
        yield rec
    finally:
        _local.launches = prev


def cuda_capture(fn, inputs, pool, warmup=WARMUP):
    """Capture ``fn(*inputs)`` into a ``torch.cuda.CUDAGraph`` in memory
    pool ``pool``: ``warmup`` eager calls on a side stream first (cuBLAS
    handles, kernel libraries and the allocator's blocks are set up
    there, outside the capture).  Returns ``(graph, outputs, launches)``:
    ``outputs`` are ``fn``'s outputs as captured (the graph writes them
    at each replay), ``launches`` the kernel launches the capture
    recorded."""
    import torch

    dev = inputs[0].device
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    # no collection during the capture: a collected graph of another
    # cache would be destroyed in this thread, which a capture forbids
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(*inputs)
            with recording_launches() as launches:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(*inputs)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
    finally:
        if gc_on:
            gc.enable()
    current.wait_stream(side)
    return graph, outputs, launches


def _add_launches(counts):
    if counts:
        from tensorflowonspark_tpu_torch import ops

        ops.add_launch_counts(counts)


class Graph:
    """One captured signature: ``graph`` (anything with ``replay()``),
    the static ``inputs`` and ``outputs``, the kernel ``launches`` the
    capture recorded, its ``capture_ms`` and its ``replays``."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "capture_ms",
                 "replays")

    def __init__(self, graph, inputs, outputs, launches, capture_ms):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = dict(launches)
        self.capture_ms = capture_ms
        self.replays = 0

    def __call__(self, *args):
        """Copy ``args`` (tensors of the static inputs' shapes, on any
        device) into the static inputs, replay, count the recorded
        launches; returns the static outputs."""
        if len(args) != len(self.inputs):
            raise ValueError(f"graph takes {len(self.inputs)} inputs, got "
                             f"{len(args)}")
        for dst, src in zip(self.inputs, args):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"input of shape {tuple(src.shape)} for a "
                                 f"graph captured at {tuple(dst.shape)}")
            dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        _add_launches(self.launches)
        return self.outputs


class GraphCache:
    """Graphs by signature, in one memory pool (one cache per engine or
    predictor).  ``device``: where the static inputs live.  ``capture``:
    ``capture(fn, inputs, pool) -> (graph, outputs, launches)``, by
    default :func:`cuda_capture`; the CPU tests inject a plain call, so
    that the signature logic, not the graph, is what they test."""

    def __init__(self, device, capture=None):
        self.device = device
        self._capture = capture or cuda_capture
        self._graphs = {}
        self._pool = None
        self.capture_ms = 0.0        # all captures of this cache, summed
        self.captures = 0            # captures made (clears do not undo)

    def __len__(self):
        return len(self._graphs)

    def __contains__(self, key):
        return key in self._graphs

    def get(self, key):
        return self._graphs.get(key)

    def keys(self):
        return list(self._graphs)

    def capture(self, key, fn, inputs):
        """Capture ``fn`` over static copies of ``inputs`` on the cache's
        device, keyed ``key``; returns the :class:`Graph`.  Its outputs
        hold nothing until the first replay.  Raises where the capture
        fails (nothing is kept)."""
        import torch

        static = tuple(t.to(self.device, copy=True) for t in inputs)
        with _capture_lock:
            t0 = time.perf_counter()
            if self._pool is None and \
                    torch.device(self.device).type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            graph, outputs, launches = self._capture(fn, static, self._pool)
            ms = (time.perf_counter() - t0) * 1e3
        g = Graph(graph, static, outputs, launches, ms)
        self._graphs[key] = g
        self.capture_ms += ms
        self.captures += 1
        return g

    def clear(self):
        """Drop every graph (and with the last one, the pool's memory)."""
        self._graphs.clear()
        self._pool = None
