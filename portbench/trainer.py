"""What the benchmark runs in the program's trainer process.

``main(args, ctx)`` is handed to ``cluster.run`` in place of the
program's ``main_fun`` and calls that ``main_fun`` unchanged.  Around it,
torch's global optimizer hooks observe each step as the optimizer takes
it, and nothing else of the program is touched:

- each step's end on the host clock: the hook synchronises the card
  after the optimizer's launches (the program's loop reads the loss
  right after, so no overlap is lost);
- the first gradient as the optimizer got it, from its state after one
  step (Adam's first moment over ``1 - beta1``, SGD's momentum buffer);
- each leaf's change after three updates, against the initial weights
  that the plain reference draws again from the seed;
- with ``fingerprint``, a fingerprint of every record the program's
  ``DataFeed`` hands out, in order;
- at the window's end, the program's own early stop,
  ``DataFeed.terminate()``, on the feed ``main_fun`` asked for;
- with tracing on, ``torch.profiler`` over a stretch of the window.

The readings go to ``<run_dir>/trainer.json``; the driver reads them.
"""

from __future__ import annotations

import importlib
import json
import os
import time

WINDOW_CLOSED = "window_closed"


def resolve(path):
    """``"module:attr"`` -> the attribute."""
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


class _Ctx:
    """The node's context, with ``get_data_feed`` noting the feed."""

    def __init__(self, ctx, rec):
        self._ctx = ctx
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._ctx, name)

    def get_data_feed(self, *args, **kwargs):
        feed = self._ctx.get_data_feed(*args, **kwargs)
        self._rec.feed = feed
        if self._rec.h.get("fingerprint"):
            taken = self._rec.taken
            rows, cols = feed.next_batch, feed.next_batch_columns

            def next_batch(batch_size):
                records = rows(batch_size)
                taken.extend(fingerprint_rows(records))
                return records

            def next_batch_columns(batch_size):
                columns = cols(batch_size)
                taken.extend(fingerprint_columns(columns))
                return columns

            feed.next_batch = next_batch
            feed.next_batch_columns = next_batch_columns
        return feed


SAMPLES = 16  # values sampled from each long field of a record


def _values(v):
    import numpy as np

    if isinstance(v, (bytes, bytearray, memoryview)):
        a = np.frombuffer(v, np.uint8)
    else:
        a = np.asarray(v).reshape(-1)
    if a.size > SAMPLES:
        a = a[np.linspace(0, a.size - 1, SAMPLES).astype(np.int64)]
    return [int(x) for x in a]


def fingerprint_rows(records):
    """Each record's first values (a token record's first ids)."""
    return [_values(r)[:4] for r in records]


def fingerprint_columns(columns):
    """Each record of a column batch: its fields in name order, a long
    field by ``SAMPLES`` values spread over it."""
    keys = sorted(columns)
    n = len(columns[keys[0]])
    return [[x for k in keys for x in _values(columns[k][i])]
            for i in range(n)]


class _Recorder:
    def __init__(self, h):
        self.h = h
        self.feed = None
        self.taken = []     # each record's fingerprint, as handed out
        self.ends = []
        self.grad_norms = None
        self.change_norms = None
        self.shapes = None
        self.window_start = None
        self.closed = False
        self.prof = None
        self.traced = None      # the stopped capture, reduced after the run
        self.trace_stop = None
        self.trace_steps = None
        self.cuda = None

    def _sync(self, opt):
        import torch

        if self.cuda is None:
            p = opt.param_groups[0]["params"][0]
            self.cuda = p.device.type == "cuda"
        if self.cuda:
            torch.cuda.synchronize()

    def post(self, opt, args, kwargs):
        self._sync(opt)
        t = time.time()
        self.ends.append(t)
        k = len(self.ends)
        if k == 1:
            self.grad_norms = _state_grad_norms(opt)
        if k == 3:
            self.change_norms, self.shapes = _change_norms(opt, self.h)
        warm = self.h["warm"]
        if k == warm:
            self.window_start = t
            if self.h["trace"]:
                self._start_trace()
        if self.prof is not None and k >= warm + self.trace_steps:
            self._stop_trace()
        if (k > warm and not self.closed
                and t - self.window_start >= self.h["seconds"]):
            self.closed = True
            with open(os.path.join(self.h["run_dir"], WINDOW_CLOSED), "w"):
                pass
            if self.prof is not None:
                self._stop_trace()
            if self.feed is not None:
                self.feed.terminate()

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        # the stretch: about trace_seconds of steps at the warm steps' pace
        step_s = max(self.ends[-1] - self.ends[-2], 1e-3)
        self.trace_steps = max(2, int(self.h["trace_seconds"] / step_s + 1))
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def _stop_trace(self):
        self.prof.stop()
        self.trace_stop = time.time()
        self.traced, self.prof = self.prof, None

    def write(self):
        import torch

        from portbench import trace

        out = {"ends": self.ends, "window_start": self.window_start,
               "trace_stop": self.trace_stop,
               "closed": self.closed, "grad_norms": self.grad_norms,
               "change_norms": self.change_norms, "shapes": self.shapes,
               "trace": (trace.compact(self.traced)
                         if self.traced is not None else None),
               "taken": self.taken,
               "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                     if self.cuda else None)}
        path = os.path.join(self.h["run_dir"], "trainer.json")
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)


def _leaves(opt):
    return [p for g in opt.param_groups for p in g["params"]]


def _norm(t):
    import torch

    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def _state_grad_norms(opt):
    """Each leaf's gradient norm as the optimizer took it at step 1."""
    kind = type(opt).__name__
    out = []
    for g in opt.param_groups:
        for p in g["params"]:
            st = opt.state[p]
            if kind == "Adam":
                out.append(_norm(st["exp_avg"]) / (1.0 - g["betas"][0]))
            elif kind == "SGD":
                out.append(_norm(st["momentum_buffer"]))
            else:
                raise TypeError(f"no gradient reading for {kind}")
    return out


def _change_norms(opt, h):
    """Each leaf's ``||p - p0||`` with ``p0`` drawn again, leaf by leaf,
    by the plain reference's copy of the initialiser."""
    import torch

    from portbench import reference

    ref = reference.load(h["reference"])
    leaves = _leaves(opt)
    order = ref.optimizer_order(h["config"])
    if len(order) != len(leaves):
        raise ValueError(f"the optimizer holds {len(leaves)} leaves, the "
                         f"reference {len(order)}")
    index = {name: i for i, name in enumerate(order)}
    norms = [None] * len(leaves)
    dev = leaves[0].device
    for name, p0 in ref.init_leaves(h["config"], h["seed"], dev):
        p = leaves[index[name]]
        if tuple(p.shape) != tuple(p0.shape):
            raise ValueError(f"leaf {name}: program {tuple(p.shape)}, "
                             f"reference {tuple(p0.shape)}")
        with torch.no_grad():
            norms[index[name]] = _norm(p.detach().float() - p0)
        del p0
    return norms, [list(p.shape) for p in leaves]


def main(args, ctx):
    """The program's ``main_fun`` (``args["portbench"]["main_fun"]``),
    observed as the module docstring says."""
    from torch.optim import optimizer as optim

    h = args["portbench"]
    rec = _Recorder(h)
    post = optim.register_optimizer_step_post_hook(rec.post)
    try:
        resolve(h["main_fun"])(args, _Ctx(ctx, rec))
    finally:
        post.remove()
        if rec.prof is not None:
            rec._stop_trace()
        rec.write()
