"""Step-time / throughput / MFU / infeed-stall counters.

Counterpart of ``tensorflowonspark_tpu/utils/metrics.py``: one
lightweight ``TrainMetrics`` aggregator per worker (time steps with
``step()``, account feed waits with ``infeed_wait()``, mark the step's
phases with ``mark()``, read a summary with ``report()``), the
transformer's FLOPs-per-token estimate, the
segmentation and MNIST forward FLOPs counted shape-exactly by
``utils.flops`` (the model run on meta tensors), and a ``peak_flops``
for the card.

MFU convention: model FLOPs per step / (step time x peak FLOPs).
"""

from __future__ import annotations

import collections
import functools
import logging
import os
import time

from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics_registry,
    telemetry,
)

logger = logging.getLogger(__name__)

PHASES_KEPT = 1024  # steps whose phases ``TrainMetrics.report()`` keeps

# dense bf16 peak FLOP/s per card by device-name substring (NVIDIA data
# sheets, SXM parts, at the full power limit)
PEAK_FLOPS = {
    "H100": 989e12,
}


def peak_flops(device=None):
    """The card's dense bf16 peak: ``TFOS_PEAK_FLOPS`` if set, else the
    table entry whose key is in the device's name; None for a CPU or an
    unknown card (MFU not reported).  ``device``: anything
    ``torch.device`` takes; default the current CUDA device."""
    env = os.environ.get("TFOS_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for k, v in PEAK_FLOPS.items():
        if k in name:
            return v
    return None


def transformer_flops_per_token(cfg, causal=False):
    """~6N FLOPs/token (fwd+bwd) + attention term, from the config.

    Default is the PaLM appendix-B convention: the attention matmuls are
    counted dense (12·L·d·S per token) even for causal models.
    ``causal=True`` halves the attention term to count only the work a
    causal kernel must do."""
    n_params = (
        cfg.vocab_size * cfg.dim * 2
        + cfg.n_layers * (cfg.dim * cfg.dim * 4
                          + cfg.dim * cfg.dim * cfg.mlp_ratio * 2)
    )
    attn = 12 * cfg.n_layers * cfg.dim * cfg.max_seq  # 2*2*3 * L * d * S
    if causal:
        attn //= 2
    return 6 * n_params + attn


def segmentation_flops_per_image(image_size=256, num_classes=21, width=1.0):
    """Forward-pass FLOPs per image of ``models/segmentation.py`` in
    training mode, counted shape-exactly (``utils.flops``: 2 FLOPs a MAC,
    transposed-conv zero positions excluded).  Multiply by 3 for the
    train step.  Runs on meta tensors: no device compute."""
    return _seg_flops_cached(int(image_size), int(num_classes), float(width))


@functools.lru_cache(maxsize=8)
def _seg_flops_cached(image_size, num_classes, width):
    import torch

    from tensorflowonspark_tpu_torch.models import segmentation
    from tensorflowonspark_tpu_torch.utils import flops as F

    ps, ss = segmentation.init(torch.Generator().manual_seed(0),
                               num_classes=num_classes, width=width)
    img = torch.empty((1, image_size, image_size, 3), device="meta")
    return F.count_flops(
        lambda p, s, x: segmentation.apply(p, s, x, train=True)[0],
        ps, ss, img)["flops"]


@functools.lru_cache(maxsize=1)
def mnist_inference_flops_per_row():
    """Forward-pass FLOPs per row of the MNIST export model that
    BASELINE config #5 (batch inference) serves, ``mnist.apply``, counted
    like :func:`segmentation_flops_per_image`."""
    import torch

    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import flops as F

    params = mnist.init_params(torch.Generator().manual_seed(0))
    x = torch.empty((1, 28, 28, 1), device="meta")
    return F.count_flops(mnist.apply, params, x)["flops"]


def unmarked(phase):
    """``TrainMetrics.mark``'s stand-in where a step is given none."""


class TrainMetrics:
    """Windowed counters; cheap enough for the hot loop.

    Also the feed point of the training-health watchtower
    (``obs.health``): by default ``obs.health.monitor_from_env()`` rides
    along (none under ``TFOS_HEALTH=0``); ``health=False`` opts one
    instance out, and a monitor of the caller's own can carry a
    ``checkpoint_fn`` for the ``TFOS_HEALTH_ACTION`` reactions.  Every
    ``step()`` hands it the step's time, the stall fraction and the loss
    and gradient probe the caller passes; a ``halt`` reaction raises
    ``obs.health.HealthHalt`` out of ``step()``.

    Phases: while telemetry records in this process (decided when the
    instance is made, so that with telemetry off a ``mark()`` is one
    attribute check and makes nothing), the loop's ``infeed_wait()`` and
    the step's ``mark()``s split each step into ``train/input_wait``,
    ``train/forward``, ``train/backward`` and ``train/optimizer`` spans
    (or whatever phases the step marks), children of its ``train/step``
    by ``parent_id``.  On a CUDA ``device`` each mark after the step's
    first records a ``torch.cuda.Event``; with the step's own start and
    end events handed to ``step(events=)`` after the caller's
    synchronisation, the phases' device milliseconds partition the
    step's exactly.  ``report()["phases"]`` keeps the last
    ``PHASES_KEPT`` steps'."""

    def __init__(self, flops_per_item=None, device=None, window=50,
                 health=None):
        self.flops_per_item = flops_per_item
        self.window = window
        self._peak = peak_flops(device) if flops_per_item else None
        if health is None:
            from tensorflowonspark_tpu_torch.obs import health as _health

            self.health = _health.monitor_from_env()
        else:
            self.health = health or None  # health=False opts out
        self._phases = (collections.deque(maxlen=PHASES_KEPT)
                        if telemetry.enabled() else None)
        self._cuda = False
        if self._phases is not None and device is not None:
            import torch

            self._cuda = torch.device(device).type == "cuda"
        self.reset()

    def reset(self):
        self.steps = 0
        self.items = 0
        self.step_time = 0.0
        self.infeed_time = 0.0
        self._last = None
        if self._phases is not None:
            self._phases.clear()
            self._marks = []  # this step's (phase, wall, t0, event)
            self._wait = None  # this step's input wait: (wall, seconds)

    # -- recording ----------------------------------------------------------

    def infeed_wait(self, seconds):
        """The loop's wait for the step's batch; also the step's
        ``train/input_wait`` phase while phases are kept."""
        self.infeed_time += seconds
        if self._phases is not None:
            self._wait = (time.time() - seconds, seconds)

    def mark(self, phase):
        """Open the step's phase ``phase``, closing the one open: the
        step's first mark opens its first phase, and ``step()`` closes
        its last.  Nothing while phases are not kept."""
        if self._phases is None:
            return
        event = None
        if self._cuda and self._marks:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self._marks.append((phase, time.time(), time.perf_counter(), event))

    def step(self, items=0, loss=None, grad_norm=None, grad_finite=None,
             events=None):
        """Call once per completed train step with the item count.

        The first call only arms the timer; its items are NOT counted, so
        rates divide N timed steps' items by N timed steps' time.  The
        caller makes the step complete first (for a CUDA step: read the
        loss, or synchronise).  ``loss``, ``grad_norm`` and
        ``grad_finite`` go to the health monitor.  ``events``: the
        step's ``(start, end)`` CUDA events, both complete, which bound
        its first and last phase on the device."""
        # injection point ``train.step``: delay/exc before the clock read,
        # so an injected delay lands in this step's measured duration
        faults.check("train.step")
        if loss is not None:
            loss = faults.poison("train.step", loss)
        now = time.perf_counter()
        dur = ids = None
        if self._last is not None:
            dur = now - self._last
            self.step_time += dur
            self.items += items
            if telemetry.enabled():
                attrs = {"items": items}
                if self.flops_per_item:
                    attrs["flops_per_item"] = self.flops_per_item
                if self._peak:
                    attrs["peak_flops"] = self._peak
                if self._phases is not None:
                    ids = telemetry.span_ids()
                    attrs.update(ids)
                telemetry.record_span("train/step", dur, **attrs)
            if metrics_registry.enabled():
                metrics_registry.inc("tfos_train_steps_total")
                metrics_registry.observe("tfos_train_step_ms", dur * 1000.0)
                if self.step_time:
                    metrics_registry.set_gauge(
                        "tfos_train_items_per_sec",
                        self.items / self.step_time)
                    metrics_registry.set_gauge(
                        "tfos_train_infeed_stall_frac",
                        min(self.infeed_time / self.step_time, 1.0))
                    if self.flops_per_item and self._peak:
                        metrics_registry.set_gauge(
                            "tfos_train_mfu",
                            self.items * self.flops_per_item
                            / self.step_time / self._peak)
        if self._phases is not None:
            self._close_phases(now, ids, events)
        self._last = now
        self.steps += 1
        if self.health is not None:
            self.health.observe_step(
                loss=None if loss is None else float(loss),
                step_time_s=dur,
                infeed_frac=(min(self.infeed_time / self.step_time, 1.0)
                             if self.step_time else None),
                grad_norm=(None if grad_norm is None else float(grad_norm)),
                grad_finite=(None if grad_finite is None
                             else bool(grad_finite)),
                step=self.steps)

    def _close_phases(self, now, ids, events):
        """The step's phases: its ``report()`` entry and, under its
        ``train/step`` span's ``ids`` (none for the first step, which
        only arms the timer), its spans."""
        marks, wait = self._marks, self._wait
        self._marks, self._wait = [], None
        entry = {"step": self.steps}
        if wait is not None:
            entry["input_wait"] = [wait[0], 1e3 * wait[1]]
        ends = [t0 for _, _, t0, _ in marks[1:]] + [now]
        if events is not None and self._cuda:
            bounds = [events[0]] + [ev for *_, ev in marks[1:]] + \
                [events[1]]
            for (phase, *_), a, b in zip(marks, bounds, bounds[1:]):
                entry[phase] = a.elapsed_time(b)
        else:  # no device clock: the host's
            for (phase, _, t0, _), t1 in zip(marks, ends):
                entry[phase] = 1e3 * (t1 - t0)
        self._phases.append(entry)
        if ids is None:
            return
        child = {"trace_id": ids["trace_id"], "parent_id": ids["span_id"]}
        if wait is not None:
            telemetry.record_span_at("train/input_wait", wait[0], wait[1],
                                     **child)
        for (phase, wall, t0, _), t1 in zip(marks, ends):
            telemetry.record_span_at(f"train/{phase}", wall, t1 - t0,
                                     **child)

    # -- reading ------------------------------------------------------------

    def report(self):
        """Summary dict over the window since reset(); rates need >=2
        step() calls (the first call only arms the timer)."""
        out = {
            "steps": self.steps,
            "items": self.items,
            "step_time_avg_s": self.step_time / max(self.steps - 1, 1),
            "infeed_wait_s": self.infeed_time,
            "infeed_stall_frac": (
                self.infeed_time / self.step_time if self.step_time else 0.0
            ),
        }
        if self.step_time:
            out["items_per_sec"] = self.items / self.step_time
            if self.flops_per_item and self._peak:
                out["mfu"] = (
                    self.items * self.flops_per_item
                    / self.step_time / self._peak
                )
        if self._phases is not None:
            # each step's input wait as [start wall, ms] and each phase's
            # ms (the device's on a CUDA step)
            out["phases"] = list(self._phases)
        return out

    def maybe_log(self, prefix=""):
        if self.steps and self.steps % self.window == 0:
            logger.info("%smetrics: %s", prefix, self.report())
