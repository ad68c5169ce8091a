"""The general driver of SPARK-fed training cells.

The program's entry as a user drives it: ``cluster.run(LocalEngine,
main_fun, input_mode=SPARK, num_gpus=1, num_executors=1)``, then
``cluster.train`` over one epoch of the mix's records at a time, until
the trainer has closed the window (``portbench.trainer`` calls the
program's ``DataFeed.terminate()`` there), then ``shutdown``.

Two record sources, named by the mix's ``records``:

- ``tokens``: ``pool`` sequences of ``sequence_length`` token ids drawn
  uniformly from the vocabulary by the seed, made in the driver
  (``engine.parallelize``) in partitions of ``partition_records``;
- ``tfrecord_images``: ``images`` seeded uint8 images (and labels over
  the configuration's classes) written in set-up as ``shards`` raw
  TFRecord shards in the run's directory, which the executor reads and
  decodes itself (``dfutil.load_tfrecords(...).map_partitions(
  resnet_imagenet_spark.decode_stream(size))``).

The window opens at the end of the mix's ``warm_steps``-th step and
closes at the end of the first step at least ``--seconds`` later: its
rate is the items of every step in it over its length.  The first three
steps' readings are held against the configuration's plain reference,
run on the same rows once the program has shut down.  The feed is
checked too: every record the trainer's ``DataFeed`` handed out, in
order, is the one fed (``trainer.fingerprint_rows`` / ``_columns``).
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import time

import numpy as np

from portbench import check, flops, reference, trainer


def _rng(seed, stream):
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


# -- records ----------------------------------------------------------------

class Tokens:
    """Token sequences made in the driver."""

    def __init__(self, ctx):
        tr, cfg = ctx.traffic, ctx.config
        self.batch = tr["batch"]
        self.seq = tr["sequence_length"]
        self.pool = _rng(ctx.seed, 1).integers(
            0, cfg["vocab_size"], (tr["pool"], self.seq), dtype=np.int32)
        self.part = tr["partition_records"]
        self.items_per_step = self.batch * self.seq

    def dataset(self, engine):
        return engine.parallelize(list(self.pool),
                                  len(self.pool) // self.part)

    def write(self, run_dir):
        pass

    def batches(self, n, rows=None):
        """The first ``n`` steps' rows (the first ``rows`` of each)."""
        return [self.pool[i * self.batch:(i + 1) * self.batch][:rows]
                .astype(np.int64) for i in range(n)]

    def fingerprints(self):
        return trainer.fingerprint_rows(self.pool)


class TFRecordImages:
    """Raw uint8 image shards the executor reads."""

    def __init__(self, ctx):
        tr, cfg = ctx.traffic, ctx.config
        side = cfg["image_size"]
        rng = _rng(ctx.seed, 2)
        n = tr["images"]
        self.images = rng.integers(0, 256, (n, side, side, 3),
                                   dtype=np.uint8)
        self.labels = rng.integers(0, cfg["num_classes"], n, dtype=np.int64)
        # a raw record may not open with a JPEG or PNG signature: the
        # program reads such a payload as that format
        # (``imagenet_records._decode_payload``)
        head = self.images.reshape(n, -1)[:, :2]
        clash = (head[:, 0] == 0xFF) & (head[:, 1] == 0xD8) | \
            (head[:, 0] == 0x89) & (head[:, 1] == 0x50)
        self.images.reshape(n, -1)[clash, 0] = 0
        self.batch = tr["batch"]
        self.items_per_step = self.batch
        self.side = side
        self.shards = tr["shards"]

    def write(self, run_dir):
        from tensorflowonspark_tpu_torch import dfutil, recordio

        self.dir = os.path.join(run_dir, "shards")
        os.makedirs(self.dir)
        n = len(self.images)
        per = n // self.shards
        for s in range(self.shards):
            with recordio.TFRecordWriter(
                    os.path.join(self.dir, f"part-r-{s:05d}")) as w:
                for i in range(s * per, (s + 1) * per):
                    w.write(dfutil.to_example(
                        {"image": self.images[i].tobytes(),
                         "label": int(self.labels[i])}))

    def dataset(self, engine):
        from tensorflowonspark_tpu_torch import dfutil
        from tensorflowonspark_tpu_torch.examples import resnet_imagenet_spark

        ds, _ = dfutil.load_tfrecords(engine, self.dir,
                                      binary_features=("image",),
                                      min_partitions=self.shards)
        return ds.map_partitions(
            resnet_imagenet_spark.decode_stream(self.side))

    def batches(self, n, rows=None):
        """The first ``n`` steps' images and labels (the first ``rows``
        of each)."""
        b, r = self.batch, rows or self.batch
        return [(self.images[i * b:i * b + r], self.labels[i * b:i * b + r])
                for i in range(n)]

    def fingerprints(self):
        return trainer.fingerprint_columns({"image": self.images,
                                            "label": self.labels})


def feed_mismatch(want, taken):
    """Records the trainer took that are not the fed stream's, in order
    (the stream is the records repeated as epochs); none taken counts as
    every one missed."""
    if not taken:
        return float("inf")
    return float(sum(t != want[i % len(want)] for i, t in enumerate(taken)))


SOURCES = {"tokens": Tokens, "tfrecord_images": TFRecordImages}


# -- the program's arguments, by configuration family -----------------------

def _lm_args(cfg, tr, ctx):
    return {"config": {"vocab_size": cfg["vocab_size"],
                       "dim": cfg["hidden_size"],
                       "n_layers": cfg["num_hidden_layers"],
                       "n_heads": cfg["num_attention_heads"],
                       "max_seq": cfg["max_position_embeddings"],
                       "mlp_ratio": cfg["intermediate_size"]
                       // cfg["hidden_size"],
                       "rope_base": cfg["rotary_emb_base"],
                       "dtype": cfg["dtype"]},
            "batch_size": tr["batch"], "lr": tr["optimizer"]["lr"]}


def _resnet_args(cfg, tr, ctx):
    return {"batch_size": tr["batch"], "lr": tr["optimizer"]["lr"],
            "image_size": cfg["image_size"],
            "num_classes": cfg["num_classes"],
            "compute_dtype": cfg["dtype"],
            "model_dir": os.path.join(ctx.run_dir, "model"),
            "save_every": 10 ** 9}


PROGRAM_ARGS = {"lm": _lm_args, "resnet": _resnet_args}


def _step_flops(cfg, tr):
    if cfg["family"] == "lm":
        return flops.lm_train_step_flops(cfg, tr["batch"],
                                         tr["sequence_length"])
    return flops.resnet_train_step_flops(cfg, tr["batch"])


def window(ends, warm, seconds):
    """The window over the steps' ends (host clock, in step order): it
    opens at the end of step ``warm`` and closes at the end of the first
    step that ends ``seconds`` or more later.  Returns (the 0-based index
    of that last step, the steps in the window, its length)."""
    start = ends[warm - 1]
    last = next((k for k in range(warm, len(ends))
                 if ends[k] - start >= seconds), None)
    if last is None:
        raise RuntimeError(f"no step ended {seconds} s after step {warm}")
    return last, last + 1 - warm, ends[last] - start


def _spans(run_dir, name):
    """``name``'s spans as ``(start, end)`` on the host clock, once each
    (the drain copies a node's spool beside it)."""
    out = set()
    for path in glob.glob(os.path.join(run_dir, "telemetry", "**",
                                       "*.jsonl"), recursive=True):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("name") == name and rec.get("dur_ms") is not None:
                    out.add((rec["ts"], rec["ts"] + rec["dur_ms"] / 1e3))
    return sorted(out)


def run(ctx):
    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    tr, cfg = ctx.traffic, ctx.config
    cuda = ctx.device == "cuda"
    source = SOURCES[tr["records"]](ctx)
    source.write(ctx.run_dir)
    warm = tr["warm_steps"]
    env = {}
    if ctx.trace:
        from tensorflowonspark_tpu_torch.utils import telemetry

        env[telemetry.DIR_ENV] = os.path.join(ctx.run_dir, "telemetry")
        os.environ.update(env)
    args = PROGRAM_ARGS[cfg["family"]](cfg, tr, ctx)
    args.update(seed=ctx.seed, out_dir=ctx.run_dir,
                device=None if cuda else "cpu")
    args["portbench"] = {
        "main_fun": cfg["train_main_fun"], "warm": warm,
        "seconds": ctx.seconds, "trace": ctx.trace,
        "trace_seconds": tr["trace_seconds"], "run_dir": ctx.run_dir,
        "reference": cfg["reference"], "config": cfg, "seed": ctx.seed,
        "fingerprint": True}
    closed = os.path.join(ctx.run_dir, trainer.WINDOW_CLOSED)
    engine = LocalEngine(1, env=env or None,
                         workdir=os.path.join(ctx.run_dir, "engine"))
    epochs = 0
    try:
        ds = source.dataset(engine)
        t_run = time.time()
        cluster = TFCluster.run(
            engine, trainer.main, args, num_executors=1,
            input_mode=TFCluster.InputMode.SPARK, num_gpus=1 if cuda else 0,
            reservation_timeout=300)
        while not os.path.exists(closed) and epochs < tr["max_epochs"]:
            cluster.train(ds, feed_timeout=600)
            epochs += 1
        cluster.shutdown()
    finally:
        engine.stop()
    with open(os.path.join(ctx.run_dir, "trainer.json")) as f:
        rec = json.load(f)
    with open(os.path.join(ctx.run_dir, cfg["train_report"])) as f:
        report = json.load(f)
    if not rec["closed"]:
        raise RuntimeError(f"the feed ({epochs} epochs) ended before the "
                           f"window closed: {len(rec['ends'])} steps")
    last, steps, window_s = window(rec["ends"], warm, ctx.seconds)
    step_ms = report["step_ms"][warm:last + 1]

    # the check: program readings, then the reference on the same rows
    prog = {"losses": report["losses"][:3], "grad_norms": rec["grad_norms"],
            "change_norms": rec["change_norms"]}
    ref_mod = reference.load(cfg["reference"])
    ref = ref_mod.train_readings(cfg, ctx.seed, source.batches(3),
                                 ctx.device, "float32", tr["optimizer"])
    weights = ref_mod.product_weights(cfg)
    numbers = check.train_numbers(prog, ref, weights)
    controls = None
    if ctx.controls:
        controls = {}
        for k, rows, precision in (("control_float8", None, "float8"),
                                   ("half_batch", source.batch // 2,
                                    "float32")):
            got = ref_mod.train_readings(cfg, ctx.seed,
                                         source.batches(3, rows),
                                         ctx.device, precision,
                                         tr["optimizer"])
            ctx.log(f"readings {k} {json.dumps(got)}")
            controls[k] = check.train_numbers(got, ref, weights)
        ctx.log(f"controls {json.dumps(controls)}")
    numbers["feed_mismatch"] = feed_mismatch(source.fingerprints(),
                                             rec["taken"])
    checks = check.held(numbers, ctx.cell["limits"])
    ctx.log(f"readings program {json.dumps(prog)} reference "
            f"{json.dumps(ref)}")
    ctx.log(f"numbers {json.dumps(numbers)}")
    kind = "cpu"
    if cuda:
        import torch

        torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(0)
    feed_wait = None
    if ctx.trace:
        # the per-layer readings take the window after the capture has
        # stopped, so that the profiler's cost is not in them
        ends = rec["ends"]
        first = next((k for k in range(warm, last)
                      if ends[k] >= (rec["trace_stop"] or 0)), warm - 1)
        steps, start = last - first, ends[first]
        window_s = ends[last] - start
        w0, w1 = start, start + window_s
        spans = _spans(ctx.run_dir, "feed/wait")
        feed_wait = sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in spans)
    return {
        "kind": "train", "cell": ctx.name, "config": cfg, "traffic": tr,
        "setup_s": rec["window_start"] - ctx.t0, "window_s": window_s,
        "train": {"item": "tokens" if cfg["family"] == "lm" else "images",
                  "steps": steps, "items": steps * source.items_per_step,
                  "flops": steps * _step_flops(cfg, tr),
                  "boot_s": report["first_step_wall"] - t_run,
                  "device_step_ms": statistics.median(step_ms),
                  "feed_wait_s": feed_wait},
        "trace": rec["trace"], "report": report,
        "attempted": steps, "failed": 0, "checks": checks,
        "controls": controls, "numbers": numbers,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": ctx.cell["chips"],
                   "memory_peak_bytes": rec["memory_peak_bytes"]}}
