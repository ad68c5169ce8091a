"""The transformer, InputMode.SPARK: token records stream into training.

The main path of the port: ``cluster.run`` -> rendezvous -> node ->
``gpu_info`` claim -> forked trainer -> ``torch_initialize`` ->
``DataFeed`` -> ``infeed.device_feed`` (``prefetch_to_device``) ->
``transformer.loss_fn`` (flash-attention kernels forward and backward)
-> ``backward`` -> gradient all-reduce -> Adam.  Each record is one
sequence of ``max_seq`` token ids.  ``chip_smoke.py`` drives it at full
width on the card; on the CPU (gloo, the plain attention)::

    python -m tensorflowonspark_tpu_torch.examples.transformer_spark \\
        --device cpu --dim 64 --n_layers 2 --n_heads 2 --max_seq 64 \\
        --vocab_size 256 --batch_size 4 --steps 3 \\
        --ckpt_dir /tmp/lm/ckpt --export_dir /tmp/lm/export

With ``--ckpt_dir`` the chief saves the params (the JAX layout, npz)
every ``--ckpt_every`` steps and at the end; with ``--export_dir`` it
exports them with the ``Config`` in the metadata (``config``), which
``serving.ModelSpec(export_dir=..., decode=DecodeSpec(Config(
**meta["config"])))`` and the JAX package's ``load_exported`` both
load.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def collate(records):
    """``[n, seq]`` int64 tokens from ``n`` token records."""
    return np.stack(records).astype(np.int64)


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``config`` (``transformer.Config``
    keywords), ``batch_size`` (global), optional ``lr`` (1e-3),
    ``device`` (default the card), ``init_params`` (a JAX-layout params
    tree; default random from ``seed``), ``ce_impl``, ``ckpt_dir`` and
    ``ckpt_every`` (the chief's checkpoints), ``export_dir`` (the
    chief's export) and ``out_dir``,
    where each rank writes ``transformer-rank<r>.json``: its losses,
    step times, the records its ``DataFeed`` handed out (counted, a
    dropped tail included) and what the feed saw (``DataFeed.stats``,
    the feeders' timings from the node's KV, the copies into pinned
    memory), its ``CUDA_VISIBLE_DEVICES``, kernel launches,
    ``TrainMetrics`` report, feed wait and the wall-clock times at which
    it began, joined the job, had its model and optimizer, and began its
    first step."""
    main_start_wall = time.time()
    import torch

    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils import metrics, train

    cfg = T.Config(**args["config"])
    env = ctx.torch_initialize(args.get("device"))
    joined_wall = time.time()
    dev = env["device"]
    if dev.type == "cuda":
        # float32 stays float32, bf16 products accumulate in float32:
        # the settings chip_smoke.py's in-process training runs under
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    if args.get("init_params") is not None:
        params = T.params_from_jax(args["init_params"], cfg, device=dev)
    else:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(
            args.get("seed", 0)), dev)
    leaves = [params["embed"], params["ln_f"], params["head"],
              *params["layers"].values()]
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=args.get("lr", 1e-3),
                           betas=(0.9, 0.999), eps=1e-8)
    model_wall = time.time()
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    tm = metrics.TrainMetrics(
        flops_per_item=metrics.transformer_flops_per_token(cfg, causal=True),
        device=dev)
    feed_tm = metrics.TrainMetrics()  # accumulates the DataFeed's waits
    feed = ctx.get_data_feed(train_mode=True, metrics=feed_tm)
    batches = iter(infeed.synchronized(infeed.device_feed(
        feed, per_proc, collate=collate, placement=dev), feed=feed))
    cuda = dev.type == "cuda"
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, first_step_wall = [], [], None
    while True:
        # the host's wait for the next staged batch: infeed_stall_frac
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        if losses:
            tm.infeed_wait(time.perf_counter() - t_wait)
        else:
            first_step_wall = time.time()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss = T.loss_fn(params, batch, cfg,
                         ce_impl=args.get("ce_impl", "dense"))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        train.all_reduce_mean_([p.grad for p in leaves])
        opt.step()
        if cuda:
            end.record()
        losses.append(loss.item())  # waits for the step
        if cuda:
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        tm.step(items=per_proc * cfg.max_seq, loss=losses[-1])  # tokens
        every = args.get("ckpt_every")
        if args.get("ckpt_dir") and every and len(losses) % every == 0 \
                and ckpt.is_chief(ctx):
            ckpt.save_checkpoint(args["ckpt_dir"], params, len(losses))
    if args.get("ckpt_dir") and ckpt.is_chief(ctx):
        ckpt.save_checkpoint(args["ckpt_dir"], params, len(losses))
    if args.get("export_dir"):
        ckpt.export_model(args["export_dir"], params, ctx, metadata={
            "config": dataclasses.asdict(cfg)})
    out_dir = args.get("out_dir")
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"transformer-rank{rank}.json"),
                  "w") as f:
            json.dump({
                "rank": rank, "pid": os.getpid(), "device": str(dev),
                "health": env["health"], "losses": losses,
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "step_ms": step_ms, "records": feed.records,
                "feed": feed.stats(), "feeders": ctx.mgr.get("feed_stats"),
                "pin": dict(infeed.pin_stats),
                "launches": {"flash_fwd": attention.launches,
                             "flash_dq": attention.dq_launches,
                             "flash_dkv": attention.dkv_launches},
                "train_metrics": tm.report(),
                "feed_wait_s": feed_tm.infeed_time,
                "main_start_wall": main_start_wall,
                "joined_wall": joined_wall, "model_wall": model_wall,
                "first_step_wall": first_step_wall,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if cuda else None)}, f)


def main():
    p = argparse.ArgumentParser()
    for name, default in (("vocab_size", 16384), ("dim", 1024),
                          ("n_layers", 8), ("n_heads", 8),
                          ("max_seq", 2048), ("batch_size", 8),
                          ("steps", 5), ("cluster_size", 1),
                          ("num_gpus", 0)):
        p.add_argument(f"--{name}", type=int, default=default)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="the chief's npz checkpoints")
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="checkpoint every N steps (and at the end)")
    p.add_argument("--export_dir", default=None,
                   help="the chief's export, Config in the metadata")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    config = dict(vocab_size=args.vocab_size, dim=args.dim,
                  n_layers=args.n_layers, n_heads=args.n_heads,
                  max_seq=args.max_seq, dtype=args.dtype)
    tokens = np.random.default_rng(0).integers(
        0, args.vocab_size, (args.batch_size * args.steps, args.max_seq)
    ).astype(np.int32)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun,
            {"config": config, "batch_size": args.batch_size,
             "device": args.device, "out_dir": args.out_dir,
             "ckpt_dir": args.ckpt_dir, "ckpt_every": args.ckpt_every,
             "export_dir": args.export_dir},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, num_gpus=args.num_gpus)
        cluster.train(engine.parallelize(list(tokens), args.steps))
        cluster.shutdown()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
