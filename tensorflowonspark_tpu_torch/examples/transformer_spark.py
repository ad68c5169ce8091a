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

With ``--ckpt_dir`` the chief saves the train state every
``--ckpt_every`` steps and at the end: one tree of the params (the JAX
layout, npz) under ``params`` and Adam's state under ``opt``, packed as
the JAX package packs ``optax.adam``'s ``(count, mu, nu)``
(``checkpoint.pack_pytree``); every trainer resumes from the newest
one through ``ctx.restore_latest``, so a cluster recovered by
``cluster.run(restarts=N)`` goes on from the last save.  With
``--export_dir`` the chief exports the params with the ``Config`` in the
metadata (``config``), which ``serving.ModelSpec(export_dir=...,
decode=DecodeSpec(Config(**meta["config"])))`` and the JAX package's
``load_exported`` both load.

With ``--elastic_data N`` each trainer steps through
``ctx.elastic_runtime({"data": N}, global_batch=batch_size)``: the
logical data axis of N folded onto the job's ranks, the deficit of a
shrunk cluster made up by gradient accumulation (``--restarts 1
--min_executors 1``), so every optimizer step sees ``batch_size`` rows.
With ``--out_dir`` and ``--ckpt_dir`` (a job that can resume) each
trainer appends one JSON line a step to ``steps-exec<executor>.jsonl``:
its epoch, step, loss, world size, accumulation steps, the rows' first
tokens and its kernel launches so far.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


ROW_KEY_TOKENS = 4  # the first tokens of a row name it in the step log


def collate(records):
    """``[n, seq]`` int64 tokens from ``n`` token records."""
    return np.stack(records).astype(np.int64)


def param_leaves(params):
    """The params' tensors in the optimizer's order."""
    return [params["embed"], params["ln_f"], params["head"],
            *params["layers"].values()]


def make_optimizer(params, lr=1e-3):
    """The params' leaves made to require grad, and their Adam."""
    import torch

    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves, torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)


def _like(params):
    """``params``' tree with a placeholder at each leaf."""
    return {k: _like(v) if isinstance(v, dict) else 0
            for k, v in params.items()}


def train_state(params, opt):
    """The checkpoint tree: ``params``, and Adam's ``(count, mu, nu)``
    packed under ``opt`` (no moments before the first step), the count
    an int32 as ``optax.adam``'s is."""
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    state = opt.state.get(params["embed"])
    if not state:
        return {"params": params}

    def moment(name, tree):
        return {k: moment(name, v) if isinstance(v, dict)
                else opt.state[v][name] for k, v in tree.items()}

    return {"params": params, "opt": ckpt.pack_pytree(
        [np.int32(int(state["step"])), moment("exp_avg", params),
         moment("exp_avg_sq", params)])}


def load_train_state(tree, params, opt):
    """Copy a :func:`train_state` tree (host arrays, as restored) into
    ``params`` and ``opt``'s state, in place."""
    import torch

    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    def walk(dst, src, fn):
        for k, v in dst.items():
            if isinstance(v, dict):
                walk(v, src[k], fn)
            else:
                fn(v, src[k])

    with torch.no_grad():
        walk(params, tree["params"],
             lambda p, x: p.copy_(torch.from_numpy(np.asarray(x))))
    if "opt" not in tree:
        return
    like = _like(params)
    count, mu, nu = ckpt.unpack_pytree(tree["opt"], [0, like, like])
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)

    def put(p, pair):
        m, v = pair
        opt.state[p] = {"step": step.clone(),
                        "exp_avg": torch.from_numpy(np.asarray(m)).to(
                            p.device),
                        "exp_avg_sq": torch.from_numpy(np.asarray(v)).to(
                            p.device)}

    walk(params, _zip_trees(mu, nu), put)


def _zip_trees(a, b):
    return {k: _zip_trees(v, b[k]) if isinstance(v, dict) else (v, b[k])
            for k, v in a.items()}


def train_step(params, opt, batch, cfg, vg=None, ce_impl="dense"):
    """One optimizer step on ``batch``; returns the loss tensor.  With
    ``vg`` (an elastic layout's ``value_and_grad``) the batch runs in its
    microbatches and the gradients are averaged over the layout's batch
    axes; without, one backward and the all-reduce over the job."""
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.utils import train

    if vg is not None:
        loss, _ = vg(params, batch)
    else:
        loss = T.loss_fn(params, batch, cfg, ce_impl=ce_impl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        train.all_reduce_mean_([p.grad for p in param_leaves(params)])
    opt.step()
    return loss


def elastic_loss(cfg, ce_impl="dense"):
    """The loss an elastic layout's ``value_and_grad`` differentiates."""
    from tensorflowonspark_tpu_torch.models import transformer as T

    return lambda params, tokens: T.loss_fn(params, tokens, cfg,
                                            ce_impl=ce_impl)


def main_fun(args, ctx):
    """Runs in every trainer.  ``args``: ``config`` (``transformer.Config``
    keywords), ``batch_size`` (global), optional ``lr`` (1e-3),
    ``device`` (default the card), ``backend`` (the process group's;
    ``"gloo"`` lets ranks share one card), ``init_params`` (a JAX-layout
    params tree; default random from ``seed``), ``ce_impl``,
    ``field`` (read the feed as dense columns under this name, as a
    ``data.Pipeline`` of ``{field: tokens}`` through the data service
    sends it; default: records), ``ckpt_dir``, ``ckpt_every`` and
    ``ckpt_keep`` (the chief's
    checkpoints, the newest 3 kept by default, which every trainer
    resumes from), ``elastic_data`` (the logical data
    axis of an elastic layout), ``export_dir`` (the chief's export) and
    ``out_dir``, where each trainer of a job with a ``ckpt_dir``
    appends its step log and where each rank writes ``transformer-rank<r>.json``: its losses,
    step times, the records its ``DataFeed`` handed out (counted, a
    dropped tail included) and what the feed saw (``DataFeed.stats``,
    the feeders' timings from the node's KV, the copies into pinned
    memory), its ``CUDA_VISIBLE_DEVICES``, kernel launches,
    ``TrainMetrics`` report, feed wait, the wall-clock times at which
    it began, joined the job, had its model and optimizer, and began its
    first step, and the seconds the chief's export took."""
    main_start_wall = time.time()
    import torch

    from tensorflowonspark_tpu_torch import infeed
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.ops import attention, norm
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
    from tensorflowonspark_tpu_torch.utils import metrics, train

    cfg = T.Config(**args["config"])
    env = ctx.torch_initialize(args.get("device"), backend=args.get(
        "backend"))
    joined_wall = time.time()
    dev = env["device"]
    if dev.type == "cuda":
        # float32 stays float32, bf16 and f16 products accumulate in
        # float32, as chip_smoke.py's in-process training runs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            False
    if args.get("init_params") is not None:
        params = T.params_from_jax(args["init_params"], cfg, device=dev)
    else:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(
            args.get("seed", 0)), dev)
    _, opt = make_optimizer(params, args.get("lr", 1e-3))
    ckpt_dir, keep = args.get("ckpt_dir"), args.get("ckpt_keep", 3)
    start_step, restore_ms = 0, None
    if ckpt_dir:
        t0 = time.perf_counter()
        tree, start_step = ctx.restore_latest(ckpt_dir)
        if tree is not None:
            load_train_state(tree, params, opt)
            restore_ms = 1e3 * (time.perf_counter() - t0)
        del tree
    ce_impl = args.get("ce_impl", "dense")
    vg, accum, world = None, 1, max(env["num_processes"], 1)
    if args.get("elastic_data"):
        rt = ctx.elastic_runtime({"data": int(args["elastic_data"])},
                                 global_batch=args["batch_size"])
        sched = rt.batch_schedule()
        accum, world = sched["accum_steps"], rt.layout.n_physical
        per_proc = sched["per_device"] * accum
        vg = rt.value_and_grad(elastic_loss(cfg, ce_impl))
    else:
        per_proc = args["batch_size"] // world
    model_wall = time.time()
    out_dir = args.get("out_dir")
    log_path = (os.path.join(out_dir, f"steps-exec{ctx.executor_id}.jsonl")
                if out_dir and ckpt_dir else None)

    def log(**rec):
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(dict(rec, epoch=ctx.epoch,
                                        pid=os.getpid())) + "\n")

    log(event="start", resumed_step=start_step, restore_ms=restore_ms,
        world=world, accum=accum, wall=time.time())
    tm = metrics.TrainMetrics(
        flops_per_item=metrics.transformer_flops_per_token(cfg, causal=True),
        device=dev)
    # accumulates the DataFeed's waits
    feed_tm = metrics.TrainMetrics(health=False)
    field = args.get("field")
    if field:
        # the data service's named chunks (or the feeder's bare ones,
        # whose one column takes the name), as dense columns
        feed = ctx.get_data_feed(train_mode=True, metrics=feed_tm,
                                 input_mapping={field: field})
        batches = iter(infeed.synchronized(infeed.device_feed(
            feed, per_proc, collate=lambda cols: collate(cols[field]),
            placement=dev, columnar=True), feed=feed))
    else:
        feed = ctx.get_data_feed(train_mode=True, metrics=feed_tm)
        batches = iter(infeed.synchronized(infeed.device_feed(
            feed, per_proc, collate=collate, placement=dev), feed=feed))
    cuda = dev.type == "cuda"
    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    norm.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, first_step_wall, saved = [], [], None, None
    # host time from one step's end to the next's: the step as the
    # loop sees it (the wait for the batch, the step, the probe's read,
    # TrainMetrics and its health monitor)
    step_wall_ms, last_end = [], None
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
        loss = train_step(params, opt, batch, cfg, vg, ce_impl)
        # the watchtower's gradient probe (TFOS_HEALTH_GRADNORM=1, else
        # None), on the card, inside the step's timing
        probe = train.health_probe(loss.detach(), [
            p.grad for p in param_leaves(params)])
        if cuda:
            end.record()
        losses.append(loss.item())  # waits for the step
        if cuda:
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        tm.step(items=per_proc * cfg.max_seq, loss=losses[-1],  # tokens
                grad_norm=probe and probe["grad_norm"],
                grad_finite=probe and probe["finite"])
        now = time.perf_counter()
        if last_end is not None:
            step_wall_ms.append(1e3 * (now - last_end))
        last_end = now
        step = start_step + len(losses)
        every = args.get("ckpt_every")
        save_ms = None
        if ckpt_dir and every and step % every == 0 and ckpt.is_chief(ctx):
            t0 = time.perf_counter()
            ckpt.save_checkpoint(ckpt_dir, train_state(params, opt), step,
                                 keep=keep)
            save_ms = 1e3 * (time.perf_counter() - t0)
            saved = step
        if log_path:
            log(event="step", step=step, loss=losses[-1], world=world,
                accum=accum, step_ms=step_ms[-1], save_ms=save_ms,
                wall=time.time(),
                rows=batch[:, :ROW_KEY_TOKENS].tolist(),
                launches={"flash_fwd": attention.launches,
                          "flash_dq": attention.dq_launches,
                          "flash_dkv": attention.dkv_launches,
                          "rmsnorm": norm.launches})
    if ckpt_dir and ckpt.is_chief(ctx) and \
            saved != start_step + len(losses):
        ckpt.save_checkpoint(ckpt_dir, train_state(params, opt),
                             start_step + len(losses), keep=keep)
    export_s = None
    if args.get("export_dir"):
        t0 = time.perf_counter()
        if ckpt.export_model(args["export_dir"], params, ctx, metadata={
                "config": dataclasses.asdict(cfg)}):
            export_s = time.perf_counter() - t0
    if out_dir:
        rank = env["process_id"]
        with open(os.path.join(out_dir, f"transformer-rank{rank}.json"),
                  "w") as f:
            json.dump({
                "rank": rank, "pid": os.getpid(), "device": str(dev),
                "slice_health": env["slice_health"], "losses": losses,
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "step_ms": step_ms, "step_wall_ms": step_wall_ms,
                "records": feed.records,
                "feed": feed.stats(), "feeders": ctx.mgr.get("feed_stats"),
                "pin": dict(infeed.pin_stats),
                "launches": {"flash_fwd": attention.launches,
                             "flash_dq": attention.dq_launches,
                             "flash_dkv": attention.dkv_launches,
                             "rmsnorm": norm.launches},
                "train_metrics": tm.report(),
                "feed_wait_s": feed_tm.infeed_time,
                "main_start_wall": main_start_wall,
                "joined_wall": joined_wall, "model_wall": model_wall,
                "first_step_wall": first_step_wall,
                "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                if cuda else None),
                "export_s": export_s}, f)


def main():
    p = argparse.ArgumentParser()
    for name, default in (("vocab_size", 16384), ("dim", 1024),
                          ("n_layers", 8), ("n_heads", 8),
                          ("max_seq", 2048), ("batch_size", 8),
                          ("steps", 5), ("cluster_size", 1),
                          ("num_gpus", 0), ("elastic_data", 0),
                          ("restarts", 0), ("min_executors", 0)):
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
    p.add_argument("--backend", default=None,
                   help="the process group's; gloo lets ranks share a card")
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
             "export_dir": args.export_dir, "backend": args.backend,
             "elastic_data": args.elastic_data},
            num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.SPARK, num_gpus=args.num_gpus,
            restarts=args.restarts, min_executors=args.min_executors)
        cluster.train(engine.parallelize(list(tokens), args.steps))
        cluster.shutdown()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
