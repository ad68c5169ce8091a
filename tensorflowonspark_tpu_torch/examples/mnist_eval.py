"""MNIST with a sidecar evaluator node (``eval_node=True``), and ps nodes.

Counterpart of ``examples/mnist/mnist_eval.py``: the chief writes
step-stamped checkpoints (``utils.checkpoint.save_checkpoint``); the
evaluator is a sidecar loop that polls the checkpoint directory,
evaluates each new step on a held-out set and appends one JSON line a
step to ``<model_dir>/eval_results.jsonl``.  The cluster runs under
``InputMode.TENSORFLOW``: the chief and the workers train on their
shards in their executors, the evaluator and any ps node run in
processes forked from theirs and hold their slots until shutdown::

    python -m tensorflowonspark_tpu_torch.examples.mnist_eval \\
        --cluster_size 3 --steps 40 --device cpu

``cluster_size`` counts every node: the ps nodes (``--num_ps``), one
evaluator, one chief and the workers.  The evaluator and the ps nodes
own no GPU (as in the JAX package, where they own no chip): the
evaluator evaluates on the CPU.  A ps node has nothing to serve in an
all-reduce job: it records that it ran and returns.  On one card the
chief and a worker share the GPU, which NCCL refuses: pass
``--backend gloo``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time

import numpy as np


def _eval_loop(args, ctx):
    """The evaluator: on the CPU, until the chief's DONE marker, each
    newer checkpoint is evaluated; then the newest one is drained, the
    EVAL_DONE marker acks, and the loop returns the last step."""
    import torch

    from tensorflowonspark_tpu_torch.examples.mnist_data_setup import (
        synthetic_mnist,
    )
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    images, labels = synthetic_mnist(args["num_examples"], seed=1)
    images_t = torch.from_numpy(images)
    log_path = os.path.join(args["model_dir"], "eval_results.jsonl")
    done_path = os.path.join(args["model_dir"], "DONE")
    ckpt_dir = os.path.join(args["model_dir"], "ckpt")
    seen = -1
    deadline = time.monotonic() + args["eval_timeout"]
    while True:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        step = ckpt.step_of(latest) if latest else -1
        if latest and step > seen:
            params = mnist.params_from_jax(ckpt.load_checkpoint(latest),
                                           device="cpu")
            with torch.no_grad():
                logits = mnist.apply(params, images_t).numpy()
            acc = float((logits.argmax(-1) == labels).mean())
            with open(log_path, "a") as f:
                f.write(json.dumps({"step": step, "accuracy": acc,
                                    "examples": len(labels)}) + "\n")
            print(f"evaluator: step {step} accuracy={acc:.3f}", flush=True)
            seen = step
            # the timeout bounds idle time, not the whole run
            deadline = time.monotonic() + args["eval_timeout"]
            continue
        if os.path.exists(done_path):
            # ack after draining the newest checkpoint: the chief waits
            # for it, so shutdown never cuts a final evaluation
            _write_json(os.path.join(args["model_dir"], "EVAL_DONE"), seen)
            print(f"evaluator: DONE after step {seen}", flush=True)
            return seen
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"evaluator: no DONE marker within {args['eval_timeout']}s")
        time.sleep(0.2)


def _write_json(path, obj):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def main_fun(args, ctx):
    """Every node's main: the evaluator's loop, a ps node's record, or
    the chief's and workers' training.  ``args``: ``num_examples``,
    ``batch_size`` (global), ``steps``, ``ckpt_steps``, ``lr``,
    ``eval_timeout``, ``model_dir``; optional ``device`` (default the
    card) and ``backend`` (``torch_initialize``'s).  Each node writes
    ``<model_dir>/<job>-<task>.json`` (its pid and, for the trainers,
    losses, device and the kernels' launches over the steps)."""
    record = os.path.join(args["model_dir"],
                          f"{ctx.job_name}-{ctx.task_index}.json")
    if ctx.job_name == "evaluator":
        step = _eval_loop(args, ctx)
        _write_json(record, {"pid": os.getpid(), "last_step": step,
                             "cuda_visible": os.environ.get(
                                 "CUDA_VISIBLE_DEVICES")})
        return
    if ctx.job_name == "ps":
        _write_json(record, {"pid": os.getpid(), "cuda_visible":
                             os.environ.get("CUDA_VISIBLE_DEVICES")})
        return

    import torch

    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.examples.mnist_data_setup import (
        synthetic_mnist,
    )
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    env = ctx.torch_initialize(args.get("device"),
                               backend=args.get("backend"))
    ops.reset_launch_counts()
    dev = env["device"]
    # shard by the process group's rank: chief:0 and worker:0 share
    # task_index 0
    images, labels = synthetic_mnist(args["num_examples"], seed=0)
    shard = (np.arange(len(images)) % env["num_processes"]
             == env["process_id"])
    images_t = torch.from_numpy(images[shard])
    labels_t = torch.from_numpy(labels[shard].astype(np.int64))
    params = mnist.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    leaves = [p.requires_grad_() for layer in params.values()
              for p in layer.values()]
    step_fn = mnist.make_train_step(
        torch.optim.SGD(leaves, lr=args["lr"], momentum=0.9))
    chief = ckpt.is_chief(ctx)
    ckpt_dir = os.path.join(args["model_dir"], "ckpt")
    per_proc = args["batch_size"] // max(env["num_processes"], 1)
    rng = np.random.default_rng(env["process_id"])
    losses = []
    for step in range(1, args["steps"] + 1):
        idx = torch.from_numpy(rng.integers(0, len(images_t), per_proc))
        loss, _ = step_fn(params, images_t[idx].to(dev),
                          labels_t[idx].to(dev))
        losses.append(float(loss))
        if step % args["ckpt_steps"] == 0 and chief:
            ckpt.save_checkpoint(ckpt_dir, mnist.params_to_jax(params), step)
    if chief:
        if args["steps"] % args["ckpt_steps"]:
            ckpt.save_checkpoint(ckpt_dir, mnist.params_to_jax(params),
                                 args["steps"])
        # DONE after the last checkpoint, then hold this slot until the
        # evaluator acks: shutdown must not cut its last evaluation
        _write_json(os.path.join(args["model_dir"], "DONE"), "done")
        ack = os.path.join(args["model_dir"], "EVAL_DONE")
        deadline = time.monotonic() + args["eval_timeout"]
        while not os.path.exists(ack):
            if time.monotonic() > deadline:
                raise TimeoutError("evaluator never acked DONE")
            time.sleep(0.2)
    _write_json(record, {"pid": os.getpid(), "losses": losses,
                         "device": str(dev), "launches": ops.launch_counts()})


def reset_model_dir(model_dir):
    """A reused model_dir starts clean: a stale DONE/EVAL_DONE pair
    would end the evaluator at once, and old checkpoints would shadow
    the new ones."""
    os.makedirs(model_dir, exist_ok=True)
    for name in ("DONE", "EVAL_DONE", "eval_results.jsonl"):
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(model_dir, name))
    shutil.rmtree(os.path.join(model_dir, "ckpt"), ignore_errors=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=3,
                   help="every node: ps + 1 evaluator + 1 chief + workers")
    p.add_argument("--num_ps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--ckpt_steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--num_examples", type=int, default=2048)
    p.add_argument("--eval_timeout", type=float, default=300.0)
    p.add_argument("--model_dir", default="mnist_model_eval")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    p.add_argument("--backend", default=None,
                   help="the process group's backend; 'gloo' when ranks "
                        "share one card")
    p.add_argument("--num_gpus", type=int, default=0)
    p.add_argument("--tensorboard", action="store_true")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch import cluster as TFCluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    args.model_dir = os.path.abspath(args.model_dir)
    reset_model_dir(args.model_dir)
    engine = LocalEngine(args.cluster_size)
    try:
        cluster = TFCluster.run(
            engine, main_fun, vars(args), num_executors=args.cluster_size,
            num_ps=args.num_ps, input_mode=TFCluster.InputMode.TENSORFLOW,
            master_node="chief", eval_node=True, num_gpus=args.num_gpus,
            tensorboard=args.tensorboard,
            log_dir=os.path.join(args.model_dir, "tb")
            if args.tensorboard else None)
        print("tensorboard:", cluster.tensorboard_url())
        cluster.shutdown(grace_secs=2)
    finally:
        engine.stop()
    with open(os.path.join(args.model_dir, "eval_results.jsonl")) as f:
        evals = [json.loads(ln) for ln in f]
    print(f"evaluations: "
          f"{[(e['step'], round(e['accuracy'], 3)) for e in evals]}")


if __name__ == "__main__":
    main()
