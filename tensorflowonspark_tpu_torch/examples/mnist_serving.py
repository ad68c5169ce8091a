"""MNIST online serving: export a model, stand up a 2-replica service,
and hammer it with concurrent clients.

Counterpart of ``examples/serving/mnist_serving.py``, with the same flow
and flags, plus ``--device``.  Self-contained: seeded random MNIST
params, exported with the port's predict
(``tensorflowonspark_tpu_torch.models.mnist:predict``), then

- dynamic micro-batching (concurrent single-example requests coalesce
  into power-of-two shape buckets, one signature per bucket),
- checkpoint hot reload (a new checkpoint is picked up in-band while
  the service runs),
- live SLO stats (p50/p95/p99 latency, mean device batch, shed rate).

On the CPU::

    python -m tensorflowonspark_tpu_torch.examples.mnist_serving \\
        --device cpu

Add ``--http`` to also expose the stdlib HTTP frontend and poke it
(``tfos-serve-torch`` is the standalone CLI for the same thing).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_replicas", type=int, default=2)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--requests", type=int, default=4,
                   help="requests per client thread")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_delay_ms", type=float, default=10.0)
    p.add_argument("--http", action="store_true",
                   help="also start the HTTP frontend and issue one POST")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resolve_device, serving
    from tensorflowonspark_tpu_torch.models import mnist
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(args.device)
    workdir = tempfile.mkdtemp(prefix="tfos_serving_example_")
    export_dir = os.path.join(workdir, "export")
    ckpt_dir = os.path.join(workdir, "ckpts")

    params = mnist.params_to_jax(mnist.init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    ckpt.save_checkpoint(ckpt_dir, params, step=1)
    ckpt.export_model(export_dir, params,
                      metadata={"predict": mnist.PREDICT})

    spec = serving.ModelSpec(export_dir=export_dir, ckpt_dir=ckpt_dir,
                             device=args.device)
    rng = np.random.default_rng(0)
    images = rng.random((args.clients, 28, 28, 1)).astype(np.float32)

    with serving.Server(spec, num_replicas=args.num_replicas,
                        max_batch=args.max_batch,
                        max_delay_ms=args.max_delay_ms) as srv:
        client = srv.client()
        client.predict({"image": images[0]}, timeout=300)

        errors = []

        def burst(i):
            for _ in range(args.requests):
                try:
                    out = client.predict({"image": images[i]}, timeout=300)
                    assert out["logits"].shape == (10,)
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))

        t0 = time.monotonic()
        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        n = args.clients * args.requests
        print(f"{n} requests from {args.clients} concurrent clients "
              f"in {wall:.2f}s ({n / wall:.0f} req/s), "
              f"errors={len(errors)}")

        # hot reload: a new checkpoint; the pool's watcher broadcasts an
        # in-band reload, so no request is dropped while params swap
        ckpt.save_checkpoint(ckpt_dir, params, step=2)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if set(srv.pool.versions().values()) == {2}:
                break
            time.sleep(0.2)
        print("hot-reload:", srv.pool.versions())

        if args.http:
            import urllib.request

            httpd = serving.serve_http(srv, port=0, block=False)
            try:
                host, port = httpd.server_address
                req = urllib.request.Request(
                    f"http://{host}:{port}/v1/predict",
                    data=json.dumps(
                        {"inputs": {"image": images[0].tolist()}}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    body = json.loads(r.read())
                print("HTTP prediction:", body["outputs"]["prediction"])
            finally:
                httpd.shutdown()

        summary = srv.summary()
        print("summary:", json.dumps(summary, default=str))
    return summary, errors


if __name__ == "__main__":
    main()
