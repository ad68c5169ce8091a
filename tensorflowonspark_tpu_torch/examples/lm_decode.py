"""Autoregressive LM decode serving: export a decoder-only transformer,
stand up a continuous-batching decode service, and measure its SLOs
under open-loop Poisson load.

Counterpart of ``examples/serving/lm_decode.py``, with the same flow and
flags, plus ``--device``.  Self-contained: seeded random transformer
params, exported with ``utils.checkpoint.export_model``, then

- ``Server.generate``: one decode session, token-identical to a
  full-recompute greedy decode (the KV cache changes nothing);
- seeded sampling: ``temperature=/top_k=/top_p=/seed=`` — the same seed
  reproduces the same stream (what failover replay relies on);
- prefix sharing: sessions repeating a system prompt map the resident
  KV blocks instead of re-prefilling them;
- the open-loop load generator (``serving.run_open_loop``) reporting
  TTFT p50/p99, per-token-gap p50/p99 and tokens/s.

On the CPU::

    python -m tensorflowonspark_tpu_torch.examples.lm_decode --device cpu

Add ``--http`` to also expose the HTTP frontend and issue one
``POST /v1/generate``.
"""

from __future__ import annotations

import argparse
import json
import tempfile


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_replicas", type=int, default=2)
    p.add_argument("--slots", type=int, default=8,
                   help="KV slots (max concurrent sessions) per replica")
    p.add_argument("--sessions", type=int, default=16,
                   help="open-loop session count")
    p.add_argument("--rate", type=float, default=4.0,
                   help="offered session arrivals per second")
    p.add_argument("--max_tokens", type=int, default=16)
    p.add_argument("--http", action="store_true",
                   help="also start the HTTP frontend and issue one POST")
    p.add_argument("--device", default=None,
                   help="'cpu' for the CPU; default the card")
    args = p.parse_args(argv)

    import os

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import resolve_device, serving
    from tensorflowonspark_tpu_torch.models import transformer as T
    from tensorflowonspark_tpu_torch.ops import attention
    from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

    dev = resolve_device(args.device)
    cfg = T.Config(vocab_size=257, dim=64, n_layers=2, n_heads=4,
                   max_seq=64, dtype="float32")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    workdir = tempfile.mkdtemp(prefix="tfos_decode_example_")
    export_dir = os.path.join(workdir, "export")
    ckpt.export_model(export_dir, params, metadata={})

    spec = serving.ModelSpec(
        export_dir=export_dir, device=args.device,
        decode=serving.DecodeSpec(cfg, slots=args.slots,
                                  max_tokens=args.max_tokens))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(4, 25, size=args.sessions)]

    with serving.Server(spec, num_replicas=args.num_replicas,
                        request_timeout=300) as srv:
        out = srv.generate(prompts[0], max_tokens=args.max_tokens,
                           timeout=300)
        ref = T.greedy_decode_reference(
            params, prompts[0], cfg, max_tokens=args.max_tokens,
            attn_fn=lambda q, k, v: attention.mha_reference(q, k, v,
                                                            causal=True))
        assert out["tokens"] == ref, "KV-cached decode diverged from oracle"
        print(f"single session: {len(out['tokens'])} tokens, "
              f"ttft {out['ttft_ms']:.1f} ms — token-identical to "
              "full-recompute greedy decode")

        a = srv.generate(prompts[0], max_tokens=args.max_tokens,
                         temperature=0.8, top_k=40, seed=1234, timeout=300)
        b = srv.generate(prompts[0], max_tokens=args.max_tokens,
                         temperature=0.8, top_k=40, seed=1234, timeout=300)
        assert a["tokens"] == b["tokens"], "seeded sampling not reproducible"
        print(f"seeded sampling (T=0.8 top_k=40 seed=1234): "
              f"{a['tokens'][:8]}... — same seed, same stream")

        # same system prompt, different tails: followers map the shared
        # prefix blocks instead of re-prefilling them
        system = prompts[0][:16] if len(prompts[0]) >= 16 else prompts[0]
        for tail in ([7, 3, 9], [11, 2, 5], [4, 8, 6]):
            srv.generate(system * 2 + tail, max_tokens=4, timeout=300)
        reps = srv.summary(include_replicas=True)["replica_stats"]
        hits = sum(int(((r or {}).get("decode") or {}).get(
            "prefix_hits") or 0) for r in reps.values())
        saved = sum(int(((r or {}).get("decode") or {}).get(
            "prefix_tokens_saved") or 0) for r in reps.values())
        print(f"prefix sharing: hits={hits} prefill_tokens_saved={saved}")

        def session(i):
            o = srv.generate(prompts[i % len(prompts)],
                             max_tokens=args.max_tokens, timeout=300)
            return {"ttft_ms": o.get("ttft_ms"),
                    "token_ms": o.get("token_ms"),
                    "tokens": len(o.get("tokens") or ())}

        stats = serving.run_open_loop(
            session, rate_rps=args.rate, n_requests=args.sessions,
            seed=0, shed_exc=serving.Overloaded)
        print(f"open loop: offered {stats['offered_rps']} sessions/s, "
              f"completed {stats['completed']}/{stats['requests']} "
              f"(shed {stats['shed']}, errors {stats['errors']})")
        print(f"  ttft  p50 {stats.get('ttft_p50_ms')} ms   "
              f"p99 {stats.get('ttft_p99_ms')} ms")
        print(f"  token p50 {stats.get('tok_p50_ms')} ms   "
              f"p99 {stats.get('tok_p99_ms')} ms   "
              f"{stats.get('tokens_per_sec', 0)} tok/s")

        if args.http:
            import urllib.request

            httpd = serving.serve_http(srv, port=0, block=False)
            try:
                host, port = httpd.server_address
                req = urllib.request.Request(
                    f"http://{host}:{port}/v1/generate",
                    data=json.dumps({"prompt": prompts[0],
                                     "max_tokens": 8}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    body = json.loads(r.read())
                print("HTTP generation:", body["tokens"])
            finally:
                httpd.shutdown()

        print("summary:", json.dumps(srv.summary()["decode"], default=str))
    return stats


if __name__ == "__main__":
    main()
