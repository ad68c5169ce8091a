#!/usr/bin/env python3
"""What a process forked after CUDA gets, on a machine with a card.

    python3 scripts/torch_fork_after_cuda_probe.py

The parent makes a CUDA context (as an engine executor does once
``TFModel.transform`` or a serving replica has predicted in it), then
forks children the way the node runtime forks its trainers
(``multiprocessing`` "fork"): one that touches CUDA, one that stays on
the CPU with ``CUDA_VISIBLE_DEVICES=""`` (a ps or evaluator node's
process).  Each child's outcome and seconds are printed as one JSON
line; a child that does not finish within 60 s is killed and reported
as hung.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import time
import traceback


def _cuda_child(out):
    import torch

    try:
        x = torch.ones(4, device="cuda")
        out.put(("ok", float(x.sum())))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        out.put(("error", f"{type(e).__name__}: {e}"))


def _cpu_child(out):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    try:
        x = torch.ones(4) @ torch.ones(4)
        out.put(("ok", float(x)))
    except Exception:  # noqa: BLE001 - reported to the parent
        out.put(("error", traceback.format_exc(limit=1)))


def _run(target):
    ctx = mp.get_context("fork")
    out = ctx.Queue()
    t0 = time.perf_counter()
    p = ctx.Process(target=target, args=(out,))
    p.start()
    p.join(timeout=60)
    seconds = time.perf_counter() - t0
    if p.is_alive():
        p.kill()
        p.join()
        return {"outcome": "hung", "seconds": seconds}
    status, detail = out.get(timeout=5) if not out.empty() else (
        "no result", None)
    return {"outcome": status, "detail": detail, "exitcode": p.exitcode,
            "seconds": seconds}


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    torch.ones(1, device="cuda").sum().item()  # the parent's context
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "parent_cuda_initialized": torch.cuda.is_initialized(),
        "forked_cuda_child": _run(_cuda_child),
        "forked_cpu_child": _run(_cpu_child)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
