#!/usr/bin/env python3
"""The port's CUDA kernels against another tree's, on one card, in one run.

    git archive <commit> tensorflowonspark_tpu_torch/ops/csrc | tar -x -C build/other
    python3 scripts/torch_kernel_ab.py build/other/tensorflowonspark_tpu_torch/ops/csrc

Run from the root of a checkout on a machine with a CUDA card.  It builds
``flash_fwd``, ``flash_bwd`` (their bf16 head_dim-128 libraries, the main
path's) and ``rmsnorm`` from this tree's ``ops/csrc`` and from the other
directory (same ``nvcc`` flags, the instantiation's defines included,
which a tree that builds every instantiation into one library ignores;
the C interfaces must match), and times each kernel at the main path's shapes
through this tree's wrappers, swapping the libraries in turns other,
this, this, other, with ``chip_smoke.time_ms`` (each run queued behind a
device-side spin, so the events time the device's work).  It also checks
that the two trees' backward kernels give the same dq, dk and dv bit for
bit on one (out, lse).  Prints one JSON line, ``kernel_ab {...}``: the
card, and for each kernel and tree its two times in ms.  Imports only
torch and the port.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from tensorflowonspark_tpu_torch.ops import _build, attention, norm  # noqa: E402

# this tree's library of each source at the main path's shapes (bf16,
# head_dim 128)
LIBS = {"flash_fwd": _build.variant("flash_fwd", 128, 1),
        "flash_bwd": _build.variant("flash_bwd", 128, 1),
        "rmsnorm": "rmsnorm"}


def build_other(csrc, out_dir):
    """Build every source of LIBS from ``csrc`` into ``out_dir`` with this
    tree's flags for its library, one ``nvcc`` each, started together;
    returns {this tree's library name: ctypes.CDLL}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {lib: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *_build._recipe(lib)[1], "-o",
         os.path.join(out_dir, f"lib{lib}.so"),
         os.path.join(csrc, f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, lib in LIBS.items()}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the other {n}:\n{log}")
    return {n: ctypes.CDLL(os.path.abspath(os.path.join(out_dir,
                                                        f"lib{n}.so")))
            for n in procs}


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build(list(LIBS.values()))
    trees = {"other": build_other(argv[1], str(_build.BUILD_DIR / "other")),
             "this": {n: _build.load(n) for n in LIBS.values()}}

    def use(tree):
        _build._LIBS.update(trees[tree])

    gen = torch.Generator(device=dev).manual_seed(1234)
    b, s, h, d = 8, 2048, 8, 128  # the main path's attention call
    scale = d ** -0.5
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    x = {"bfloat16": torch.randn((8, 2048, 1024), generator=gen,
                                 device=dev).to(torch.bfloat16)}
    x["float32"] = torch.randn((8, 2048, 1024), generator=gen, device=dev)
    w = torch.randn(1024, generator=gen, device=dev) + 1.0

    def fwd():
        return attention._flash_forward(q, k, v, causal=True, scale=scale)

    use("this")
    out, lse = fwd()  # one (out, lse) for both trees' backward
    gi, lse_i, delta = attention._bwd_inputs(q, k, v, out, lse, g)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    times, grads = {}, {}
    for tree in ("other", "this", "this", "other"):
        use(tree)
        t = times.setdefault(tree, {})
        t.setdefault("flash_fwd", []).append(cs.time_ms(fwd, 20))
        for dtype, xt in x.items():
            t.setdefault(f"rmsnorm_{dtype}", []).append(cs.time_ms(
                lambda: norm._rmsnorm_cuda(xt, w, 1e-6, 256), 100))
        for kernel, out0, out1 in (("flash_dq", dq, dq),
                                   ("flash_dkv", dk, dv)):
            t.setdefault(kernel, []).append(cs.time_ms(
                lambda: attention._launch_bwd(
                    kernel, q, k, v, gi, lse_i, delta, out0, out1,
                    causal=True, scale=scale), 10))
        grads[tree] = attention._flash_backward_cuda(
            q, k, v, out, lse, g, causal=True, scale=scale)
    torch.cuda.synchronize()
    same = {n: torch.equal(a, o) for n, a, o in
            zip(("dq", "dk", "dv"), grads["this"], grads["other"])}
    print("kernel_ab " + json.dumps(dict(
        gpu=cs.gpu_line(), other_csrc=argv[1], ms=times,
        backward_bit_for_bit=same)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
