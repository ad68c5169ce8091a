#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
``sm_90a``).  It builds the port's kernels from the checkout's sources
into ``build/torch_kernels/`` and drives the port's three paths: the
SPARK-fed training path (the main path), in-process training and
serving, plus the ``fused_rmsnorm`` entry point, and ResNet-50 in
process and SPARK-fed (which launches none of the kernels):

0. preflight: a CUDA device must be present (else exit 2 at once); the
   card's name and power limit from ``nvidia-smi``; TF32 off for float32
   matmuls and convolutions, bf16 matmuls accumulate in float32;
1. build every kernel (one ``nvcc`` per source, started together); the
   ``ptxas`` registers and spills of every kernel; the bf16 flash
   kernels (forward, dq, dk/dv) must issue tensor-core MMAs (``HMMA`` in
   their SASS, read with ``cuobjdump``) and spill nothing at head_dim 64
   and 128, the float32 ones none; the forward's registers, shared
   memory and CTAs an SM as the card holds it;
2. the flash forward kernel (bf16: tensor cores; float32: FMAs) against
   its plain PyTorch version on the card, at the main path's shapes and
   the tail / head_dim cases, with times beside its bound and a library
   call (SDPA);
3. the flash backward's dq and dk/dv kernels (bf16: tensor cores;
   float32: FMAs) against ``flash_backward_plain`` in the same cases,
   timed the same way (the library call is SDPA's backward);
4. the RMSNorm kernel against ``rmsnorm_reference`` at the transformer's
   activation shape in bf16 and float32 and at tail shapes (scalar
   path, ragged rows, a misaligned input), forward and gradient through
   ``fused_rmsnorm``, each case naming the kernel path it took (the
   one-pass registers path or the two-pass path); times beside its
   bound and ``F.rms_norm``;
5. training at full width (the repo's on-chip transformer config,
   bf16, batch 8): five Adam(1e-3) steps fed through
   ``prefetch_to_device``; every loss finite and the loss falling; the
   forward, dq and dk/dv kernels each launched once per layer per step;
   ``remat=True`` and ``remat="dots"`` give the same loss, running the
   forward twice; the blockwise CE gives the dense loss; a profiled
   rerun splits the device time by kernel group;
6. the same training SPARK-fed (the main path): ``cluster.run`` on a
   one-executor ``LocalEngine`` with ``num_gpus=1``, the same batch as
   8 token records a step through the rendezvous, the node's GPU claim,
   a forked trainer, ``torch_initialize``, ``DataFeed`` and
   ``device_feed``; its five losses equal phase 5's, each flash kernel
   launched 8 times a step in the trainer, every partition consumed
   once (the rendezvous ledger) and no trainer left after shutdown;
7. gradient exactness at full width in float32: one step's loss and
   every parameter's gradient through the kernels equal those through
   ``mha_reference`` attention, which never touches a kernel;
8. serving at full width (bf16): a paged, prefix-sharing
   ``DecodeEngine`` answers 16 sessions; every token index streams once
   and in order, the prefix trie is hit, the cache ends empty with no
   leaked block, and the flash kernel ran on every layer of every plain
   prefill;
9. token-exactness at full width in float32: ``DecodeEngine`` greedy
   tokens equal the full-recompute ``greedy_decode_reference`` with
   ``mha_reference`` attention;
10. ResNet-50 in process at the north-star shape (1000 classes, 224x224
    uint8 images, batch 256, bf16 compute, SGD(0.1, momentum 0.9)): one
    ``bn_fused=False`` step (its loss equals the fused first step's; its
    peak memory), two warm-up and six timed steps on one seeded batch
    (images/s, MFU, peak memory; every loss finite, every BN running
    statistic finite and moved off (0, 1)), the space-to-depth stem
    against the 7x7 stem in bf16 and float32, and a profiled rerun split
    into convolutions (forward, dgrad, wgrad), BN statistics,
    elementwise work, the optimizer and copies; no transformer kernel
    launched;
11. one float32 ResNet-50 step (TF32 off) at batch 4, 64x64, on the card
    against the same step on the CPU: loss, every gradient, new BN state;
12. ResNet-50 SPARK-fed (this slice's main path): ``cluster.run`` of
    ``resnet_imagenet_spark.main_fun`` on the one-executor engine with
    ``num_gpus=1``, phase 10's batch as 256 (uint8 image, label) records
    a step for six steps through ``DataFeed`` and
    ``device_feed(columnar=True)``; its losses equal phase 10's first
    six, every partition consumed once, no trainer left, and the chief's
    checkpoint (HWIO on disk) restores in this process into params whose
    loss is phase 10's seventh.

Any failure raises, so the exit code is non-zero and the last line is
not printed.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it names the card, the one before that lists the
kernels' results, with their launches on the path each is on (the flash
kernels: in-process training, and ``launches_spark_train`` in the
SPARK-fed trainer; RMSNorm: one call of ``fused_rmsnorm``).  Imports
only torch, numpy and the port.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from tensorflowonspark_tpu_torch import cluster as TFCluster
from tensorflowonspark_tpu_torch import infeed
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.examples import (
    resnet_imagenet_spark,
    transformer_spark,
)
from tensorflowonspark_tpu_torch.models import layers, resnet
from tensorflowonspark_tpu_torch.models import transformer as T
from tensorflowonspark_tpu_torch.ops import (
    _build,
    attention,
    fused_rmsnorm,
    norm,
)
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
from tensorflowonspark_tpu_torch.utils import metrics
from tensorflowonspark_tpu_torch.utils import train as train_utils
from tensorflowonspark_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeSpec,
)

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# bench.py's on-chip transformer: the only full-width config the repo runs
FULL = dict(vocab_size=16384, dim=1024, n_layers=8, n_heads=8, max_seq=2048)

# (B, S, H, D, causal, dtype, out atol); the first is the main path's full
# prompt bucket, the one the kernels line reports; the second holds the
# kernels at that shape in float32, where the tolerance is absolute
FLASH_CASES = [
    (8, 2048, 8, 128, True, torch.bfloat16, 2e-5),
    (8, 2048, 8, 128, True, torch.float32, 2e-5),
    (2, 96, 8, 128, False, torch.float32, 2e-5),   # tail masking
    (1, 1, 8, 128, True, torch.bfloat16, 2e-5),    # a one-token prompt
    (3, 300, 4, 64, True, torch.float32, 2e-5),    # head_dim 64
    # the bf16 twins of the tail cases, which reach the tensor-core
    # backward kernels, and a ragged causal sequence at full width
    (2, 96, 8, 128, False, torch.bfloat16, 2e-5),
    (3, 300, 4, 64, True, torch.bfloat16, 2e-5),
    (1, 1000, 8, 128, True, torch.bfloat16, 2e-5),
]
LSE_TOL = 1e-4
# Every kernel and its plain version compute in float32 from the same
# inputs and round each output once to the input dtype, so they differ by
# float32 summation order (~1e-6 of the terms) and, in bf16, by at most
# one rounding step of each element.  The check is per element,
# |got - ref| <= rtol*|ref| + atol:
# - bf16: rtol = 2^-7, one bf16 ulp of the element (bf16 keeps 8
#   significant bits, so an ulp is 2^-8..2^-7 of the value);
# - atol: the float32 tolerance of the same output, which covers the
#   summation-order noise and values that cancel to ~0 (the dq of a
#   one-token sequence, ds = p * (g.v - g.out) with out = v).
# Gradients: float32 at 2e-4 absolute, tests/test_ops.py's gradient
# tolerance.  Typical gradient elements are ~0.03 at the main shape
# (randn inputs, softmax scale 1/sqrt(D)), so a row whose gradient is lost
# or mis-scaled fails.
BF16_RTOL = 2.0 ** -7
BWD_F32_TOL = 2e-4
# ~1.1 ms at the H100's 1.755 GHz boost clock: longer than the host takes to
# enqueue any one timed call (time_ms)
SPIN_CYCLES = 2_000_000

TRAIN_BATCH, TRAIN_STEPS = 8, 5  # bench.py:920's batch; five Adam steps

# (shape, dtype, element offset of x in its buffer); the first is the
# transformer's activation, [8*2048, 1024], the one the kernels line
# reports.  Tails: dim 100 (bf16) and 97 (f32) are no multiple of a
# 16-byte vector, 900 / 903 / 7 rows no multiple of a CTA's 8; the f16
# input starts one element past a 16-byte boundary.  The main shapes take
# the kernel's registers path, the tails its two-pass scalar path.
RMS_CASES = [
    ((8, 2048, 1024), torch.bfloat16, 0),
    ((8, 2048, 1024), torch.float32, 0),
    ((3, 300, 100), torch.bfloat16, 0),
    ((3, 301, 97), torch.float32, 0),
    ((7, 64), torch.float16, 1),
]
# Kernel and plain version compute in float32 from the same inputs and
# round once: per element, one ulp of the output type (2^-7 of |ref| in
# bf16, 2^-10 in f16) plus 1e-5, or 1e-5 + 1e-5*|ref| in float32 (rsqrt
# and summation order).
RMS_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 1e-5}
RMS_ATOL = 1e-5
# the SPARK-fed losses against the in-process ones: the same kernels on
# the same batches, but bf16 embedding gradients are summed with atomics
# in no fixed order
SPARK_LOSS_RTOL = 1e-3

# ResNet-50 at the JAX package's north-star shape: 1000 classes, 224x224x3
# uint8 images, batch 256, SGD(0.1, momentum 0.9)
# (examples/resnet/resnet_imagenet_spark.py's defaults, bench.py's on-chip
# shape and optimizer); bf16 compute, f32 masters and BN statistics
RESNET = dict(depth=50, num_classes=1000, image=224, batch=256, lr=0.1)
RESNET_WARMUP, RESNET_STEPS = 2, 6   # in process: untimed, then timed
SPARK_RESNET_STEPS = 6               # SPARK-fed: the first six of those
# bn_fused=False computes the same forward op for op, so the first step's
# loss agrees but for cuDNN's own run-to-run order
RESNET_FUSED_RTOL = 1e-5
# stem_s2d against the 7x7 stem, max |difference| over max |logit|.  The
# two stems sum the same products in another order; in bf16 each conv
# output is then one rounding apart in some elements, and that spreads
# through 53 layers, each renormalised by BN: 2e-2 of the largest logit
# (2.8e-3 on the H100; a wrong fold of the kernel or the input moves
# logits by O(1) of it).  float32: 1e-4.
RESNET_S2D_BF16_RTOL = 2e-2
RESNET_S2D_F32_RTOL = 1e-4
# one float32 step on the card against the CPU: max |difference| over each
# tensor's largest value
RESNET_EXACT = dict(batch=4, image=64)
RESNET_EXACT_RTOL = 1e-3


def ptxas_report(log):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def sass_mma_counts(lib_path):
    """{kernel symbol: tensor-core MMA instructions (HMMA)} in the SASS of
    a built kernel library, read with the toolkit's ``cuobjdump``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


# kernel library -> the flash kernels in it
TC_LIBS = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_dq", "flash_dkv")}


def check_tc_build():
    """Every bf16 flash kernel issues tensor-core MMAs and spills nothing
    at head_dim 64 and 128 (as ``ptxas`` reported when this process built
    it); the float32 ones are FMA kernels.  Prints a ``flash_fwd build``
    and a ``flash_bwd build`` line; returns {kernel: {head_dim:
    {registers, hmma, ...}}} for the bf16 kernels, the forward's with the
    shared memory, local bytes and CTAs an SM that the card reports."""
    out = {}
    for lib, names in TC_LIBS.items():
        regs = ptxas_report(_build.build_log.get(lib, ""))
        mmas = sass_mma_counts(_build._lib_path(lib))
        found = {n: {} for n in names}
        for fn, n_mma in mmas.items():
            name = next((n for n in names if n in fn), None)
            if name is None:
                continue
            tc = "_tc_kernel" in fn
            if tc != (n_mma > 0):
                raise AssertionError(f"{fn}: {n_mma} HMMA instructions")
            if tc:
                d = "128" if "Li128E" in fn else "64"
                r, st, ld = regs.get(fn, (None, None, None))
                if st or ld:
                    raise AssertionError(f"{fn} spills: {st} bytes stored, "
                                         f"{ld} loaded")
                found[name][d] = dict(registers=r, hmma=n_mma)
        if not all(len(v) == 2 for v in found.values()):
            raise AssertionError(f"bf16 {lib} kernels not all found: "
                                 f"{found} in {sorted(mmas)}")
        out.update(found)
    for d, attrs in fwd_tc_attrs().items():
        out["flash_fwd"][d].update(attrs)
        if attrs["local_bytes"]:
            raise AssertionError(f"flash_fwd_tc_kernel<{d}> uses local "
                                 f"memory: {attrs}")
    print("flash_fwd build " + json.dumps(out["flash_fwd"]), flush=True)
    print("flash_bwd build " + json.dumps(
        {n: out[n] for n in TC_LIBS["flash_bwd"]}), flush=True)
    return out


def fwd_tc_attrs():
    """{head_dim: registers, dynamic shared memory, local bytes and CTAs
    an SM} of the bf16 forward kernel, as the card's runtime reports."""
    lib = attention._lib()
    fn = lib.tfos_flash_fwd_tc_attrs
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for d in attention.HEAD_DIMS:
        vals = (ctypes.c_int * 4)()
        err = fn(d, vals)
        if err:
            raise RuntimeError(f"tfos_flash_fwd_tc_attrs({d}) failed: "
                               f"{lib.tfos_cuda_error_string(err).decode()}")
        out[str(d)] = dict(zip(("runtime_registers", "shared_bytes",
                                "local_bytes", "ctas_per_sm"), vals))
    return out


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, queued=True):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up.
    ``queued``: each run waits on the card behind a device-side spin of
    ``SPIN_CYCLES``, so that the events time the device's work and not
    the host's enqueue of it (tens of microseconds of Python and ctypes a
    call, as long as the small kernels themselves); otherwise the events
    also span that enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def visible_pairs(sq, skv, causal):
    """(q, kv) pairs the causal or full mask leaves visible, per head."""
    if causal:
        return sum(min(i + 1, skv) for i in range(sq))
    return sq * skv


def bound_ms(flops, nbytes, dtype):
    """Least time for the card: the larger of ``flops`` over the dense
    peak for the dtype and ``nbytes`` over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound_ms(b, sq, skv, h, d, causal, dtype):
    """Forward: 2 matmuls of 2*D flops per visible (q, kv) pair; q, k, v
    read once, out and lse written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * b * h * d * (2 * sq + 2 * skv) + 4 * b * h * sq
    return bound_ms(4.0 * b * h * d * visible_pairs(sq, skv, causal), nbytes,
                    dtype)


def flash_bwd_bound_ms(kernel, b, sq, skv, h, d, causal, dtype):
    """Backward kernels.  dq: s, dp and dq, 3 products of 2*D flops per
    visible pair; dk/dv: s, dp, dv and dk, 4 products; the pair as one
    backward ("pair"): s, dp, dq, dk and dv, 5 products.  Bytes: q, k,
    v, g, lse and delta read once, the kernel's gradients written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    products, n_out = {"flash_dq": (3, sq), "flash_dkv": (4, 2 * skv),
                       "pair": (5, sq + 2 * skv)}[kernel]
    flops = 2.0 * products * b * h * d * visible_pairs(sq, skv, causal)
    nbytes = (esize * b * h * d * (2 * sq + 2 * skv + n_out)
              + 8 * b * h * sq)
    return bound_ms(flops, nbytes, dtype)


def phase_flash(dev):
    """Kernel against the plain version; returns the main case's row."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for b, s, h, d, causal, dtype, tol in FLASH_CASES:
        # q, k, v as strided views of a fused projection, as prefill has them
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / d ** 0.5
        out, lse = attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal=causal,
                                                       scale=scale)
        torch.cuda.synchronize()
        err, share = _close(out, ref, dtype, tol)
        lse_err = (lse - ref_lse).abs().max().item()
        if not (share <= 1.0 and lse_err <= LSE_TOL):
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at "
                f"{(b, s, h, d, causal, dtype)}: out err {err} ({share:.3g} "
                f"of the per-element tolerance, atol {tol}), lse err "
                f"{lse_err} (tol {LSE_TOL})")
        reps = 20 if s >= 1024 else 50
        def kernel():
            return attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)

        ms = time_ms(kernel, reps)
        ms_with_enqueue = time_ms(kernel, reps, queued=False)
        plain_ms = time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal, scale=scale), reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), reps)
        bound, bound_by = flash_bound_ms(b, s, s, h, d, causal, dtype)
        row = dict(shape=[b, s, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tol_share=share, lse_err=lse_err, ms=ms,
                   ms_with_enqueue=ms_with_enqueue, plain_ms=plain_ms,
                   bound_ms=bound,
                   bound_by=bound_by, library_ms=library_ms)
        print("flash_fwd case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def _close(got, ref, dtype, atol):
    """(max abs error, worst share of the per-element tolerance
    ``rtol*|ref| + atol``) of a kernel's output against its plain
    version; it passes where the share is at most 1."""
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    ref = ref.float()
    diff = (got.float() - ref).abs()
    share = (diff / (rtol * ref.abs() + atol)).max().item()
    return diff.max().item(), share


def phase_flash_bwd(dev):
    """dq and dk/dv kernels against ``flash_backward_plain``; returns the
    main case's row."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for b, s, h, d, causal, dtype, _ in FLASH_CASES:
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = torch.randn((b, s, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        scale = 1.0 / d ** 0.5
        out, lse = attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)
        got = attention._flash_backward_cuda(q, k, v, out, lse, g,
                                             causal=causal, scale=scale)
        ref = attention.flash_backward_plain(q, k, v, out, lse, g,
                                             causal=causal, scale=scale)
        torch.cuda.synchronize()
        errs = {}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err, share = _close(x, r, dtype, BWD_F32_TOL)
            if not (x.dtype == dtype and share <= 1.0):
                raise AssertionError(
                    f"flash backward {name} disagrees with the plain "
                    f"version at {(b, s, h, d, causal, dtype)}: err {err} "
                    f"({share:.3g} of the per-element tolerance), dtype "
                    f"{x.dtype}")
            errs[name] = (err, share)
        reps = 10 if s >= 1024 else 50
        gi, lse_i, delta = attention._bwd_inputs(q, k, v, out, lse, g)
        dq, dk, dv = (torch.empty_like(x) for x in got)
        common = dict(causal=causal, scale=scale)
        dq_ms = time_ms(lambda: attention._launch_bwd(
            "flash_dq", q, k, v, gi, lse_i, delta, dq, dq, **common), reps)
        dkv_ms = time_ms(lambda: attention._launch_bwd(
            "flash_dkv", q, k, v, gi, lse_i, delta, dk, dv, **common), reps)
        plain_ms = time_ms(lambda: attention.flash_backward_plain(
            q, k, v, out, lse, g, **common), reps)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)
        gt = g.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True), reps)
        shape = (b, s, s, h, d, causal, dtype)
        dq_bound, dq_by = flash_bwd_bound_ms("flash_dq", *shape)
        dkv_bound, dkv_by = flash_bwd_bound_ms("flash_dkv", *shape)
        pair_bound, _ = flash_bwd_bound_ms("pair", *shape)
        row = dict(shape=[b, s, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""),
                   max_abs_err={n: e for n, (e, _) in errs.items()},
                   tol_share={n: t for n, (_, t) in errs.items()},
                   dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                   dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                   dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                   pair_bound_ms=pair_bound, library_ms=library_ms)
        print("flash_bwd case " + json.dumps(row), flush=True)
        rows.append(row)
        del qt, kt, vt, lib_out
    return rows[0]


def _rms_close(got, ref, dtype):
    """(max abs error, worst share of ``RMS_RTOL*|ref| + RMS_ATOL``)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    share = (diff / (RMS_RTOL[dtype] * ref.abs() + RMS_ATOL)).max().item()
    return diff.max().item(), share


def phase_rmsnorm(dev):
    """The RMSNorm kernel against ``rmsnorm_reference``, forward and
    gradient through ``fused_rmsnorm``; the entry point's path is one
    forward and backward at the main shape.  Returns the main case's
    row."""
    gen = torch.Generator(device=dev).manual_seed(99)
    rows = []
    for shape, dtype, offset in RMS_CASES:
        n = int(np.prod(shape))
        buf = torch.randn(n + offset, generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        x = buf[offset:].view(shape)
        dim = shape[-1]
        scale = (torch.randn(dim, generator=gen, device=dev) + 1.0)
        g = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        norm.launches = 0  # the entry point's path: one call
        xk = x.detach().requires_grad_()
        sk = scale.detach().requires_grad_()
        y = fused_rmsnorm(xk, sk)
        gx, gs = torch.autograd.grad(y, (xk, sk), g)
        path_launches = norm.launches
        # the wrapper's choice: x as given, y freshly allocated (aligned)
        path = norm.kernel_path(dim, x.element_size(),
                                x.data_ptr() % 16 == 0)
        xr = x.detach().requires_grad_()
        sr = scale.detach().requires_grad_()
        yr = norm.rmsnorm_reference(xr, sr)
        rgx, rgs = torch.autograd.grad(yr, (xr, sr), g)
        torch.cuda.synchronize()
        err, share = _rms_close(y, yr, dtype)
        gerr = max(_rms_close(gx, rgx, dtype)[1],
                   _rms_close(gs, rgs, torch.float32)[1])
        if not (y.dtype == dtype and share <= 1.0 and gerr <= 1.0
                and path_launches == 1):
            raise AssertionError(
                f"rmsnorm kernel disagrees with its plain version at "
                f"{shape} {dtype} (offset {offset}): out err {err} "
                f"({share:.3g} of the per-element tolerance), grad share "
                f"{gerr:.3g}, {path_launches} launches for one call")
        reps = 50 if n >= 1 << 20 else 100
        with torch.no_grad():
            def kernel():
                return norm._rmsnorm_cuda(x, scale, 1e-6, 256)

            ms = time_ms(kernel, reps)
            ms_with_enqueue = time_ms(kernel, reps, queued=False)
            plain_ms = time_ms(lambda: norm.rmsnorm_reference(x, scale),
                               reps)
            s_lib = scale.to(dtype)
            library_ms = time_ms(lambda: torch.nn.functional.rms_norm(
                x, (dim,), s_lib, 1e-6), reps)
        esize = x.element_size()
        bound, bound_by = bound_ms(4.0 * n, 2 * esize * n + 4 * dim,
                                   torch.float32)
        row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                   offset=offset, path=path, max_abs_err=err,
                   tol_share=share,
                   grad_tol_share=gerr, launches=path_launches, ms=ms,
                   ms_with_enqueue=ms_with_enqueue, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=library_ms)
        print("rmsnorm case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def _param_leaves(params):
    return [params["embed"], params["ln_f"], params["head"],
            *params["layers"].values()]


def _counts():
    return dict(flash_fwd=attention.launches,
                flash_dq=attention.dq_launches,
                flash_dkv=attention.dkv_launches)


def _reset_counts():
    attention.launches = attention.dq_launches = attention.dkv_launches = 0


def _grad_norm(leaves):
    return torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                          for p in leaves)).item()


def phase_train(dev, gpu):
    """Full-width bf16 training through the kernels: the blockwise-CE
    check on the initial params, five Adam steps, then the remat checks
    and a profiled rerun; returns the five steps' launch counts and
    summary."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    # bench.py's transformer lane: one seeded batch, trained on each step
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq)).astype(np.int64)
    items = TRAIN_BATCH * cfg.max_seq
    tm = metrics.TrainMetrics(
        flops_per_item=metrics.transformer_flops_per_token(cfg, causal=True),
        device=dev)

    def step(toks, **kw):
        loss = T.loss_fn(params, toks, cfg, **kw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        return loss

    toks = torch.from_numpy(tokens).to(dev)

    def check(name, **kw):
        """One forward and backward, no optimizer step: loss, gradient
        norm and launches."""
        _reset_counts()
        loss = step(toks, **kw).item()
        out = dict(loss=loss, grad_norm=_grad_norm(leaves),
                   launches=_counts())
        opt.zero_grad(set_to_none=True)
        checks[name] = out
        return out

    # blockwise against dense CE on the initial params.  The dense CE
    # rounds each logit to bf16 (unbiased, up to 2^-8 relative), the
    # blockwise one keeps them in f32; with a random head's logits those
    # roundings average out near 2e-6 of the loss over the batch's 16,376
    # positions, so 2e-5 holds while a wrong block, offset or mask moves
    # the loss by far more.  (After training on one batch the gold logits
    # grow, and so does their rounding.)
    checks = {}
    base0, blk = check("dense_init"), check(
        "blockwise_init", ce_impl="blockwise",
        ce_block=min(2048, cfg.vocab_size))
    if abs(blk["loss"] - base0["loss"]) > 2e-5 * abs(base0["loss"]):
        raise AssertionError(f"blockwise CE loss {blk['loss']} vs dense "
                             f"{base0['loss']} (rtol 2e-5)")

    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    _reset_counts()
    norm.launches = 0
    feed = iter(infeed.prefetch_to_device(
        (tokens for _ in range(TRAIN_STEPS)), depth=2, placement=dev))
    while True:
        # the host's wait for the next staged batch: TrainMetrics'
        # infeed_stall_frac.  The first wait precedes its first timed step.
        t_wait = time.perf_counter()
        batch = next(feed, None)
        if batch is None:
            break
        if losses:
            tm.infeed_wait(time.perf_counter() - t_wait)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(batch)
        opt.step()
        end.record()
        losses.append(loss.item())  # waits for the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        tm.step(items=items, loss=losses[-1])
    launches = _counts()
    if norm.launches:
        raise AssertionError(f"the transformer calls rmsnorm_reference; "
                             f"the RMSNorm kernel ran {norm.launches} times")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = cfg.n_layers * TRAIN_STEPS
    if launches != dict(flash_fwd=want, flash_dq=want, flash_dkv=want):
        raise AssertionError(f"launches {launches}, want {want} of each "
                             f"({cfg.n_layers} layers x {TRAIN_STEPS} "
                             f"steps)")
    med = statistics.median(step_ms)
    peak = metrics.peak_flops(dev)
    summary = dict(
        batch=TRAIN_BATCH, seq=cfg.max_seq, steps=TRAIN_STEPS,
        losses=losses, step_ms=step_ms, step_ms_median=med,
        tokens_per_s=items / (med / 1e3),
        mfu_median_step=(items / (med / 1e3) * tm.flops_per_item / peak
                         if peak else None),
        train_metrics=tm.report(), launches=launches, peak_mem_gb=peak_gb,
        gpu=gpu)
    print("train " + json.dumps(summary), flush=True)

    # one further step on the trained params, with and without remat
    base = check("dense")
    for name, mode in (("remat", True), ("dots", "dots")):
        c = check(name, remat=mode)
        # the same kernels on the same inputs: the recompute repeats the
        # forward exactly, so the loss agrees to float32 rounding; the
        # gradient norm to 1e-2, since bf16 embedding gradients are summed
        # with atomics in no fixed order
        if abs(c["loss"] - base["loss"]) > 1e-6 * abs(base["loss"]) or \
                abs(c["grad_norm"] - base["grad_norm"]) > \
                1e-2 * base["grad_norm"]:
            raise AssertionError(f"{name}: {c} vs no remat {base}")
        if c["launches"] != dict(flash_fwd=2 * cfg.n_layers,
                                 flash_dq=cfg.n_layers,
                                 flash_dkv=cfg.n_layers):
            raise AssertionError(f"{name} launches {c['launches']}")
    print("train checks " + json.dumps(checks), flush=True)

    # two more steps under the profiler: device time by kernel group and
    # the idle share of their wall (the profiler's overhead lengthens it)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(toks)
            opt.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print("train profile " + json.dumps(device_breakdown(prof, pwall)),
          flush=True)
    del params, leaves, opt, prof
    torch.cuda.empty_cache()
    return launches, summary


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def phase_spark_train(engine, gpu, train):
    """The main path: phase_train's five steps SPARK-fed through the
    port's cluster on ``engine``, a one-executor ``LocalEngine`` started
    with the script (its interpreter boots while the kernel phases run,
    so the boot time below is the cluster's).  ``train`` is
    phase_train's summary, whose losses this run must give."""
    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    n_layers = FULL["n_layers"]
    tokens = np.random.default_rng(0).integers(
        0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))
    # phase_train's batch as 8 records a step, 5 partitions of 8
    records = [tokens[i].astype(np.int32) for i in range(TRAIN_BATCH)] \
        * TRAIN_STEPS
    out_dir = tempfile.mkdtemp(prefix="tfos_spark_train_")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": cfg, "batch_size": TRAIN_BATCH, "seed": 0,
             "out_dir": out_dir},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        t_run = time.time() - t0
        c.train(engine.parallelize(records, TRAIN_STEPS), feed_timeout=600)
        fed = c.server.fed_partitions("input")
        c.shutdown()
        t_total = time.time() - t0
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
        orphan = _alive(report["pid"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses, ref = report["losses"], train["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    med = statistics.median(report["step_ms"])
    items = TRAIN_BATCH * FULL["max_seq"]
    summary = dict(
        losses=losses, phase_train_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        step_ms=report["step_ms"], step_ms_median=med,
        tokens_per_s=items / (med / 1e3),
        phase_train_step_ms_median=train["step_ms_median"],
        phase_train_tokens_per_s=train["tokens_per_s"],
        infeed_stall_frac=report["train_metrics"]["infeed_stall_frac"],
        phase_train_infeed_stall_frac=train["train_metrics"][
            "infeed_stall_frac"],
        feed_wait_s=report["feed_wait_s"],
        boot_s=report["first_step_wall"] - t0, cluster_run_s=t_run,
        main_start_s=report["main_start_wall"] - t0,
        joined_s=report["joined_wall"] - t0,
        model_ready_s=report["model_wall"] - t0,
        total_s=t_total, launches=report["launches"],
        records=report["records"], fed_partitions=fed,
        trainer_alive_after_shutdown=orphan, health=report["health"],
        cuda_visible_devices=report["cuda_visible_devices"],
        train_metrics=report["train_metrics"],
        peak_mem_gb=report["peak_mem_gb"], gpu=gpu)
    print("spark_train " + json.dumps(summary), flush=True)
    if len(losses) != TRAIN_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"SPARK-fed losses {losses} vs in-process "
                             f"{ref} (rtol {SPARK_LOSS_RTOL})")
    want = n_layers * TRAIN_STEPS
    if report["launches"] != dict(flash_fwd=want, flash_dq=want,
                                  flash_dkv=want):
        raise AssertionError(f"trainer launches {report['launches']}, want "
                             f"{want} of each")
    if fed != list(range(TRAIN_STEPS)) or \
            report["records"] != TRAIN_BATCH * TRAIN_STEPS:
        raise AssertionError(f"fed partitions {fed}, records the trainer's "
                             f"DataFeed handed out {report['records']}")
    if orphan:
        raise AssertionError(f"trainer {report['pid']} alive after "
                             "shutdown")
    return report["launches"]


def phase_grad_exact(dev):
    """Float32 at full width, batch 2: loss and every gradient through the
    kernels against ``mha_reference`` attention under autograd."""
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    ref_cfg = T.Config(**FULL, dtype="float32", attn_impl="reference")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, cfg.max_seq))).to(dev)
    runs = {}
    for name, c in (("flash", cfg), ("reference", ref_cfg)):
        _reset_counts()
        loss = T.loss_fn(params, toks, c)
        grads = torch.autograd.grad(loss, leaves)
        runs[name] = (loss.item(), grads, _counts())
    loss, grads, launches = runs["flash"]
    ref_loss, ref_grads, ref_launches = runs["reference"]
    if launches != dict(flash_fwd=cfg.n_layers, flash_dq=cfg.n_layers,
                        flash_dkv=cfg.n_layers) or any(ref_launches.values()):
        raise AssertionError(f"launches: flash {launches}, reference "
                             f"{ref_launches}")
    # both runs are float32 end to end (no TF32) and differ only in the
    # order of the attention sums, ~1e-6 relative per layer; 1e-3 of each
    # tensor's largest gradient leaves room for 8 layers of that, while a
    # masking or indexing fault moves gradients by O(1) of their size
    names = ["embed", "ln_f", "head", *params["layers"]]
    worst = {}
    for name, gk, gr in zip(names, grads, ref_grads):
        scale = gr.abs().max().item()
        err = (gk - gr).abs().max().item()
        worst[name] = err / scale
        if not (torch.isfinite(gk).all() and err <= 1e-3 * scale):
            raise AssertionError(f"grad {name}: max err {err}, largest "
                                 f"reference gradient {scale}")
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
        raise AssertionError(f"loss {loss} vs reference {ref_loss}")
    print("exact float32 grads " + json.dumps(dict(
        loss=loss, ref_loss=ref_loss, rel_err_by_param=worst,
        launches=launches)), flush=True)
    del params, leaves, grads, ref_grads, runs
    torch.cuda.empty_cache()


def run_engine(params, spec, jobs, dev, timeout):
    """Submit ``jobs`` = [(sid, prompt)] to a fresh engine on the card and
    wait for all; any error emission or init error raises.  Returns
    (done {sid: tokens}, streamed {sid: [(index, token)]}, first-token
    times {sid: s}, wall seconds, stats, engine)."""
    lock = threading.Lock()
    done, errors = {}, {}
    streamed = {sid: [] for sid, _ in jobs}
    first = {}
    t_submit = {}

    def emit(kind, sid, *rest):
        now = time.perf_counter()
        with lock:
            if kind == "token":
                streamed[sid].append(tuple(int(x) for x in rest))
                if rest[0] == 0:
                    first[sid] = now - t_submit[sid]
            elif kind == "done":
                done[sid] = [int(t) for t in rest[0]]
            else:
                errors[sid] = rest[0]

    eng = DecodeEngine(params, spec, emit, device=dev)
    eng.start(timeout=600)
    try:
        t0 = time.perf_counter()
        for sid, prompt in jobs:
            with lock:
                t_submit[sid] = time.perf_counter()
            eng.submit(sid, prompt)
        deadline = time.time() + timeout
        while time.time() < deadline:
            with lock:
                if errors or len(done) == len(jobs):
                    break
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    if errors:
        raise AssertionError(f"engine emitted errors: {errors}")
    if len(done) != len(jobs):
        raise AssertionError(f"only {len(done)}/{len(jobs)} sessions done "
                             f"within {timeout}s")
    return done, streamed, first, wall, stats, eng


def _transformer_group(name):
    """Kernel group of a transformer step's device event."""
    low = name.lower()
    return ("flash_fwd" if "flash_fwd" in low else
            "flash_dq" if "flash_dq" in low else
            "flash_dkv" if "flash_dkv" in low else
            "memcpy" if "memcpy" in low else
            "matmul" if any(w in low for w in ("gemm", "nvjet", "cutlass",
                                               "cublas"))
            else "softmax" if "softmax" in low else
            "optimizer" if any(w in low for w in ("adam", "multi_tensor"))
            else "index/gather/scatter" if any(
                w in low for w in ("index", "gather", "scatter"))
            else "other")


def device_breakdown(prof, wall_s, classify=_transformer_group, top=8):
    """Device time of a profiled run: busy time (union of kernel and copy
    intervals), the idle share of ``wall_s``, and time by kernel group
    (``classify(kernel name) -> group``)."""
    spans, groups, names = [], collections.Counter(), collections.Counter()
    for e in prof.events():
        # device-side ranges of record_function annotations (such as
        # "Optimizer.step#Adam.step") span kernels counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name
        groups[classify(name)] += (t1 - t0) / 1e3
        names[name[:90]] += (t1 - t0) / 1e3
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    busy_ms = busy / 1e3
    return dict(wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall_s),
                device_events=len(spans),
                groups_ms=dict(groups.most_common()),
                top_kernels_ms=names.most_common(top))


def phase_serving(dev, gpu):
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for p in params["layers"].values())
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=32)
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=512).tolist()
    jobs = []
    for i in range(16):
        n = int(rng.integers(64, 1536 + 1))
        if i % 2 == 0:   # 8 sessions share a 512-token system prompt
            n = max(n, 512 + 16)
            prompt = system + rng.integers(1, cfg.vocab_size,
                                           size=n - 512).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size, size=n).tolist()
        jobs.append((f"s{i:02d}", prompt))
    attention.launches = 0
    done, streamed, first, wall, stats, eng = run_engine(
        params, spec, jobs, dev, timeout=600)
    launches = attention.launches
    for sid, prompt in jobs:
        toks = done[sid]
        if [i for i, _ in streamed[sid]] != list(range(32)):
            raise AssertionError(f"{sid}: streamed indices "
                                 f"{[i for i, _ in streamed[sid]]}")
        if [t for _, t in streamed[sid]] != toks or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{sid}: bad tokens {toks}")
    cache = eng._cache
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {stats}")
    if cache.occupancy != 0 or cache.leaked_blocks() != []:
        raise AssertionError(f"cache not drained: occupancy "
                             f"{cache.occupancy}, leaked "
                             f"{cache.leaked_blocks()}")
    plain_prefills = stats["prefills"] - stats["extends"]
    if launches < cfg.n_layers * plain_prefills or launches == 0:
        raise AssertionError(f"flash kernel launched {launches} times for "
                             f"{plain_prefills} plain prefills x "
                             f"{cfg.n_layers} layers")
    ttft = sorted(first.values())
    summary = dict(
        params=n_params, sessions=len(jobs), tokens=32 * len(jobs),
        ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
        ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
        tokens_per_s=32 * len(jobs) / wall, wall_s=wall,
        prefills=stats["prefills"], extends=stats["extends"],
        prefix_hits=stats["prefix_hits"],
        prefix_tokens_saved=stats["prefix_tokens_saved"],
        iterations=stats["iterations"], flash_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, gpu=gpu)
    print("serving " + json.dumps(summary), flush=True)
    # the same traffic once more under the profiler: where the device time
    # goes and how much of the wall the device sits idle (the profiler's
    # own overhead lengthens this wall)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, _, pwall, _, _ = run_engine(params, spec, jobs, dev,
                                          timeout=600)
    print("serving profile " + json.dumps(device_breakdown(prof, pwall)),
          flush=True)
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_exact(dev):
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=16)
    rng = np.random.default_rng(1)
    jobs = [(f"x{n}", rng.integers(1, cfg.vocab_size, size=n).tolist())
            for n in (40, 300, 1100)]
    before = attention.launches
    done, _, _, _, _, _ = run_engine(params, spec, jobs, dev, timeout=600)
    if attention.launches == before:
        raise AssertionError("float32 engine run never launched the kernel")
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    for sid, prompt in jobs:
        ref = T.greedy_decode_reference(params, prompt, cfg, max_tokens=16,
                                        attn_fn=ref_attn)
        if done[sid] != ref:
            raise AssertionError(f"{sid}: engine {done[sid]} != "
                                 f"reference {ref}")
    print(f"exact float32: {len(jobs)} prompts x 16 greedy tokens equal the "
          "full-recompute reference", flush=True)


# -- ResNet-50 ----------------------------------------------------------------

def _resnet_batch():
    """The in-process phase's batch: ``RESNET["batch"]`` seeded uint8
    NHWC images and labels (numpy seed 0, as bench.py seeds its batch)."""
    rng = np.random.default_rng(0)
    b, side = RESNET["batch"], RESNET["image"]
    images = rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)
    labels = rng.integers(0, RESNET["num_classes"], b).astype(np.int64)
    return images, labels


def _resnet_net(dev, seed=0, bn_fused=True):
    params, state = resnet.init(
        torch.Generator(device=dev).manual_seed(seed), depth=RESNET["depth"],
        num_classes=RESNET["num_classes"], device=dev)
    leaves = [p.requires_grad_() for p in resnet.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=RESNET["lr"], momentum=0.9)
    step = resnet.make_train_step(opt, depth=RESNET["depth"],
                                  bn_fused=bn_fused)
    return params, state, step


def _rel_max(got, ref):
    """max |got - ref| over max |ref| (float64 on the host)."""
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def _resnet_group(name):
    """Kernel group of a ResNet step's device event."""
    low = name.lower()
    if "dgrad" in low:
        return "conv dgrad"
    if "wgrad" in low:
        return "conv wgrad"
    if "fprop" in low or "convolve" in low or "conv2d" in low:
        return "conv forward"
    if any(w in low for w in ("xmma", "cudnn", "cutlass", "implicit_gemm",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv other (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "cublas")):
        # cuDNN runs many 1x1 convolutions as plain GEMMs
        return "GEMM (1x1 convs, fc)"
    if "reduce" in low:
        return "BN statistics and reductions"
    if "max_pool" in low or "maxpool" in low:
        return "max pool"
    if any(w in low for w in ("multi_tensor", "sgd", "foreach")):
        return "optimizer"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "copy" in low:
        return "copies (dtype casts, layouts)"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise (BN apply, ReLU, adds, gates)"
    return "other"


def phase_resnet(dev, gpu):
    """ResNet-50 in process at the north-star shape (bf16 compute, f32
    masters and BN statistics, SGD(0.1, momentum 0.9)): one unfused-BN
    step for its loss and peak memory, then warm-up and timed fused
    steps on one seeded batch, the stem and state gates, and a profiled
    rerun.  Returns the summary (its ``losses`` are every step's)."""
    images_np, labels_np = _resnet_batch()
    images = torch.from_numpy(images_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    b = RESNET["batch"]
    flops_img = 3 * resnet.flops_per_image(RESNET["depth"], RESNET["image"])
    _reset_counts()
    norm.launches = 0

    # bn_fused=False: autograd over the same forward; the first step's
    # loss must equal the fused path's, which saves only x per BN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, state, step = _resnet_net(dev, bn_fused=False)
    loss_unfused = step(params, state, images, labels)[0].item()
    peak_unfused = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state, step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    params, state, step = _resnet_net(dev)
    losses, step_ms = [], []
    for _ in range(RESNET_WARMUP + RESNET_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, acc, state = step(params, state, images, labels)
        end.record()
        losses.append(loss.item())  # waits for the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_fused = torch.cuda.max_memory_allocated(dev) / 1e9
    timed = step_ms[RESNET_WARMUP:]
    med = statistics.median(timed)
    peak = metrics.peak_flops(dev)
    summary = dict(
        depth=RESNET["depth"], batch=b, image=RESNET["image"],
        dtype="bfloat16", warmup_steps=RESNET_WARMUP, losses=losses,
        step_ms=step_ms, step_ms_median=med, images_per_s=b / (med / 1e3),
        mfu_median_step=(b / (med / 1e3) * flops_img / peak
                         if peak else None),
        flops_per_image=flops_img, peak_mem_gb=peak_fused,
        peak_mem_gb_unfused_step=peak_unfused,
        first_loss_fused=losses[0], first_loss_unfused=loss_unfused,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        final_acc=float(acc), gpu=gpu)
    print("resnet " + json.dumps(summary), flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet losses {losses}")
    if abs(loss_unfused - losses[0]) > RESNET_FUSED_RTOL * abs(losses[0]):
        raise AssertionError(f"first-step loss: bn_fused=False "
                             f"{loss_unfused} vs fused {losses[0]} (rtol "
                             f"{RESNET_FUSED_RTOL})")
    for path, t in _leaf_items(state):
        init = 0.0 if path.endswith("mean") else 1.0
        if not (torch.isfinite(t).all() and (t != init).any()):
            raise AssertionError(f"BN running stat {path} not finite or "
                                 f"still at its initial {init}")

    # the space-to-depth stem against the 7x7/s2 SAME stem on the card,
    # on the trained params, training-mode BN over the batch
    checks = {}
    with torch.no_grad():
        for name, dtype, rtol in (("bfloat16", torch.bfloat16,
                                   RESNET_S2D_BF16_RTOL),
                                  ("float32", torch.float32,
                                   RESNET_S2D_F32_RTOL)):
            out = [resnet.apply(params, state, images, depth=RESNET["depth"],
                                compute_dtype=dtype, stem_s2d=s2d)[0]
                   for s2d in (True, False)]
            err = _rel_max(out[0], out[1])
            checks[f"s2d_vs_7x7_{name}"] = dict(rel_err=err, rtol=rtol)
            if not (torch.isfinite(out[0]).all() and err <= rtol):
                raise AssertionError(f"stem_s2d logits differ from the 7x7 "
                                     f"stem's in {name}: {err} (rtol "
                                     f"{rtol})")
    print("resnet checks " + json.dumps(checks), flush=True)

    # two more steps under the profiler: device time by kernel group and
    # the idle share of their wall (the profiler's overhead lengthens it)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(params, state, images, labels)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print("resnet profile " + json.dumps(
        device_breakdown(prof, pwall, _resnet_group, top=25)), flush=True)
    launches = _counts()
    launches["rmsnorm"] = norm.launches
    if any(launches.values()):
        raise AssertionError(f"ResNet launched a transformer kernel: "
                             f"{launches}")
    summary["launches"] = launches
    del params, state, step, prof
    torch.cuda.empty_cache()
    return summary


class _PinnedBranches:
    """Records the branches that ``layers.relu`` (1 above 0, 1/2 at 0, 0
    below) and ``layers.max_pool`` (each window's argmax) take on one run,
    and makes a second run take the same ones, counting where its own
    would differ.  The card's convolutions and the CPU's sum in other
    orders, so a ReLU input or a pooling window within float32 rounding
    of a tie can branch differently, and one such element moves every
    gradient upstream of it by up to O(1) of a small layer's; pinned,
    both runs differentiate the same function."""

    def __init__(self):
        self.relu_masks, self.pool_idx = [], []
        self.replay = False
        self.relu_differ = self.pool_differ = 0

    def relu(self, x):
        own = (x > 0).to(x.dtype) + 0.5 * (x == 0).to(x.dtype)
        if not self.replay:
            self.relu_masks.append(own.cpu())
            return layers._max0(x)
        m = self.relu_masks.pop(0).to(x.device)
        self.relu_differ += int((own != m).sum())
        return x * m

    def max_pool(self, x, window, stride, padding):
        # ResNet's stem pool: SAME
        w, st = layers._pair(window), layers._pair(stride)
        xp, _ = layers._pad_same(x, w, st, value=float("-inf"))
        y, idx = torch.nn.functional.max_pool2d(xp, w, st,
                                                return_indices=True)
        if not self.replay:
            self.pool_idx.append(idx.cpu())
            return y
        pinned = self.pool_idx.pop(0).to(x.device)
        self.pool_differ += int((pinned != idx).sum())
        return xp.flatten(2).gather(2, pinned.flatten(2)).view_as(y)


def phase_resnet_exact(dev):
    """One float32 step of ResNet-50 (TF32 off) at a small batch and image
    on the card against the same step on the CPU through the same code
    (``bn_fused=False``, whose ReLUs all go through ``layers.relu``, the
    CPU run taking the card's ReLU and pooling branches: see
    ``_PinnedBranches``): the loss, every gradient and the new BN
    state."""
    side, b = RESNET_EXACT["image"], RESNET_EXACT["batch"]
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, RESNET["num_classes"], b))
    params_cpu, state_cpu = resnet.init(
        torch.Generator().manual_seed(3), depth=RESNET["depth"],
        num_classes=RESNET["num_classes"], device="cpu")
    runs = {}
    pins = _PinnedBranches()
    real = layers.relu, layers.max_pool
    layers.relu, layers.max_pool = pins.relu, pins.max_pool
    try:
        for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            pins.replay = name == "cpu"
            runs[name] = _resnet_exact_run(params_cpu, state_cpu, images,
                                           labels, d)
    finally:
        layers.relu, layers.max_pool = real
    if pins.relu_masks or pins.pool_idx:
        raise AssertionError("the CPU run took another path than the "
                             "card's")
    (loss, grads, new_state), (rloss, rgrads, rstate) = runs["cuda"], \
        runs["cpu"]
    worst, worst_names = {}, {}
    for what, got, ref in (("grads", grads, rgrads),
                           ("state", new_state, rstate)):
        errs = sorted(((_rel_max(a, b), path) for (path, a), (_, b) in zip(
            _leaf_items(got), _leaf_items(ref))), reverse=True)
        worst[what] = errs[0][0]
        worst_names[what] = errs[:3]
    worst["loss"] = _rel_max(loss, rloss)
    print("resnet exact " + json.dumps(dict(
        batch=b, image=side, loss=loss.item(), cpu_loss=rloss.item(),
        rel_err=worst, worst_tensors=worst_names, rtol=RESNET_EXACT_RTOL,
        cpu_relu_branches_pinned=pins.relu_differ,
        cpu_pool_branches_pinned=pins.pool_differ)), flush=True)
    if not all(v <= RESNET_EXACT_RTOL for v in worst.values()):
        raise AssertionError(f"float32 ResNet step on the card vs the CPU: "
                             f"{worst} (rtol {RESNET_EXACT_RTOL})")


def _resnet_exact_run(params_cpu, state_cpu, images, labels, d):
    """(loss, grads, new state) of one float32 ResNet-50 step on ``d``,
    unfused BN."""
    # on the card through the JAX-layout round trip, which lays the conv
    # kernels out channels-last there
    params, state = resnet.params_from_jax(
        *resnet.params_to_jax(params_cpu, state_cpu), device=d)

    def loss_fn(p):
        logits, new_state = resnet.apply(
            p, state, images.to(d), depth=RESNET["depth"],
            compute_dtype=torch.float32, bn_fused=False)
        return layers.softmax_cross_entropy(logits, labels.to(d)), new_state

    (loss, new_state), grads = train_utils.value_and_grad(
        loss_fn, has_aux=True)(params)
    return loss, grads, new_state


def _leaf_items(tree, prefix=""):
    """(path, tensor) of a tree's leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def phase_spark_resnet(dev, engine, gpu, res):
    """The main path: ResNet-50 SPARK-fed through the port's cluster on
    ``engine``: phase_resnet's batch as ``RESNET["batch"]`` (uint8 image,
    label) records a step, ``SPARK_RESNET_STEPS`` steps, into
    ``resnet_imagenet_spark.main_fun``.  ``res`` is phase_resnet's
    summary, whose first losses this run must give."""
    images_np, labels_np = _resnet_batch()
    b = RESNET["batch"]
    records = [(images_np[i], int(labels_np[i])) for i in range(b)] \
        * SPARK_RESNET_STEPS
    tmp = tempfile.mkdtemp(prefix="tfos_spark_resnet_")
    model_dir = os.path.join(tmp, "model")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, resnet_imagenet_spark.main_fun,
            {"batch_size": b, "lr": RESNET["lr"], "image_size": RESNET["image"],
             "num_classes": RESNET["num_classes"], "model_dir": model_dir,
             "save_every": 10 ** 6, "seed": 0, "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        t_run = time.time() - t0
        c.train(engine.parallelize(records, SPARK_RESNET_STEPS),
                feed_timeout=600)
        fed = c.server.fed_partitions("input")
        c.shutdown()
        t_total = time.time() - t0
        with open(os.path.join(tmp, "resnet_imagenet-rank0.json")) as f:
            report = json.load(f)
        orphan = _alive(report["pid"])
        tree, saved = ckpt.restore_latest(os.path.join(model_dir, "ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses, ref = report["losses"], res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref)]
    med = statistics.median(report["step_ms"][1:])
    tm = report["train_metrics"]

    # the chief's checkpoint: HWIO kernels on disk, restored into the
    # port's params on the card, whose loss on the batch is the in-process
    # run's next step's
    kernels = {path: v.shape for path, v in _leaf_items(tree["params"])
               if v.ndim == 4}
    hwio = kernels.pop("stem/w") == (7, 7, 3, 64) and all(
        sh[0] == sh[1] in (1, 3) for sh in kernels.values())
    params, state, _ = _resnet_net(dev)
    resnet.restore_checkpoint_tree(tree, params, state,
                                   torch.optim.SGD(resnet.param_leaves(
                                       params), lr=RESNET["lr"]))
    with torch.no_grad():
        logits, _ = resnet.apply(params, state,
                                 torch.from_numpy(images_np).to(dev),
                                 depth=RESNET["depth"])
        restored_loss = layers.softmax_cross_entropy(
            logits, torch.from_numpy(labels_np).to(dev)).item()
    next_ref = res["losses"][SPARK_RESNET_STEPS]
    del params, state, logits
    torch.cuda.empty_cache()
    peak = metrics.peak_flops(dev)
    summary = dict(
        losses=losses, phase_resnet_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        # end to end: TrainMetrics over the timed steps, the trainer's
        # waits for its next batch included
        images_per_s=tm.get("items_per_sec"), mfu=tm.get("mfu"),
        step_ms=report["step_ms"], step_ms_median_after_first=med,
        device_step_images_per_s=b / (med / 1e3),
        device_step_mfu=(b / (med / 1e3) * res["flops_per_image"] / peak
                         if peak else None),
        train_metrics=tm, infeed_stall_frac=tm["infeed_stall_frac"],
        feed_wait_s=report["feed_wait_s"],
        boot_s=report["first_step_wall"] - t0, cluster_run_s=t_run,
        main_start_s=report["main_start_wall"] - t0,
        model_ready_s=report["model_wall"] - t0, total_s=t_total,
        records=report["records"], fed_partitions=fed,
        trainer_alive_after_shutdown=orphan, peak_mem_gb=report["peak_mem_gb"],
        checkpoint_step=saved, checkpoint_hwio=hwio,
        restored_loss=restored_loss, phase_resnet_next_loss=next_ref,
        phase_resnet_images_per_s=res["images_per_s"],
        pickled_mb_per_step=b * images_np[0].nbytes / 1e6,
        cuda_visible_devices=report["cuda_visible_devices"], gpu=gpu)
    print("spark_resnet " + json.dumps(summary), flush=True)
    if len(losses) != SPARK_RESNET_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"SPARK-fed ResNet losses {losses} vs "
                             f"in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if fed != list(range(SPARK_RESNET_STEPS)) or \
            report["records"] != b * SPARK_RESNET_STEPS:
        raise AssertionError(f"fed partitions {fed}, records the trainer's "
                             f"DataFeed handed out {report['records']}")
    if orphan:
        raise AssertionError(f"trainer {report['pid']} alive after "
                             "shutdown")
    if saved != SPARK_RESNET_STEPS or not hwio or \
            abs(restored_loss - next_ref) > SPARK_LOSS_RTOL * abs(next_ref):
        raise AssertionError(
            f"chief checkpoint: step {saved}, HWIO {hwio}, loss of the "
            f"restored params {restored_loss} vs in-process {next_ref}")
    return summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    # float32 stays float32: no TF32 in matmuls or convolutions, and bf16
    # matmuls accumulate in float32 as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the SPARK-fed phase's executor: spawned now, so its interpreter's
    # start overlaps the kernel phases; stopped, with every child, below
    engine = LocalEngine(1)
    try:
        kernels = run_phases(dev, gpu, engine)
    finally:
        engine.stop()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(dev, gpu, engine):
    """Every phase in order; returns the kernels line's entries."""
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_log.items():
        for fn, (regs, st, ld) in ptxas_report(log).items():
            print(f"ptxas {name}: {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)
    tc_build = check_tc_build()

    fwd_case = phase_flash(dev)
    bwd_case = phase_flash_bwd(dev)
    rms_case = phase_rmsnorm(dev)
    launches, train = phase_train(dev, gpu)
    spark_launches = phase_spark_train(engine, gpu, train)
    phase_grad_exact(dev)
    phase_serving(dev, gpu)
    phase_exact(dev)
    res = phase_resnet(dev, gpu)
    phase_resnet_exact(dev)
    phase_spark_resnet(dev, engine, gpu, res)

    attn_src = "tensorflowonspark_tpu/ops/attention.py"
    bwd_src = "tensorflowonspark_tpu_torch/ops/csrc/flash_bwd.cu"
    # no plain or library call computes dq, or dk and dv, alone: both
    # backward rows set their kernel against one whole backward, and give
    # the pair's time and bound beside it
    whole_bwd = dict(
        plain_scope="whole backward (dq, dk, dv): flash_backward_plain",
        library_scope="whole backward (dq, dk, dv): SDPA's backward",
        pair_ms=bwd_case["dq_ms"] + bwd_case["dkv_ms"],
        pair_bound_ms=bwd_case["pair_bound_ms"])
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="tensorflowonspark_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces=f"{attn_src}:88", launches=launches["flash_fwd"],
             max_abs_err=fwd_case["max_abs_err"], ms=fwd_case["ms"],
             plain_ms=fwd_case["plain_ms"], bound_ms=fwd_case["bound_ms"],
             bound_by=fwd_case["bound_by"],
             library_ms=fwd_case["library_ms"],
             bf16_build=tc_build["flash_fwd"]),
        dict(name="flash_dq", route="cuda", source=bwd_src,
             replaces=f"{attn_src}:216", launches=launches["flash_dq"],
             max_abs_err=bwd_case["max_abs_err"]["dq"],
             ms=bwd_case["dq_ms"], plain_ms=bwd_case["plain_ms"],
             bound_ms=bwd_case["dq_bound_ms"],
             bound_by=bwd_case["dq_bound_by"],
             library_ms=bwd_case["library_ms"],
             bf16_build=tc_build["flash_dq"], **whole_bwd),
        dict(name="flash_dkv", route="cuda", source=bwd_src,
             replaces=f"{attn_src}:253", launches=launches["flash_dkv"],
             max_abs_err=max(bwd_case["max_abs_err"]["dk"],
                             bwd_case["max_abs_err"]["dv"]),
             ms=bwd_case["dkv_ms"], plain_ms=bwd_case["plain_ms"],
             bound_ms=bwd_case["dkv_bound_ms"],
             bound_by=bwd_case["dkv_bound_by"],
             library_ms=bwd_case["library_ms"],
             bf16_build=tc_build["flash_dkv"], **whole_bwd),
        dict(name="rmsnorm", route="cuda",
             source="tensorflowonspark_tpu_torch/ops/csrc/rmsnorm.cu",
             replaces="tensorflowonspark_tpu/ops/norm.py:24",
             launches=rms_case["launches"], launches_train_path=0,
             launches_scope="one call of fused_rmsnorm, forward and "
                            "backward (no model calls it)",
             max_abs_err=rms_case["max_abs_err"], ms=rms_case["ms"],
             plain_ms=rms_case["plain_ms"], bound_ms=rms_case["bound_ms"],
             bound_by=rms_case["bound_by"],
             library_ms=rms_case["library_ms"]),
    ]
    for k in kernels[:3]:
        k["launches_spark_train"] = spark_launches[k["name"]]
    for k in kernels:
        k["launches_resnet"] = res["launches"][k["name"]]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
