"""PyTorch port: the numerical design of the bf16 flash backward kernels
(``ops/csrc/flash_bwd.cu``), emulated on the CPU.

No kernel runs here, but the rounding the bf16 kernels apply can: bf16
operands, f32 first products (``q kᵀ``, ``g vᵀ``), ``p`` and ``ds`` formed
in f32 and entering the second products (``ds k``, ``pᵀ g``, ``dsᵀ q``) as
a bf16 hi/lo pair (``hi = bf16(x)``, ``lo = bf16(x − hi)``), the products
summed in f32 and each output rounded once to bf16.  That arithmetic is
held to the per-element check chip_smoke.py holds the kernels to on the
card, ``|got − ref| ≤ 2⁻⁷·|ref| + 2e-4`` against ``flash_backward_plain``,
and, before the output rounding, to half of it.  Rounding ``p`` and
``ds`` once to bf16 instead, as
FlashAttention does, is what the split avoids: its share is printed beside
(``pytest -s tests/test_torch_flash_bwd.py``).  The plain version itself is
held against the JAX Pallas backward (interpret mode) at the same shape.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.ops import attention as jattn  # noqa: E402
from tensorflowonspark_tpu_torch.ops import attention as tattn  # noqa: E402

SHAPE = (1, 512, 2, 128)  # (B, S, H, D), causal
# chip_smoke.py's per-element check of the bf16 backward: one bf16 ulp of
# the element (BF16_RTOL) plus the float32 gradient tolerance (BWD_F32_TOL)
BF16_RTOL, BWD_F32_TOL = 2.0 ** -7, 2e-4


def _bf16_inputs(seed=0):
    """q, k, v, g: numpy-seeded standard normals rounded to bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, k, v, out, lse, g, *, scale, split, round_out=True):
    """(dq, dk, dv) through the bf16 kernels' arithmetic (causal):
    ``split`` feeds p and ds to the second products as hi/lo pairs,
    otherwise rounded once to bf16; ``round_out`` rounds the outputs to
    bf16 as the kernels store them, otherwise they stay f32."""
    qt, kt, vt, gt = (x.transpose(1, 2).float() for x in (q, k, v, g))
    delta = tattn._delta(g, out)
    s = qt @ kt.transpose(-1, -2) * scale
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = gt @ vt.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale

    def parts(x):
        hi = _bf(x)
        return (hi, _bf(x - hi)) if split else (hi,)

    def mm(a, b):  # the second products, summed in f32
        return sum(x @ b for x in a)

    dq = mm(parts(ds), kt)
    dk = mm([x.transpose(-1, -2) for x in parts(ds)], qt)
    dv = mm([x.transpose(-1, -2) for x in parts(p)], gt)
    dtype = torch.bfloat16 if round_out else torch.float32
    return [x.transpose(1, 2).to(dtype) for x in (dq, dk, dv)]


def _share(got, ref):
    """Worst share of the per-element tolerance (passes at <= 1)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    return (diff / (BF16_RTOL * ref.abs() + BWD_F32_TOL)).max().item()


def test_bf16_kernel_arithmetic_meets_the_chip_check_with_margin():
    """The emulated kernels meet chip_smoke.py's check on the bf16
    outputs, and the error they add before the output rounding takes at
    most half of that tolerance.  (The margin is taken before the
    rounding: kernel and plain version each round an f32 value once, so
    any difference at all, even float32 summation order, can land them
    one bf16 ulp apart, up to a share of ~1 near a power of two.)"""
    q, k, v, g = _bf16_inputs()
    scale = 1.0 / math.sqrt(SHAPE[-1])
    out, lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                           scale=scale)
    ref = tattn.flash_backward_plain(q, k, v, out, lse, g, causal=True,
                                     scale=scale)
    # the plain version's f32 gradients before its output rounding
    ref32 = tattn.flash_backward_plain(
        *(x.float() for x in (q, k, v, out)), lse, g.float(), causal=True,
        scale=scale)
    shares = {}
    for split in (True, False):
        for round_out, want in ((True, ref), (False, ref32)):
            got = _emulate(q, k, v, out, lse, g, scale=scale, split=split,
                           round_out=round_out)
            shares[split, round_out] = {
                name: _share(x, r)
                for name, x, r in zip(("dq", "dk", "dv"), got, want)}
    print(f"tol_share at {SHAPE} causal bf16, bf16 outputs: hi/lo pair "
          f"{shares[True, True]}, single bf16 rounding {shares[False, True]}"
          f"; f32 before the output rounding: hi/lo pair "
          f"{shares[True, False]}, single bf16 rounding "
          f"{shares[False, False]}")
    for name in ("dq", "dk", "dv"):
        assert shares[True, True][name] <= 1.0, (name, shares)
        assert shares[True, False][name] <= 0.5, (name, shares)


def test_flash_backward_plain_matches_jax_pallas_at_the_design_shape():
    """``flash_backward_plain`` against the JAX package's Pallas backward
    (interpret mode, the kernels' 64-row tiles) on the same bf16-valued
    inputs in float32, at the float32 gradient tolerance."""
    q, k, v, g = (x.float() for x in _bf16_inputs())
    scale = 1.0 / math.sqrt(SHAPE[-1])
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal=True, scale=scale,
                                    block_q=64, block_kv=64, interpret=True)
    ref = jattn._flash_backward_pallas(
        jq, jk, jv, out, lse, jg, causal=True, scale=scale, block_q=64,
        block_kv=64, interpret=True)
    got = tattn.flash_backward_plain(
        q, k, v, torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)), g, causal=True, scale=scale)
    for r, t, name in zip(ref, got, ("dq", "dk", "dv")):
        assert t.dtype == torch.float32 and t.shape == SHAPE
        np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                   atol=BWD_F32_TOL, err_msg=name)
