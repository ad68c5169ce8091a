"""PyTorch port: the numerical design of the bf16 and float16 flash
backward kernels (``ops/csrc/flash_bwd.cu``), emulated on the CPU.

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
The float16 kernels take fp16 operands, ``p``'s pair in fp16, and ``ds``'s
pair in bf16 against the other operand of its products (k, q) widened
exactly into a bf16 pair, three products (``hi·hi + hi·lo + lo·hi``):
held at head_dims 80 and 256 to the fp16 rows' check (``2⁻¹⁰·|ref| +
2e-4``), and, with g at a loss gradient's size (2⁻¹⁷), to the same check
scaled with it, which a ds pair in fp16 misses (printed beside).
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
# the element (BF16_RTOL) plus the float32 gradient tolerance (BWD_F32_TOL);
# F16_RTOL its fp16 rows' ulp
BF16_RTOL, BWD_F32_TOL = 2.0 ** -7, 2e-4
F16_RTOL = 2.0 ** -10


def _bf16_inputs(seed=0, shape=SHAPE, dtype=torch.bfloat16):
    """q, k, v, g: numpy-seeded standard normals rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _bf(x, dtype=torch.bfloat16):
    return x.to(dtype).float()


def _emulate(q, k, v, out, lse, g, *, scale, split, round_out=True,
             ds_pair=torch.bfloat16):
    """(dq, dk, dv) through the kernels' arithmetic (causal) in q's dtype:
    ``split`` feeds p and ds to the second products as hi/lo pairs (p's
    in q's dtype, ds's in ``ds_pair``), otherwise rounded once to q's
    dtype; ``round_out`` rounds the outputs to it as the kernels store
    them, otherwise they stay f32.  A ds pair in bf16 against fp16 k or
    q takes the kernels' three products with the fp16 operand widened
    exactly into a bf16 pair (lo·lo dropped)."""
    dtype = q.dtype
    qt, kt, vt, gt = (x.transpose(1, 2).float() for x in (q, k, v, g))
    delta = tattn._delta(g, out)
    s = qt @ kt.transpose(-1, -2) * scale
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = gt @ vt.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * scale

    def parts(x, pair):
        hi = _bf(x, pair)
        return (hi, _bf(x - hi, pair)) if split else (_bf(x, dtype),)

    def mm(a, b):  # the second products, summed in f32
        return sum(x @ b for x in a)

    def mm_ds(a, b):
        if not split or ds_pair == dtype:
            return mm(a, b)
        b_hi = _bf(b)  # fp16 b widened exactly: b == b_hi + (b - b_hi)
        return a[0] @ b_hi + a[0] @ (b - b_hi) + a[1] @ b_hi

    ds_parts = parts(ds, ds_pair)
    dq = mm_ds(ds_parts, kt)
    dk = mm_ds([x.transpose(-1, -2) for x in ds_parts], qt)
    dv = mm([x.transpose(-1, -2) for x in parts(p, dtype)], gt)
    out_dtype = dtype if round_out else torch.float32
    return [x.transpose(1, 2).to(out_dtype) for x in (dq, dk, dv)]


def _share(got, ref, rtol=BF16_RTOL, atol=BWD_F32_TOL):
    """Worst share of the per-element tolerance (passes at <= 1)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    return (diff / (rtol * ref.abs() + atol)).max().item()


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


def _f16_case(head_dim, g_scale, seed=5):
    """fp16 inputs at (1, 512, 2, head_dim) with g scaled by ``g_scale``;
    returns them with scale, out, lse and the plain gradients rounded to
    fp16 and in f32."""
    q, k, v, g = _bf16_inputs(seed, (1, 512, 2, head_dim), torch.float16)
    g = (g.float() * g_scale).to(torch.float16)
    scale = 1.0 / math.sqrt(head_dim)
    out, lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                           scale=scale)
    ref = tattn.flash_backward_plain(q, k, v, out, lse, g, causal=True,
                                     scale=scale)
    ref32 = tattn.flash_backward_plain(
        *(x.float() for x in (q, k, v, out)), lse, g.float(), causal=True,
        scale=scale)
    return (q, k, v, out, lse, g), scale, ref, ref32


def _shares(got, want, atol=BWD_F32_TOL):
    return {n: _share(x, r, F16_RTOL, atol)
            for n, x, r in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("head_dim", [80, 256])
def test_f16_kernel_arithmetic_meets_the_chip_check_with_margin(head_dim):
    """The float16 kernels' arithmetic at Pythia's and Gemma-2B's
    head_dims meets the check chip_smoke.py holds the fp16 rows to, one
    fp16 ulp (2^-10 of the element) plus 2e-4, and half of it before the
    output rounding."""
    args, scale, ref, ref32 = _f16_case(head_dim, 1.0)
    got = _emulate(*args, scale=scale, split=True)
    got32 = _emulate(*args, scale=scale, split=True, round_out=False)
    shares = (_shares(got, ref), _shares(got32, ref32))
    print(f"tol_share at head_dim {head_dim} causal f16: fp16 outputs "
          f"{shares[0]}; f32 before the output rounding {shares[1]}")
    assert all(x.dtype == torch.float16 for x in got)
    for n in ("dq", "dk", "dv"):
        assert shares[0][n] <= 1.0 and shares[1][n] <= 0.5, (n, shares)


def test_f16_ds_pair_in_bf16_holds_a_loss_sized_gradient():
    """With g at a loss gradient's size (2^-17: ds ~1e-6 and below, where
    fp16 keeps a few bits or none) the float16 kernels' f32 gradients
    still take at most half of the fp16 rows' check, its absolute part
    scaled with g, since ds's pair is bf16; a ds pair in fp16 misses it
    (its share is printed and must exceed 1: why the kernels widen k
    and q instead).  The fp16 outputs themselves are subnormal there."""
    g_scale = 2.0 ** -17
    args, scale, _, ref32 = _f16_case(80, g_scale)
    atol = BWD_F32_TOL * g_scale
    kernel = _shares(_emulate(*args, scale=scale, split=True,
                              round_out=False), ref32, atol)
    fp16_pair = _shares(_emulate(*args, scale=scale, split=True,
                                 round_out=False, ds_pair=torch.float16),
                        ref32, atol)
    print(f"tol_share, g x 2^-17: ds pair in bf16 {kernel}, in fp16 "
          f"{fp16_pair}")
    for n in ("dq", "dk", "dv"):
        assert kernel[n] <= 0.5, (n, kernel)
    assert fp16_pair["dq"] > 1 and fp16_pair["dk"] > 1, fp16_pair


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
