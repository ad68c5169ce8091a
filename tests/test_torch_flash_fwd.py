"""PyTorch port: the numerical design of the bf16 and float16 tensor-core
flash forward (``ops/csrc/flash_fwd.cu``, ``flash_fwd_tc_kernel``),
emulated on the CPU.

No kernel runs here, but the rounding the kernel applies can: bf16
operands, ``S = q kᵀ`` in f32 (bf16 x bf16 products are exact in f32)
scaled after the product, the online softmax over 64-column kv blocks
(running max in log2 units, rescale of ``l`` and the f32 accumulator once
a block), ``p`` entering ``p v`` as a bf16 hi/lo pair (``hi = bf16(p)``,
``lo = bf16(p − hi)``), ``l`` summed from the f32 ``p``, and the output
rounded once to bf16.  That arithmetic is held to the per-element check
chip_smoke.py holds the kernel to on the card, ``|got − ref| ≤
2⁻⁷·|ref| + 2e-5`` against ``flash_attention_plain``, and to ``LSE_TOL``
on the lse; before the output rounding, to half of that check.
Rounding ``p`` once to bf16 instead, as FlashAttention does, is what the
split avoids: its share is printed beside
(``pytest -s tests/test_torch_flash_fwd.py``).  The plain version itself
is held against the JAX Pallas forward (interpret mode) at the same shape.
The float16 kernel is the same arithmetic in fp16 (``p``'s pair fp16,
subnormals and all), held at head_dims 80 and 256 to the fp16 rows' check,
``|got − ref| ≤ 2⁻¹⁰·|ref| + 2e-5``.
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
BLOCK_KV = 64  # the kernel's kv tile
# chip_smoke.py's per-element check of the bf16 forward: one bf16 ulp of
# the element (BF16_RTOL) plus the float32 tolerance of the output (the
# FLASH_CASES atol), and its lse tolerance; F16_RTOL its fp16 rows' ulp
BF16_RTOL, OUT_ATOL, LSE_TOL = 2.0 ** -7, 2e-5, 1e-4
F16_RTOL = 2.0 ** -10


def _bf16_inputs(seed=0, shape=SHAPE, dtype=torch.bfloat16):
    """q, k, v: numpy-seeded standard normals rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(3)]


def _bf(x, dtype=torch.bfloat16):
    return x.to(dtype).float()


def _emulate(q, k, v, *, scale, split, round_out=True):
    """(out, lse) through the tensor-core kernel's arithmetic (causal) in
    q's dtype (bf16 or float16): ``split`` feeds p to ``p v`` as a hi/lo
    pair of that type, otherwise rounded once to it; ``round_out`` rounds
    out to it as the kernel stores it, otherwise it stays f32."""
    dtype = q.dtype
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))  # [B,H,S,D]
    n = q.shape[1]
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    s_all = qt @ kt.transpose(-1, -2)  # exact products, f32 sums
    qpos = torch.arange(n)[:, None]
    m2 = torch.full(s_all.shape[:-1], -1e30)
    l = torch.zeros(s_all.shape[:-1])
    acc = torch.zeros(qt.shape)
    for k0 in range(0, n, BLOCK_KV):
        s = s_all[..., k0:k0 + BLOCK_KV]
        kpos = torch.arange(k0, k0 + s.shape[-1])[None, :]
        visible = qpos >= kpos
        s = torch.where(visible, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m2, s.amax(-1) * c)
        alpha = torch.exp2(m2 - m_new)
        p = torch.where(visible, torch.exp2(s * c - m_new[..., None]),
                        torch.zeros(()))
        l = l * alpha + p.sum(-1)
        hi = _bf(p, dtype)
        parts = (hi, _bf(p - hi, dtype)) if split else (hi,)
        acc = acc * alpha[..., None] + sum(
            x @ vt[..., k0:k0 + BLOCK_KV, :] for x in parts)
        m2 = m_new
    denom = torch.clamp(l, min=1e-30)
    out = (acc / denom[..., None]).transpose(1, 2)
    lse = m2 * math.log(2.0) + torch.log(denom)
    return out.to(dtype if round_out else torch.float32), lse


def _share(got, ref, rtol=BF16_RTOL):
    """Worst share of the per-element tolerance (passes at <= 1)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    return (diff / (rtol * ref.abs() + OUT_ATOL)).max().item()


def test_bf16_forward_arithmetic_meets_the_chip_check_with_margin():
    """The emulated kernel meets chip_smoke.py's check on the bf16 output
    and its lse tolerance, and the error it adds before the output
    rounding takes at most half of that check.  (The margin is taken
    before the rounding: kernel and plain version each round an f32
    value once, so any difference at all can land them one bf16 ulp
    apart, up to a share of ~1 near a power of two.)"""
    q, k, v = _bf16_inputs()
    scale = 1.0 / math.sqrt(SHAPE[-1])
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                               scale=scale)
    # the plain version's f32 output before its output rounding
    ref32, _ = tattn.flash_attention_plain(
        *(x.float() for x in (q, k, v)), causal=True, scale=scale)
    shares, lse_err = {}, {}
    for split in (True, False):
        for round_out, want in ((True, ref), (False, ref32)):
            out, lse = _emulate(q, k, v, scale=scale, split=split,
                                round_out=round_out)
            shares[split, round_out] = _share(out, want)
            lse_err[split] = (lse - ref_lse).abs().max().item()
    print(f"tol_share at {SHAPE} causal bf16, bf16 output: hi/lo pair "
          f"{shares[True, True]:.3g}, single bf16 rounding "
          f"{shares[False, True]:.3g}; f32 before the output rounding: "
          f"hi/lo pair {shares[True, False]:.3g}, single bf16 rounding "
          f"{shares[False, False]:.3g}; lse err {lse_err[True]:.3g}")
    assert shares[True, True] <= 1.0, shares
    assert shares[True, False] <= 0.5, shares
    assert lse_err[True] <= LSE_TOL, lse_err


@pytest.mark.parametrize("head_dim", [80, 256])
def test_f16_forward_arithmetic_meets_the_chip_check_with_margin(head_dim):
    """The float16 kernel's arithmetic (fp16 operands, p's pair in fp16)
    at Pythia's and Gemma-2B's head_dims meets the check chip_smoke.py
    holds the fp16 rows to, one fp16 ulp (2^-10 of the element) plus
    2e-5, and the lse tolerance; before the output rounding, half of
    it."""
    shape = (1, 512, 2, head_dim)
    q, k, v = _bf16_inputs(3, shape, torch.float16)
    scale = 1.0 / math.sqrt(head_dim)
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=True,
                                               scale=scale)
    ref32, _ = tattn.flash_attention_plain(
        *(x.float() for x in (q, k, v)), causal=True, scale=scale)
    out, lse = _emulate(q, k, v, scale=scale, split=True)
    out32, _ = _emulate(q, k, v, scale=scale, split=True, round_out=False)
    one, _ = _emulate(q, k, v, scale=scale, split=False, round_out=False)
    shares = (_share(out, ref, F16_RTOL), _share(out32, ref32, F16_RTOL),
              _share(one, ref32, F16_RTOL))
    print(f"tol_share at {shape} causal f16: fp16 output {shares[0]:.3g}; "
          f"f32 before the output rounding: hi/lo pair {shares[1]:.3g}, "
          f"single fp16 rounding {shares[2]:.3g}")
    assert out.dtype == torch.float16
    assert shares[0] <= 1.0 and shares[1] <= 0.5, shares
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


def test_flash_attention_plain_matches_jax_pallas_at_the_design_shape():
    """``flash_attention_plain`` against the JAX package's Pallas forward
    (interpret mode, 64-row tiles) on the same bf16-valued inputs in
    float32: out at the float32 tolerance of the forward's check, lse at
    1e-5."""
    q, k, v = (x.float() for x in _bf16_inputs())
    scale = 1.0 / math.sqrt(SHAPE[-1])
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    ref, ref_lse = jattn._flash_forward(jq, jk, jv, causal=True, scale=scale,
                                        block_q=64, block_kv=64,
                                        interpret=True)
    out, lse = tattn.flash_attention_plain(q, k, v, causal=True, scale=scale)
    assert out.dtype == torch.float32 and out.shape == SHAPE
    assert lse.shape == (SHAPE[0], SHAPE[2], SHAPE[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5)
