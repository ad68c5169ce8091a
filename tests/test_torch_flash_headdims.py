"""PyTorch port: flash attention at every head_dim and in float16, against
the JAX package on the CPU.

The JAX ``flash_attention`` runs its Pallas forward in interpret mode, as
the JAX package's own tests run it on the CPU, and its XLA backward; the
port's ``flash_attention`` runs its plain versions there (the CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions).  Both get the same numpy-seeded inputs.  Also held here: the
head_dim padding the CUDA wrappers apply to a head_dim the kernels do not
run as it is (``attention.padded_head_dim``: the next built head_dim up to
256, the next multiple of the chunked kernels' 128 above), with the plain
versions, and what the wrappers' shape check takes, at any head_dim and
at more than 65,535 (batch, head) pairs.  These tests hold the plain
versions and the wrappers' logic; the kernels themselves are held only by
``chip_smoke.py`` on the card.

Tolerances, per element, ``|port − jax| ≤ rtol·|jax| + atol``: float32 at
atol 2e-5 (out) and 2e-4 (gradients), chip_smoke.py's float32 tolerances
(both sides compute in f32, in another order); bfloat16 and float16 add
one ulp of the element (rtol 2^-7 and 2^-10), since each side rounds its
f32 result once.  lse (f32 on both sides) at 1e-5.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_hygiene import module_hygiene  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu.ops import attention as jattn  # noqa: E402
from tensorflowonspark_tpu_torch import ops as tops  # noqa: E402
from tensorflowonspark_tpu_torch.ops import attention as tattn  # noqa: E402

RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
OUT_ATOL, GRAD_ATOL, LSE_ATOL = 2e-5, 2e-4, 1e-5


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got, ref, dtype, atol, name):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    bound = RTOL[dtype] * np.abs(ref) + atol
    share = float((np.abs(got - ref) / bound).max())
    assert share <= 1.0, (name, dtype, share, float(np.abs(got - ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", [16, 32, 80, 96, 256, 320, 512])
def test_flash_attention_matches_jax_at_head_dim(head_dim, causal, dtype):
    """out, lse and dq/dk/dv of the port's ``flash_attention`` equal the
    JAX package's at head_dim 16-512 in each dtype (320 and 512 are the
    chunked kernels', 320 padded to 384): two heads, a batch of one, 100
    positions (a tail past the 64-row tiles)."""
    shape = (1, 100, 2, head_dim)
    q, k, v, g = _inputs(head_dim + causal, shape)
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(getattr(torch, dtype)) for a in (jq, jk, jv, jg))

    def jfn(q, k, v):
        return jops.flash_attention(q, k, v, causal=causal, block_q=64,
                                    block_kv=64)

    ref, vjp = jax.vjp(jfn, jq, jk, jv)
    ref_grads = vjp(jg)
    tq, tk, tv = (x.requires_grad_() for x in (tq, tk, tv))
    out = tops.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                               block_kv=64)
    grads = torch.autograd.grad(out, (tq, tk, tv), tg)
    assert out.dtype == getattr(torch, dtype) and out.shape == shape
    _close(out.detach().float().numpy(), ref.astype(jnp.float32), dtype,
           OUT_ATOL, "out")
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert got.dtype == out.dtype
        _close(got.float().numpy(), want.astype(jnp.float32), dtype,
               GRAD_ATOL, name)
    scale = 1.0 / math.sqrt(head_dim)
    _, lse_ref = jattn._flash_forward(jq, jk, jv, causal=causal,
                                      scale=scale, block_q=64, block_kv=64,
                                      interpret=True)
    _, lse = tattn._flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                  causal=causal, scale=scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               atol=LSE_ATOL)


def test_kernel_head_dim_is_the_next_built_or_the_next_chunk_multiple():
    """Up to 256 the smallest built head_dim not below; above, the next
    multiple of the chunked kernels' 128 (every head_dim runs)."""
    assert tattn.CHUNK == 128
    want = {1: 32, 24: 32, 72: 80, 80: 80, 200: 256, 256: 256, 257: 384,
            320: 384, 384: 384, 400: 512, 512: 512, 513: 640, 1024: 1024}
    assert {d: tattn.kernel_head_dim(d) for d in want} == want


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", [24, 72, 100, 200, 300, 400])
def test_padded_head_dim_equals_the_unpadded_attention(head_dim, causal):
    """Attention zero-padded along head_dim to the head_dim the kernels
    run (the next built one up to 256, the next multiple of 128 above)
    and sliced back, at the unpadded head_dim's scale, gives the unpadded
    plain attention: out and lse forward, dq, dk and dv backward, to
    float32 summation order: 1e-6 up to 256, 4e-6 above, where each
    score sums 300-512 products and the two orders part by up to 1.4e-6
    (measured at 400)."""
    atol = 1e-6 if head_dim <= 256 else 4e-6
    shape = (2, 70, 3, head_dim)
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(head_dim, shape))
    scale = 1.0 / math.sqrt(head_dim)
    padded = tattn.kernel_head_dim(head_dim)
    assert padded > head_dim
    seen = []

    def plain_fwd(q, k, v):
        seen.append(q.shape[-1])
        return tattn.flash_attention_plain(q, k, v, causal=causal,
                                           scale=scale)

    out, lse = tattn.padded_head_dim(plain_fwd, 1, q, k, v)
    ref, ref_lse = tattn.flash_attention_plain(q, k, v, causal=causal,
                                               scale=scale)
    assert seen == [padded] and out.shape == shape
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=atol)
    bwd = functools.partial(tattn.flash_backward_plain, causal=causal,
                            scale=scale)
    grads = tattn.padded_head_dim(bwd, 3, q, k, v, out, lse, g)
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               bwd(q, k, v, ref, ref_lse, g)):
        assert got.shape == shape, name
        torch.testing.assert_close(got, want, rtol=0, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("head_dim", [80, 512])
def test_padded_head_dim_passes_a_built_head_dim_through(head_dim):
    calls = []
    q = torch.zeros((1, 4, 1, head_dim))
    assert tattn.padded_head_dim(lambda *t: calls.append(t) or ("x",), 1,
                                 q, q, q) == ("x",)
    assert calls[0][0] is q


@pytest.mark.parametrize("head_dim,dtype,match", [
    (1, torch.float16, None),
    (72, torch.bfloat16, None),
    (256, torch.float32, None),
    (257, torch.bfloat16, None),
    (1024, torch.float16, None),
    (0, torch.bfloat16, "head_dim 1 or more"),
    (64, torch.float64, "float32, bfloat16 or float16"),
])
def test_check_shapes_takes_head_dims_to_256_and_float16(head_dim, dtype,
                                                         match):
    """The wrappers' shape check takes every head_dim from 1 (above 256
    too: the chunked kernels) and float32, bfloat16 and float16, and
    names what it refuses: an empty head_dim, another dtype."""
    q = torch.zeros((1, 8, 2, head_dim), dtype=dtype)
    if match is None:
        tattn._check_shapes(q, q, q)
    else:
        with pytest.raises(ValueError, match=match):
            tattn._check_shapes(q, q, q)
        with pytest.raises(ValueError, match=match):
            tattn._flash_forward_cuda(q, q, q, causal=True, scale=0.1)


def test_more_than_65535_batch_heads_pass_the_check_and_match_jax():
    """B*H = 65,600 (16,400 prompts of 4 heads, as one batch inference
    of many short prompts gives): the wrappers' shape check takes it (the
    kernels put B*H on the grid's x, which has no 65,535 limit), and the
    plain forward the CPU runs equals the JAX ``mha_reference`` there, at
    a tiny sequence (float32 to 2e-5, chip_smoke.py's tolerance)."""
    shape = (16400, 3, 4, 16)
    q, k, v = _inputs(65600, shape, n=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tattn._check_shapes(tq, tk, tv)
    out, lse = tattn._flash_forward(tq, tk, tv, causal=False, scale=0.25)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=False, scale=0.25)
    assert out.shape == shape and lse.shape == (16400, 4, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=OUT_ATOL)
