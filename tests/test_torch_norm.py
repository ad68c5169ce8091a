"""PyTorch port, ``fused_rmsnorm``: forward and gradients against the JAX
package's ``fused_rmsnorm`` (its Pallas kernel in interpret mode, as
tests/test_ops.py runs it) on the same numpy inputs (CPU).

On the CPU the port's entry point runs the plain ``rmsnorm_reference``;
its CUDA kernel (``ops/csrc/rmsnorm.cu``) is held against that plain
version on the card by ``chip_smoke.py``.  Tolerances: float32 forward
and gradients ``atol`` 2e-5 (one f32 rounding of O(1) values, summed
over a 64-wide row, is ~1e-6); bfloat16 per element, one bf16 ulp of
the element (``2^-7 * |ref|``) plus 1e-5, since both sides compute in
f32 and round the output once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import ops as jops  # noqa: E402
from tensorflowonspark_tpu_torch import ops as tops  # noqa: E402
from tensorflowonspark_tpu_torch.ops import norm as tnorm  # noqa: E402

F32_TOL = 2e-5
BF16_RTOL = 2.0 ** -7


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    return x, scale


# (shape, block_rows): 51 and 900 rows are not multiples of block_rows;
# dim 33 is no multiple of a 16-byte vector (the kernel's scalar path)
@pytest.mark.parametrize("shape,block_rows", [
    ((3, 17, 64), 8),
    ((3, 300, 96), 256),
    ((5, 33), 16),
])
def test_fused_rmsnorm_f32_forward_and_grads_match_jax(shape, block_rows):
    x, scale = _inputs(shape)
    ref = jops.fused_rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                             block_rows=block_rows, interpret=True)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    got = tops.fused_rmsnorm(xt, st, block_rows=block_rows)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=F32_TOL)
    # the gradient of sum(y^2), through each package's custom backward
    gj = jax.grad(lambda a, s: jnp.sum(jops.fused_rmsnorm(
        a, s, block_rows=block_rows, interpret=True) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    got.pow(2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]),
                               atol=F32_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj[1]),
                               atol=F32_TOL * np.sqrt(x.size / shape[-1]))


@pytest.mark.parametrize("shape", [(2, 24, 128), (3, 19, 40)])
def test_fused_rmsnorm_bf16_matches_jax_per_element(shape):
    x, scale = _inputs(shape, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jops.fused_rmsnorm(xb, jnp.asarray(scale),
                                        block_rows=16, interpret=True),
                     np.float32)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got = tops.fused_rmsnorm(xt, torch.from_numpy(scale), block_rows=16)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= BF16_RTOL * np.abs(ref) + 1e-5).all(), diff.max()


def test_fused_rmsnorm_rejects_what_it_does_not_take():
    x = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tops.fused_rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="does not match"):
        tops.fused_rmsnorm(torch.zeros((2, 8)), torch.ones(7))
    with pytest.raises(ValueError, match="block_rows"):
        tops.fused_rmsnorm(torch.zeros((2, 8)), torch.ones(8), block_rows=0)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    """A CPU tensor never reaches the kernel (whose library cannot build
    here): the launch count stays 0, and a CPU tensor handed to the
    kernel's launcher is refused rather than run some other way."""
    before = tnorm.launches
    x, scale = _inputs((4, 32))
    y = tops.fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_array_equal(
        y.numpy(), tops.rmsnorm_reference(torch.from_numpy(x),
                                          torch.from_numpy(scale)).numpy())
    assert tnorm.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tnorm._rmsnorm_cuda(torch.from_numpy(x), torch.from_numpy(scale),
                            1e-6, 256)
