"""PyTorch port, ``models/layers.py`` against the JAX package's on the
same seeded numpy inputs (CPU, float32): SAME and VALID convolutions and
max pooling at strides 1 and 2, the BatchNorm family (value, new state
and every gradient, through the state too, ``train`` and eval, ``fused``
both ways), ReLU's gradient at exact zeros, ``avg_pool_global``,
``layernorm`` and ``dense(precision="highest")``.

The port computes NCHW / OIHW; the JAX package NHWC / HWIO, so inputs
are transposed on the way in and results on the way out.

Tolerance: 1e-5 relative to each tensor's largest value (``RTOL``).
Both sides compute in float32 and differ in the order of their sums
(~1e-7 relative each); the worst measured here is 8.4e-7 (a BN scale
gradient).  A wrong SAME pad, a symmetric pad where XLA's is
asymmetric, a biased/unbiased variance mix-up or a tie gradient of 0
instead of 1/2 each move a value by far more.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.models import layers as JL  # noqa: E402
from tensorflowonspark_tpu_torch.models import layers as L  # noqa: E402

RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, ref, what, rtol=RTOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (what, err)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 4, 7])
def test_conv_matches_jax(k, stride, padding):
    """Odd and even sides (13 x 16): at stride 2 SAME pads unevenly
    (13 -> 7 by a 4x4 window pads (1, 2), 16 -> 8 by a 3x3 pads
    (0, 1))."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 13, 16, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = JL.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                  jnp.asarray(x), stride=stride, padding=padding)
    got = L.conv({"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                  "b": torch.from_numpy(b)}, _nchw(x), stride=stride,
                 padding=padding)
    _close(_nhwc(got), ref, f"conv k{k} s{stride} {padding}")


def test_same_pads_follow_xla():
    assert L.same_pads(56, 3, 2) == (0, 1)
    assert L.same_pads(224, 7, 2) == (2, 3)
    assert L.same_pads(112, 3, 2) == (0, 1)
    assert L.same_pads(56, 1, 2) == (0, 0)
    assert L.same_pads(32, 3, 1) == (1, 1)
    with pytest.raises(ValueError, match="padding"):
        L.conv({"w": torch.zeros((4, 3, 3, 3))}, torch.zeros((1, 3, 8, 8)),
               padding="FULL")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1), (2, 1)])
def test_max_pool_matches_jax(window, stride, padding):
    """Value and gradient; odd sides, and all-negative inputs so a pad
    that is not -inf would win a window."""
    rng = np.random.default_rng(window * 10 + stride)
    x = -np.abs(rng.standard_normal((2, 11, 12, 4))).astype(np.float32)
    g = rng.standard_normal(JL.max_pool(jnp.asarray(x), window, stride,
                                        padding).shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(JL.max_pool(x, window, stride, padding) * g)

    ref_dx = jax.grad(jloss)(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    y = L.max_pool(xt, window, stride, padding)
    (y * _nchw(g)).sum().backward()
    _close(_nhwc(y), JL.max_pool(jnp.asarray(x), window, stride, padding),
           "max_pool")
    _close(_nhwc(xt.grad), ref_dx, "max_pool grad")


def test_relu_tie_gradient_matches_jax():
    """``jnp.maximum(x, 0)``'s gradient at exactly 0 is 1/2; the port's
    relu must give the same (``torch.relu`` gives 0)."""
    x = np.array([0.0, 0.0, -1.5, 2.0, 0.0], np.float32)
    ref = jax.grad(lambda v: jnp.sum(JL.relu(v) * jnp.arange(1.0, 6.0)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (L.relu(xt) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(ref))
    np.testing.assert_array_equal(_np(xt.grad), [0.5, 1.0, 0.0, 4.0, 2.5])


# -- the BatchNorm family ----------------------------------------------------

C = 8


def _bn_case(kind):
    """(x, shortcut, params, state) as numpy NHWC with exact ties: scale
    and bias 0 on channel 3 (pre-activation exactly 0 everywhere there;
    for the add, the shortcut is 0 on it too), bias 6 on channel 5 for
    relu6 (exactly 6: its upper boundary)."""
    rng = np.random.default_rng({"bn": 0, "bn_relu": 1, "bn_relu6": 2,
                                 "bn_add_relu": 3}[kind])
    x = (rng.standard_normal((4, 5, 6, C)) * 2.0 + 0.7).astype(np.float32)
    sc = rng.standard_normal((4, 5, 6, C)).astype(np.float32)
    sc[..., 3] = 0.0
    scale = np.linspace(0.5, 2.0, C).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, C).astype(np.float32)
    scale[3] = bias[3] = 0.0
    if kind == "bn_relu6":
        scale[5], bias[5] = 0.0, 6.0
    state = {"mean": rng.standard_normal(C).astype(np.float32) * 0.1,
             "var": (rng.random(C) + 0.5).astype(np.float32)}
    return x, sc, {"scale": scale, "bias": bias}, state


def _jax_bn(kind, params, state, x, sc, train, fused):
    fn = {"bn": JL.batchnorm, "bn_relu": JL.batchnorm_relu,
          "bn_relu6": JL.batchnorm_relu6}.get(kind)
    if fn is None:
        return JL.batchnorm_add_relu(params, state, x, sc, train=train,
                                     fused=fused)
    return fn(params, state, x, train=train, fused=fused)


def _torch_bn(kind, params, state, x, sc, train, fused):
    fn = {"bn": L.batchnorm, "bn_relu": L.batchnorm_relu,
          "bn_relu6": L.batchnorm_relu6}.get(kind)
    if fn is None:
        return L.batchnorm_add_relu(params, state, x, sc, train=train,
                                    fused=fused)
    return fn(params, state, x, train=train, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["bn", "bn_relu", "bn_relu6",
                                  "bn_add_relu"])
def test_batchnorm_family_matches_jax(kind, train, fused):
    """Value, new state and the gradients for x, the shortcut, scale and
    bias of ``sum(tanh(y)·w) + sum(new_mean·u) + sum(new_var·v)``, so the
    cotangents reach the running statistics too."""
    x, sc, params, state = _bn_case(kind)
    rng = np.random.default_rng(9)
    w = rng.standard_normal(x.shape).astype(np.float32)
    u, v = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    jstate = {k: jnp.asarray(a) for k, a in state.items()}

    def jloss(p, x, sc):
        y, new = _jax_bn(kind, p, jstate, x, sc, train, fused)
        return (jnp.sum(jnp.tanh(y) * w) + jnp.sum(new["mean"] * u)
                + jnp.sum(new["var"] * v)), (y, new)

    (_, (ref_y, ref_new)), ref_g = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        {k: jnp.asarray(a) for k, a in params.items()}, jnp.asarray(x),
        jnp.asarray(sc))

    pt = {k: torch.from_numpy(a).requires_grad_() for k, a in params.items()}
    xt = _nchw(x).requires_grad_()
    sct = _nchw(sc).requires_grad_()
    st = {k: torch.from_numpy(a) for k, a in state.items()}
    y, new = _torch_bn(kind, pt, st, xt, sct, train, fused)
    loss = ((torch.tanh(y) * _nchw(w)).sum()
            + (new["mean"] * torch.from_numpy(u)).sum()
            + (new["var"] * torch.from_numpy(v)).sum())
    loss.backward()

    _close(_nhwc(y), ref_y, "y")
    for k in ("mean", "var"):
        _close(new[k], ref_new[k], f"new {k}")
    if not train:
        assert new is st
    for k in ("scale", "bias"):
        _close(pt[k].grad, ref_g[0][k], f"d{k}")
    _close(_nhwc(xt.grad), ref_g[1], "dx")
    if kind == "bn_add_relu":
        _close(_nhwc(sct.grad), ref_g[2], "dshortcut")
    else:
        assert sct.grad is None


def test_batchnorm_ties_take_half_the_gradient():
    """On the tie channel of ``batchnorm_relu`` (pre-activation exactly
    0) the bias gradient is 1/2 of the upstream sum, fused or not, as in
    the JAX package; ``torch.relu`` would give 0."""
    x, _, params, state = _bn_case("bn_relu")
    g = np.ones((4, C, 5, 6), np.float32)
    for fused in (True, False):
        pt = {k: torch.from_numpy(a).requires_grad_()
              for k, a in params.items()}
        st = {k: torch.from_numpy(a) for k, a in state.items()}
        y, _ = L.batchnorm_relu(pt, st, _nchw(x), fused=fused)
        assert float(y.detach()[:, 3].abs().max()) == 0.0
        (y * torch.from_numpy(g)).sum().backward()
        assert float(pt["bias"].grad[3]) == pytest.approx(0.5 * 4 * 5 * 6)


def test_batchnorm_statistics_are_the_jax_formulas():
    """Biased variance in the EMA, momentum on the old value, and the
    state kept in f32; eval mode returns the state it was given."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, C, 4, 4)).astype(np.float32) * 3.0 + 1.0
    params, state = L.batchnorm_init(C)
    assert state["mean"].dtype == state["var"].dtype == torch.float32
    assert params["scale"].shape == params["bias"].shape == (C,)
    _, new = L.batchnorm(params, state, torch.from_numpy(x), momentum=0.8)
    xc = x.transpose(1, 0, 2, 3).reshape(C, -1).astype(np.float64)
    _close(new["mean"], 0.2 * xc.mean(1), "ema mean")
    _close(new["var"], 0.8 + 0.2 * xc.var(1), "ema var (biased)")


def test_avg_pool_layernorm_and_dense_highest_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 7, 6)).astype(np.float32)
    _close(L.avg_pool_global(_nchw(x)), JL.avg_pool_global(jnp.asarray(x)),
           "avg_pool_global")
    h = rng.standard_normal((4, 9, 16)).astype(np.float32) * 2.0 + 0.5
    ln = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    assert set(L.layernorm_init(16)) == set(JL.layernorm_init(16))
    _close(L.layernorm({k: torch.from_numpy(a) for k, a in ln.items()},
                       torch.from_numpy(h)),
           JL.layernorm({k: jnp.asarray(a) for k, a in ln.items()},
                        jnp.asarray(h)), "layernorm")
    dw = rng.standard_normal((16, 5)).astype(np.float32)
    db = rng.standard_normal(5).astype(np.float32)
    for prec, jprec in (("highest", jax.lax.Precision.HIGHEST),
                        ("default", None), (None, None)):
        _close(L.dense({"w": torch.from_numpy(dw),
                        "b": torch.from_numpy(db)}, torch.from_numpy(h),
                       precision=prec),
               JL.dense({"w": jnp.asarray(dw), "b": jnp.asarray(db)},
                        jnp.asarray(h), precision=jprec), f"dense {prec}")
    with pytest.raises(ValueError, match="precision"):
        L.dense({"w": torch.from_numpy(dw), "b": torch.from_numpy(db)},
                torch.from_numpy(h), precision="fastest")
