"""Functional layers: parameter dicts plus pure apply functions.

Counterpart of ``tensorflowonspark_tpu/models/layers.py``.  Layouts: the
port's convolutions, pooling and batch norm take NCHW activations and
OIHW kernels (PyTorch's), where the JAX package's take NHWC and HWIO; a
model converts at its public boundary (``mnist.apply`` and
``resnet.apply`` take NHWC images, their ``params_from_jax`` transpose
the kernels).  On a CUDA card an NHWC image permuted to NCHW is already
``torch.channels_last`` in memory, the layout cuDNN's bf16 convolutions
run fastest in, and the layers keep it.  Dense weights are ``[in, out]``
in both packages; ``layernorm`` normalises the last axis in both.

Batch norm is the JAX package's arithmetic, not ``F.batch_norm``'s:
one-pass ``E[x]``, ``E[x²]`` statistics in f32 with the biased variance
clamped at 0, the scale and bias folded in f32 and applied as one
multiply-add in the compute dtype, and an EMA of the biased variance with
``momentum`` weighting the old value.  ``fused=True`` (training) runs the
JAX package's custom VJPs as ``torch.autograd.Function``s: each saves
only its inputs, recomputes the activation's gate in the backward, and
runs the shared two-pass backward (:func:`_bn_bwd_core`).

ReLU's gradient where its input is exactly 0 is 1/2, ``jnp.maximum``'s
convention, in every path (``torch.relu`` gives 0 there).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def _he_init(generator, shape, fan_in, dtype, device):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(math.sqrt(2.0 / fan_in)).to(dtype)


# -- dense -------------------------------------------------------------------

def dense_init(generator, in_dim, out_dim, dtype=torch.float32, device=None):
    device = generator.device if device is None else device
    return {"w": _he_init(generator, (in_dim, out_dim), in_dim, dtype,
                          device),
            "b": torch.zeros((out_dim,), dtype=dtype, device=device)}


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dense(params, x, precision=None):
    """``x @ w + b`` in x's dtype (params may be f32 masters); a bf16
    product accumulates in f32 and rounds once, as the JAX package's
    ``preferred_element_type=f32`` product does.

    ``precision``: the JAX package's ``lax.Precision`` names as strings.
    ``None`` or ``"default"``: the process's matmul settings (a float32
    product is full float32 unless the caller enabled TF32);
    ``"highest"``: full float32 for this product, TF32 off whatever the
    settings."""
    if precision not in (None, "default", "highest"):
        raise ValueError(f"precision must be None, 'default' or 'highest', "
                         f"got {precision!r}")
    w = params["w"].to(x.dtype)
    with _no_tf32() if precision == "highest" else contextlib.nullcontext():
        y = x @ w
    return y + params["b"].to(x.dtype)


# -- conv --------------------------------------------------------------------

def conv_init(generator, h, w, in_ch, out_ch, dtype=torch.float32,
              use_bias=True, device=None):
    """OIHW kernel ``[out_ch, in_ch, h, w]``, He-initialised."""
    device = generator.device if device is None else device
    p = {"w": _he_init(generator, (out_ch, in_ch, h, w), h * w * in_ch,
                       dtype, device)}
    if use_bias:
        p["b"] = torch.zeros((out_ch,), dtype=dtype, device=device)
    return p


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size, window, stride):
    """XLA's SAME padding of one spatial side: ``(lo, hi)`` with
    ``out = ceil(size / stride)``, ``lo = total // 2``.  At stride 2 it is
    asymmetric (56 -> 28 by a 3x3 window pads (0, 1); 224 -> 112 by a 7x7
    pads (2, 3)), which torch's symmetric ``padding=`` cannot give."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, window, stride, value=0.0):
    """``x`` padded for a SAME window: ``(x, symmetric pad)`` — either the
    input and the pad torch's op takes, or an explicitly padded input and
    0 where the two sides differ."""
    (ph, qh), (pw, qw) = (same_pads(x.shape[2], window[0], stride[0]),
                          same_pads(x.shape[3], window[1], stride[1]))
    if ph == qh and pw == qw and value == 0.0:
        return x, (ph, pw)
    return F.pad(x, (pw, qw, ph, qh), value=value), (0, 0)


def conv(params, x, stride=1, padding="SAME"):
    """2-D convolution of NCHW ``x`` by the OIHW kernel, in x's dtype,
    with XLA's ``"SAME"`` (any stride and kernel) or ``"VALID"``."""
    w = params["w"].to(x.dtype)
    stride = _pair(stride)
    if padding == "SAME":
        x, pad = _pad_same(x, w.shape[2:], stride)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    b = params.get("b")
    return F.conv2d(x, w, None if b is None else b.to(x.dtype),
                    stride=stride, padding=pad)


# -- norm --------------------------------------------------------------------

def batchnorm_init(ch, dtype=torch.float32, device=None):
    """Returns (params, state): trainable ``scale``/``bias`` and the
    running ``mean``/``var`` (always f32), kept apart so the optimizer
    never sees the running statistics."""
    params = {"scale": torch.ones((ch,), dtype=dtype, device=device),
              "bias": torch.zeros((ch,), dtype=dtype, device=device)}
    state = {"mean": torch.zeros((ch,), dtype=torch.float32, device=device),
             "var": torch.ones((ch,), dtype=torch.float32, device=device)}
    return params, state


def _reduce_dims(x):
    """Every axis but the channels (axis 1)."""
    return (0,) + tuple(range(2, x.ndim))


def _per_channel(v, x):
    """A ``[C]`` vector shaped to broadcast over ``x``'s channel axis."""
    return v.view((1, -1) + (1,) * (x.ndim - 2))


def _max0(x):
    # jnp.maximum(x, 0): gradient 1/2 where x is exactly 0
    return torch.maximum(x, x.new_zeros(()))


def _bn_stats(x, eps):
    """One-pass E[x]/E[x²] in f32 over every axis but the channels ->
    (mean, var, inv)."""
    dims = _reduce_dims(x)
    n = x.numel() // x.shape[1]
    xf = x.float()
    mean = xf.sum(dims) / n
    mean_sq = (xf * xf).sum(dims) / n
    var = _max0(mean_sq - mean * mean)
    return mean, var, torch.rsqrt(var + eps)


def _bn_scale_bias(mean, inv, scale, bias, dtype):
    """Fold (mean, inv, scale, bias) in f32, round to the compute dtype:
    the activations stay in that dtype."""
    sf = scale.float()
    mul = (inv * sf).to(dtype)
    add = (bias.float() - mean * inv * sf).to(dtype)
    return mul, add


def _bn_apply(x, mul, add):
    """``x·mul + add`` as one multiply-add in x's dtype."""
    return torch.addcmul(_per_channel(add, x), x, _per_channel(mul, x))


def _bn_bwd_core(gm, x, mean, inv, scale, mean_ct, var_ct):
    """The shared two-pass BN backward, given the (possibly gated) f32
    cotangent ``gm``; returns (dx, dscale, dbias).

    Pass 1 reduces over (gm, x); pass 2 is ``dx = a·gm + b·x + c``
    (γ·inv·(gm − Σgm/n − x̂·Σ(gm·x̂)/n) rearranged), with the (mean, var)
    output cotangents folded into b and c."""
    dims = _reduce_dims(x)
    n = x.numel() // x.shape[1]
    xf = x.float()
    sum_g = gm.sum(dims)
    sum_gx = (gm * xf).sum(dims)
    sum_g_xhat = (sum_gx - mean * sum_g) * inv
    sf = scale.float()
    a = sf * inv
    b = -sf * inv * inv * sum_g_xhat / n
    c = -a * sum_g / n - b * mean
    b = b + 2.0 * var_ct / n
    c = c + (mean_ct - 2.0 * var_ct * mean) / n
    dx = torch.addcmul(
        torch.addcmul(_per_channel(c, x), _per_channel(a, x), gm),
        _per_channel(b, x), xf).to(x.dtype)
    return dx, sum_g_xhat.to(scale.dtype), sum_g.to(scale.dtype)


class _BNTrainFused(torch.autograd.Function):
    """Training-mode BN core, ``(y, mean, var)``, with the two-pass
    hand-written backward (``_bn_train_fused`` in the JAX package)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var, inv = _bn_stats(x, eps)
        mul, add = _bn_scale_bias(mean, inv, scale, bias, x.dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        return _bn_apply(x, mul, add), mean, var

    @staticmethod
    def backward(ctx, g, mean_ct, var_ct):
        x, mean, inv, scale = ctx.saved_tensors
        dx, dscale, dbias = _bn_bwd_core(g.float(), x, mean, inv, scale,
                                         mean_ct, var_ct)
        return dx, dscale, dbias, None


def _make_bn_act_fused(act, gate):
    """BN -> activation as one autograd Function saving only x.

    ``act(pre)`` is the forward activation; ``gate(pre)`` its f32
    derivative on the pre-activation recomputed exactly as the forward
    computed it, so the convention at ties is whatever ``gate`` encodes."""

    class BNAct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale, bias, eps):
            mean, var, inv = _bn_stats(x, eps)
            mul, add = _bn_scale_bias(mean, inv, scale, bias, x.dtype)
            ctx.save_for_backward(x, mean, inv, scale, bias)
            return act(_bn_apply(x, mul, add)), mean, var

        @staticmethod
        def backward(ctx, g, mean_ct, var_ct):
            x, mean, inv, scale, bias = ctx.saved_tensors
            mul, add = _bn_scale_bias(mean, inv, scale, bias, x.dtype)
            gm = g.float() * gate(_bn_apply(x, mul, add))
            dx, dscale, dbias = _bn_bwd_core(gm, x, mean, inv, scale,
                                             mean_ct, var_ct)
            return dx, dscale, dbias, None

    return BNAct.apply


def _relu_gate(pre):
    # sign() reproduces jnp.maximum's tie convention (1/2 at 0)
    return (torch.sign(pre.float()) + 1.0) * 0.5


def _relu6_gate(pre):
    # jax.nn.relu6's gradient is 0 at both saturation boundaries
    pf = pre.float()
    return ((pf > 0) & (pf < 6)).float()


_bn_relu_train_fused = _make_bn_act_fused(lambda pre: pre.clamp_min_(0),
                                          _relu_gate)
_bn_relu6_train_fused = _make_bn_act_fused(F.relu6, _relu6_gate)


class _BNAddReluTrainFused(torch.autograd.Function):
    """relu(bn(x) + shortcut), the ResNet block end, as one autograd
    Function saving x and the shortcut, not the pre-relu sum."""

    @staticmethod
    def forward(ctx, x, shortcut, scale, bias, eps):
        mean, var, inv = _bn_stats(x, eps)
        mul, add = _bn_scale_bias(mean, inv, scale, bias, x.dtype)
        ctx.save_for_backward(x, shortcut, mean, inv, scale, bias)
        return (_bn_apply(x, mul, add) + shortcut).clamp_min_(0), mean, var

    @staticmethod
    def backward(ctx, g, mean_ct, var_ct):
        x, shortcut, mean, inv, scale, bias = ctx.saved_tensors
        mul, add = _bn_scale_bias(mean, inv, scale, bias, x.dtype)
        gm = g.float() * _relu_gate(_bn_apply(x, mul, add) + shortcut)
        dx, dscale, dbias = _bn_bwd_core(gm, x, mean, inv, scale,
                                         mean_ct, var_ct)
        return dx, gm.to(shortcut.dtype), dscale, dbias, None


def _ema_state(state, mean, var, momentum):
    return {"mean": momentum * state["mean"] + (1 - momentum) * mean,
            "var": momentum * state["var"] + (1 - momentum) * var}


def batchnorm(params, state, x, train=True, momentum=0.9, eps=1e-5,
              fused=True):
    """BatchNorm over every axis but the channels (axis 1).

    ``train``: batch statistics, and the running ones advance by
    ``momentum·old + (1 − momentum)·batch`` (biased variance); else the
    running statistics, and the state comes back unchanged.  ``fused``
    (training only): the hand-written two-pass backward; False is plain
    autograd over the same forward.  Returns (y, new_state)."""
    if train:
        if fused:
            y, mean, var = _BNTrainFused.apply(
                x, params["scale"], params["bias"], eps)
        else:
            mean, var, inv = _bn_stats(x, eps)
            mul, add = _bn_scale_bias(
                mean, inv, params["scale"], params["bias"], x.dtype)
            y = _bn_apply(x, mul, add)
        return y, _ema_state(state, mean, var, momentum)
    inv = torch.rsqrt(state["var"] + eps)
    mul, add = _bn_scale_bias(state["mean"], inv, params["scale"],
                              params["bias"], x.dtype)
    return _bn_apply(x, mul, add), state


def _batchnorm_act(fused_core, act, params, state, x, train, momentum,
                   eps, fused):
    if train and fused:
        y, mean, var = fused_core(x, params["scale"], params["bias"], eps)
        return y, _ema_state(state, mean, var, momentum)
    y, new_state = batchnorm(params, state, x, train=train,
                             momentum=momentum, eps=eps, fused=fused)
    return act(y), new_state


def batchnorm_relu(params, state, x, train=True, momentum=0.9, eps=1e-5,
                   fused=True):
    """``relu(batchnorm(...))``; fused training saves no pre-activation.
    Returns (y, new_state)."""
    return _batchnorm_act(_bn_relu_train_fused, relu, params, state, x,
                          train, momentum, eps, fused)


def batchnorm_relu6(params, state, x, train=True, momentum=0.9, eps=1e-5,
                    fused=True):
    """``relu6(batchnorm(...))`` (MobileNet-style blocks); gradient 0 at
    both saturation boundaries.  Returns (y, new_state)."""
    return _batchnorm_act(_bn_relu6_train_fused, F.relu6, params, state, x,
                          train, momentum, eps, fused)


def batchnorm_add_relu(params, state, x, shortcut, train=True, momentum=0.9,
                       eps=1e-5, fused=True):
    """``relu(batchnorm(x) + shortcut)``, the ResNet block end; fused
    training saves no pre-relu sum.  Returns (y, new_state)."""
    if train and fused:
        y, mean, var = _BNAddReluTrainFused.apply(
            x, shortcut, params["scale"], params["bias"], eps)
        return y, _ema_state(state, mean, var, momentum)
    y, new_state = batchnorm(params, state, x, train=train,
                             momentum=momentum, eps=eps, fused=fused)
    return relu(y + shortcut), new_state


def layernorm_init(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-6):
    """Normalise the last axis (biased variance), then scale and bias."""
    var, mu = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


# -- pooling / activations ---------------------------------------------------

def max_pool(x, window=2, stride=2, padding="VALID"):
    """Max pooling of NCHW ``x``.  VALID drops a ragged edge; SAME pads
    with -inf as XLA's ``reduce_window`` does (112 -> 56 by a 3x3/s2
    window pads (0, 1))."""
    window, stride = _pair(window), _pair(stride)
    if padding == "SAME":
        x, _ = _pad_same(x, window, stride, value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return F.max_pool2d(x, window, stride)


def avg_pool_global(x):
    """Mean over the spatial axes of NCHW ``x`` -> ``[N, C]``."""
    return x.mean(dim=tuple(range(2, x.ndim)))


def relu(x):
    """``max(x, 0)`` with gradient 1/2 at exactly 0, as ``jnp.maximum``."""
    return _max0(x)


# -- losses ------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, num_classes=None):
    """Mean cross entropy over integer labels; log-softmax in f32.
    ``num_classes`` is unused, as in the JAX package."""
    del num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()
