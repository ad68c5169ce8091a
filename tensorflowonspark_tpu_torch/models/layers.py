"""Functional layers: parameter dicts plus pure apply functions.

An own copy of the part of ``tensorflowonspark_tpu/models/layers.py``
that the MNIST model calls.  Layouts: the port's convolutions take NCHW
activations and OIHW kernels (PyTorch's), where the JAX package's take
NHWC and HWIO; a model converts at its public boundary
(``mnist.apply`` takes NHWC images, ``mnist.params_from_jax`` transposes
the kernels).  Dense weights are ``[in, out]`` in both.  Batch norm,
layer norm and the fused ResNet blocks come with ResNet (ROADMAP.md
queue 1, item 11).
"""

from __future__ import annotations

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


def dense(params, x, precision=None):
    """``x @ w + b`` in x's dtype (params may be f32 masters); a bf16
    product accumulates in f32 and rounds once, as the JAX package's
    ``preferred_element_type=f32`` product does.  A float32 product is
    full float32 unless the caller enabled TF32."""
    if precision is not None:
        raise NotImplementedError("per-call matmul precision comes with "
                                  "ROADMAP.md queue 1, item 11")
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


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


def conv(params, x, stride=1, padding="SAME"):
    """2-D convolution of NCHW ``x`` by the OIHW kernel, in x's dtype.

    ``"SAME"`` at stride 1 with an odd kernel is a symmetric pad of
    ``k // 2``, which is what XLA's SAME gives there; other SAME cases
    pad asymmetrically and come with ResNet (ROADMAP.md queue 1,
    item 11)."""
    w = params["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    if padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError(
                "SAME padding beyond stride 1 and odd kernels comes with "
                "ROADMAP.md queue 1, item 11")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    b = params.get("b")
    return F.conv2d(x, w, None if b is None else b.to(x.dtype),
                    stride=stride, padding=pad)


# -- pooling / activations ---------------------------------------------------

def max_pool(x, window=2, stride=2, padding="VALID"):
    """Max pooling of NCHW ``x``; VALID drops a ragged edge, as XLA's."""
    if padding != "VALID":
        raise NotImplementedError("SAME pooling comes with ROADMAP.md "
                                  "queue 1, item 11")
    return F.max_pool2d(x, window, stride)


def relu(x):
    return torch.relu(x)


# -- losses ------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, num_classes=None):
    """Mean cross entropy over integer labels; log-softmax in f32.
    ``num_classes`` is unused, as in the JAX package."""
    del num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()
