"""Image segmentation family: MobileNetV2-style encoder + U-Net decoder.

Counterpart of ``tensorflowonspark_tpu/models/segmentation.py`` (the
Oxford-IIIT pet U-Net of BASELINE.json config 4): inverted-residual
bottlenecks (expand 1x1 -> depthwise 3x3 -> project 1x1), a skip tap
before each stride-2 stage, and a transposed-conv decoder that
concatenates the taps U-Net style.  The names, the trees and their
nesting are the JAX package's.

Layouts follow ``models/layers.py``: inside the model activations are
NCHW and conv kernels OIHW; ``apply`` takes NHWC images and returns NHWC
logits, as the JAX model does.  The compute dtype is the images' dtype
(params are f32 masters), as in the JAX model.  Two kernels differ from
the JAX layout, and :func:`params_from_jax` / :func:`params_to_jax`
convert them:

- the depthwise kernel is OIHW ``[C, 1, 3, 3]`` (``groups=C``), the JAX
  HWIO ``[3, 3, 1, C]`` transposed like any conv kernel;
- the up-conv kernel is ``F.conv_transpose2d``'s ``[in, out, 3, 3]``,
  spatially flipped: ``lax.conv_transpose`` (``transpose_kernel=False``)
  correlates the zero-inserted input with the kernel as it is, where
  ``conv_transpose2d`` correlates it with the flipped kernel.  At k=3,
  s=2, SAME the JAX op pads the zero-inserted input by (2, 1), which is
  ``conv_transpose2d``'s (2, 2) output cropped by its last row and
  column: H -> 2H at any H.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models import layers as L
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
from tensorflowonspark_tpu_torch.utils import train as _train


def _dwconv_init(generator, ch, dtype=torch.float32, device=None):
    # depthwise 3x3: OIHW with I=1, O=ch, groups=ch
    return {"w": L._he_init(generator, (ch, 1, 3, 3), 9, dtype, device)}


def _dwconv(params, x, stride=1):
    stride = (stride, stride)
    x, pad = L._pad_same(x, (3, 3), stride)
    return F.conv2d(x, params["w"].to(x.dtype), stride=stride, padding=pad,
                    groups=x.shape[1])


def _invres_init(generator, in_ch, out_ch, expand, dtype, device):
    mid = in_ch * expand
    bn = functools.partial(L.batchnorm_init, device=device)
    p, s = {}, {}
    if expand != 1:
        p["expand"] = L.conv_init(generator, 1, 1, in_ch, mid, dtype,
                                  use_bias=False, device=device)
        p["bn_e"], s["bn_e"] = bn(mid)
    p["dw"] = _dwconv_init(generator, mid, dtype, device)
    p["bn_d"], s["bn_d"] = bn(mid)
    p["project"] = L.conv_init(generator, 1, 1, mid, out_ch, dtype,
                               use_bias=False, device=device)
    p["bn_p"], s["bn_p"] = bn(out_ch)
    return p, s


def _invres_apply(p, s, x, stride, train):
    ns = {}
    y = x
    if "expand" in p:
        y = L.conv(p["expand"], y)
        y, ns["bn_e"] = L.batchnorm_relu6(p["bn_e"], s["bn_e"], y, train)
    y = _dwconv(p["dw"], y, stride=stride)
    y, ns["bn_d"] = L.batchnorm_relu6(p["bn_d"], s["bn_d"], y, train)
    y = L.conv(p["project"], y)
    y, ns["bn_p"] = L.batchnorm(p["bn_p"], s["bn_p"], y, train)
    if stride == 1 and x.shape[1] == y.shape[1]:
        y = x + y
    return y, ns


# encoder stage plan: (out_ch, stride, expand) — a compact MobileNetV2;
# each stride-2 stage's input is a U-Net skip tap.
_ENCODER = [
    (16, 1, 1),
    (24, 2, 6),
    (32, 2, 6),
    (64, 2, 6),
    (96, 1, 6),
]


def _upconv_init(generator, in_ch, out_ch, dtype, device):
    # 3x3 stride-2 transposed conv: conv_transpose2d's [in, out, kh, kw]
    return {"w": L._he_init(generator, (in_ch, out_ch, 3, 3), 9 * in_ch,
                            dtype, device)}


def _upconv(params, x):
    h, w = x.shape[2:]
    y = F.conv_transpose2d(x, params["w"].to(x.dtype), stride=2)
    return y[:, :, :2 * h, :2 * w]


def init(generator, num_classes=3, in_ch=3, width=1.0, dtype=torch.float32,
         device=None):
    """(params, state) for a U-Net over the MobileNetV2-style encoder,
    random from a ``torch.Generator`` (the JAX package's ``jax.random``
    gives other numbers; the tests convert its trees with
    :func:`params_from_jax` instead).  ``device``: default the
    generator's."""
    device = generator.device if device is None else device
    bn = functools.partial(L.batchnorm_init, device=device)
    p, s = {}, {}
    ch = max(8, int(16 * width))
    p["stem"] = L.conv_init(generator, 3, 3, in_ch, ch, dtype,
                            use_bias=False, device=device)
    p["bn_stem"], s["bn_stem"] = bn(ch)

    taps = []
    for i, (out_ch, stride, expand) in enumerate(_ENCODER):
        out_ch = max(8, int(out_ch * width))
        if stride == 2:
            taps.append(ch)
        p[f"enc{i}"], s[f"enc{i}"] = _invres_init(generator, ch, out_ch,
                                                  expand, dtype, device)
        ch = out_ch

    for i, skip_ch in enumerate(reversed(taps)):
        p[f"up{i}"] = _upconv_init(generator, ch, skip_ch, dtype, device)
        p[f"bn_up{i}"], s[f"bn_up{i}"] = bn(skip_ch)
        ch = skip_ch * 2  # concat with the tap
    p["head"] = _upconv_init(generator, ch, num_classes, dtype, device)
    return p, s


def apply(params, state, x, train=False):
    """``[B, H, W, C]`` -> (``[B, H, W, num_classes]`` logits, new_state),
    computed in x's dtype.  H and W must be divisible by 2**(#stride-2
    stages + stem)."""
    ns = {}
    y = L.conv(params["stem"], x.permute(0, 3, 1, 2), stride=2)
    y, ns["bn_stem"] = L.batchnorm_relu6(
        params["bn_stem"], state["bn_stem"], y, train)

    taps = []
    for i, (_, stride, _) in enumerate(_ENCODER):
        if stride == 2:
            taps.append(y)
        y, ns[f"enc{i}"] = _invres_apply(
            params[f"enc{i}"], state[f"enc{i}"], y, stride, train)

    for i, tap in enumerate(reversed(taps)):
        y = _upconv(params[f"up{i}"], y)
        y, ns[f"bn_up{i}"] = L.batchnorm_relu(
            params[f"bn_up{i}"], state[f"bn_up{i}"], y, train)
        y = torch.cat([y, tap], dim=1)
    logits = _upconv(params["head"], y)
    return logits.permute(0, 2, 3, 1), ns


def loss_fn(params, state, images, masks, train=True):
    """Per-pixel CE; masks ``[B, H, W]`` int.  Returns (loss, new_state).
    Placed params are gathered first (:func:`utils.train.full_params`)."""
    logits, ns = apply(_train.full_params(params), state, images,
                       train=train)
    loss = L.softmax_cross_entropy(
        logits.reshape(-1, logits.shape[-1]), masks.reshape(-1))
    return loss, ns


def make_train_step(optimizer):
    """``train_step(params, state, images, masks) -> (loss, new_state)``,
    ``loss`` a 0-d tensor on the device.

    ``optimizer`` is a ``torch.optim`` optimizer over
    :func:`param_leaves` (``torch.optim.Adam(leaves, lr=1e-3)`` is
    ``optax.adam(1e-3)``); the step updates the params in place, where
    the JAX step returns new params and optimizer state.  In a process
    group of more than one process the gradients are averaged across it
    (:func:`utils.train.average_gradients_`), and batch norm normalises
    with the statistics of every process's batch, as the JAX package's
    step does over a mesh-sharded batch (``models.layers``).  ``params``
    may be placed on a ``data x fsdp`` mesh
    (``parallel.shard_train_state``): the step then gathers them for the
    forward and reduce-scatters their gradients."""
    vg = _train.value_and_grad(loss_fn, has_aux=True)

    def train_step(params, state, images, masks):
        (loss, new_state), grads = vg(params, state, images, masks)
        leaves = param_leaves(params)
        for p, g in zip(leaves, ckpt.tree_leaves(grads)):
            p.grad = g
        _train.average_gradients_(leaves)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss, new_state

    return train_step


def param_leaves(params):
    """The params' tensors in the JAX package's canonical (sorted-key)
    order, which is the order of an ``optax.adam`` state's leaves."""
    return ckpt.tree_leaves(params)


def _is_upconv(name):
    return name == "head" or (name.startswith("up") and name[2:].isdigit())


def _convert(tree, leaf, upconv=False):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf, upconv or _is_upconv(k))
                for k, v in tree.items()}
    return leaf(tree, upconv)


def params_from_jax(params, state=None, device=None):
    """The JAX package's (params, state) trees (numpy or JAX arrays) as f32
    tensors on ``device`` (default: the current CUDA device, through
    :func:`resolve_device`; pass ``device="cpu"`` for the CPU).  Conv and
    depthwise kernels go HWIO -> OIHW; up-conv kernels HWIO -> flipped
    ``[in, out, kh, kw]``.  Returns (params, state); state None gives
    None."""
    device = resolve_device(device)

    def leaf(x, upconv):
        a = np.array(x, np.float32)
        if a.ndim == 4:
            a = (a[::-1, ::-1].transpose(2, 3, 0, 1) if upconv
                 else a.transpose(3, 2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (_convert(params, leaf),
            None if state is None else _convert(state, leaf))


def params_to_jax(params, state=None):
    """Inverse of :func:`params_from_jax`: numpy f32 trees in the JAX
    package's layout."""

    def leaf(t, upconv):
        a = t.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = (a.transpose(2, 3, 0, 1)[::-1, ::-1] if upconv
                 else a.transpose(2, 3, 1, 0))
        return np.ascontiguousarray(a)

    return (_convert(params, leaf),
            None if state is None else _convert(state, leaf))
