"""ResNet family: ResNet-18/34/50/101/152 for ImageNet and the CIFAR
6n+2 plans (20/32/44/56/110).

Counterpart of ``tensorflowonspark_tpu/models/resnet.py``, the model of
the north-star workload (ResNet-50 on ImageNet, ``InputMode.SPARK``).
Parameters are f32 masters, activations and convolutions run in the
compute dtype (bf16 by default), and the BN running statistics live in
a separate f32 state tree.  ``apply`` takes NHWC images, as the JAX
model does, and computes in NCHW; on a CUDA card the permuted images,
the activations and the conv kernels are ``torch.channels_last``, which
is cuDNN's bf16 fast path on Hopper (on the CPU they are plain NCHW,
see ``_layout``).  The trees' names and nesting are
the JAX package's; :func:`params_from_jax` and :func:`params_to_jax`
convert the conv kernels (HWIO <-> OIHW), so both packages compute the
same function and their checkpoints cross over
(:func:`checkpoint_tree`, :func:`restore_checkpoint_tree`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as _remat

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models import layers as L
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
from tensorflowonspark_tpu_torch.utils import metrics as _metrics
from tensorflowonspark_tpu_torch.utils import train as _train

# stage plans: depth -> (block, per-stage block counts).  ImageNet family:
# 4 stages, width 64.  CIFAR family (6n+2 layers): 3 stages of n basic
# blocks, with width=16 and small_inputs=True.
_PLANS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    20: ("basic", (3, 3, 3)),
    32: ("basic", (5, 5, 5)),
    44: ("basic", (7, 7, 7)),
    56: ("basic", (9, 9, 9)),
    110: ("basic", (18, 18, 18)),
}


def _layout(t):
    """Channels-last on a CUDA card (cuDNN's bf16 fast path); plain NCHW
    on the CPU, where torch's channels-last gradient of a 1x1 stride-2
    conv crashes the process (torch 2.13, oneDNN)."""
    return t.contiguous(memory_format=torch.channels_last if t.is_cuda
                        else torch.contiguous_format)


def _conv_init(gen, k, in_ch, out_ch, dtype, device):
    p = L.conv_init(gen, k, k, in_ch, out_ch, dtype, use_bias=False,
                    device=device)
    p["w"] = _layout(p["w"])
    return p


def _block_init(gen, kind, in_ch, ch, stride, dtype, device):
    p, s = {}, {}
    bn = functools.partial(L.batchnorm_init, device=device)
    if kind == "bottleneck":
        out_ch = ch * 4
        p["conv1"] = _conv_init(gen, 1, in_ch, ch, dtype, device)
        p["bn1"], s["bn1"] = bn(ch)
        p["conv2"] = _conv_init(gen, 3, ch, ch, dtype, device)
        p["bn2"], s["bn2"] = bn(ch)
        p["conv3"] = _conv_init(gen, 1, ch, out_ch, dtype, device)
        p["bn3"], s["bn3"] = bn(out_ch)
    else:
        out_ch = ch
        p["conv1"] = _conv_init(gen, 3, in_ch, ch, dtype, device)
        p["bn1"], s["bn1"] = bn(ch)
        p["conv2"] = _conv_init(gen, 3, ch, ch, dtype, device)
        p["bn2"], s["bn2"] = bn(ch)
    if stride != 1 or in_ch != out_ch:
        p["proj"] = _conv_init(gen, 1, in_ch, out_ch, dtype, device)
        p["bn_proj"], s["bn_proj"] = bn(out_ch)
    return p, s, out_ch


def _block_apply(p, s, x, kind, stride, train, bn_fused=True):
    ns = {}
    bn = functools.partial(L.batchnorm, train=train, fused=bn_fused)
    bnr = functools.partial(L.batchnorm_relu, train=train, fused=bn_fused)
    bnar = functools.partial(L.batchnorm_add_relu, train=train,
                             fused=bn_fused)
    shortcut = x
    if "proj" in p:
        shortcut = L.conv(p["proj"], x, stride=stride)
        shortcut, ns["bn_proj"] = bn(p["bn_proj"], s["bn_proj"], shortcut)
    if kind == "bottleneck":
        y = L.conv(p["conv1"], x)
        y, ns["bn1"] = bnr(p["bn1"], s["bn1"], y)
        y = L.conv(p["conv2"], y, stride=stride)
        y, ns["bn2"] = bnr(p["bn2"], s["bn2"], y)
        y = L.conv(p["conv3"], y)
        y, ns["bn3"] = bnar(p["bn3"], s["bn3"], y, shortcut)
    else:
        y = L.conv(p["conv1"], x, stride=stride)
        y, ns["bn1"] = bnr(p["bn1"], s["bn1"], y)
        y = L.conv(p["conv2"], y)
        y, ns["bn2"] = bnar(p["bn2"], s["bn2"], y, shortcut)
    return y, ns


def init(generator, depth=50, num_classes=1000, width=64,
         small_inputs=False, dtype=torch.float32, device=None):
    """Random (params, state) from a ``torch.Generator`` (the JAX
    package's ``jax.random`` gives other numbers; the tests convert its
    trees with :func:`params_from_jax` instead).  ``small_inputs``: the
    CIFAR 3x3 stem without the max pool.  ``device``: default the
    generator's."""
    device = generator.device if device is None else device
    kind, counts = _PLANS[depth]
    params, state = {}, {}
    params["stem"] = _conv_init(generator, 3 if small_inputs else 7, 3,
                                width, dtype, device)
    params["bn_stem"], state["bn_stem"] = L.batchnorm_init(width,
                                                           device=device)
    in_ch = width
    for stage, nblocks in enumerate(counts):
        ch = width * (2 ** stage)
        for b in range(nblocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            name = f"s{stage}b{b}"
            params[name], state[name], in_ch = _block_init(
                generator, kind, in_ch, ch, stride, dtype, device)
    params["fc"] = L.dense_init(generator, in_ch, num_classes, dtype,
                                device=device)
    return params, state


def param_leaves(params):
    """The params' tensors in the JAX package's canonical (sorted-key)
    order, which is the order of an ``optax.sgd`` state's leaves."""
    return ckpt.tree_leaves(params)


def params_from_jax(params, state=None, device=None):
    """The JAX package's (params, state) trees (numpy or JAX arrays) as f32
    tensors on ``device`` (default: the current CUDA device, through
    :func:`resolve_device`; pass ``device="cpu"`` for the CPU).  Conv
    kernels (the 4-D leaves) go HWIO -> OIHW, channels-last on a card.
    Returns (params, state); state None gives None."""
    device = resolve_device(device)

    def leaf(x):
        t = torch.from_numpy(np.array(x, np.float32)).to(device)
        if t.ndim == 4:
            t = _layout(t.permute(3, 2, 0, 1))
        return t

    return (pytree.tree_map(leaf, params),
            None if state is None else pytree.tree_map(leaf, state))


def params_to_jax(params, state=None):
    """Inverse of :func:`params_from_jax`: numpy f32 trees in the JAX
    package's layout (conv kernels OIHW -> HWIO)."""

    def leaf(t):
        t = t.detach().float().cpu()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return np.ascontiguousarray(t.numpy())

    return (pytree.tree_map(leaf, params),
            None if state is None else pytree.tree_map(leaf, state))


def _stem_space_to_depth(w7, x):
    """The 7x7/s2 SAME stem as a 4x4/s1 conv over 2x2 space-to-depth
    input, in NCHW: ``[B, C, H, W] -> [B, 4C, H/2, W/2]`` with channel
    order (row parity, column parity, c), and the OIHW kernel zero-padded
    to 8x8 and folded to ``[O, 4C, 4, 4]`` in the same order.  SAME
    geometry of the original: pads (1, 2) on both sides.  The same
    outputs as the 7x7 conv, and checkpoints keep the 7x7 layout."""
    b, c, h, w = x.shape
    xs = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = _layout(xs.reshape(b, 4 * c, h // 2, w // 2))
    k = F.pad(w7, (0, 1, 0, 1))
    o = k.shape[0]
    k = k.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    k = _layout(k.reshape(o, 4 * c, 4, 4).to(x.dtype))
    return F.conv2d(F.pad(xs, (1, 2, 1, 2)), k)


def apply(params, state, images, depth=50, train=True, small_inputs=False,
          compute_dtype=torch.bfloat16, stem_s2d=True, bn_fused=True):
    """images ``[N, H, W, 3]`` (uint8 or float, not normalised) ->
    (logits ``[N, num_classes]`` f32, new_state)."""
    kind, counts = _PLANS[depth]
    x = _layout(images.permute(0, 3, 1, 2).to(compute_dtype))
    new_state = {}
    if small_inputs:
        x = L.conv(params["stem"], x)
    elif stem_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
        x = _stem_space_to_depth(params["stem"]["w"], x)
    else:
        x = L.conv(params["stem"], x, stride=2)
    x, new_state["bn_stem"] = L.batchnorm_relu(
        params["bn_stem"], state["bn_stem"], x, train, fused=bn_fused)
    if not small_inputs:
        x = L.max_pool(x, window=3, stride=2, padding="SAME")  # 112 -> 56
    for stage, nblocks in enumerate(counts):
        for b in range(nblocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            name = f"s{stage}b{b}"
            x, new_state[name] = _block_apply(
                params[name], state[name], x, kind, stride, train, bn_fused)
    x = L.avg_pool_global(x).float()
    return L.dense(params["fc"], x), new_state


def make_train_step(optimizer, depth=50, small_inputs=False,
                    compute_dtype=torch.bfloat16, remat=False, stem_s2d=True,
                    accum_steps=1, bn_fused=True, tm=None):
    """``train_step(params, state, images, labels) -> (loss, acc,
    new_state)``, ``loss`` and ``acc`` as 0-d tensors on the device.

    ``optimizer`` is a ``torch.optim`` optimizer over
    :func:`param_leaves` (``torch.optim.SGD(leaves, lr, momentum=0.9)`` is
    ``optax.sgd(lr, momentum=0.9)``: with dampening 0 torch's momentum
    buffer is optax's ``trace``, ``g`` on the first step); the step
    updates the params in place, where the JAX step returns new params
    and optimizer state.  In a process group of more than one process the
    gradients are averaged across it (:func:`utils.train.average_gradients_`)
    and batch norm uses the statistics of every process's batch, as the
    JAX step does over a mesh-sharded batch (``models.layers``).
    ``params`` may be placed on a ``data x fsdp`` mesh
    (``parallel.shard_train_state``): the step then gathers them for the
    forward and reduce-scatters their gradients.

    ``remat``: recompute the forward in the backward
    (``torch.utils.checkpoint``).  ``accum_steps > 1``: the batch in that
    many microbatches, each normalised with its own statistics (over
    that microbatch on every process of the group), the
    running statistics advancing once per microbatch; the loss and
    gradients are the microbatches' mean and the accuracy is the last
    microbatch's, as in the JAX package.

    ``tm``: a ``utils.metrics.TrainMetrics`` whose phases each step
    marks: forward, backward (with the gradients' all-reduce) and
    optimizer; with ``accum_steps > 1`` forward and backward as one
    ``forward_backward``."""
    fwd = apply
    if remat:
        fwd = functools.partial(_remat.checkpoint, apply, use_reentrant=False)

    def loss_fn(params, state, images, labels):
        logits, new_state = fwd(_train.full_params(params), state, images,
                                depth, True, small_inputs, compute_dtype,
                                stem_s2d, bn_fused)
        return L.softmax_cross_entropy(logits, labels), (logits, new_state)

    mark = tm.mark if tm is not None else _metrics.unmarked
    first = "forward" if accum_steps == 1 else "forward_backward"
    if accum_steps == 1:
        vg = _train.value_and_grad(loss_fn, has_aux=True, mark=mark)
    else:
        def micro_loss(p, aux_prev, x, y):
            _, st = aux_prev  # BN running stats advance per microbatch
            return loss_fn(p, st, x, y)

        micro_vg = _train.accumulated_value_and_grad(
            micro_loss, accum_steps, has_aux=True, carry_aux=True)

        def vg(params, state, images, labels):
            return micro_vg(params, images, labels, init_aux=(None, state))

    def train_step(params, state, images, labels):
        mark(first)
        (loss, (logits, new_state)), grads = vg(params, state, images,
                                                labels)
        leaves = param_leaves(params)
        for p, g in zip(leaves, ckpt.tree_leaves(grads)):
            p.grad = g
        _train.average_gradients_(leaves)
        mark("optimizer")
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        # accum path: logits are the last microbatch's
        acc_labels = labels[-logits.shape[0]:]
        return loss, L.accuracy(logits, acc_labels), new_state

    return train_step


def checkpoint_tree(params, state, optimizer):
    """The JAX package's checkpoint tree of this training state:
    ``{"params", "state", "opt"}`` in its layout (HWIO kernels), with
    ``"opt"`` the ``pack_pytree`` of the ``optax.sgd(lr, momentum)``
    state, whose leaves are the momentum buffers in sorted-key order
    (zeros before the first step)."""
    params_np, state_np = params_to_jax(params, state)
    trace, _ = params_to_jax(_train.sgd_momentum_tree(optimizer, params))
    return {"params": params_np, "state": state_np,
            "opt": ckpt.pack_pytree(trace)}


def restore_checkpoint_tree(tree, params, state, optimizer):
    """Copy a restored :func:`checkpoint_tree` (written by either package)
    into ``params`` and ``state`` in place, and its momentum buffers into
    ``optimizer``."""
    device = param_leaves(params)[0].device
    new_params, new_state = params_from_jax(tree["params"], tree["state"],
                                            device=device)
    trace, _ = params_from_jax(ckpt.unpack_pytree(tree["opt"], new_params),
                               device=device)
    with torch.no_grad():
        for dst, src in zip(param_leaves(params) + ckpt.tree_leaves(state),
                            param_leaves(new_params)
                            + ckpt.tree_leaves(new_state)):
            dst.copy_(src)
    _train.load_sgd_momentum_(optimizer, params, trace)


def flops_per_image(depth=50, image_size=224):
    """Forward-pass FLOPs per image, 2 FLOPs per MAC (the JAX package's
    table: torchvision's published 224x224 MAC counts for the ImageNet
    plans, the CIFAR plans' counts at 32x32), scaled by the image area."""
    if depth in (18, 34, 50, 101, 152):
        macs = {18: 1.81e9, 34: 3.66e9, 50: 4.09e9,
                101: 7.8e9, 152: 11.5e9}[depth]
        ref = 224
    else:
        macs = {20: 0.041e9, 32: 0.069e9, 44: 0.097e9,
                56: 0.126e9, 110: 0.255e9}[depth]
        ref = 32
    return 2.0 * macs * (image_size / ref) ** 2
