"""MNIST CNN: Conv(32) -> Conv(64) -> pool -> Dense(128) -> Dense(10).

Counterpart of ``tensorflowonspark_tpu/models/mnist.py``, the parity
workload of the SPARK-fed MNIST example.  ``apply`` takes NHWC images as
the JAX model does and computes in NCHW; the activations go back to
NHWC before the flatten ahead of ``fc1``, so ``fc1``'s rows meet the
features the JAX model feeds them.  ``params_from_jax`` transposes the
JAX package's HWIO kernels to OIHW, ``params_to_jax`` back (the export's
layout); ``predict`` is the export's predict signature.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.models import layers as L
from tensorflowonspark_tpu_torch.utils import train

# the export metadata's name of :func:`predict`
PREDICT = f"{__name__}:predict"


def init_params(generator, dtype=torch.float32, device=None):
    """Random He-initialised params from a ``torch.Generator`` (the JAX
    package's ``jax.random`` gives other numbers; the tests convert its
    params with :func:`params_from_jax` instead)."""
    return {
        "conv1": L.conv_init(generator, 3, 3, 1, 32, dtype, device=device),
        "conv2": L.conv_init(generator, 3, 3, 32, 64, dtype, device=device),
        "fc1": L.dense_init(generator, 7 * 7 * 64, 128, dtype,
                            device=device),
        "fc2": L.dense_init(generator, 128, 10, dtype, device=device),
    }


def params_from_jax(tree, device=None):
    """The JAX package's params tree (numpy or JAX arrays) as f32 tensors
    on ``device`` (default: the current CUDA device, through
    :func:`resolve_device`; pass ``device="cpu"`` for the CPU).  Conv
    kernels HWIO -> OIHW."""
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32).transpose(3, 2, 0, 1))).to(device)

    def plain(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    out = {}
    for name, p in tree.items():
        out[name] = {k: (conv(v) if name.startswith("conv") and k == "w"
                         else plain(v)) for k, v in p.items()}
    return out


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: numpy f32 trees in the JAX
    package's layout (conv kernels OIHW -> HWIO), as exports hold them."""
    def leaf(name, k, t):
        t = t.detach().float().cpu()
        if name.startswith("conv") and k == "w":
            t = t.permute(2, 3, 1, 0)
        return np.ascontiguousarray(t.numpy())

    return {name: {k: leaf(name, k, v) for k, v in p.items()}
            for name, p in params.items()}


def predict(params, inputs, device=None):
    """The export's predict signature, named in export metadata as
    ``tensorflowonspark_tpu_torch.models.mnist:predict``: ``inputs``
    ``{tensor_name: images}`` of ``[N, 28, 28, 1]`` or flat 784-wide rows
    -> ``{"prediction": [N], "logits": [N, 10]}`` as numpy arrays.
    ``params``: the JAX layout (``utils.checkpoint.load_exported``), put
    on ``device`` as :func:`params_from_jax` does (None is the card) on
    every call, or tensors from :func:`params_from_jax`, used where they
    are (a caller that predicts many batches converts once)."""
    if not isinstance(params["fc2"]["w"], torch.Tensor):
        params = params_from_jax(params, device=device)
    (x,) = inputs.values()
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 2:  # flat 784-wide rows (CSV / TFRecord ingestion)
        x = x.reshape(-1, 28, 28, 1)
    dev = params["fc2"]["w"].device
    with torch.no_grad():
        logits = apply(params, torch.from_numpy(x).to(dev)).cpu().numpy()
    return {"prediction": logits.argmax(-1), "logits": logits}


def apply(params, images):
    """images ``[N, 28, 28, 1]`` in [0, 1] -> logits ``[N, 10]``."""
    x = images.permute(0, 3, 1, 2)          # NHWC -> NCHW
    x = L.relu(L.conv(params["conv1"], x))
    x = L.max_pool(x)                       # 14x14
    x = L.relu(L.conv(params["conv2"], x))
    x = L.max_pool(x)                       # 7x7
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
    x = L.relu(L.dense(params["fc1"], x))
    return L.dense(params["fc2"], x)


def loss_fn(params, images, labels):
    logits = apply(params, images)
    return L.softmax_cross_entropy(logits, labels), logits


def make_train_step(optimizer):
    """``train_step(params, images, labels) -> (loss, accuracy)``.

    ``optimizer`` is a ``torch.optim`` optimizer over the params' leaves
    (``torch.optim.SGD(leaves, lr, momentum=0.9)`` is
    ``optax.sgd(lr, momentum=0.9)``); the step updates them in place,
    where the JAX step returns new params and optimizer state.  In a
    process group of more than one process the gradients are summed
    across it and divided by its size after ``backward``
    (:func:`utils.train.all_reduce_mean_`), which is the global batch's
    mean gradient when every process steps on the same batch size."""
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(params, images, labels):
        loss, logits = loss_fn(params, images, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        train.all_reduce_mean_([p.grad for p in leaves])
        optimizer.step()
        return loss.detach(), L.accuracy(logits.detach(), labels)

    return train_step
