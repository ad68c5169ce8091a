"""Linear regression, the smallest model family.

Counterpart of ``tensorflowonspark_tpu/models/linear.py``: ``{"w": [dim],
"b": []}``, zero-initialised, ``apply`` is ``x @ w + b``, the train step
minimises the mean squared error.  The pipeline's reference test trains
it (``TFEstimator.fit`` -> ``TFModel.transform``), and ``predict`` is the
export's predict signature.  The params' layout is the JAX package's, so
``params_from_jax`` only makes tensors of them.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.utils import cuda_graphs, train

# the export metadata's name of :func:`predict`
PREDICT = f"{__name__}:predict"


def init_params(dim=2, dtype=torch.float32, device=None):
    """Zeros, the usual start of a linear regression."""
    device = resolve_device(device)
    return {"w": torch.zeros((dim,), dtype=dtype, device=device),
            "b": torch.zeros((), dtype=dtype, device=device)}


def params_from_jax(tree, device=None):
    """The JAX package's params (numpy or JAX arrays) as f32 tensors on
    ``device`` (default: the current CUDA device; ``"cpu"`` for the
    CPU)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in tree.items()}


def params_to_jax(params):
    """Numpy f32 arrays in the JAX package's layout, as exports hold
    them."""
    return {k: np.ascontiguousarray(v.detach().float().cpu().numpy())
            for k, v in params.items()}


def apply(params, x):
    return x @ params["w"] + params["b"]


def make_train_step(optimizer):
    """``train_step(params, x, y) -> loss``: one step of ``optimizer``
    (a ``torch.optim`` optimizer over the params' tensors, updated in
    place) on the mean squared error.  In a process group of more than
    one process the gradients are averaged across it
    (:func:`utils.train.all_reduce_mean_`)."""
    leaves = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(params, x, y):
        loss = torch.mean((apply(params, x) - y) ** 2)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        train.all_reduce_mean_([p.grad for p in leaves])
        optimizer.step()
        return loss.detach()

    return train_step


def _device_params(params, device=None):
    """``params`` as :func:`predict` computes with them: a JAX-layout
    tree put on ``device`` (None is the card), tensors where they are."""
    if not isinstance(params["w"], torch.Tensor):
        params = params_from_jax(params, device=device)
    return params


def _host_rows(inputs):
    """The request's one column as ``([N, dim] float32,)`` host tensors."""
    (x,) = inputs.values()
    return (torch.from_numpy(np.asarray(x, np.float32)),)


def _host_outputs(y):
    return y.cpu().numpy()


def predict(params, inputs, device=None):
    """The export's predict signature, named in export metadata as
    ``tensorflowonspark_tpu_torch.models.linear:predict``: ``inputs``
    ``{tensor_name: [N, dim]}`` -> predictions ``[N]`` as a numpy array.
    ``params``: the JAX layout, put on ``device`` (None is the card), or
    tensors from :func:`params_from_jax`, used where they are.  Its
    device part, :func:`apply`, is what a serving replica captures in a
    CUDA graph a bucket (``predict.parts``)."""
    params = _device_params(params, device)
    (x,) = _host_rows(inputs)
    with torch.no_grad():
        return _host_outputs(apply(params, x.to(params["w"].device)))


predict.parts = cuda_graphs.PredictParts(
    params=_device_params, inputs=_host_rows, core=apply,
    outputs=_host_outputs)
