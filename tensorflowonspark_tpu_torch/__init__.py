"""TensorFlowOnSpark-TPU, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside ``tensorflowonspark_tpu`` (the JAX reference).
It mirrors the reference's module paths and names, so each module has a
counterpart there, but it imports no JAX and nothing of the reference
package: what it needs of the reference's JAX-free modules it keeps as
its own copies.

The first slice is the serving path: continuous-batching transformer
decode (``serving.decode.DecodeEngine``) whose prefill attention runs a
hand-written flash-attention kernel (``ops/csrc/flash_fwd.cu``).  The
second is the transformer's training path: ``models.transformer.loss_fn``
differentiated by autograd, whose attention backward runs the
hand-written dq and dk/dv kernels (``ops/csrc/flash_bwd.cu``), with the
step utilities (``utils.train``, ``utils.metrics``) and
``infeed.prefetch_to_device``.  The third is the SPARK-fed training
path: the package's own copies of the cluster layer (``cluster``,
``node``, ``engine``, ``rendezvous``, ``manager``, ``feed``,
``gpu_info``) feed engine partitions through a ``DataFeed`` into
trainers forked from the executors, which join one process group
(``TFNodeContext.torch_initialize``); with it came the last kernel,
RMSNorm (``ops.fused_rmsnorm``, ``ops/csrc/rmsnorm.cu``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); :func:`resolve_device` never falls
back to the CPU on its own.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """``None`` -> the current CUDA device; anything else ->
    ``torch.device(device)`` (a bare ``cuda`` gets the current index).

    Raises RuntimeError when a CUDA device is asked for (explicitly or
    by default) and none is present — no silent CPU fallback."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
