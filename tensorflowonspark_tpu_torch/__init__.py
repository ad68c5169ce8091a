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
RMSNorm (``ops.fused_rmsnorm``, ``ops/csrc/rmsnorm.cu``).  Later slices
brought ResNet, the feed's shm ring, TFRecord IO, the online serving
tier (``serving.Server`` over a supervised ``ReplicaPool``, its HTTP
frontend and ``cluster.TFCluster.serve``), and the Spark ML layer
(``pipeline.TFEstimator``/``TFModel``, ``spark_ml``, the
``tfos-inference-torch`` CLI, ``parallel_run``) with SPARK-mode
inference (``TFCluster.inference``), ps and evaluator nodes and a
pyspark ``SparkContext`` as the engine, then the MobileNetV2-UNet
segmentation model (``models.segmentation``) with its examples and the
shape-exact FLOP counter (``utils.flops``).

The import surface is the JAX package's (and the reference's)::

    from tensorflowonspark_tpu_torch import TFCluster, TFNode, InputMode
    cluster = TFCluster.run(engine, main_fun, args, num_executors, ...)
    cluster.train(dataset); cluster.shutdown()

Those names load their modules on first use: importing the package
imports neither torch nor any of its submodules.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); :func:`resolve_device` never falls
back to the CPU on its own.
"""

from __future__ import annotations

import logging

__version__ = "0.1.0"

# Library-polite logging: a NullHandler on the package's namespace;
# applications and the example drivers opt in to the reference's root
# format with configure_logging().
logging.getLogger(__name__).addHandler(logging.NullHandler())


def configure_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s (%(threadName)s-%(process)d) "
               "%(message)s",
    )


_LAZY = {
    "InputMode": ("tensorflowonspark_tpu_torch.cluster", "InputMode"),
    # the reference exposes TFCluster as a MODULE (TFCluster.run(...))
    "TFCluster": ("tensorflowonspark_tpu_torch.cluster", None),
    "TFNode": ("tensorflowonspark_tpu_torch.feed", None),
    "TFNodeContext": ("tensorflowonspark_tpu_torch.node", "TFNodeContext"),
    "TFParallel": ("tensorflowonspark_tpu_torch.parallel_run", None),
    "compat": ("tensorflowonspark_tpu_torch.compat", None),
    "dfutil": ("tensorflowonspark_tpu_torch.dfutil", None),
    "infeed": ("tensorflowonspark_tpu_torch.infeed", None),
    "pipeline": ("tensorflowonspark_tpu_torch.pipeline", None),
    "serving": ("tensorflowonspark_tpu_torch.serving", None),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        mod = importlib.import_module(module)
        return getattr(mod, attr) if attr else mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
