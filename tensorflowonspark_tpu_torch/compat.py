"""Compatibility shims: the reference's call sites over the port.

Counterpart of ``tensorflowonspark_tpu/compat.py`` (parity: reference
``tensorflowonspark/compat.py:10-31``):

- ``export_saved_model(model, export_dir, ctx)``: chief-only export
  (``utils.checkpoint.export_model``); a node that is not the chief
  writes nothing, where the reference exported to a dummy path;
- ``disable_auto_shard(options)``: accepted and ignored; the feed
  already gives each node its own partitions;
- ``is_gpu_available()``: whether PyTorch sees a CUDA device.
"""

from __future__ import annotations

import logging

from tensorflowonspark_tpu_torch.utils import checkpoint as _checkpoint

logger = logging.getLogger(__name__)


def export_saved_model(model, export_dir, ctx=None, metadata=None):
    """Export ``model`` (a params tree in the JAX package's layout, or an
    object with a ``params`` attribute) from the chief only; returns
    ``export_dir``, or None on a node that is not the chief."""
    params = getattr(model, "params", model)
    return _checkpoint.export_model(export_dir, params, ctx,
                                    metadata=metadata)


def disable_auto_shard(options):
    """No-op: partition feeds are already per node."""
    logger.debug("disable_auto_shard: no-op on the port's feed")
    return options


def is_gpu_available():
    """True when PyTorch sees a CUDA device."""
    import torch

    return torch.cuda.is_available()
