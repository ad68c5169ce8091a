"""Resize-time resharding: re-place train state under a new layout.

Counterpart of ``tensorflowonspark_tpu/elastic/reshard.py``.  A
checkpoint written under one mesh shape restores under another.  The
contract is a host round trip: every leaf is fetched to host memory
first, then laid out under the target placement
(``parallel.sharding.apply_shardings``: DTensors on a ``DeviceMesh``, or
plain tensors on a device for a one-process layout).  Values never
change, only placement.  Optimizer moments travel with their
parameter's layout (``parallel.sharding.shard_train_state``).

Unlike a JAX array, a ``DTensor`` cannot read another rank's shard
without that rank: fetching a sharded leaf all-gathers it over its mesh
(``full_tensor``), which every rank of that mesh must join.  A state
whose old mesh lost a rank is restored from a checkpoint instead
(``ElasticRuntime.restore``), as recovery does.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)


def _host(x):
    import torch

    if not torch.is_tensor(x):
        return np.asarray(x)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def host_fetch(tree):
    """Every leaf as host numpy (DTensors gathered over their mesh)."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(_host, tree)


def reshard(tree, target_shardings):
    """Re-place ``tree`` under ``target_shardings`` through the host.

    ``target_shardings`` is a tree of placements matching ``tree`` (a
    prefix works, as with ``jax.device_put``), each ``(mesh,
    placements)`` or a ``torch.device``, or a callable ``tree ->
    shardings``, so that a caller derives them from the tree itself
    (``lambda t: fsdp_sharding(mesh, t)``), as
    ``utils.checkpoint.restore_any(target_shardings=)`` passes them."""
    from tensorflowonspark_tpu_torch.parallel import sharding

    if callable(target_shardings):
        target_shardings = target_shardings(tree)
    t0 = time.perf_counter()
    with telemetry.span("elastic/reshard"):
        placed = sharding.apply_shardings(host_fetch(tree),
                                          target_shardings)
    metrics_registry.observe("tfos_elastic_reshard_ms",
                             (time.perf_counter() - t0) * 1000.0)
    return placed


def reshard_train_state(layout, params, state, opt_state, fsdp_axis="fsdp"):
    """Re-place a whole train state under ``layout``: fsdp for params
    and optimizer moments, replicated model state, the rules of the
    first placement (``shard_train_state``) applied through the host.
    Returns ``((params, state, opt_state), (p_sh, s_sh, o_sh))``."""
    t0 = time.perf_counter()
    with telemetry.span("elastic/reshard_train_state"):
        out = layout.shard_train_state(
            host_fetch(params), host_fetch(state), host_fetch(opt_state),
            fsdp_axis=fsdp_axis)
    metrics_registry.observe("tfos_elastic_reshard_ms",
                             (time.perf_counter() - t0) * 1000.0)
    return out
