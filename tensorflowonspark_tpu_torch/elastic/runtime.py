"""Elastic runtime: one ``TrainSpec``, any divisor topology.

Counterpart of ``tensorflowonspark_tpu/elastic/runtime.py``.  A
``TrainSpec`` names the *logical* mesh a model is configured for (axis
convention: ``parallel.mesh.AXIS_ORDER``).  ``ElasticRuntime`` resolves
it against the devices this incarnation has (``elastic.virtualize``),
hands out placements, and when the cluster shrinks or re-grows under
``cluster.run(restarts=N, min_executors=k)``, ``resize()`` re-forms the
layout over the surviving devices and ``reshard`` / ``restore`` re-place
the train state under it (``elastic.reshard``).

Every build and resize sets the gauges ``tfos_elastic_mesh_devices``,
``tfos_elastic_virtual_devices`` and ``tfos_elastic_accum_steps``; a
resize counts in ``tfos_elastic_resizes_total{scope="runtime"}``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import tensorflowonspark_tpu_torch.elastic.virtual as _virtual
# function imports, not the module: the package re-exports the
# reshard() function under the reshard module's name
from tensorflowonspark_tpu_torch.elastic.reshard import (
    reshard as _reshard_tree,
    reshard_train_state as _reshard_train_state,
)
from tensorflowonspark_tpu_torch.utils import metrics_registry, telemetry

logger = logging.getLogger(__name__)


@dataclass
class TrainSpec:
    """The topology-stable half of a training config.

    ``mesh_axes``: the fully specified logical mesh, e.g. ``{"data": 8,
    "fsdp": 4}`` (aliases ``pipe``/``expert`` accepted).
    ``global_batch``: the optimizer's batch size; 0 when the caller
    batches by itself.  ``accum_axis``: the axis that absorbs a device
    deficit through gradient accumulation (default ``data``)."""

    mesh_axes: dict = field(default_factory=dict)
    global_batch: int = 0
    accum_axis: str = _virtual.DEFAULT_ACCUM_AXIS


def default_devices(device=None):
    """One device a rank: this rank's (``device``, default the current
    CUDA device, which raises without a card) times the world size of
    the process group (1 without one)."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import resolve_device

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return [resolve_device(device)] * world


class ElasticRuntime:
    """The layout of one training job: built once, resized on a
    topology change, with the train state placed and restored under
    the current layout::

        rt = ElasticRuntime(TrainSpec({"data": 8}), devices)
        (params, state, opt_state), shardings = rt.shard_train_state(...)
        ...                      # an executor lost; recovery re-formed us
        rt.resize(default_devices())          # 8 virtual -> 4 physical
        (params, ...), shardings = rt.reshard_train_state(params, ...)
    """

    def __init__(self, spec, devices=None):
        if not isinstance(spec, TrainSpec):
            spec = TrainSpec(dict(spec))
        self.spec = spec
        self.generation = 0
        self.layout = None
        self._build(devices, event="elastic/build")

    # -- topology -------------------------------------------------------

    def _build(self, devices, event):
        if devices is None:
            devices = default_devices()
        layout = _virtual.virtualize(self.spec.mesh_axes, devices,
                                     accum_axis=self.spec.accum_axis)
        self.layout = layout
        telemetry.event(event, generation=self.generation,
                        logical=dict(layout.logical),
                        physical=dict(layout.physical),
                        accum_steps=layout.accum_steps,
                        devices=layout.n_physical)
        metrics_registry.set_gauge("tfos_elastic_mesh_devices",
                                   layout.n_physical)
        metrics_registry.set_gauge("tfos_elastic_virtual_devices",
                                   layout.n_virtual)
        metrics_registry.set_gauge("tfos_elastic_accum_steps",
                                   layout.accum_steps)
        logger.info("elastic runtime gen %d: %s", self.generation,
                    layout.describe())
        return layout

    def resize(self, devices=None):
        """Re-form the layout over a new device set (smaller after an
        executor loss, larger after the pool re-grew).  The logical
        shape never changes, only the physical fold.  Tensors keep
        their old placement: pass them through ``reshard`` or
        ``reshard_train_state`` before stepping again."""
        self.generation += 1
        layout = self._build(devices, event="elastic/resize")
        metrics_registry.inc("tfos_elastic_resizes_total", scope="runtime")
        return layout

    # -- placement ------------------------------------------------------

    @property
    def mesh(self):
        return self.layout.mesh

    def batch_sharding(self, axes=_virtual.BATCH_AXES):
        return self.layout.batch_sharding(axes=axes)

    def fsdp_sharding(self, tree, axis="fsdp"):
        return self.layout.fsdp_sharding(tree, axis=axis)

    def replicated(self):
        return self.layout.replicated()

    def shard_train_state(self, params, state, opt_state, fsdp_axis="fsdp"):
        return self.layout.shard_train_state(params, state, opt_state,
                                             fsdp_axis=fsdp_axis)

    def reshard(self, tree, shardings=None):
        """Re-place any tree under the current layout (through the
        host); by default the fsdp rules over the tree."""
        if shardings is None:
            shardings = self.layout.fsdp_sharding(tree)
        return _reshard_tree(tree, shardings)

    def reshard_train_state(self, params, state, opt_state,
                            fsdp_axis="fsdp"):
        return _reshard_train_state(self.layout, params, state, opt_state,
                                    fsdp_axis=fsdp_axis)

    def value_and_grad(self, loss_fn):
        return self.layout.value_and_grad(loss_fn)

    def restore(self, ckpt_dir, shardings=None):
        """``(tree, step)`` from the newest checkpoint in ``ckpt_dir``,
        placed under the current layout (``utils.checkpoint.restore_any(
        target_shardings=)``): the resize-aware resume.  ``shardings``:
        a placement tree or a callable; default the fsdp rules over the
        restored tree."""
        from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

        if shardings is None:
            def shardings(tree):
                return self.layout.fsdp_sharding(tree)
        return ckpt.restore_any(ckpt_dir, target_shardings=shardings)

    # -- batch schedule -------------------------------------------------

    def batch_schedule(self):
        """How ``spec.global_batch`` lands on the current layout:
        ``{"global", "microbatch", "per_device", "accum_steps"}``.  The
        global batch (so the optimizer's trajectory) is the same on every
        topology; only the per-dispatch slice moves."""
        gb = int(self.spec.global_batch)
        if gb <= 0:
            raise ValueError("TrainSpec.global_batch not set")
        layout = self.layout
        micro = layout.microbatch(gb)
        data_shards = 1
        for a in _virtual.BATCH_AXES:
            data_shards *= layout.physical.get(a, 1)
        if micro % data_shards:
            raise ValueError(
                f"microbatch {micro} not divisible by {data_shards} "
                f"batch shards (layout {layout.describe()})")
        return {"global": gb, "microbatch": micro,
                "per_device": micro // data_shards,
                "accum_steps": layout.accum_steps}


def from_context(ctx, spec, devices=None):
    """An :class:`ElasticRuntime` inside a cluster node, after
    ``ctx.torch_initialize``: by default one device a rank of the job
    (``ctx.device``, times the world size), the logical shape the
    caller's ``TrainSpec``.  The event carries the node's cluster epoch,
    so that resize generations line up with incarnations in the
    trace."""
    if devices is None:
        dev = getattr(ctx, "device", None)
        if dev is None:
            raise RuntimeError("elastic runtime: call ctx.torch_initialize() "
                               "first (or pass devices=)")
        devices = default_devices(dev)
    rt = ElasticRuntime(spec, devices=devices)
    telemetry.event("elastic/from_context", epoch=getattr(ctx, "epoch", 0),
                    job=getattr(ctx, "job_name", None),
                    task=getattr(ctx, "task_index", None),
                    devices=rt.layout.n_physical)
    return rt
