"""Virtual-device layer: a logical mesh decoupled from the hardware.

Counterpart of ``tensorflowonspark_tpu/elastic/virtual.py``.  One
``TrainSpec``'s *logical* mesh (``data=8, fsdp=4``: 32 virtual devices)
runs unchanged on any physical device count that divides it: the
surplus factor folds out of the accumulation axis (default ``data``)
and is made up with gradient accumulation, so the optimizer sees the
same global batch and the same mean gradient on one device or many.

The algebra, for ``n_virtual = prod(logical)`` and ``n_physical``
devices, is the JAX package's:

- ``n_virtual % n_physical == 0`` (divisor topologies only);
- ``factor = n_virtual // n_physical`` divides the accumulation axis,
  giving ``physical[accum] = logical[accum] / factor`` and
  ``accum_steps = factor``;
- every other axis keeps its logical size.

Here the devices are the ranks of the process group: the list holds
one entry for each device a rank was given (one: its ``torch.device``)
times the world size.  With an initialised process group the layout's
mesh is a ``DeviceMesh`` over every rank (``parallel.mesh.make_mesh``),
so the list must be as long as the world; without one, the layout is a
single process's, its mesh None and its placements the device itself.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

from tensorflowonspark_tpu_torch.parallel.mesh import canonical_axes

logger = logging.getLogger(__name__)

DEFAULT_ACCUM_AXIS = "data"
BATCH_AXES = ("data", "fsdp")  # the axes the global batch is split over


def _as_device(d):
    import torch

    if isinstance(d, torch.device):
        return d
    if isinstance(d, str):
        return torch.device(d)
    return None


@dataclass(frozen=True)
class VirtualLayout:
    """One placement of a logical mesh onto physical devices.

    ``logical`` is the stable shape a ``TrainSpec`` names; ``physical``
    what this incarnation's devices support; ``accum_steps`` bridges
    them (``prod(logical) == prod(physical) * accum_steps``).  ``mesh``
    is the ``DeviceMesh`` over ``physical`` (None for one process
    outside a process group); ``device`` this rank's device."""

    logical: dict = field(default_factory=dict)
    physical: dict = field(default_factory=dict)
    accum_axis: str = DEFAULT_ACCUM_AXIS
    accum_steps: int = 1
    mesh: object = None
    device: object = None

    @property
    def n_virtual(self):
        return math.prod(self.logical.values()) if self.logical else 1

    @property
    def n_physical(self):
        return math.prod(self.physical.values()) if self.physical else 1

    # -- placements: (mesh, placements), or the device without a mesh --

    def batch_sharding(self, axes=BATCH_AXES):
        if self.mesh is None:
            return self.device
        from tensorflowonspark_tpu_torch.parallel import sharding

        return sharding.batch_sharding(self.mesh, axes=axes)

    def fsdp_sharding(self, tree, axis="fsdp"):
        if self.mesh is None:
            from torch.utils import _pytree as pytree

            return pytree.tree_map(lambda _: self.device, tree)
        from tensorflowonspark_tpu_torch.parallel import sharding

        return sharding.fsdp_sharding(self.mesh, tree, axis)

    def replicated(self):
        if self.mesh is None:
            return self.device
        from tensorflowonspark_tpu_torch.parallel import mesh as _mesh

        return _mesh.replicated(self.mesh)

    def shard_train_state(self, params, state, opt_state, fsdp_axis="fsdp"):
        """``((params, state, opt_state), (p_sh, s_sh, o_sh))`` as
        ``parallel.shard_train_state`` lays them out; without a mesh,
        every leaf copied onto the device (params requiring grad)."""
        from tensorflowonspark_tpu_torch.parallel import sharding

        if self.mesh is not None:
            return sharding.shard_train_state(self.mesh, params, state,
                                              opt_state,
                                              fsdp_axis=fsdp_axis)
        import torch
        from torch.utils import _pytree as pytree

        dev = self.device
        placed_params = sharding.apply_shardings(
            pytree.tree_map(lambda p: torch.as_tensor(p).detach()
                            .requires_grad_(), params), dev)
        placed = (placed_params, sharding.apply_shardings(state, dev),
                  None if opt_state is None
                  else sharding.apply_shardings(opt_state, dev))
        return placed, (dev, dev, dev)

    # -- the step -------------------------------------------------------

    def value_and_grad(self, loss_fn):
        """``loss_fn``'s value and gradient at this layout's
        accumulation depth: ``vg(params, *batch) -> (loss, grads)``.
        ``params`` is a tree of leaf tensors; ``batch`` this rank's share
        of the global batch, replayed in ``accum_steps`` microbatches on
        its leading axis (``utils.train.accumulated_value_and_grad``).
        The mean gradient is put in the leaves' ``.grad``, for a
        ``torch.optim`` step, and averaged with the loss over the
        processes (``utils.train.average_gradients_``), so loss and mean
        gradient are the logical shape's on any divisor topology."""
        from tensorflowonspark_tpu_torch.utils import train

        other = {a: n for a, n in self.physical.items()
                 if a not in BATCH_AXES and n > 1}
        if self.mesh is not None and other:
            raise ValueError(f"a data parallel step needs a data x fsdp "
                             f"layout; this one also has {other}")
        base = train.accumulated_value_and_grad(loss_fn, self.accum_steps)

        def vg(params, *batch):
            from torch.utils import _pytree as pytree

            loss, grads = base(params, *batch)
            leaves, spec = pytree.tree_flatten(params)
            for p, g in zip(leaves, pytree.tree_leaves(grads)):
                p.grad = g
            if self.mesh is not None:
                train.average_gradients_(leaves)
                train.all_reduce_mean_([loss])
            return loss, pytree.tree_unflatten([p.grad for p in leaves], spec)

        return vg

    def microbatch(self, global_batch):
        """The rows one physical step takes, ``accum_steps`` times an
        optimizer update."""
        if global_batch % self.accum_steps:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"accum_steps={self.accum_steps}")
        return global_batch // self.accum_steps

    def describe(self):
        return (f"logical={self.logical} physical={self.physical} "
                f"accum={self.accum_steps}x{self.accum_axis} "
                f"devices={self.n_physical}")


def virtualize(logical_axes, devices, accum_axis=DEFAULT_ACCUM_AXIS):
    """Place ``logical_axes`` (a fully specified virtual mesh shape)
    onto ``devices``, folding any surplus into gradient accumulation.

    Raises ``ValueError``, as the JAX package does, when the device
    count does not divide the virtual device count, when the surplus
    does not divide the accumulation axis, or when the logical shape
    holds ``-1``; and when a process group is initialised but
    ``devices`` is not one a rank."""
    logical = canonical_axes(dict(logical_axes))
    if any(v == -1 for v in logical.values()):
        raise ValueError(
            f"virtual mesh shape must be fully specified, got {logical} "
            "(-1 absorption is only meaningful against a fixed device "
            "count; see parallel.mesh.MeshSpec)")
    if any(v < 1 for v in logical.values()):
        raise ValueError(f"virtual mesh axis sizes must be >= 1: {logical}")
    accum_axis = canonical_axes({accum_axis: 1}).popitem()[0]
    devices = list(devices)
    n_virtual = math.prod(logical.values()) if logical else 1
    n_physical = len(devices)
    if n_physical < 1:
        raise ValueError("virtualize: empty device list")
    if n_virtual % n_physical:
        raise ValueError(
            f"{n_physical} devices is not a divisor topology of the "
            f"virtual mesh {logical} ({n_virtual} virtual devices)")
    factor = n_virtual // n_physical
    physical = dict(logical)
    if factor > 1:
        if accum_axis not in logical:
            raise ValueError(
                f"virtual mesh {logical} has no '{accum_axis}' axis to "
                f"fold the {factor}x device deficit into")
        if logical[accum_axis] % factor:
            raise ValueError(
                f"cannot fold {factor}x into axis '{accum_axis}' of size "
                f"{logical[accum_axis]} (virtual {logical} on "
                f"{n_physical} devices)")
        physical[accum_axis] = logical[accum_axis] // factor
    mesh, rank = None, 0
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_physical != world:
            raise ValueError(
                f"{n_physical} devices for a process group of {world} "
                "ranks: a rank is given one device")
        dev = _as_device(devices[rank])
        from tensorflowonspark_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(physical or {"data": 1},
                         device_type=dev.type if dev is not None else "cuda")
    layout = VirtualLayout(logical=logical, physical=physical,
                           accum_axis=accum_axis, accum_steps=factor,
                           mesh=mesh, device=_as_device(devices[rank]))
    logger.info("virtualize: %s", layout.describe())
    return layout
