"""Device meshes over a process group, and placement helpers.

Counterpart of ``tensorflowonspark_tpu/parallel/mesh.py``.  There, one
SPMD program lays tensors out over a named-axis ``jax.sharding.Mesh``
and XLA inserts the collectives.  Here every process is one position of
a :class:`torch.distributed.device_mesh.DeviceMesh` with the same named
axes, and the parallel layers issue the collectives over the mesh's
per-axis process groups (``mesh.get_group("seq")``) themselves.

Axis convention (any subset may be size 1), as in the JAX package:
  ``data``  — data parallel (batch sharding)
  ``fsdp``  — parameter sharding over the data axis group (ZeRO-style)
  ``model`` — tensor/model parallel
  ``seq``   — sequence/context parallel (ring attention)
  ``pp``    — pipeline stages
  ``ep``    — MoE expert parallel
("pipe" and "expert" are accepted as aliases of pp/ep.)

A placement is ``(mesh, placements)``: the mesh and one
``torch.distributed.tensor`` placement per mesh axis (``Shard(d)`` or
``Replicate()``), the counterpart of a ``NamedSharding``.  A spec is
what ``PartitionSpec`` holds: one entry per tensor dim, an axis name, a
tuple of names or None.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

AXIS_ORDER = ("pp", "data", "fsdp", "seq", "ep", "model")

# accepted alternate spellings -> canonical axis name
AXIS_ALIASES = {"pipe": "pp", "expert": "ep"}


def canonical_axes(axes):
    """Alias-canonicalized copy of an axes dict ({'pipe': 2} -> {'pp': 2});
    raises when two spellings collide after canonicalization."""
    sizes = {AXIS_ALIASES.get(k, k): v for k, v in axes.items()}
    if len(sizes) != len(axes):
        raise ValueError(
            f"mesh axes {list(axes)} collide after alias "
            f"canonicalization ({AXIS_ALIASES})"
        )
    return sizes


@dataclass
class MeshSpec:
    """Named axis sizes; -1 at most once to absorb remaining devices."""

    axes: dict = field(default_factory=dict)

    def resolve(self, n_devices):
        sizes = canonical_axes(self.axes)
        unknown = [k for k, v in sizes.items() if v == -1]
        known = math.prod(v for v in sizes.values() if v != -1)
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[unknown[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


def make_mesh(axes=None, *, device_type):
    """A ``DeviceMesh`` with named axes over the initialised process
    group, one mesh position per rank (row-major, the trailing axis
    changing fastest, so ``model`` ranks are neighbours).

    Args:
      axes: {name: size} with at most one -1; default {'data': -1}.  The
        sizes multiply to the world size.
      device_type: ``"cuda"`` (one card a rank, NCCL) or ``"cpu"`` (gloo
        ranks); required, so a mesh is on the CPU only when asked.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    sizes = MeshSpec(dict(axes) if axes else {"data": -1}).resolve(
        dist.get_world_size())
    # AXIS_ORDER first, then any other names in their given order
    names = [a for a in AXIS_ORDER if a in sizes] + [
        a for a in sizes if a not in AXIS_ORDER]
    shape = tuple(sizes[n] for n in names)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=tuple(names))
    logger.info("mesh: %s", dict(zip(names, shape)))
    return mesh


def mesh_shape(mesh):
    """``{axis name: size}`` in mesh order (``mesh.shape`` of a JAX mesh)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def spec_to_placements(mesh, spec):
    """A PartitionSpec-like tuple -> one placement per mesh axis: an axis
    named by tensor dim d's entry becomes ``Shard(d)``, the others
    ``Replicate()``.  Entries may name axes the mesh lacks (dropped), as
    a spec written for a larger mesh may."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name in owner:
                raise ValueError(f"mesh axis {name!r} used twice in {spec}")
            owner[name] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in mesh.mesh_dim_names)


def sharded(mesh, *spec):
    """``(mesh, placements)`` over the given PartitionSpec entries."""
    return mesh, spec_to_placements(mesh, spec)


def replicated(mesh):
    """``(mesh, placements)`` replicated over every axis."""
    return mesh, spec_to_placements(mesh, ())


def local_shard(x, mesh, placements):
    """This rank's block of the full tensor ``x`` under ``placements``
    (mesh axes in order, each ``Shard(d)`` cutting dim d into equal
    parts, the earlier axis the outer cut, as DTensor does)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.mesh.shape[i]
            if x.shape[pl.dim] % n:
                raise ValueError(
                    f"dim {pl.dim} of shape {tuple(x.shape)} does not "
                    f"divide over mesh axis {mesh.mesh_dim_names[i]} ({n})")
            x = x.chunk(n, dim=pl.dim)[coord[i]]
    return x.contiguous()


def place(x, sharding):
    """The full tensor ``x`` (the same on every rank, as a host tree
    ``device_put`` takes) -> a ``DTensor`` holding this rank's block, on
    the mesh's device.  No communication: each rank cuts its own
    block."""
    import torch
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding
    # a copy, as a device_put is: the placed tree never aliases ``x``
    local = local_shard(x, mesh, placements).clone()
    if mesh.device_type == "cuda" and local.device.type != "cuda":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=_contiguous_stride(
                                  tuple(x.shape)))


def local_to_global(mesh, local_arrays, axis="data"):
    """Each rank's local batch as its shard of one global batch.

    Returns DTensors (``Shard(0)`` over ``axis``, which may be a tuple of
    axes such as ``("data", "fsdp")``, replicated over the others) whose
    global shape is the concatenation of every rank's batch along dim 0;
    ``.to_local()`` is this rank's batch again, which is what the port's
    training steps compute on.  Every rank's batch must have the same
    shape."""
    from torch.utils import _pytree as pytree

    spec = (axis,)

    def one(x):
        from torch.distributed.tensor import DTensor

        _, placements = sharded(mesh, *spec)
        n = math.prod(mesh.mesh.shape[i] for i, p in enumerate(placements)
                      if not p.is_replicate())
        shape = (x.shape[0] * n,) + tuple(x.shape[1:])
        return DTensor.from_local(x.contiguous(), mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    return pytree.tree_map(one, local_arrays)


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))
