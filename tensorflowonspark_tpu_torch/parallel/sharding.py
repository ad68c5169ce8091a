"""Sharding rules: how parameter, state and batch trees map onto the mesh.

Counterpart of ``tensorflowonspark_tpu/parallel/sharding.py``.  A
sharding is ``(mesh, placements)`` (``parallel.mesh``); placed trees
hold ``torch.distributed.tensor.DTensor`` leaves, each rank storing its
block.  GSPMD inserts the collectives of a sharded step in the JAX
package; here the step asks for them:

- :func:`gather_params` turns placed params into the full tensors the
  functional models compute with, all-gathering the dims sharded over
  the named axes (``fsdp``), differentiably: the backward sums every
  rank's gradient of a gathered block and keeps this rank's (a
  reduce-scatter, ZeRO-3's);
- :func:`reduce_gradients_` then sums (or averages) the gradients over
  the batch axes on which a param is replicated.

Dims sharded over ``model`` stay local: Megatron's layers compute on
their shards (``models/transformer.py``).  Optimizer moments follow
their parameter by construction: ``torch.optim`` keeps each moment as a
tensor like its param, a DTensor with the param's placements.
"""

from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree

from tensorflowonspark_tpu_torch.parallel import collectives as _coll
from tensorflowonspark_tpu_torch.parallel.mesh import (
    mesh_shape,
    place,
    replicated,
    replicated as replicated_sharding,  # noqa: F401 - the JAX name
    sharded,
)


def batch_sharding(mesh, axes=("data", "fsdp")):
    """Sharding for [batch, ...] arrays: the batch dim split over the
    data axes of size > 1."""
    shape = mesh_shape(mesh)
    present = tuple(a for a in axes if shape.get(a, 1) > 1)
    return sharded(mesh, present if present else None)


def fsdp_sharding(mesh, tree, axis="fsdp", min_shard_elems=2 ** 12):
    """ZeRO-style parameter sharding, the JAX package's rule: for each
    leaf, shard the largest dimension divisible by the fsdp axis size;
    leaves under ``min_shard_elems`` elements or with no divisible dim
    stay replicated.  Returns a tree of ``(mesh, placements)``."""
    n = mesh_shape(mesh).get(axis, 1)

    def rule(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if n <= 1 or not shape or math.prod(shape) < min_shard_elems:
            return replicated(mesh)
        # prefer the largest divisible dim (usually the output channels)
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % n == 0:
                spec = [None] * len(shape)
                spec[d] = axis
                return sharded(mesh, *spec)
        return replicated(mesh)

    return pytree.tree_map(rule, tree)


def _is_sharding(x):
    return (isinstance(x, tuple) and len(x) == 2 and hasattr(
        x[0], "mesh_dim_names")) or isinstance(x, torch.device)


def _map_with(fn, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree`` and the matching tree of
    shardings, by key (nested dicts, lists, tuples); one sharding where
    a subtree stands applies to all of its leaves (a prefix tree, as
    ``jax.device_put`` takes)."""
    if isinstance(tree, dict):
        if _is_sharding(shardings):
            return {k: _map_with(fn, v, shardings) for k, v in tree.items()}
        return {k: _map_with(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if _is_sharding(shardings):
            return type(tree)(_map_with(fn, v, shardings) for v in tree)
        return type(tree)(_map_with(fn, v, s)
                          for v, s in zip(tree, shardings, strict=True))
    return fn(tree, shardings)


def apply_shardings(tree, shardings):
    """Place every leaf of ``tree`` (full tensors, the same on every rank)
    by the matching tree of ``(mesh, placements)``: a tree of DTensors.
    A ``torch.device`` in place of a sharding (a one-process layout,
    which has no mesh) copies the leaf onto that device as it is.
    Leaves that require grad stay leaves that require grad."""

    def one(x, sh):
        if not _is_sharding(sh):
            raise ValueError(f"not a (mesh, placements) sharding: {sh!r}")
        req = bool(getattr(x, "requires_grad", False))
        x = torch.as_tensor(x).detach()
        dt = (x.to(sh, copy=True) if isinstance(sh, torch.device)
              else place(x, sh))
        return dt.requires_grad_() if req else dt

    return _map_with(one, tree, shardings)


def shard_train_state(mesh, params, state, opt_state=None,
                      fsdp_axis="fsdp"):
    """Lay out the train state: fsdp for params (and the moments of an
    ``opt_state`` tree, scalars replicated), replicated BN state.
    Returns ``((params, state, opt_state), (p_sh, s_sh, o_sh))``; the
    placed params are leaves that require grad, ready for a
    ``torch.optim`` optimizer, whose moments then follow them."""
    p_sh = fsdp_sharding(mesh, params, fsdp_axis)
    s_sh = pytree.tree_map(lambda _: replicated(mesh), state)
    o_sh = pytree.tree_map(
        lambda leaf: fsdp_sharding(mesh, leaf, fsdp_axis)
        if getattr(leaf, "ndim", 0) else replicated(mesh), opt_state)
    placed_params = apply_shardings(
        pytree.tree_map(lambda p: torch.as_tensor(p).detach()
                        .requires_grad_(), params), p_sh)
    placed = (placed_params, apply_shardings(state, s_sh),
              None if opt_state is None else apply_shardings(opt_state,
                                                             o_sh))
    return placed, (p_sh, s_sh, o_sh)


class _GatherShard(torch.autograd.Function):
    """All-gather dim ``d`` over ``group``; the backward sums the full
    gradient over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, d, group):
        ctx.d, ctx.group = d, group
        return _coll._gather(x, d, group)

    @staticmethod
    def backward(ctx, g):
        return _coll.reduce_scatter(g, ctx.d, ctx.group), None, None


def _gather_leaf(x, axes):
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    local = x.to_local()
    # the earlier mesh axis is the outer cut: gather the inner one first
    for i in reversed(range(len(x.placements))):
        pl, name = x.placements[i], mesh.mesh_dim_names[i]
        if isinstance(pl, Shard) and name in axes:
            group = mesh.get_group(name)
            if _coll.group_size(group) > 1:
                local = _GatherShard.apply(local, pl.dim, group)
    return local


def gather_params(tree, axes=("fsdp",)):
    """DTensor leaves -> plain tensors with every dim sharded over one of
    ``axes`` gathered (differentiably, see the module docstring); dims
    sharded over other axes (``model``) stay this rank's block.  Plain
    tensor leaves pass through."""
    return pytree.tree_map(lambda x: _gather_leaf(x, axes), tree)


def local_tree(tree):
    """DTensor leaves -> this rank's block (``to_local``), detached."""
    from torch.distributed.tensor import DTensor

    return pytree.tree_map(
        lambda x: x.to_local().detach() if isinstance(x, DTensor) else x,
        tree)


def reduce_gradients_(params, axes=("data", "fsdp"), mean=True):
    """Combine the gradients of placed ``params`` over the batch
    ``axes``, in place: each gradient is summed over every axis on which
    its param is replicated (an axis it is sharded on was summed by the
    gather's backward), then divided by the product of the axes' sizes
    when ``mean``.  Use ``mean=True`` when each rank's loss is its local
    mean (the data-parallel convention of ``utils.train``), False when
    each rank's loss is its share of the global sum."""
    from torch.distributed.tensor import DTensor, Replicate

    for p in pytree.tree_leaves(params):
        g = p.grad
        if g is None:
            continue
        if not isinstance(p, DTensor):
            raise TypeError("reduce_gradients_ needs placed (DTensor) "
                            "params")
        mesh = p.device_mesh
        local = g.to_local()
        div = 1
        for i, name in enumerate(mesh.mesh_dim_names):
            if name not in axes:
                continue
            group = mesh.get_group(name)
            div *= _coll.group_size(group)
            if isinstance(p.placements[i], Replicate) \
                    and _coll.group_size(group) > 1:
                local = _coll._sum(local, group)
        if mean and div > 1:
            local = local / div
        p.grad = DTensor.from_local(local, mesh, p.placements,
                                    run_check=False, shape=p.shape,
                                    stride=p.stride())
