"""Differentiable collectives over process groups.

JAX differentiates ``lax.psum``, ``lax.ppermute`` and ``lax.all_to_all``
inside ``shard_map`` for free.  Here each is a ``torch.autograd.Function``
whose backward is the transposed collective:

- :func:`all_reduce`: sum forward, sum backward (every rank's
  cotangent reaches every rank's input; a statistic that each rank's
  loss reads, as in global batch norm);
- :func:`copy_to` / :func:`reduce_from`: Megatron's pair ``f`` (identity
  forward, sum backward) and ``g`` (sum forward, identity backward),
  for a computation whose loss is the same on every rank of the group;
- :func:`gather_from`: all-gather along a dim forward, this rank's slice
  backward (the loss again the same on every rank);
- :func:`ppermute`: send to the next rank of the ring and receive from
  the previous one; the backward sends the other way;
- :func:`all_to_all`: the tiled all-to-all of ``lax.all_to_all``; its
  backward swaps the split and concat axes.

Every rank must run the same collectives in the same order, in the
backward too.  Autograd runs the backward nodes of a graph in reverse
creation order, so the order matches across ranks as long as every rank's
backward reaches the same communicating nodes.  A rank that skips a
block (a causal ring) or drops what it received (pipeline stage 0)
would not reach that node's backward; :func:`tie` joins such tensors to
the result with a zero gradient, so it does.

A group of one process (or ``None``) issues no collective.  Groups are
``torch.distributed`` process groups, e.g. ``mesh.get_group("seq")`` of
a :class:`~torch.distributed.device_mesh.DeviceMesh`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group):
    """Processes in ``group``; 1 for None or outside a process group."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group):
    return 0 if group_size(group) == 1 else dist.get_rank(group)


def _sum(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _gather(x, dim, group):
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_chunk(x, dim, group):
    return x.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()


def reduce_scatter(x, dim, group):
    """Sum ``x`` over ``group`` and keep this rank's chunk along ``dim``
    (not differentiable).  gloo builds of torch before 2.13 lack
    ``reduce_scatter``, so gloo groups all-reduce and slice."""
    if group_size(group) == 1:
        return x
    if dist.get_backend(group) == "gloo":
        return _own_chunk(_sum(x, group), dim, group)
    parts = [p.contiguous() for p in x.chunk(group_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.dim, ctx.group), None, None


def _shift(x, group, step):
    """Send ``x`` to the rank ``step`` ahead in ``group``'s ring and
    return what the rank ``step`` behind sent."""
    n, r = group_size(group), group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    ops = [dist.P2POp(dist.isend, x, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _a2a(x, group, split_axis, concat_axis):
    n = group_size(group)
    shape = list(x.shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(shape)} "
                         f"not divisible by the group's {n} ranks")
    # [.., n, split/n, ..] with the rank chunk moved to the front
    xs = x.reshape(shape[:split_axis] + [n, shape[split_axis] // n]
                   + shape[split_axis + 1:])
    xs = xs.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    # out[i] is rank i's chunk, with the dims of x: put the rank dim just
    # before concat_axis and merge the two (rank-major concatenation)
    new = list(shape)
    new[split_axis] = shape[split_axis] // n
    new[concat_axis] = new[concat_axis] * n
    out = out.movedim(0, concat_axis)
    return out.reshape(new)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def all_reduce(x, group):
    """Sum over ``group``; the backward sums the cotangents too."""
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)


def copy_to(x, group):
    """Identity; the backward sums the cotangents over ``group``."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group``; the backward passes the cotangent through."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, dim, group):
    """Concatenate every rank's ``x`` along ``dim`` in rank order; the
    backward keeps this rank's slice."""
    return x if group_size(group) == 1 else _GatherFrom.apply(x, dim, group)


def ppermute(x, group):
    """Ring shift by one: rank i's ``x`` goes to rank i+1 (mod n)."""
    return x if group_size(group) == 1 else _PPermute.apply(x, group)


def all_to_all(x, group, split_axis, concat_axis):
    """``lax.all_to_all(tiled=True)``: split ``split_axis`` into n
    chunks, send chunk j to rank j, concatenate the received chunks
    along ``concat_axis`` in rank order."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.likes = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.likes))


def tie(out, tensors):
    """``out``, with ``tensors`` joined to it in the graph at a zero
    gradient: the backward then reaches whatever produced them (a
    received shift whose value this rank did not use) on every rank."""
    tensors = [t for t in tensors if t.requires_grad]
    if not tensors or not torch.is_grad_enabled():
        return out
    return _Tie.apply(out, *tensors)
