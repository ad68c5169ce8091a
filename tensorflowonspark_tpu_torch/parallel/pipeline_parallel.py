"""Pipeline parallelism: GPipe-style microbatching over a ``pp`` mesh axis.

Counterpart of ``tensorflowonspark_tpu/parallel/pipeline_parallel.py``:

- stage parameters are stacked on a leading axis placed over ``pp``
  (:func:`stage_sharding`): rank i holds stage i's weights only;
- the batch is split into m microbatches; at tick t, stage i runs
  microbatch t-i (bubble fraction (S-1)/(m+S-1)): ``m + S - 1`` ticks,
  stage 0 ingesting, the last stage banking, and an all-reduce of the
  one-hot bank that leaves the output on every stage;
- activations pass to the next stage with the autograd
  :func:`parallel.collectives.ppermute`, so the pipeline is
  differentiable end to end (the JAX package's ``lax.scan`` over
  ``lax.ppermute`` is a Python loop here).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from tensorflowonspark_tpu_torch.parallel import collectives as _coll
from tensorflowonspark_tpu_torch.parallel.mesh import sharded


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def pipeline_apply(stage_fn, stage_params, x, *, mesh, n_microbatches,
                   axis_name="pp"):
    """Run ``stage_fn(params_i, x) -> x`` through the S stages of
    ``axis_name``.

    ``stage_params``: the stacked tree placed by :func:`stage_sharding`
    (DTensors), or this rank's block of it (leading axis of size 1).
    ``x``: [B, ...], the whole batch on every stage; B must divide by
    ``n_microbatches``.  Returns the last stage's output, same shape as
    x, on every stage.  The loss computed from it is the same on every
    stage, and each stage's parameter gradients are its own."""
    group = (mesh.get_group(axis_name)
             if axis_name in mesh.mesh_dim_names else None)
    n_stages, idx = _coll.group_size(group), _coll.group_rank(group)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by n_microbatches "
                         f"{n_microbatches}")
    mb = b // n_microbatches
    xm = x.reshape(n_microbatches, mb, *x.shape[1:])
    params = pytree.tree_map(lambda p: _local(p)[0], stage_params)

    total = n_microbatches + n_stages - 1
    state = torch.zeros_like(xm[0])   # activation entering this stage
    bank = [None] * n_microbatches
    received = []
    for t in range(total):
        if idx == 0:   # stage 0 ingests microbatch t (clipped)
            if t > 0:
                received.append(state)
            state = xm[min(t, n_microbatches - 1)]
        y = stage_fn(params, state)
        # stage i finishes microbatch t-i; the last stage banks it
        if idx == n_stages - 1 and t >= n_stages - 1:
            bank[t - (n_stages - 1)] = y
        if t + 1 < total:
            state = _coll.ppermute(y, group)
    out = (torch.stack(bank) if idx == n_stages - 1
           else torch.zeros_like(xm))
    # the last stage's bank on every stage: a one-hot sum, whose
    # backward hands the (replicated) cotangent to the last stage
    out = _coll.tie(_coll.reduce_from(out, group), received)
    return out.reshape(b, *x.shape[1:])


def stack_stage_params(params_list):
    """[per-stage trees] -> one tree with a leading stage axis."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *params_list)


def stage_sharding(mesh, stage_params, axis_name="pp"):
    """Shardings placing the stacked stage axis on ``axis_name``."""
    return pytree.tree_map(lambda _: sharded(mesh, axis_name), stage_params)
