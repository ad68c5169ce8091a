"""Training-loop building blocks: gradient norm, health probe, gradient
accumulation.

Counterpart of ``tensorflowonspark_tpu/utils/train.py``.  Parameters and
gradients are trees of tensors (nested dicts, lists or tuples) with the
reference's layout.  Where the reference scans microbatches under one
``jit``, this is a Python loop: each microbatch runs forward and
backward, its gradients are added to a running sum, and the sum is
divided by ``accum_steps`` at the end, so memory stays that of one
microbatch.
"""

from __future__ import annotations

import os

import torch
from torch.utils import _pytree as pytree

GRADNORM_ENV = "TFOS_HEALTH_GRADNORM"


def gradnorm_enabled():
    """True when ``TFOS_HEALTH_GRADNORM`` asks for the health probe."""
    return os.environ.get(GRADNORM_ENV, "").strip().lower() in (
        "1", "true", "on", "yes")


def global_norm(tree):
    """Global L2 norm over a gradient tree, accumulated in float32."""
    leaves = [x for x in pytree.tree_leaves(tree) if torch.is_tensor(x)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)


def health_probe(loss, grads):
    """``{"grad_norm", "finite"}`` (a float32 scalar and a bool scalar:
    ``isfinite(loss) & isfinite(grad_norm)``), computed on the gradients'
    device, to forward into ``TrainMetrics.step(grad_norm=...,
    grad_finite=...)``; None when ``TFOS_HEALTH_GRADNORM`` is off, so a
    step can call it unconditionally and pay nothing unless enabled."""
    if not gradnorm_enabled():
        return None
    gn = global_norm(grads)
    loss = torch.as_tensor(loss, dtype=torch.float32, device=gn.device)
    finite = torch.logical_and(torch.all(torch.isfinite(loss)),
                               torch.isfinite(gn))
    return {"grad_norm": gn, "finite": finite}


def split_microbatches(batch, accum_steps):
    """Reshape every tensor leaf of ``batch`` (leading batch dim shared)
    to ``[accum_steps, b / accum_steps, ...]``.  Raises when the leading
    dim is not divisible."""

    def split(x):
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"accum_steps={accum_steps}")
        return x.reshape(accum_steps, x.shape[0] // accum_steps,
                         *x.shape[1:])

    return pytree.tree_map(split, batch)


def _detach(tree):
    return pytree.tree_map(
        lambda x: x.detach() if torch.is_tensor(x) else x, tree)


def value_and_grad(loss_fn, has_aux=False):
    """``jax.value_and_grad`` for a tree of tensors: ``vg(params, *args)
    -> (loss, grads)`` (or ``((loss, aux), grads)``), gradients with
    respect to every tensor leaf of ``params``, in its tree layout.  The
    leaves are differentiated through detached aliases (no copy), so the
    caller's tensors and their ``.grad`` are left alone; the returned
    loss and aux are detached."""

    def vg(params, *args):
        leaves, spec = pytree.tree_flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        out = loss_fn(pytree.tree_unflatten(live, spec), *args)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        grads = pytree.tree_unflatten(list(grads), spec)
        loss = loss.detach()
        return ((loss, _detach(aux)), grads) if has_aux else (loss, grads)

    return vg


def accumulated_value_and_grad(loss_fn, accum_steps, has_aux=False,
                               carry_aux=False):
    """:func:`value_and_grad` with microbatch accumulation.

    ``loss_fn(params, *batch) -> loss`` (or ``(loss, aux)`` with
    ``has_aux=True``).  Returns ``vg(params, *batch)`` -> ``(loss,
    grads)`` (or ``((loss, aux), grads)``); every batch leaf's leading
    dimension must be divisible by ``accum_steps``, and the loss and
    gradients are the mean over microbatches (one big batch's, for a
    mean-reduced loss).

    ``carry_aux=True`` (requires ``has_aux``) threads the aux through
    the microbatches, ``loss_fn(params, aux_prev, *mb)``, so stateful
    aux advances once per microbatch; the caller passes the incoming
    state as ``vg(params, *batch, init_aux=state)``.  Without it, aux is
    the last microbatch's.

    ``accum_steps=1`` returns plain :func:`value_and_grad`."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if carry_aux and not has_aux:
        raise ValueError("carry_aux requires has_aux=True")
    base = value_and_grad(loss_fn, has_aux=has_aux)
    if accum_steps == 1 and not carry_aux:
        return base

    def vg(params, *batch, init_aux=None):
        if carry_aux and init_aux is None:
            raise ValueError("carry_aux=True requires init_aux=...")
        micro = split_microbatches(batch, accum_steps)
        loss_sum, aux, grad_sum = 0.0, init_aux, None
        for i in range(accum_steps):
            mb = pytree.tree_map(lambda x, i=i: x[i], micro)
            if carry_aux:
                (loss, aux), grads = base(params, aux, *mb)
            else:
                out, grads = base(params, *mb)
                loss, aux = out if has_aux else (out, aux)
            loss_sum = loss_sum + loss
            grad_sum = grads if grad_sum is None else pytree.tree_map(
                torch.add, grad_sum, grads)
        loss = loss_sum / accum_steps
        grads = pytree.tree_map(lambda g: g / accum_steps, grad_sum)
        return ((loss, aux), grads) if has_aux else (loss, grads)

    return vg
