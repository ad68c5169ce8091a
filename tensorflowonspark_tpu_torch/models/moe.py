"""Mixture-of-Experts MLP with expert parallelism (the ``ep`` mesh axis).

Counterpart of ``tensorflowonspark_tpu/models/moe.py``: top-1 switch
routing with a dense one-hot dispatch (every expert sees every token,
masked by the routing: exactly differentiable, no sort or scatter) and
the load-balance aux loss ``balance_weight · E · Σ_e f_e · p_e``.

Numerics follow the JAX module: the router's logits and the two expert
products accumulate in float32 (``preferred_element_type``), the expert
products round once to the input dtype, GELU is the tanh form.

Under expert parallelism each rank holds E/n experts (``param_specs``),
computes them for every token, and the combine is an autograd
all-reduce over the ``ep`` group (sum forward, identity backward: the
loss after it is the same on every rank), with the token input entering
the experts through its transpose (identity forward, sum backward).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch import resolve_device
from tensorflowonspark_tpu_torch.parallel import collectives as _coll


def init(generator, dim, hidden, num_experts, dtype=torch.float32,
         device=None):
    """He-normal router and expert weights, the JAX ``init``'s shapes."""
    device = generator.device if device is None else device

    def he(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * math.sqrt(2.0 / fan_in)).to(dtype)

    return {"router": he((dim, num_experts), dim),
            "w1": he((num_experts, dim, hidden), dim),
            "w2": he((num_experts, hidden, dim), hidden)}


def params_from_jax(tree, device=None):
    """The JAX package's MoE params (numpy or JAX arrays; the layouts
    are the same) as float32 tensors on ``device`` (default the card)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in ("router", "w1", "w2")}


def param_specs(*, ep_axis="model", fsdp_axis=None):
    """The expert axis over ``ep_axis`` (each rank holds E/n experts), a
    replicated router; PartitionSpec-like tuples, as the JAX module's."""
    return {"router": (None, None),
            "w1": (ep_axis, fsdp_axis, None),
            "w2": (ep_axis, None, fsdp_axis)}


def _dot_f32(a, b):
    """``a @ b`` in a's dtype: float32 accumulation, one rounding (as
    ``models.transformer._matmul``; bf16 on CUDA needs
    ``allow_bf16_reduced_precision_reduction = False``)."""
    return torch.matmul(a, b.to(a.dtype))


def apply(params, x, *, balance_weight=1e-2, ep_group=None):
    """x [B, S, D] -> (y [B, S, D], aux_loss).

    ``params``: the full experts, or with ``ep_group`` this rank's
    block of them (``w1``/``w2`` leading axis E/n, the router whole).
    aux_loss is E · Σ_e f_e · p_e (fraction routed times mean router
    probability), 1.0 at perfect balance, times ``balance_weight``."""
    b, s, d = x.shape
    dt = x.dtype
    xf = x.reshape(b * s, d)
    router = params["router"]
    num_experts = router.shape[1]
    logits = torch.matmul(xf.float(), router.to(dt).float())
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)
    onehot = F.one_hot(expert, num_experts).to(dt)
    gate = probs.gather(1, expert[:, None]).to(dt)

    w1, w2 = params["w1"], params["w2"]
    n_local = w1.shape[0]
    ranks = _coll.group_size(ep_group)
    if n_local * ranks != num_experts:
        raise ValueError(f"{n_local} local experts x {ranks} ranks != the "
                         f"router's {num_experts}")
    off = _coll.group_rank(ep_group) * n_local
    mask = onehot[:, off:off + n_local].t()                    # [El, T]
    xe = _coll.copy_to(xf, ep_group)
    dispatched = mask[:, :, None] * xe[None]                   # [El, T, D]
    h = _dot_f32(dispatched, w1)
    out = _dot_f32(F.gelu(h, approximate="tanh"), w2)          # [El, T, D]
    combined = (out * mask[:, :, None]).sum(dim=0)
    combined = _coll.reduce_from(combined, ep_group) * gate

    frac_routed = onehot.float().mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = balance_weight * num_experts * (frac_routed * mean_prob).sum()
    return combined.reshape(b, s, d), aux
