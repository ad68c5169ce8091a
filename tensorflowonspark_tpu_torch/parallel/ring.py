"""Sequence/context parallelism: ring, zigzag ring and Ulysses attention.

Counterpart of ``tensorflowonspark_tpu/parallel/ring.py``.  There the
functions run inside ``shard_map`` over a named mesh axis; here each
rank calls them on its local shards with the process group of the
sequence axis (``mesh.get_group("seq")``), and the collectives are the
autograd ones of :mod:`parallel.collectives`, so every scheme is
differentiable as in JAX:

- **Ring attention** (:func:`ring_attention`): each rank keeps its q
  shard and passes the k/v shards around the ring (:func:`ppermute`),
  folding each block into blockwise online-softmax partials.  Under the
  causal mask a kv shard after the q shard is skipped, not masked.
- **Zigzag ring** (:func:`zigzag_ring_attention`): the sequence is cut
  into 2n stripes and rank i holds stripes (i, 2n-1-i), so every rank
  computes the same number of unmasked stripe pairs.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all re-shards
  seq -> heads, each rank runs full-sequence attention for its heads
  (``attn_fn``: ``ops.flash_attention`` runs the flash kernels on the
  card), and a second all-to-all re-shards back.

The two rings share one :func:`_online_softmax_update`, as the JAX rings
do: a masking fix in only one of them would desync them.  The blocks are
plain tensor math in float32, as the JAX package's ``jnp.einsum``
blocks are (no Pallas kernel there either).
"""

from __future__ import annotations

import math

import torch

from tensorflowonspark_tpu_torch.parallel import collectives as _coll

_NEG_INF = -1e30


def _block_scores(q, k, scale, causal, q_offset, kv_offset):
    """[B,Sq,H,D]x[B,Skv,H,D] -> masked f32 scores [B,H,Sq,Skv]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask[None, None], _NEG_INF)
    return s


def _online_softmax_update(carry, q_blk, k_blk, v_blk, scale, causal,
                           q_offset, kv_offset):
    """One blockwise online-softmax accumulation step (shared by the
    contiguous and zigzag rings)."""
    acc, m, l = carry
    s = _block_scores(q_blk, k_blk, scale, causal, q_offset, kv_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return acc_new, m_new, l_new


def _init_carry(q, rows):
    b, _, h, d = q.shape
    return (q.new_zeros((b, h, rows, d), dtype=torch.float32),
            q.new_full((b, h, rows), _NEG_INF, dtype=torch.float32),
            q.new_zeros((b, h, rows), dtype=torch.float32))


def _finish(acc, l, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(dtype)


def ring_attention(q, k, v, group, *, causal=False, scale=None):
    """Attention over a sequence-sharded ring.

    q/k/v: this rank's shards [B, S_local, H, D]; the global sequence is
    the concatenation of the shards in the group's rank order.  Returns
    this rank's output shard [B, S_local, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, my = _coll.group_size(group), _coll.group_rank(group)
    s_local = q.shape[1]
    carry = _init_carry(q, s_local)
    k_cur, v_cur = k, v
    received = []
    for step in range(n):
        # after `step` shifts this rank holds the shard of rank my-step;
        # step 0 is the diagonal block, so m is finite for every row
        kv_idx = (my - step) % n
        if not (causal and kv_idx > my):
            carry = _online_softmax_update(
                carry, q, k_cur, v_cur, scale, causal,
                q_offset=my * s_local, kv_offset=kv_idx * s_local)
        if step + 1 < n:
            k_cur = _coll.ppermute(k_cur, group)
            v_cur = _coll.ppermute(v_cur, group)
            received += [k_cur, v_cur]
    return _coll.tie(_finish(carry[0], carry[2], q.dtype), received)


def zigzag_permutation(seq_len, axis_size):
    """Global-position permutation for zigzag sequence sharding: 2n
    stripes, rank i owns stripes (i, 2n-1-i).  Returns a long tensor
    ``perm`` with ``x[:, perm]`` the zigzag order of a [B, S, ...]
    sequence; invert with :func:`inverse_permutation`."""
    if seq_len % (2 * axis_size):
        raise ValueError(
            f"seq_len {seq_len} must divide into 2*axis_size="
            f"{2 * axis_size} stripes")
    stripe = seq_len // (2 * axis_size)
    order = []
    for i in range(axis_size):
        order.append(i)
        order.append(2 * axis_size - 1 - i)
    return torch.cat([torch.arange(s * stripe, (s + 1) * stripe)
                      for s in order])


def inverse_permutation(perm):
    """Index tensor inverting ``zigzag_permutation`` (x_perm[inv] == x)."""
    perm = torch.as_tensor(perm)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def zigzag_ring_attention(q, k, v, group, *, causal=False, scale=None):
    """Load-balanced causal ring attention.

    Inputs are this rank's shards in zigzag order (the global sequence
    reordered with :func:`zigzag_permutation`): the concatenation of
    global stripes (my, 2n-1-my), each S_local/2 long.  A (q stripe, kv
    stripe) pair is computed only when the causal mask can reach it.
    Returns the local output shard, still in zigzag order."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n, my = _coll.group_size(group), _coll.group_rank(group)
    s_local = q.shape[1]
    if s_local % 2:
        raise ValueError("zigzag shards must have even local length")
    s_h = s_local // 2
    q_stripes = (my, 2 * n - 1 - my)
    q_halves = (q[:, :s_h], q[:, s_h:])
    carries = [_init_carry(q, s_h), _init_carry(q, s_h)]
    k_cur, v_cur = k, v
    received = []
    for step in range(n):
        kv_idx = (my - step) % n
        kv_stripes = (kv_idx, 2 * n - 1 - kv_idx)
        for qi, q_stripe in enumerate(q_stripes):
            for ki, kv_stripe in enumerate(kv_stripes):
                if causal and kv_stripe > q_stripe:
                    continue
                rows = slice(ki * s_h, (ki + 1) * s_h)
                carries[qi] = _online_softmax_update(
                    carries[qi], q_halves[qi], k_cur[:, rows],
                    v_cur[:, rows], scale, causal,
                    q_offset=q_stripe * s_h, kv_offset=kv_stripe * s_h)
        if step + 1 < n:
            k_cur = _coll.ppermute(k_cur, group)
            v_cur = _coll.ppermute(v_cur, group)
            received += [k_cur, v_cur]
    out = torch.cat([_finish(c[0], c[2], q.dtype) for c in carries], dim=1)
    return _coll.tie(out, received)


def ulysses_attention(q, k, v, group, *, causal=False, scale=None,
                      attn_fn=None):
    """All-to-all sequence parallelism: [B, S/n, H, D] shards ->
    [B, S, H/n, D], full-sequence ``attn_fn(q, k, v, causal=, scale=)``
    on this rank's heads (default ``ops.mha_reference``; pass
    ``ops.flash_attention`` on the card), and back."""
    from tensorflowonspark_tpu_torch.ops import mha_reference

    if attn_fn is None:
        attn_fn = mha_reference
    n = _coll.group_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by "
                         f"the sequence axis size ({n})")
    qg, kg, vg = (_coll.all_to_all(x, group, 2, 1) for x in (q, k, v))
    out = attn_fn(qg, kg, vg, causal=causal, scale=scale)
    return _coll.all_to_all(out, group, 1, 2)


_IMPLS = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
          "ulysses": ulysses_attention}


def sequence_parallel_attention(mesh, impl="ring", *, seq_axis="seq",
                                causal=False, scale=None, attn_fn=None):
    """``call(q, k, v)`` on this rank's [B, S_local, H_local, D] blocks
    (batch split over the data axes, heads over ``model``, sequence over
    ``seq_axis``): attention with the sequence exchange over
    ``seq_axis``'s group, the block of the output back.  A mesh without
    ``seq_axis`` runs the scheme on one rank.

    ``impl="zigzag"`` expects the caller to have reordered the global
    sequence with ``zigzag_permutation(seq_len, seq axis size)``
    (``models.transformer.zigzag_lm_batch`` does it for an LM batch).
    ``attn_fn`` is Ulysses' local attention."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {sorted(_IMPLS)}")
    if attn_fn is not None and impl != "ulysses":
        raise ValueError("attn_fn is Ulysses' local attention")
    group = (mesh.get_group(seq_axis)
             if seq_axis in (mesh.mesh_dim_names or ()) else None)
    fn = _IMPLS[impl]
    kw = {"attn_fn": attn_fn} if impl == "ulysses" else {}

    def call(q, k, v):
        return fn(q, k, v, group, causal=causal, scale=scale, **kw)

    return call
