"""Decoder-only transformer: forward, training loss and KV-cached decode.

Counterpart of ``tensorflowonspark_tpu/models/transformer.py``.
Parameters are a plain dict with the reference's tree layout: per-layer
weights stacked on a leading ``[n_layers, ...]`` axis, master weights in
float32, activations and matmuls in the config's compute dtype with
float32 accumulation.  Training differentiates ``loss_fn`` with torch
autograd: each matmul casts its float32 master to the compute dtype, so
gradients land on the masters, as under ``jax.grad`` of the reference.

Numerics follow the reference step for step, so that a converted JAX
checkpoint gives the same logits and greedy decode gives the same
tokens:

- ``_matmul`` rounds its result to the activation dtype, as the
  reference's ``dot(..., preferred_element_type=f32).astype(x.dtype)``
  does; logits are that rounded value upcast to float32.
- GELU is the tanh approximation (``jax.nn.gelu``'s default).
- qkv columns are ordered ``[3, heads, head_dim]``; rope is half-split
  and gathered by position.
- Attention inside the decode steps is the reference's f32 masked
  softmax with the finite ``-1e30`` fill.

Where JAX returns new cache arrays, the decode steps here write the
caches IN PLACE (the pools are large; a copy per step would double the
cache's memory traffic) and return them as well.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tensorflowonspark_tpu_torch import ops, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NEG_INF = -1e30  # finite mask fill (ops.attention convention: never -inf)
_MATMUL_KEYS = ("wqkv", "wo", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    max_seq: int = 2048
    mlp_ratio: int = 4
    rope_base: float = 10000.0
    dtype: str = "bfloat16"  # compute dtype; params always float32
    # 'flash' = the hand-written kernel on CUDA (its plain version on
    # the CPU); 'reference' = full-materialization attention
    attn_impl: str = "flash"

    @property
    def head_dim(self):
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} not divisible by n_heads "
                             f"{self.n_heads}")
        return self.dim // self.n_heads

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]


def _param_shapes(cfg):
    dim, mlp, nl = cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.n_layers
    return {
        "embed": (cfg.vocab_size, dim),
        "layers": {
            "ln1": (nl, dim),
            "wqkv": (nl, dim, 3 * dim),
            "wo": (nl, dim, dim),
            "ln2": (nl, dim),
            "w1": (nl, dim, mlp),
            "w2": (nl, mlp, dim),
        },
        "ln_f": (dim,),
        "head": (dim, cfg.vocab_size),
    }


def init(cfg: Config, generator, device=None):
    """Random float32 params, the reference ``init``'s shapes and
    scales: embed N(0, 0.02²), dense weights He-normal
    (``sqrt(2 / fan_in)``), norm scales 1.  ``generator`` is a
    ``torch.Generator`` on ``device`` (default: the generator's)."""
    device = torch.device(device) if device is not None else generator.device
    shapes = _param_shapes(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * std

    def he(shape):
        return normal(shape, math.sqrt(2.0 / shape[-2]))

    ls = shapes["layers"]
    return {
        "embed": normal(shapes["embed"], 0.02),
        "layers": {
            "ln1": torch.ones(ls["ln1"], device=device),
            "wqkv": he(ls["wqkv"]),
            "wo": he(ls["wo"]),
            "ln2": torch.ones(ls["ln2"], device=device),
            "w1": he(ls["w1"]),
            "w2": he(ls["w2"]),
        },
        "ln_f": torch.ones(shapes["ln_f"], device=device),
        "head": he(shapes["head"]),
    }


def params_from_jax(tree, cfg: Config, device=None):
    """Convert the reference's params pytree (nested dicts of numpy or
    JAX arrays, layers stacked ``[n_layers, ...]``) into this module's
    float32 tensors on ``device`` (default: the current CUDA device,
    through :func:`resolve_device`, which raises without a card; pass
    ``device="cpu"`` for the CPU).  Shapes are checked against ``cfg``."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def conv(x, shape, name):
        arr = np.asarray(x, np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"param {name}: shape {arr.shape}, config "
                             f"wants {tuple(shape)}")
        return torch.from_numpy(arr.copy()).to(device)

    out = {k: conv(tree[k], shapes[k], k) for k in ("embed", "ln_f", "head")}
    out["layers"] = {k: conv(tree["layers"][k], s, f"layers.{k}")
                     for k, s in shapes["layers"].items()}
    return out


def compute_params(params, cfg: Config, device=None):
    """Params on ``device`` (default: where they are) with the matmul
    weights and the embedding cast once to the compute dtype (norm
    scales stay float32).  Numerically identical to casting on every
    call, as ``_matmul`` does, without the per-call copies; the decode
    engine runs on this."""
    dt = cfg.compute_dtype
    dev = params["embed"].device if device is None else device
    layers = {k: v.to(dev, dt if k in _MATMUL_KEYS else v.dtype)
              for k, v in params["layers"].items()}
    return {"embed": params["embed"].to(dev, dt), "layers": layers,
            "ln_f": params["ln_f"].to(dev),
            "head": params["head"].to(dev, dt)}


def _matmul(x, w):
    """``x @ w`` in x's dtype: float32 accumulation, result rounded to
    x's dtype (bfloat16 matmuls on CUDA need
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    = False`` to keep the accumulation in float32)."""
    return torch.matmul(x, w.to(x.dtype))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _layer(params, i):
    return {k: v[i] for k, v in params["layers"].items()}


def _device(params):
    return params["embed"].device


def _tokens(tokens, device):
    return torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                           else tokens, dtype=torch.long, device=device)


def _default_attn(cfg):
    base = (ops.flash_attention if cfg.attn_impl == "flash"
            else ops.mha_reference)
    return functools.partial(base, causal=True)


def _block_tail(x, p):
    """The MLP half of a block, with its residual."""
    y = ops.rmsnorm_reference(x, p["ln2"])
    return x + _matmul(_gelu(_matmul(y, p["w1"])), p["w2"])


def _layer_apply_kv(p, x, cfg, rope, attn_fn):
    """One transformer block; also returns the layer's rope-rotated
    keys and values in cache layout [B, H, S, D]."""
    b, s, dim = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    cos, sin, positions = rope
    y = ops.rmsnorm_reference(x, p["ln1"])
    qkv = _matmul(y, p["wqkv"]).reshape(b, s, 3, h, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = ops.apply_rope(q, cos, sin, positions=positions)
    k = ops.apply_rope(k, cos, sin, positions=positions)
    attn = attn_fn(q, k, v).reshape(b, s, dim)
    x = _block_tail(x + _matmul(attn, p["wo"]), p)
    return x, k.transpose(1, 2), v.transpose(1, 2)


def _layer_apply(p, x, cfg, rope, attn_fn):
    return _layer_apply_kv(p, x, cfg, rope, attn_fn)[0]


# matmuls without batch dims: what jax's dots_with_no_batch_dims_saveable
# keeps (torch.matmul of [B, S, D] by [D, N] dispatches as aten.mm)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_fn(remat):
    """The per-layer body under the reference's ``remat`` modes: False,
    True (checkpoint everything) or "dots" (save matmul outputs,
    recompute the rest)."""
    if not remat:
        return _layer_apply
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_dots)
    elif remat is True:
        context_fn = noop_context_fn
    else:
        raise ValueError(f"remat must be bool or 'dots'; got {remat!r}")

    def fn(p, x, cfg, rope, attn_fn):
        return checkpoint(_layer_apply, p, x, cfg, rope, attn_fn,
                          use_reentrant=False, context_fn=context_fn)

    return fn


def apply(params, tokens, cfg: Config, *, attn_fn=None,
          logits_dtype=torch.float32, remat=False, positions=None,
          return_hidden=False):
    """tokens [B, S] int -> logits [B, S, vocab] in ``logits_dtype``
    (default float32; None keeps the compute dtype, as the training
    loss does).  ``return_hidden=True`` skips the head matmul and
    returns the final hidden states [B, S, dim] (the blockwise CE
    consumes these).

    ``attn_fn(q, k, v)`` on [B, S, H, D] defaults to causal flash
    attention.  ``positions`` ([S] or [B, S] int): explicit global rope
    positions for a non-contiguous layout; the default causal mask is
    by array index, so it demands an ``attn_fn`` that masks by global
    position.

    ``remat=True`` checkpoints each layer (the backward recomputes its
    internals, flash forward included); ``remat="dots"`` saves every
    matmul output and recomputes only the elementwise chain."""
    if positions is not None and attn_fn is None:
        # the default flash mask is causal by ARRAY INDEX; on permuted
        # input that silently attends to the future
        raise ValueError(
            "positions= implies a non-contiguous sequence layout; pass an "
            "attn_fn that masks by global position (e.g. "
            "sequence_parallel_attention(mesh, 'zigzag', causal=True))")
    attn_fn = attn_fn or _default_attn(cfg)
    layer_fn = _layer_fn(remat)
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    if positions is None:
        rope_len, pos2d = tokens.shape[1], None
    else:
        # cover every global position: a gather past the table raises
        rope_len = max(tokens.shape[1], cfg.max_seq)
        pos = _tokens(positions, dev)
        pos2d = (pos[None] if pos.dim() == 1 else pos).expand(tokens.shape)
    cos, sin = ops.rope_angles(rope_len, cfg.head_dim, cfg.rope_base,
                               device=dev)
    for i in range(cfg.n_layers):
        x = layer_fn(_layer(params, i), x, cfg, (cos, sin, pos2d), attn_fn)
    x = ops.rmsnorm_reference(x, params["ln_f"])
    if return_hidden:
        return x
    logits = _matmul(x, params["head"])
    return logits if logits_dtype is None else logits.to(logits_dtype)


def _nll_block(x, w, labels, m, s, gold, base):
    """One vocab block of the online logsumexp: f32 logits of the
    compute-dtype product (``preferred_element_type=f32`` in the
    reference: exact products of the rounded operands, f32 sums),
    folded into the running (max, sumexp, gold logit)."""
    logits = torch.matmul(x.float(), w.to(x.dtype).float())
    nm = torch.maximum(m, logits.max(dim=-1).values)
    s = s * torch.exp(m - nm) + torch.exp(logits - nm[:, None]).sum(dim=-1)
    block_v = w.shape[1]
    in_blk = (labels >= base) & (labels < base + block_v)
    idx = (labels - base).clamp(0, block_v - 1)
    g = logits.gather(1, idx[:, None])[:, 0]
    gold = gold + torch.where(in_blk, g, torch.zeros_like(g))
    return nm, s, gold


def _blockwise_nll(x, head, labels, block_v):
    """Per-position next-token NLL without materialising [N, vocab]:
    the head matmul streams in ``block_v``-wide vocab slices through an
    online logsumexp.  Each block is checkpointed, so the backward
    recomputes its logits instead of keeping them.

    ``x`` [N, D] final hidden states (compute dtype); ``head`` [D, V]
    float32 params; ``labels`` [N] int."""
    n = x.shape[0]
    v = head.shape[1]
    if v % block_v:
        raise ValueError(f"vocab {v} not divisible by ce_block {block_v}")
    labels = labels.long()
    # finite lower bound, not -inf: exp(min - nm) underflows to exactly 0
    # like -inf would, but the backward never sees inf arithmetic
    m = torch.full((n,), torch.finfo(torch.float32).min,
                   dtype=torch.float32, device=x.device)
    s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    gold = torch.zeros_like(s)
    for base in range(0, v, block_v):
        m, s, gold = checkpoint(
            _nll_block, x, head[:, base:base + block_v],
            labels, m, s, gold, base, use_reentrant=False)
    return m + torch.log(s) - gold


def loss_fn(params, tokens, cfg: Config, *, attn_fn=None, remat=False,
            labels=None, positions=None, ce_impl="dense", ce_block=2048):
    """Next-token cross entropy (mean over B, S-1), differentiable.

    Default labels are ``tokens`` shifted by one.  Explicit ``labels``
    align with ``tokens``' positions, -1 = ignore; the mean is then over
    the labelled positions.

    ``ce_impl="dense"``: logits stay in the compute dtype and the
    logsumexp runs on their float32 upcast.  Unlike XLA, which fuses the
    upcast into the reduction, torch materialises the float32
    [B, S, vocab] tensor (PERF.md gives its size at full width).
    ``ce_impl="blockwise"``: the head matmul streams in ``ce_block``-wide
    vocab slices (``_blockwise_nll``) and [B, S, vocab] never exists."""
    if ce_impl not in ("dense", "blockwise"):
        raise ValueError(f"unknown ce_impl {ce_impl!r}")
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    out = apply(params, tokens, cfg, attn_fn=attn_fn, remat=remat,
                positions=positions, logits_dtype=None,
                return_hidden=ce_impl == "blockwise")
    if labels is None:
        out = out[:, :-1]
        labels = tokens[:, 1:]
        valid = None
    else:
        labels = _tokens(labels, dev)
        valid = labels >= 0
        labels = labels.clamp(min=0)
    if ce_impl == "blockwise":
        b, s, d = out.shape
        nll = _blockwise_nll(out.reshape(b * s, d), params["head"],
                             labels.reshape(b * s), ce_block).reshape(b, s)
    else:
        lse = torch.logsumexp(out.float(), dim=-1)
        gold = out.gather(-1, labels[..., None])[..., 0].float()
        nll = lse - gold
    if valid is None:
        return nll.mean()
    vf = valid.float()
    return (nll * vf).sum() / vf.sum().clamp(min=1.0)


def _last_rows(x, lengths, t):
    """x [B, T, dim] -> x at each row's last real position [B, dim]."""
    b = x.shape[0]
    if lengths is None:
        last = torch.full((b,), t - 1, dtype=torch.long, device=x.device)
    else:
        last = _tokens(lengths, x.device) - 1
    last = last.clamp(0, t - 1)
    return x[torch.arange(b, device=x.device), last]


def prefill(params, tokens, cfg: Config, *, lengths=None, attn_fn=None):
    """Prompt pass for incremental decode.

    ``tokens`` [B, T] right-padded prompts, ``lengths`` [B] true prompt
    lengths (default: all T).  Returns ``(logits [B, vocab] float32 at
    each row's last real position, k, v [B, n_layers, n_heads, T,
    head_dim])`` with keys rope-rotated.  Padded tail positions give
    garbage k/v that causal masking and the decode cursors never read.
    """
    attn_fn = attn_fn or _default_attn(cfg)
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    cos, sin = ops.rope_angles(t, cfg.head_dim, cfg.rope_base, device=dev)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _layer_apply_kv(_layer(params, i), x, cfg,
                                  (cos, sin, None), attn_fn)
        ks.append(k)
        vs.append(v)
    x = ops.rmsnorm_reference(x, params["ln_f"])
    logits = _matmul(_last_rows(x, lengths, t), params["head"]).float()
    return logits, torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def _cache_write(cache_l, new, cursors):
    """Write one [H, D] entry per slot at its cursor column, in place:
    ``cache_l`` [S, H, M, D], ``new`` [S, H, D], ``cursors`` [S]."""
    slots = torch.arange(cache_l.shape[0], device=cache_l.device)
    cache_l[slots, :, cursors] = new.to(cache_l.dtype)
    return cache_l


def decode_step(params, tokens, cfg: Config, cache_k, cache_v, lengths):
    """One fused continuous-batching decode iteration over ALL slots.

    ``tokens`` [S] — each slot's incoming token, at position
    ``lengths[s]``; ``cache_k``/``cache_v`` [S, n_layers, n_heads,
    max_seq, head_dim] (keys rope-rotated), updated in place;
    ``lengths`` [S] tokens already resident per slot.  Returns
    ``(logits [S, vocab] float32, cache_k, cache_v)``.  Free slots
    (length 0, token 0) attend only their own column 0: finite garbage
    in their own logits row."""
    dtype = cfg.compute_dtype
    h, hd = cfg.n_heads, cfg.head_dim
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    s_slots = tokens.shape[0]
    m = cache_k.shape[3]
    cursors = _tokens(lengths, dev).clamp(0, m - 1)
    pos = cursors[:, None]
    scale = 1.0 / math.sqrt(hd)
    kv_mask = (torch.arange(m, device=dev)[None, None, :]
               <= cursors[:, None, None])                    # [S, 1, M]
    x = params["embed"].to(dtype)[tokens][:, None, :]        # [S, 1, dim]
    cos, sin = ops.rope_angles(m, hd, cfg.rope_base, device=dev)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        ck_l, cv_l = cache_k[:, i], cache_v[:, i]            # [S, H, M, D]
        y = ops.rmsnorm_reference(x, p["ln1"])
        qkv = _matmul(y, p["wqkv"]).reshape(s_slots, 1, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = ops.apply_rope(q, cos, sin, positions=pos)
        k = ops.apply_rope(k, cos, sin, positions=pos)
        _cache_write(ck_l, k[:, 0], cursors)
        _cache_write(cv_l, v[:, 0], cursors)
        scores = torch.einsum("shd,shmd->shm", q[:, 0].float(),
                              ck_l.float()) * scale
        scores = scores.masked_fill(~kv_mask, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("shm,shmd->shd", probs, cv_l.float())
        attn = attn.to(dtype).reshape(s_slots, 1, h * hd)
        x = _block_tail(x + _matmul(attn, p["wo"]), p)
    x = ops.rmsnorm_reference(x, params["ln_f"])
    logits = _matmul(x[:, 0], params["head"]).float()
    return logits, cache_k, cache_v


def _gather_blocks(pool_l, tables):
    """pool_l [NB, H, bs, D] gathered through ``tables`` [S, nb] ->
    [S, nb*bs, H, D]."""
    g = pool_l[tables]                                  # [S, nb, H, bs, D]
    s, nb, h, bs, d = g.shape
    return g.permute(0, 1, 3, 2, 4).reshape(s, nb * bs, h, d)


def decode_step_paged(params, tokens, cfg: Config, pool_k, pool_v,
                      block_tables, lengths):
    """One fused decode iteration over a block-paged KV pool.

    ``tokens`` [S, W]: a window of W tokens per slot, token j of slot s
    at position ``lengths[s] + j``.  ``pool_k``/``pool_v``
    [num_blocks, n_layers, n_heads, block_size, head_dim], updated in
    place; ``block_tables`` [S, blocks_per_slot] (unused entries point
    at sentinel block 0).  Writes past a slot's mapped capacity land in
    the sentinel block; free slots write only there too, so the only
    repeated write targets are sentinel rows, which no live slot reads.
    Query j attends ``position <= lengths[s] + j``.  Returns
    ``(logits [S, W, vocab] float32, pool_k, pool_v)``."""
    dtype = cfg.compute_dtype
    h, hd = cfg.n_heads, cfg.head_dim
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    s_slots, w = tokens.shape
    bs = pool_k.shape[3]
    tables = _tokens(block_tables, dev)
    cap = tables.shape[1] * bs
    lengths = _tokens(lengths, dev)
    scale = 1.0 / math.sqrt(hd)

    pos = lengths[:, None] + torch.arange(w, device=dev)[None, :]  # [S, W]
    posc = pos.clamp(0, cap - 1)
    blk = torch.gather(tables, 1, posc // bs)
    over = pos >= cap
    wblk = torch.where(over, torch.zeros_like(blk), blk).reshape(-1)
    woff = torch.where(over, pos % bs, posc % bs).reshape(-1)
    kv_mask = (torch.arange(cap, device=dev)[None, None, None, :]
               <= pos[:, None, :, None])                    # [S, 1, W, cap]

    x = params["embed"].to(dtype)[tokens]                    # [S, W, dim]
    cos, sin = ops.rope_angles(cap, hd, cfg.rope_base, device=dev)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        pk_l, pv_l = pool_k[:, i], pool_v[:, i]              # [NB, H, bs, D]
        y = ops.rmsnorm_reference(x, p["ln1"])
        qkv = _matmul(y, p["wqkv"]).reshape(s_slots, w, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = ops.apply_rope(q, cos, sin, positions=posc)
        k = ops.apply_rope(k, cos, sin, positions=posc)
        pk_l[wblk, :, woff] = k.reshape(-1, h, hd).to(pk_l.dtype)
        pv_l[wblk, :, woff] = v.reshape(-1, h, hd).to(pv_l.dtype)
        kg = _gather_blocks(pk_l, tables).float()            # [S, cap, H, D]
        vg = _gather_blocks(pv_l, tables).float()
        scores = torch.einsum("swhd,smhd->shwm", q.float(), kg) * scale
        scores = scores.masked_fill(~kv_mask, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("shwm,smhd->swhd", probs, vg)
        attn = attn.to(dtype).reshape(s_slots, w, h * hd)
        x = _block_tail(x + _matmul(attn, p["wo"]), p)
    x = ops.rmsnorm_reference(x, params["ln_f"])
    logits = _matmul(x, params["head"]).float()
    return logits, pool_k, pool_v


def prefill_extend(params, tokens, cfg: Config, pool_k, pool_v,
                   prefix_tables, prefix_lens, *, lengths=None):
    """Tail prefill on top of trie-matched resident prefix blocks.

    ``tokens`` [B, T] right-padded tails, ``lengths`` [B] true tail
    lengths; ``prefix_tables`` [B, nbp] physical blocks of each row's
    matched prefix (padded with sentinel 0); ``prefix_lens`` [B]
    matched token counts (whole blocks).  Tail queries attend the
    gathered prefix (``position < prefix_lens``) plus the tail causally,
    at rope positions ``prefix_lens + arange(T)``.  Reads the pools
    only.  Returns ``(logits [B, vocab] float32 at the last real tail
    position, k, v [B, n_layers, n_heads, T, head_dim])``."""
    dtype = cfg.compute_dtype
    h, hd = cfg.n_heads, cfg.head_dim
    dev = _device(params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    bs = pool_k.shape[3]
    ptab = _tokens(prefix_tables, dev)
    pcap = ptab.shape[1] * bs
    plens = _tokens(prefix_lens, dev)
    scale = 1.0 / math.sqrt(hd)

    pos = plens[:, None] + torch.arange(t, device=dev)[None, :]
    cos, sin = ops.rope_angles(pcap + t, hd, cfg.rope_base, device=dev)
    pmask = (torch.arange(pcap, device=dev)[None, :]
             < plens[:, None])[:, None, None, :]             # [B, 1, 1, P]
    ar = torch.arange(t, device=dev)
    cmask = (ar[None, :] <= ar[:, None])[None, None]         # [1, 1, T, T]

    x = params["embed"].to(dtype)[tokens]                    # [B, T, dim]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        y = ops.rmsnorm_reference(x, p["ln1"])
        qkv = _matmul(y, p["wqkv"]).reshape(b, t, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = ops.apply_rope(q, cos, sin, positions=pos)
        k = ops.apply_rope(k, cos, sin, positions=pos)
        kp = _gather_blocks(pool_k[:, i], ptab).float()      # [B, P, H, D]
        vp = _gather_blocks(pool_v[:, i], ptab).float()
        qf = q.float()
        sp = torch.einsum("bthd,bphd->bhtp", qf, kp) * scale
        st = torch.einsum("bthd,bshd->bhts", qf, k.float()) * scale
        sp = sp.masked_fill(~pmask, _NEG_INF)
        st = st.masked_fill(~cmask, _NEG_INF)
        probs = torch.softmax(torch.cat([sp, st], dim=-1), dim=-1)
        pp, pt = probs[..., :pcap], probs[..., pcap:]
        attn = (torch.einsum("bhtp,bphd->bthd", pp, vp)
                + torch.einsum("bhts,bshd->bthd", pt, v.float()))
        attn = attn.to(dtype).reshape(b, t, h * hd)
        x = _block_tail(x + _matmul(attn, p["wo"]), p)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    x = ops.rmsnorm_reference(x, params["ln_f"])
    logits = _matmul(_last_rows(x, lengths, t), params["head"]).float()
    return logits, torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def greedy_decode_reference(params, prompt, cfg: Config, *, max_tokens,
                            eos_id=None, attn_fn=None):
    """Full-recompute greedy decode — the KV-cache parity oracle: each
    step re-runs ``apply`` on the whole growing sequence and argmaxes
    the final position.  O(T²) per token."""
    toks = [int(t) for t in prompt]
    out = []
    with torch.inference_mode():
        for _ in range(int(max_tokens)):
            logits = apply(params, [toks], cfg, attn_fn=attn_fn)
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks.append(nxt)
            if eos_id is not None and nxt == int(eos_id):
                break
    return out
