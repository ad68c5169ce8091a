"""Plain float32 reference of the decoder the port runs at a
configuration's widths: pre-RMSNorm, full rotary (half-split), a serial
residual, the tanh GELU MLP, an untied head, next-token cross entropy.

The initial weights are drawn again from the seed in the port's order
and at its scales (a copy of ``models/transformer.init``, file
``tensorflowonspark_tpu_torch/models/transformer.py:97``): embedding
N(0, 0.02^2), products He-normal over their fan-in, norm scales 1, all
from one ``torch.Generator`` on the device.  Layers are stacked on a
leading axis, as the port keeps them.  Training recomputes each layer in
the backward (``torch.utils.checkpoint``) so that the whole model fits
beside its optimizer state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import no_tf32, rounder


def dims(cfg):
    d = cfg["hidden_size"]
    return dict(d=d, h=cfg["num_attention_heads"],
                hd=d // cfg["num_attention_heads"],
                m=cfg["intermediate_size"], v=cfg["vocab_size"],
                n=cfg["num_hidden_layers"], base=cfg["rotary_emb_base"],
                eps=cfg["layer_norm_eps"])


def init_leaves(cfg, seed, device):
    """``(name, float32 tensor)`` in the order the port's initialiser
    draws them; each is yielded before the next is drawn."""
    k = dims(cfg)
    d, m, v, n = k["d"], k["m"], k["v"], k["n"]
    g = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32) * std

    def he(shape):
        return normal(shape, math.sqrt(2.0 / shape[-2]))

    yield "embed", normal((v, d), 0.02)
    yield "ln1", torch.ones((n, d), device=device)
    yield "wqkv", he((n, d, 3 * d))
    yield "wo", he((n, d, d))
    yield "ln2", torch.ones((n, d), device=device)
    yield "w1", he((n, d, m))
    yield "w2", he((n, m, d))
    yield "ln_f", torch.ones((d,), device=device)
    yield "head", he((d, v))


def optimizer_order(cfg):
    """The leaves in the order the port hands them to its optimizer."""
    return ["embed", "ln_f", "head", "ln1", "wqkv", "wo", "ln2", "w1", "w2"]


def product_weights(cfg):
    """Which leaves, in :func:`optimizer_order`, are products' weights."""
    return [n in ("head", "wqkv", "wo", "w1", "w2")
            for n in optimizer_order(cfg)]


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope_tables(s, hd, base, device):
    half = hd // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device=device),
                      freqs)
    return torch.cos(ang), torch.sin(ang)


def _rope(x, cos, sin):
    """x [B, H, S, hd], rotated by position, halves split."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block(x, ln1, wqkv, wo, ln2, w1, w2, k, cos, sin, mm):
    b, s, d = x.shape
    y = _rmsnorm(x, ln1, k["eps"])
    qkv = mm(y, wqkv).view(b, s, 3, k["h"], k["hd"])
    qh, kh, vh = (t.transpose(1, 2) for t in qkv.unbind(2))
    qh, kh = _rope(qh, cos, sin), _rope(kh, cos, sin)
    scores = mm(qh, kh.transpose(-1, -2)) / math.sqrt(k["hd"])
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(probs, vh).transpose(1, 2).reshape(b, s, d)
    x = x + mm(o, wo)
    y = _rmsnorm(x, ln2, k["eps"])
    hid = F.gelu(mm(y, w1), approximate="tanh")
    return x + mm(hid, w2)


def _mm(precision):
    product = rounder(precision)
    return lambda a, b: product(torch.matmul, a, b)


def hidden(params, tokens, cfg, precision="float32", remat=False):
    """Final hidden states [B, S, d] of ``tokens`` [B, S]."""
    k = dims(cfg)
    mm = _mm(precision)
    cos, sin = _rope_tables(tokens.shape[1], k["hd"], k["base"],
                            tokens.device)
    x = params["embed"][tokens]
    for i in range(k["n"]):
        args = [params[n][i] for n in ("ln1", "wqkv", "wo", "ln2", "w1",
                                       "w2")]
        if remat:
            x = checkpoint(_block, x, *args, k, cos, sin, mm,
                           use_reentrant=False)
        else:
            x = _block(x, *args, k, cos, sin, mm)
    return _rmsnorm(x, params["ln_f"], k["eps"])


def logits(params, tokens, cfg, precision="float32"):
    return _mm(precision)(hidden(params, tokens, cfg, precision),
                          params["head"])


def loss(params, tokens, cfg, precision="float32"):
    """Mean next-token cross entropy over ``tokens[:, :-1]``."""
    x = hidden(params, tokens, cfg, precision, remat=True)[:, :-1]
    out = _mm(precision)(x, params["head"])
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def train_readings(cfg, seed, batches, device, precision, opt):
    """Adam steps over ``batches`` (each [B, S] token ids) from the
    seeded weights: each step's loss, each leaf's first gradient norm,
    and each leaf's change after the last step, leaves in
    :func:`optimizer_order`."""
    no_tf32()
    order = optimizer_order(cfg)
    params = {n: t.requires_grad_(True)
              for n, t in init_leaves(cfg, seed, device)}
    b1, b2 = opt["betas"]
    lr, eps = opt["lr"], opt["eps"]
    m = {n: torch.zeros_like(params[n]) for n in order}
    v = {n: torch.zeros_like(params[n]) for n in order}
    losses, grad_norms = [], None
    for t, tokens in enumerate(batches, start=1):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
        for p in params.values():
            p.grad = None
        out = loss(params, tokens, cfg, precision)
        out.backward()
        losses.append(float(out.detach()))
        if grad_norms is None:
            grad_norms = [_norm(params[n].grad) for n in order]
        with torch.no_grad():
            for n in order:
                g = params[n].grad
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                params[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        del out
    del m, v
    for p in params.values():
        p.grad = None
    change = {}
    with torch.no_grad():
        for n, p0 in init_leaves(cfg, seed, device):
            change[n] = _norm(params[n] - p0)
            del p0
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": [change[n] for n in order]}


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))
