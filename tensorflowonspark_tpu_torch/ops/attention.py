"""Attention ops: the flash-attention forward kernel + plain references.

Counterpart of ``tensorflowonspark_tpu/ops/attention.py``.  Layout at the
API boundary is ``[batch, seq, heads, head_dim]``, as there.

``flash_attention`` on a CUDA tensor launches the hand-written kernel in
``csrc/flash_fwd.cu`` (built on first use by ``ops/_build.py``); on a
CPU tensor it runs :func:`flash_attention_plain`, the plain PyTorch
version of the same function.  There is no fallback between the two: a
CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tensorflowonspark_tpu_torch.ops import _build

_NEG_INF = -1e30  # finite mask fill, never -inf
HEAD_DIMS = (64, 128)  # head_dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA flash-forward kernel in this process; one per
#: call that reached the kernel.  Callers reset it by assignment.
launches = 0


# -- rotary position embeddings ----------------------------------------------

def rope_angles(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                device=None):
    """(cos, sin) tables of shape [seq_len, head_dim//2]."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(pos, freqs)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin, positions=None):
    """Rotate [B, S, H, D] by the (cos, sin) tables (half-split, not
    interleaved).  ``positions`` ([B, S] int) selects rows of the
    tables."""
    if positions is not None:
        cos = cos[positions][:, :, None, :]  # [B, S, 1, half]
        sin = sin[positions][:, :, None, :]
    else:
        cos = cos[None, : x.shape[1], None, :]
        sin = sin[None, : x.shape[1], None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- reference implementation ------------------------------------------------

def _masked_scores(q, k, causal, scale, q_offset=0, kv_offset=0):
    """f32 [B, H, Sq, Skv] scores with the finite causal mask."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    return scores


def mha_reference(q, k, v, *, causal=False, scale=None, q_offset=0,
                  kv_offset=0):
    """Full-materialization attention; [B, S, H, D] in/out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_scores(q, k, causal, scale, q_offset, kv_offset)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=False, scale=None):
    """Plain PyTorch version of the flash forward: ``(out [B,Sq,H,D]
    in q's dtype, lse [B,H,Sq] f32)``, f32 math, finite -1e30 mask.
    The CPU path of :func:`flash_attention`, and what the kernel is
    held against on the card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_scores(q, k, causal, scale)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


# -- the CUDA kernel ---------------------------------------------------------

def _lib():
    lib = _build.load("flash_fwd")
    if not getattr(lib, "_tfos_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tfos_flash_fwd.argtypes = (
            [i32, i32] + [vp] * 5 + [i32] * 4 + [i64] * 12
            + [ctypes.c_float, i32, vp])
        lib.tfos_flash_fwd.restype = i32
        lib.tfos_cuda_error_string.argtypes = [i32]
        lib.tfos_cuda_error_string.restype = ctypes.c_char_p
        lib._tfos_typed = True
    return lib


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on head_dim, got "
                             f"strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1 or q.shape[1] < 1:
        raise ValueError("empty sequence")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} > 65535 (grid limit)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")


def _flash_forward_cuda(q, k, v, *, causal, scale):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; returns
    ``(out, lse)``.  Raises on anything the kernel does not take."""
    global launches
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tfos_flash_fwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, sq, skv,
            *[t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)],
            float(scale), int(bool(causal)), stream)
    if err != 0:
        msg = (lib.tfos_cuda_error_string(err).decode() if err > 0
               else "unsupported dtype/head_dim")
        raise RuntimeError(f"flash_fwd launch failed ({err}): {msg}")
    launches += 1
    return out, lse


def _flash_forward(q, k, v, *, causal, scale, block_q=512, block_kv=512):
    """``(out [B,Sq,H,D], lse [B,H,Sq] f32)``: the CUDA kernel for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors.
    ``block_q``/``block_kv`` are accepted for API parity with the JAX
    package and set nothing: the kernel's tiles are fixed (64 x 64)."""
    del block_q, block_kv
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


class _FlashCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, _lse = _flash_forward_cuda(q, k, v, causal=causal, scale=scale)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention backward on CUDA is not ported yet: the dq/dkv "
            "kernels come with the training slice (ROADMAP.md, queue 2)")


def flash_attention(q, k, v, *, causal=False, scale=None, block_q=512,
                    block_kv=512):
    """Flash attention on [B, S, H, D]; returns ``out``.

    CUDA tensors go through the hand-written kernel (forward only: its
    backward raises NotImplementedError until the training slice); CPU
    tensors through the plain version, which autograd differentiates.
    ``block_q``/``block_kv`` are accepted for API parity and do not set
    the CUDA tile."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _FlashCuda.apply(q, k, v, causal, scale)
    out, _lse = _flash_forward(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_kv=block_kv)
    return out
