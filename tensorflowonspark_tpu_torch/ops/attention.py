"""Attention ops: the flash-attention kernels + plain references.

Counterpart of ``tensorflowonspark_tpu/ops/attention.py``.  Layout at the
API boundary is ``[batch, seq, heads, head_dim]``, as there.

``flash_attention`` on a CUDA tensor launches the hand-written kernels
(built on first use by ``ops/_build.py``): ``csrc/flash_fwd.cu`` forward,
the dq and dk/dv kernels of ``csrc/flash_bwd.cu`` backward (bf16 on
tensor cores in both directions, float32 on f32 FMAs).  On a CPU
tensor it runs the plain PyTorch versions of the same functions
(:func:`flash_attention_plain`, :func:`flash_backward_plain`).  There is
no fallback between the two: a CUDA tensor the kernels cannot take
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.utils.cuda_graphs import launch_counted

_NEG_INF = -1e30  # finite mask fill, never -inf
HEAD_DIMS = (64, 128)  # head_dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernels in this process: the flash forward
#: (``launches``), the backward's dq and dk/dv kernels.  One per launch
#: that ran on the device: a launch inside a CUDA graph's capture counts
#: at each replay instead (``utils/cuda_graphs.py``); callers reset them
#: by assignment.
launches = 0
dq_launches = 0
dkv_launches = 0


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


def _check_shapes(q, k, v):
    """What the flash kernels take of q, k and v, the device aside."""
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


def _check_device(ref, **tensors):
    """Every tensor a CUDA tensor on ``ref``'s device.  Checked last, so
    that a CPU tensor reaches every other check."""
    for name, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name} must be a CUDA tensor on "
                             f"{ref.device}, got {t.device}")


def _check_vectors(**tensors):
    """The bf16 flash kernels (forward and backward) copy q, k, v and g
    into shared memory in 16-byte vectors (``cp.async``): each base
    pointer, and each batch, sequence and head stride of a dimension
    longer than 1, must be a multiple of 16 bytes."""
    for name, t in tensors.items():
        esize = t.element_size()
        if t.data_ptr() % 16 or any(
                t.shape[i] > 1 and t.stride(i) * esize % 16
                for i in range(3)):
            raise ValueError(
                f"{name} must start on a 16-byte boundary with batch, seq "
                f"and head strides of whole 16-byte vectors for the bf16 "
                f"flash kernels: offset {t.data_ptr() % 16} bytes, "
                f"strides {t.stride()} of {esize}-byte elements")


def _flash_forward_cuda(q, k, v, *, causal, scale):
    """Launch ``csrc/flash_fwd.cu`` on the current stream (bf16: the
    tensor-core kernel, float32: the FMA kernel); returns ``(out, lse)``.
    Raises on anything the kernel does not take."""
    global launches
    _check_shapes(q, k, v)
    if q.dtype == torch.bfloat16:
        _check_vectors(q=q, k=k, v=v)
    _check_device(q, q=q, k=k, v=v)
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
    if launch_counted("flash_fwd"):
        launches += 1
    return out, lse


def _flash_forward(q, k, v, *, causal, scale, block_q=512, block_kv=512):
    """``(out [B,Sq,H,D], lse [B,H,Sq] f32)``: the CUDA kernel for CUDA
    tensors, :func:`flash_attention_plain` for CPU tensors.
    ``block_q``/``block_kv`` are accepted for API parity with the JAX
    package and set nothing: each kernel picks its own tiles."""
    del block_q, block_kv
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


def _delta(g, out):
    """``rowsum(g * out)`` in f32 as ``[B, H, Sq]``, contiguous: the
    per-row term both backward kernels subtract from ``g vᵀ``.  Plain
    torch outside the kernels, as the JAX launcher computes it."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_plain(q, k, v, out, lse, g, *, causal, scale,
                         block_q=512):
    """Plain PyTorch flash backward: ``(dq, dk, dv)`` in the inputs'
    dtypes, f32 math.  A loop over ``block_q``-row q blocks that
    recomputes each block's probabilities from ``(q, k, lse)``:

        p   = exp(q kᵀ·scale − lse)    (0 where masked)
        ds  = p · (g vᵀ − delta) · scale,   delta = rowsum(g ∘ out)
        dq  = ds k;   dk += dsᵀ q;   dv += pᵀ g

    so memory is O(block_q · Skv) per step, never the [B, H, Sq, Skv]
    score tensor.  Port of the JAX package's ``_flash_bwd_xla``; the CPU
    path of :func:`flash_attention`'s backward, and what the CUDA
    kernels are held against on the card."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    block = min(block_q, max(sq, 8))

    def heads(x):  # [B, S, H, D] -> [B, H, S, D] f32
        return x.transpose(1, 2).float()

    qt, kt, vt, gt = heads(q), heads(k), heads(v), heads(g)
    delta = _delta(g, out)
    kpos = torch.arange(skv, device=q.device)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        q_i, g_i = qt[:, :, q0:q1], gt[:, :, q0:q1]
        s = torch.einsum("bhqd,bhkd->bhqk", q_i, kt) * scale
        e = torch.exp(s - lse[:, :, q0:q1, None])
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            e = torch.where(qpos[:, None] >= kpos[None, :], e,
                            torch.zeros((), device=q.device))
        dv += torch.einsum("bhqk,bhqd->bhkd", e, g_i)
        dp = torch.einsum("bhqd,bhkd->bhqk", g_i, vt)
        ds = e * (dp - delta[:, :, q0:q1, None]) * scale
        dq[:, :, q0:q1] = torch.einsum("bhqk,bhkd->bhqd", ds, kt)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_i)

    def unheads(x, like):  # [B, H, S, D] -> [B, S, H, D] in like's dtype
        return x.transpose(1, 2).to(like.dtype)

    return unheads(dq, q), unheads(dk, k), unheads(dv, v)


def _bwd_lib():
    lib = _build.load("flash_bwd")
    if not getattr(lib, "_tfos_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        argtypes = ([i32, i32] + [vp] * 8 + [i32] * 4
                    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       i32, vp])
        for fn in (lib.tfos_flash_dq, lib.tfos_flash_dkv):
            fn.argtypes = argtypes
            fn.restype = i32
        lib.tfos_cuda_error_string.argtypes = [i32]
        lib.tfos_cuda_error_string.restype = ctypes.c_char_p
        lib._tfos_typed = True
    return lib


def _launch_bwd(kernel, q, k, v, g, lse, delta, out0, out1, *, causal,
                scale):
    """Launch one backward kernel of ``csrc/flash_bwd.cu`` on the current
    stream and count it: ``"flash_dq"`` writes dq into ``out0``,
    ``"flash_dkv"`` dk into ``out0`` and dv into ``out1``.  Inputs as
    :func:`_flash_backward_cuda` prepares them."""
    global dq_launches, dkv_launches
    lib = _bwd_lib()
    fn = lib.tfos_flash_dq if kernel == "flash_dq" else lib.tfos_flash_dkv
    b, sq, h, d = q.shape
    strides = (ctypes.c_longlong * 18)(
        *[t.stride(i) for t in (q, k, v, g, out0, out1) for i in (0, 1, 2)])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), out0.data_ptr(), out1.data_ptr(), b, h,
                 sq, k.shape[1], strides, float(scale), int(bool(causal)),
                 stream)
    if err != 0:
        msg = (lib.tfos_cuda_error_string(err).decode() if err > 0
               else "unsupported dtype/head_dim")
        raise RuntimeError(f"{kernel} launch failed ({err}): {msg}")
    if not launch_counted(kernel):
        return
    if kernel == "flash_dq":
        dq_launches += 1
    else:
        dkv_launches += 1


def _bwd_inputs(q, k, v, out, lse, g):
    """Check what the backward kernels take; returns ``(g, lse, delta)``
    ready for :func:`_launch_bwd`.  Raises on anything else.  The kernels
    never read ``out`` (``delta`` is computed here), so only q, k, v and
    g are held to the bf16 kernels' 16-byte vectors."""
    _check_shapes(q, k, v)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, Sq] = {(b, h, sq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if g.stride(-1) != 1:
        # the one copy the backward makes: autograd may hand over a g
        # whose head_dim is not the unit stride the kernels load along
        g = g.contiguous()
    if q.dtype == torch.bfloat16:
        _check_vectors(q=q, k=k, v=v, g=g)
    _check_device(q, q=q, k=k, v=v, out=out, g=g, lse=lse)
    return g, lse.contiguous(), _delta(g, out)


def _flash_backward_cuda(q, k, v, out, lse, g, *, causal, scale):
    """Launch the dq and dk/dv kernels of ``csrc/flash_bwd.cu`` on the
    current stream; returns ``(dq, dk, dv)``.  q, k, v, out and g are
    [B, S, H, D] tensors addressed through their strides (q, k, v arrive
    as views of the fused qkv projection).  Raises on anything the
    kernels do not take."""
    g, lse, delta = _bwd_inputs(q, k, v, out, lse, g)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=v.dtype, device=q.device)
    common = dict(causal=causal, scale=scale)
    _launch_bwd("flash_dq", q, k, v, g, lse, delta, dq, dq, **common)
    _launch_bwd("flash_dkv", q, k, v, g, lse, delta, dk, dv, **common)
    return dq, dk, dv


def _flash_backward(q, k, v, out, lse, g, *, causal, scale, block_q=512):
    """``(dq, dk, dv)``: the CUDA kernels for CUDA tensors,
    :func:`flash_backward_plain` for CPU tensors."""
    if q.is_cuda:
        return _flash_backward_cuda(q, k, v, out, lse, g, causal=causal,
                                    scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return flash_backward_plain(q, k, v, out, lse, g, causal=causal,
                                scale=scale, block_q=block_q)


class _Flash(torch.autograd.Function):
    """Forward ``(out, lse)`` through :func:`_flash_forward`; backward
    through :func:`_flash_backward` from the saved ``q, k, v, out,
    lse``.  The same function on both devices: the device of ``q``
    picks kernel or plain version in each direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q):
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block_q = causal, scale, block_q
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g,
                                     causal=ctx.causal, scale=ctx.scale,
                                     block_q=ctx.block_q)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=False, scale=None, block_q=512,
                    block_kv=512, bwd_impl="xla"):
    """Flash attention on [B, S, H, D]; returns ``out``, differentiable.

    CUDA tensors go through the hand-written kernels: ``flash_fwd.cu``
    forward, and the dq and dk/dv kernels of ``flash_bwd.cu`` backward.
    CPU tensors go through the plain versions (:func:`flash_attention_plain`,
    :func:`flash_backward_plain`).  ``bwd_impl`` is validated as in the
    JAX package ("xla" or "pallas"); both of its backwards compute the
    same gradients, so it selects nothing here.  ``block_q`` sets the
    plain backward's q block; neither block sets the CUDA tiles."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bwd_impl not in ("xla", "pallas"):
        raise ValueError(f"bwd_impl must be 'xla' or 'pallas', "
                         f"got {bwd_impl!r}")
    del block_kv
    return _Flash.apply(q, k, v, causal, scale, block_q)
