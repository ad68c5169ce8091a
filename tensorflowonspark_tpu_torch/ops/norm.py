"""RMSNorm: the hand-written CUDA kernel and its plain reference.

Counterpart of ``tensorflowonspark_tpu/ops/norm.py``.  The transformer
calls :func:`rmsnorm_reference`, as the JAX transformer does;
:func:`fused_rmsnorm` is the entry point over the kernel
(``csrc/rmsnorm.cu``, built on first use by ``ops/_build.py``).  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`rmsnorm_reference`.  Its gradient recomputes through the
reference, as the JAX package's custom VJP does: there is no backward
kernel on either side.
"""

from __future__ import annotations

import ctypes

import torch

from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.utils.cuda_graphs import launch_counted

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_ROWS_PER_CTA = 8  # warps (one a row) in one CTA of the kernel
MAX_VECS_PER_LANE = 8  # 16-byte vectors a lane holds on the registers path
_MODES = {"scalar": 0, "vector": 1, "registers": 2}

#: Launches of the RMSNorm kernel in this process, one per launch that
#: ran on the device (a captured launch counts at each replay of its
#: graph); callers reset it by assignment.
launches = 0


def rmsnorm_reference(x, scale, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * scale`` in f32, cast back to x's
    dtype."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * scale.float()).to(x.dtype)


def _lib():
    lib = _build.load("rmsnorm")
    if not getattr(lib, "_tfos_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tfos_rmsnorm_fwd.argtypes = [
            i32, vp, vp, vp, ctypes.c_longlong, i32, ctypes.c_float, i32,
            i32, vp]
        lib.tfos_rmsnorm_fwd.restype = i32
        lib.tfos_cuda_error_string.argtypes = [i32]
        lib.tfos_cuda_error_string.restype = ctypes.c_char_p
        lib._tfos_typed = True
    return lib


def kernel_path(dim, element_size, aligned):
    """The path of ``csrc/rmsnorm.cu`` that rows of ``dim`` elements of
    ``element_size`` bytes take: ``"registers"`` (one pass, the row kept
    in registers) where ``dim`` is a multiple of 32 16-byte vectors and a
    lane's share fits ``MAX_VECS_PER_LANE`` vectors; otherwise the
    two-pass path, by 16-byte ``"vector"`` where ``dim`` is a multiple of
    the vector, else by ``"scalar"``.  ``aligned``: x and y start on a
    16-byte boundary (a misaligned input takes the scalar path)."""
    vec = 16 // element_size
    if not aligned or dim % vec:
        return "scalar"
    if dim % (32 * vec) == 0 and dim // (32 * vec) <= MAX_VECS_PER_LANE:
        return "registers"
    return "vector"


def _rmsnorm_cuda(x, scale, eps, block_rows):
    """Launch ``csrc/rmsnorm.cu`` on the current stream; returns y in x's
    dtype and shape.  Raises on anything the kernel does not take."""
    global launches
    dim = x.shape[-1]
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if not (scale.is_cuda and scale.device == x.device):
        raise ValueError(f"scale must be a CUDA tensor on {x.device}, got "
                         f"{scale.device}")
    x2 = x.contiguous().reshape(-1, dim)
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0 or dim == 0:
        return y.reshape(x.shape)
    scale_f = scale.to(torch.float32).contiguous()
    if scale_f.data_ptr() % 16:  # the registers path reads 16-byte vectors
        scale_f = scale_f.clone()
    path = kernel_path(dim, x.element_size(),
                       x2.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tfos_rmsnorm_fwd(
            _DTYPES[x.dtype], x2.data_ptr(), scale_f.data_ptr(),
            y.data_ptr(), rows, dim, float(eps),
            min(int(block_rows), MAX_ROWS_PER_CTA), _MODES[path], stream)
    if err != 0:
        msg = (lib.tfos_cuda_error_string(err).decode() if err > 0
               else "arguments the kernel does not take")
        raise RuntimeError(f"rmsnorm launch failed ({err}): {msg}")
    if launch_counted("rmsnorm"):
        launches += 1
    return y.reshape(x.shape)


def _rmsnorm_forward(x, scale, eps, block_rows):
    """The kernel for CUDA tensors, :func:`rmsnorm_reference` for CPU
    tensors."""
    if x.is_cuda:
        return _rmsnorm_cuda(x, scale, eps, block_rows)
    if x.device.type != "cpu":
        raise ValueError(f"fused_rmsnorm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return rmsnorm_reference(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    """Forward through the kernel; backward recomputes through
    :func:`rmsnorm_reference` (the JAX package's ``_rmsnorm_bwd`` takes
    a VJP of the reference the same way)."""

    @staticmethod
    def forward(ctx, x, scale, eps, block_rows):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_forward(x, scale, eps, block_rows)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            sd = scale.detach().requires_grad_()
            y = rmsnorm_reference(xd, sd, ctx.eps)
            gx, gs = torch.autograd.grad(y, (xd, sd), g)
        return gx, gs, None, None


def fused_rmsnorm(x, scale, eps=1e-6, block_rows=256):
    """RMSNorm over the last axis; any leading shape; differentiable.

    ``x`` float32, bfloat16 or float16 (f32 math, output in x's dtype);
    ``scale`` ``[dim]``.  ``block_rows`` caps the rows one CTA of the
    kernel takes (at most 8 there, one warp a row); as in the JAX
    package it changes no result."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_rmsnorm takes float32, bfloat16 or "
                         f"float16, got {x.dtype}")
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(x.shape)} on the last axis")
    if int(block_rows) < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return _RMSNorm.apply(x, scale, eps, block_rows)
