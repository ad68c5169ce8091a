"""RMSNorm reference.

Counterpart of ``tensorflowonspark_tpu/ops/norm.py``.  Only the plain
``rmsnorm_reference`` is ported: the transformer calls it, and no model
calls the fused kernel (``fused_rmsnorm``), which waits in ROADMAP.md.
"""

from __future__ import annotations

import torch


def rmsnorm_reference(x, scale, eps=1e-6):
    """``x * rsqrt(mean(x²) + eps) * scale`` in f32, cast back to x's
    dtype."""
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * scale.float()).to(x.dtype)
