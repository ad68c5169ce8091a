"""The plain references: float32 PyTorch, TF32 off, no kernel, cache or
batching of the program's, and no import of it.  A configuration names
its reference module (``"reference"``); :func:`load` finds it."""

from __future__ import annotations

import importlib


def load(name):
    return importlib.import_module(f"portbench.reference.{name}")


def no_tf32():
    """float32 products stay float32 on the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x, dtype, top):
    """``x`` rounded to an 8-bit float under a per-tensor scale."""
    import torch

    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


def rounder(kind):
    """``product(fn, *operands)``: ``fn`` over the operands, as the
    precision computes it.  ``"float32"``: as they are.  The control's
    ``"float8"``: each operand rounded to e4m3 and, in the backward, the
    gradient that enters the product rounded to e5m2 (per-tensor scales,
    as 8-bit training rounds both passes), so both the forward and the
    backward products take 8-bit operands."""
    import torch

    if kind == "float32":
        return lambda fn, *xs: fn(*xs)
    if kind != "float8":
        raise ValueError(f"unknown precision {kind!r}")

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return _fp8(x, torch.float8_e4m3fn, 448.0)

        @staticmethod
        def backward(ctx, g):
            return g

    class RoundGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return y.view_as(y)

        @staticmethod
        def backward(ctx, g):
            return _fp8(g, torch.float8_e5m2, 57344.0)

    return lambda fn, *xs: RoundGrad.apply(fn(*(Round.apply(x)
                                                for x in xs)))
