"""Shape-exact model-FLOPs counting by running a function on meta tensors.

Counterpart of ``tensorflowonspark_tpu/utils/flops.py``, which walks the
jaxpr JAX traces; here the function runs once on ``meta`` tensors (shapes
and dtypes only: nothing is computed or allocated, so full-size shapes
are cheap) under ``torch.utils.flop_counter.FlopCounterMode``, which
counts the ATen matmuls and convolutions the run dispatches.  Elementwise
and reduction work is excluded, 2 FLOPs per MAC, as in the JAX package
(the PaLM appendix-B convention of every MFU denominator here).

Conventions, the JAX counter's:
- matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``): 2 x batch x M x N x K;
- convolution: 2 x output positions x kernel taps x (in_ch / groups),
  so a depthwise conv counts one input channel a tap;
- transposed convolution: 2 x input positions x taps x in_ch x out_ch,
  which is the JAX counter's output positions / ``lhs_dilation``: the
  zero-inserted positions are no required work.  (The port's up-conv
  crops ``conv_transpose2d``'s output to exactly stride x its input, so
  the two agree.)

What the run dispatches is what is counted: a function that calls
``backward`` counts its backward too, as the JAX counter counts a traced
gradient.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode


def _meta(x):
    return x.detach().to("meta") if torch.is_tensor(x) else x


def count_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` with every tensor argument moved to
    the ``meta`` device and return ``{"macs", "flops", "by_op"}``: flops
    = 2 x MACs over the matmuls and convolutions it dispatched,
    ``by_op`` the flops of each ATen op."""
    args, kwargs = pytree.tree_map(_meta, (args, kwargs))
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in mode.get_flop_counts()["Global"].items()}
    flops = int(mode.get_total_flops())
    return {"macs": flops // 2, "flops": flops, "by_op": by_op}
