"""Kernels written by hand for Hopper, with their plain PyTorch versions.

Counterpart of ``tensorflowonspark_tpu/ops``: the Pallas flash-attention
forward becomes the CUDA C++ kernel in ``csrc/flash_fwd.cu``, its dq and
dk/dv backward kernels those in ``csrc/flash_bwd.cu``; the plain
versions are what the CPU runs and what the kernels are held against.
"""

from tensorflowonspark_tpu_torch.ops.attention import (  # noqa: F401
    apply_rope,
    flash_attention,
    flash_backward_plain,
    flash_attention_plain,
    mha_reference,
    rope_angles,
)
from tensorflowonspark_tpu_torch.ops.norm import (  # noqa: F401
    rmsnorm_reference,
)
