"""Kernels written by hand for Hopper, with their plain PyTorch versions.

Counterpart of ``tensorflowonspark_tpu/ops``: the Pallas flash-attention
forward becomes the CUDA C++ kernel in ``csrc/flash_fwd.cu``, its dq and
dk/dv backward kernels those in ``csrc/flash_bwd.cu``, the RMSNorm
kernel ``csrc/rmsnorm.cu``; the plain versions are what the CPU runs and
what the kernels are held against.
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
    fused_rmsnorm,
    rmsnorm_reference,
)


def reset_launch_counts():
    """Every kernel's launch count in this process to 0."""
    from tensorflowonspark_tpu_torch.ops import attention, norm

    attention.launches = attention.dq_launches = attention.dkv_launches = 0
    norm.launches = 0


def launch_counts():
    """``{kernel name: launches in this process}``, by the names the
    kernels line of ``chip_smoke.py`` gives them."""
    from tensorflowonspark_tpu_torch.ops import attention, norm

    return dict(flash_fwd=attention.launches,
                flash_dq=attention.dq_launches,
                flash_dkv=attention.dkv_launches, rmsnorm=norm.launches)
