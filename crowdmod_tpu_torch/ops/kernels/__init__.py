"""Hand-written CUDA kernels for Hopper, one module each, with their twins.

Each wrapper runs its plain PyTorch twin on CPU tensors and its kernel on
CUDA tensors (or raises).  Each kernel is a ``crowdmod::`` operator
(:mod:`.library`), defined when this package is imported;
``<wrapper>.launches`` counts the operator's kernel calls, whoever makes
them (a wrapper, or an exported program).  Kernels build from
``crowdmod_tpu_torch/csrc`` at first use (:mod:`.build`).
"""

from crowdmod_tpu_torch.ops.kernels.attention import (
    attention_reference,
    fused_attention,
)
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    conv3d_same_im2col,
    conv3d_same_reference,
    conv3d_same_tapgemm,
)
from crowdmod_tpu_torch.ops.kernels.fused_step import (
    ancestral_update_reference,
    fused_ancestral_update,
    step_coefficients,
)
from crowdmod_tpu_torch.ops.kernels.groupnorm import (
    fused_group_norm,
    group_norm_reference,
)
from crowdmod_tpu_torch.ops.kernels.resblock import (
    fused_resblock,
    resblock_reference,
)

KERNELS = (
    fused_attention, fused_ancestral_update, fused_group_norm,
    conv3d_same_im2col, conv3d_same_tapgemm, fused_resblock,
)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "KERNELS",
    "attention_reference",
    "fused_attention",
    "ancestral_update_reference",
    "fused_ancestral_update",
    "step_coefficients",
    "group_norm_reference",
    "fused_group_norm",
    "conv3d_same_reference",
    "conv3d_same_im2col",
    "conv3d_same_tapgemm",
    "resblock_reference",
    "fused_resblock",
    "reset_launch_counts",
]
