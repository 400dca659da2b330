"""Hand-written CUDA kernels for Hopper, one module each, with their twins.

Each wrapper runs its plain PyTorch twin on CPU tensors and its kernel on
CUDA tensors (or raises); ``<wrapper>.launches`` counts the kernel launches.
Kernels build from ``crowdmod_tpu_torch/csrc`` at first use
(:mod:`.build`).
"""

from crowdmod_tpu_torch.ops.kernels.attention import (
    attention_reference,
    fused_attention,
)
from crowdmod_tpu_torch.ops.kernels.fused_step import (
    ancestral_update_reference,
    fused_ancestral_update,
)

KERNELS = (fused_attention, fused_ancestral_update)


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
    "reset_launch_counts",
]
