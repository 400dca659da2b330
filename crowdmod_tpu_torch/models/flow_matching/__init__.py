from crowdmod_tpu_torch.models.flow_matching.fm import (
    INTEGRATORS,
    INTERPOLANTS,
    conic_interpolant,
    euler_sample,
    fm_loss,
    heun_sample,
    linear_interpolant,
)
from crowdmod_tpu_torch.models.flow_matching.reflow import (
    generate_coupling,
    reflow_loss,
)

__all__ = [
    "fm_loss",
    "euler_sample",
    "heun_sample",
    "linear_interpolant",
    "conic_interpolant",
    "generate_coupling",
    "reflow_loss",
    "INTERPOLANTS",
    "INTEGRATORS",
]
