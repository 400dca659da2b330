from crowdmod_tpu_torch.models.diffusion.ddpm import (
    as_eps_fn,
    ddim_eta_sample,
    ddim_eta_step,
    ddim_sample,
    ddpm_loss,
    ddpm_sample,
    gaussian_noise,
    prediction_target,
)
from crowdmod_tpu_torch.models.diffusion.distill import (
    ddim_det_step,
    distill_grid,
    distill_loss,
    distill_targets,
    distilled_sample,
)
from crowdmod_tpu_torch.models.diffusion.dpm_solver import (
    dpm_solver_sample,
    dpm_timesteps,
)

__all__ = [
    "as_eps_fn",
    "ddpm_loss",
    "prediction_target",
    "gaussian_noise",
    "ddpm_sample",
    "ddim_sample",
    "ddim_eta_sample",
    "ddim_eta_step",
    "dpm_timesteps",
    "dpm_solver_sample",
    "distill_grid",
    "ddim_det_step",
    "distill_targets",
    "distill_loss",
    "distilled_sample",
]
