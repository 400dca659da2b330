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

__all__ = [
    "as_eps_fn",
    "ddpm_loss",
    "prediction_target",
    "gaussian_noise",
    "ddpm_sample",
    "ddim_sample",
    "ddim_eta_sample",
    "ddim_eta_step",
]
