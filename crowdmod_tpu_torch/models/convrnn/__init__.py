"""The ConvRNN family (port of the JAX package's ``models/convrnn``): the
recurrent cells, the encoder–forecaster and its composite loss."""

from crowdmod_tpu_torch.models.convrnn.cells import CELLS, ConvGRUCell, ConvLSTMCell, init_state
from crowdmod_tpu_torch.models.convrnn.forecaster import Encoder, Forecaster, exp_log_channels
from crowdmod_tpu_torch.models.convrnn.losses import (
    convrnn_loss,
    kl_gaussian_loss,
    kl_poisson_loss,
    velocity_mse_loss,
)

__all__ = [
    "ConvGRUCell",
    "ConvLSTMCell",
    "CELLS",
    "init_state",
    "Encoder",
    "Forecaster",
    "exp_log_channels",
    "kl_poisson_loss",
    "kl_gaussian_loss",
    "velocity_mse_loss",
    "convrnn_loss",
]
