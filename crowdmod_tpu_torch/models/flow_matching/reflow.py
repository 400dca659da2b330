"""ReFlow (rectified flow) for the flow-matching family (port of the JAX
package's ``models/flow_matching/reflow.py``).

A trained velocity field transports noise x0 to data x1 along curved ODE
trajectories.  ReFlow retrains the field on the teacher's own coupled pairs
(x0, x1 = ODE(x0)) along the straight line between them, so the rectified
field integrates accurately in a few Euler steps; it is sampled with the
ordinary Euler integrator at a small ``INTEGRATOR_STEPS``.
"""

from __future__ import annotations

import torch

from crowdmod_tpu_torch.models.flow_matching.fm import euler_sample, linear_interpolant

__all__ = ["generate_coupling", "reflow_loss"]


@torch.no_grad()
def generate_coupling(
    u_fn,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    *,
    steps: int = 100,
    time_max_pos: int = 1000,
    x0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    device=None,
):
    """One coupled pair batch ``(x0, x1)``: x0 ~ N(0, I) (given, or drawn
    from ``generator``), x1 the teacher's ``steps``-step Euler integration
    from it, no gradient."""
    if x0 is None:
        if generator is None:
            raise ValueError("generate_coupling needs x0 or an explicit generator")
        if device is None:
            device = past.device if past is not None else generator.device
        x0 = torch.randn(sample_shape, generator=generator, device=device)
    x1 = euler_sample(u_fn, past, sample_shape, steps=steps,
                      time_max_pos=time_max_pos, x_init=x0)
    return x0, x1


def reflow_loss(
    u_fn,
    x0: torch.Tensor,
    x1: torch.Tensor,
    past: torch.Tensor | None,
    *,
    t: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    time_max_pos: int = 1000,
) -> torch.Tensor:
    """Flow-matching MSE on a given coupled pair, always along the Linear
    interpolant; ``t`` ``(B,)`` uniform on [0, 1), drawn from ``generator``
    unless given."""
    if t is None:
        if generator is None:
            raise ValueError("reflow_loss needs t or an explicit generator")
        t = torch.rand((x1.shape[0],), generator=generator, device=x1.device)
    t_b = t.reshape((-1,) + (1,) * (x1.ndim - 1))
    xt, u_target = linear_interpolant(x0, x1, t_b)
    u_pred = u_fn(xt, torch.floor(t * time_max_pos), past)
    return torch.mean(torch.square(u_target - u_pred))
