"""Inline sampler-spec parsing (port of the JAX package's
``utils/sampler_spec.py``).

A sampler is named either as a plain ``MODEL.DDPM.SAMPLER`` (``DDPM``,
``DDIM``, ``DPM-Solver``, ``Distilled``...) or inline as
``DDIM-eta:ETA:STEPS`` or ``Distilled-eta:ETA:STEPS``, optionally with a
``+GUIDANCE[:LAMBDA]`` suffix; :func:`sampler_overrides` turns the spec into
the ``MODEL.DDPM`` overrides that select it.
"""

from __future__ import annotations


def sampler_overrides(spec: str) -> dict:
    """``spec`` → the ``MODEL.DDPM`` config-override dict selecting it.

    >>> sampler_overrides("DPM-Solver")
    {'SAMPLER': 'DPM-Solver'}
    >>> sampler_overrides("DDIM-eta:1.0:25")
    {'SAMPLER': 'DDIM-eta', 'ETA': 1.0, 'ETA_STEPS': 25}
    >>> sampler_overrides("Distilled-eta:1.0:8")
    {'SAMPLER': 'Distilled', 'DISTILL_ETA': 1.0, 'DISTILL_STEPS': 8}

    Any spec may carry a ``+GUIDANCE[:LAMBDA]`` suffix composing sampling
    guidance onto the sampler:

    >>> sampler_overrides("DDIM-eta:1.0:25+Sparsity:0.004")["GUIDANCE"]
    'Sparsity'
    """
    if "+" in spec:
        spec, _, gpart = spec.partition("+")
        gname, _, lam_s = gpart.partition(":")
        if gname not in ("Sparsity", "mass_preservation"):
            raise ValueError(
                f"bad guidance suffix {gpart!r}: expected "
                "'+Sparsity:LAMBDA' or '+mass_preservation'"
            )
        over = sampler_overrides(spec)
        over["GUIDANCE"] = gname
        if lam_s:
            if gname == "mass_preservation":
                # Mass-preservation guidance has a fixed, schedule-derived
                # strength: a lambda here would be a silent no-op, so it is
                # rejected.
                raise ValueError(
                    "mass_preservation guidance takes no lambda (its "
                    "strength is schedule-derived); use '+mass_preservation'"
                )
            try:
                over["LAMBDA_GUIDANCE"] = float(lam_s)
            except ValueError:
                raise ValueError(
                    f"bad guidance suffix lambda {lam_s!r}: must be a float"
                ) from None
        return over
    if spec.startswith("Distilled-eta:"):
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad sampler spec {spec!r}: the inline form is "
                "'Distilled-eta:ETA:STEPS', e.g. 'Distilled-eta:1.0:8'"
            )
        _, eta_s, steps_s = parts
        try:
            return {"SAMPLER": "Distilled", "DISTILL_ETA": float(eta_s),
                    "DISTILL_STEPS": int(steps_s)}
        except ValueError:
            raise ValueError(
                f"bad sampler spec {spec!r}: ETA must be a float and STEPS "
                "an int ('Distilled-eta:1.0:8')"
            ) from None
    if spec.startswith("DDIM-eta:"):
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad sampler spec {spec!r}: the inline form is "
                "'DDIM-eta:ETA:STEPS', e.g. 'DDIM-eta:1.0:25'"
            )
        _, eta_s, steps_s = parts
        try:
            return {"SAMPLER": "DDIM-eta", "ETA": float(eta_s),
                    "ETA_STEPS": int(steps_s)}
        except ValueError:
            raise ValueError(
                f"bad sampler spec {spec!r}: ETA must be a float and STEPS "
                "an int ('DDIM-eta:1.0:25')"
            ) from None
    return {"SAMPLER": spec}
