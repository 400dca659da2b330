"""The ``crowdmod::`` operator namespace: the port's kernels as registered
PyTorch operators, and the seeded draws of an exported sampler.

Each kernel module defines its operator here at import (a schema, a CUDA
implementation and a fake one); registering needs neither CUDA nor
``nvcc``.  The CUDA implementation is the kernel's ``ctypes`` launch, built
at first use as before, and counts the launch; the fake implementation
gives the output's shape, dtype and device, so ``torch.export`` (and
``meta`` tensors) can trace a call without running it.  A wrapper calls its
operator for CUDA tensors; a program exported from the port calls the
operators directly, and its launches count all the same.

Operators are defined with ``Library.define``/``impl`` rather than
``torch.library.custom_op``: the dispatcher's cost a call is about a third
of ``custom_op``'s, and the UNet's serving path makes about 1,200 calls a
request.

:func:`normal` (``crowdmod::normal``) is the exported samplers' source of
randomness: standard-normal draws of a given size from a ``torch.Generator``
seeded from ``(seed, step)``, so an artifact called twice with one seed
gives the same sample, and one sampler step's draws do not depend on any
other's.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("crowdmod", "DEF")


def define(schema: str, cuda, fake) -> None:
    """Define ``crowdmod::<schema>`` with its CUDA and fake
    implementations."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"crowdmod::{name}", fake, lib=LIB)


def draw_seed(seed: int, step: int) -> int:
    """The generator seed of one draw: splitmix64 of ``seed``'s low 32 bits
    above ``step``'s (step −1, the chain's start, is 2³² − 1), a bijection,
    so that the low 32 bits, all a CPU generator keeps, mix both."""
    mask = (1 << 64) - 1
    z = ((((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return z ^ (z >> 31)


def _normal(seed, step, size, device):
    gen = torch.Generator(device=device).manual_seed(
        draw_seed(int(seed), int(step)))
    return torch.randn(size, generator=gen, device=device, dtype=torch.float32)


def _normal_fake(seed, step, size, device):
    return torch.empty(size, device=device, dtype=torch.float32)


LIB.define("normal(Tensor seed, Tensor step, int[] size, Device device) -> Tensor")
for _key in ("CPU", "CUDA"):
    LIB.impl("normal", _normal, _key)
torch.library.register_fake("crowdmod::normal", _normal_fake, lib=LIB)


def normal(seed: torch.Tensor, step: torch.Tensor, size, device) -> torch.Tensor:
    """float32 N(0, 1) draws of ``size`` on ``device`` from the generator
    seeded by :func:`draw_seed` of the int64 scalars ``seed`` and ``step``
    (host tensors: reading them costs no device round trip)."""
    return torch.ops.crowdmod.normal(seed, step, list(size), torch.device(device))
