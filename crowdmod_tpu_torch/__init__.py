"""crowdmod_tpu_torch — the PyTorch / CUDA port of ``crowdmod_tpu``.

Same models, configs and array layout as the JAX package (``(B, T, H, W, C)``
at every public function), written in PyTorch for one NVIDIA H100.  Every
Pallas kernel of the JAX package that a ported path runs becomes a CUDA C++
kernel for ``sm_90a`` under :mod:`crowdmod_tpu_torch.ops.kernels`, built from
``csrc/`` at first use.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where each kernel wrapper runs its plain
PyTorch twin.

This package imports ``torch`` and never ``jax`` or ``crowdmod_tpu``.
"""

__version__ = "0.1.0"
