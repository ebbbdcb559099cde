"""PyTorch/CUDA port of the CloudCoaster reproduction (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module (``repro_torch.models.attention`` is the twin of
``repro.models.attention``, ``repro_torch.kernels.<name>/{kernel,ops,ref}.py``
the twin of ``repro.kernels.<name>``) and imports nothing from it.

Every Pallas kernel on the ported path is a CUDA C++ kernel for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use
(``repro_torch.kernels._build``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CPU tensor each kernel op runs its
plain PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
