"""Public Mamba selective-scan op (inference only): the CUDA kernel for a
CUDA tensor, the plain PyTorch version for a CPU tensor, no fallback from
one to the other.

The reference's op is a ``jax.custom_vjp`` whose backward is the Pallas
kernel ``ssm_scan_bwd``; the port's backward is not written yet, so the op
refuses inputs that require a gradient instead of letting autograd
differentiate the plain loop on the CPU and fail on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan_fwd
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def ssm_scan(x, dt, A, Bc, Cc, D, h0, *, state_out=None):
    """Selective scan over any S >= 1. x, dt: (B,S,Di); A: (Di,N); Bc, Cc:
    (B,S,N); D: (Di,); h0: (B,Di,N) f32. Returns (y (B,S,Di) f32, hT
    (B,Di,N) f32). ``state_out`` receives hT and is returned as it; it may
    be ``h0`` itself, so a decode step updates its cache's state in place."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bc, Cc, D, h0)):
        raise NotImplementedError(
            "ssm_scan: the selective scan's backward (the reference's "
            "ssm_scan_bwd) is not ported yet; run it under torch.no_grad()")
    if x.is_cuda:
        return ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0, state_out=state_out)
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, A, Bc, Cc, D, h0, state_out=state_out)
    raise ValueError(f"ssm_scan: unsupported device {x.device}")
