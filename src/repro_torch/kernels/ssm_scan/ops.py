"""Public Mamba selective-scan op: the CUDA kernels for a CUDA tensor, the
plain PyTorch versions for a CPU tensor, no fallback from one to the other.

Under autograd the op is a ``torch.autograd.Function`` (the counterpart of
the reference's ``jax.custom_vjp`` in ``repro.kernels.ssm_scan.ops``): its
forward saves the chunk-start states, its backward replays each chunk from
them and runs the reverse recurrence (B6 on the card, ``ssm_scan_bwd_ref``
on the CPU). The tests' yardstick is autograd through the plain forward,
``ssm_scan_ref``, called directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd, ssm_scan_fwd
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref


class _SSM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D, h0):
        fwd = ssm_scan_fwd if x.is_cuda else ssm_scan_ref
        y, hT, h_starts = fwd(x, dt, A, Bc, Cc, D, h0, save_states=True)
        ctx.save_for_backward(x, dt, A, Bc, Cc, D, h_starts)
        ctx.h0_dtype = h0.dtype
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        """An unused output's gradient arrives as zeros (autograd
        materializes it), so dhT is zeros when hT is unused, as in
        training. The kernel's partials are summed in a fixed order (by the
        wrapper), as the reference's ``_bwd`` sums its per-block ones."""
        x, dt, A, Bc, Cc, D, h_starts = ctx.saved_tensors
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        dy, dhT = dy.to(acc).contiguous(), dhT.to(acc).contiguous()
        bwd = ssm_scan_bwd if x.is_cuda else ssm_scan_bwd_ref
        dx, ddt, dA, dB, dC, dD, dh0 = bwd(x, dt, A, Bc, Cc, D, dy, h_starts, dhT)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bc.dtype),
                dC.to(Cc.dtype), dD.to(D.dtype), dh0.to(ctx.h0_dtype))


def ssm_scan(x, dt, A, Bc, Cc, D, h0, *, state_out=None):
    """Selective scan over any S >= 1. x, dt: (B,S,Di); A: (Di,N); Bc, Cc:
    (B,S,N); D: (Di,); h0: (B,Di,N) f32. Returns (y (B,S,Di) f32, hT
    (B,Di,N) f32).

    ``state_out`` receives hT and is returned as it; it may be ``h0``
    itself, so a decode step updates its cache's state in place. It is
    refused when a gradient is required: autograd would have saved the
    state the write overwrites."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, A, Bc, Cc, D, h0))):
        fwd = ssm_scan_fwd if x.is_cuda else ssm_scan_ref
        return fwd(x, dt, A, Bc, Cc, D, h0, state_out=state_out)
    if state_out is not None:
        raise ValueError("ssm_scan: state_out (an in-place state write) is "
                         "refused when a gradient is required")
    return _SSM.apply(x, dt, A, Bc, Cc, D, h0)
