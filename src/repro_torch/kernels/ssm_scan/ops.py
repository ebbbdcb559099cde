"""Public Mamba selective-scan op: the CUDA kernels for a CUDA tensor, the
plain PyTorch versions for a CPU tensor, no fallback from one to the other.

Under autograd the op is a ``torch.autograd.Function`` (the counterpart of
the reference's ``jax.custom_vjp`` in ``repro.kernels.ssm_scan.ops``): its
forward saves the chunk-start states, its backward replays each chunk from
them and runs the reverse recurrence (B6 on the card, ``ssm_scan_bwd_ref``
on the CPU). The tests' yardstick is autograd through the plain forward,
``ssm_scan_ref``, called directly.

``ssm_scan_cost`` and ``ssm_scan_bwd_cost`` are B4's and B6's work
(``parallel.cost``), each input read once, each output written once, the
chunk-start states counted at the reference's 64-step chunk. On ``meta``
tensors the op returns what the plain versions return, without their
step-by-step loops (``ssm_scan_meta``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd, ssm_scan_fwd
from repro_torch.kernels.ssm_scan.ref import n_chunks, ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.parallel.cost import (Cost, acc_dtype, kernel_op, nbytes, ref_chunk_bytes,
                                       tensor_bytes)


def ssm_scan_cost(x, dt, A, Bc, Cc, D, h0, *, save_states=False, **_):
    """B4's work: per (d, n, t) dt*A, its exp, da*h, dt*x*B and the sum,
    h*C and its running sum (7); per (d, t) dt*x, D*x and its add (3). y
    and hT written, and with ``save_states`` the chunk-start states."""
    B, S, Di = x.shape
    N = A.shape[1]
    out = nbytes((B, S, Di), acc_dtype(x)) + tensor_bytes(h0)
    starts = ref_chunk_bytes(B, 1, S, Di * N) if save_states else 0
    return Cost(float(B * S * Di * (7 * N + 3)),
                tensor_bytes(x, dt, A, Bc, Cc, D, h0) + out + starts)


def ssm_scan_bwd_cost(x, dt, A, Bc, Cc, D, dy, h_starts, dhT):
    """B6's work: per (d, n, t) the replay's 5 and the backward's 20
    operations, ~9 per (d, t); the inputs but the saved states, the
    states at the reference's chunk, and dx, ddt, dA, dB, dC, dD, dh0."""
    B, S, Di = x.shape
    N = A.shape[1]
    acc = acc_dtype(x)
    grads = sum(nbytes(t.shape, acc) for t in (x, dt, A, Bc, Cc, D, dhT))
    return Cost(float(B * S * Di * (25 * N + 9)),
                tensor_bytes(x, dt, A, Bc, Cc, D, dy, dhT) + grads
                + ref_chunk_bytes(B, 1, S, Di * N))


def ssm_scan_meta(x, dt, A, Bc, Cc, D, h0, *, state_out=None, save_states=False):
    """What ``ssm_scan_ref`` returns, on ``meta`` tensors: its outputs'
    shapes and dtypes without the step-by-step loop, which has no values to
    compute there."""
    B, S, Di = x.shape
    acc = acc_dtype(x)
    out = (x.new_empty((B, S, Di), dtype=acc),
           h0.new_empty(h0.shape, dtype=acc) if state_out is None else state_out)
    if save_states:
        out += (x.new_empty((B, n_chunks(S), Di, A.shape[1]), dtype=acc),)
    return out


def ssm_scan_bwd_meta(x, dt, A, Bc, Cc, D, dy, h_starts, dhT):
    """What ``ssm_scan_bwd_ref`` returns, on ``meta`` tensors (see
    ``ssm_scan_meta``)."""
    acc = acc_dtype(x)
    return tuple(t.new_empty(t.shape, dtype=acc) for t in (x, dt, A, Bc, Cc, D, dhT))


def _fwd(x, dt, A, Bc, Cc, D, h0, **kw):
    with kernel_op("ssm_scan", ssm_scan_cost, x, dt, A, Bc, Cc, D, h0, **kw):
        fwd = ssm_scan_fwd if x.is_cuda else (ssm_scan_meta if x.is_meta else ssm_scan_ref)
        return fwd(x, dt, A, Bc, Cc, D, h0, **kw)


class _SSM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, D, h0):
        y, hT, h_starts = _fwd(x, dt, A, Bc, Cc, D, h0, save_states=True)
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
        bwd = ssm_scan_bwd if x.is_cuda else (ssm_scan_bwd_meta if x.is_meta
                                              else ssm_scan_bwd_ref)
        args = (x, dt, A, Bc, Cc, D, dy, h_starts, dhT)
        with kernel_op("ssm_scan_bwd", ssm_scan_bwd_cost, *args):
            dx, ddt, dA, dB, dC, dD, dh0 = bwd(*args)
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
    refuse_dtensor("ssm_scan", x, dt, A, Bc, Cc, D, h0)
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, dt, A, Bc, Cc, D, h0))):
        return _fwd(x, dt, A, Bc, Cc, D, h0, state_out=state_out)
    if state_out is not None:
        raise ValueError("ssm_scan: state_out (an in-place state write) is "
                         "refused when a gradient is required")
    return _SSM.apply(x, dt, A, Bc, Cc, D, h0)
