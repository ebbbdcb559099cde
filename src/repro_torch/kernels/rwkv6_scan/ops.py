"""Public RWKV-6 WKV op: the CUDA kernels for a CUDA tensor, the plain
PyTorch versions for a CPU tensor, no fallback from one to the other.

Under autograd the op is a ``torch.autograd.Function`` (the counterpart of
the reference's ``jax.custom_vjp`` in ``repro.kernels.rwkv6_scan.ops``):
its forward saves the chunk-start states, its backward rewinds each chunk
from them and runs the reverse recurrence (B7 on the card,
``rwkv6_scan_bwd_ref`` on the CPU). The tests' yardstick is autograd
through the plain forward, ``rwkv6_scan_ref``, called directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd, rwkv6_scan_fwd
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        fwd = rwkv6_scan_fwd if r.is_cuda else rwkv6_scan_ref
        y, sT, s_starts = fwd(r, k, v, w, u, s0, save_states=True)
        ctx.save_for_backward(r, k, v, w, u, s_starts)
        ctx.s0_dtype = s0.dtype
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        """An unused output's gradient arrives as zeros (autograd
        materializes it), so dsT is zeros when sT is unused, as in
        training."""
        r, k, v, w, u, s_starts = ctx.saved_tensors
        acc = torch.float64 if r.dtype == torch.float64 else torch.float32
        dy = dy.to(acc)
        if not _build.rows_ok(dy):
            dy = dy.contiguous()
        dsT = dsT.to(acc).contiguous()
        bwd = rwkv6_scan_bwd if r.is_cuda else rwkv6_scan_bwd_ref
        dr, dk, dv, dw, du_chunks, ds0 = bwd(r, k, v, w, dy, u, s_starts, dsT)
        du = du_chunks.sum(dim=(0, 2)).to(u.dtype)  # (H, hd), fixed order
        return dr, dk, dv, dw.to(w.dtype), du, ds0.to(ctx.s0_dtype)


def rwkv6_scan(r, k, v, w, u, s0, *, state_out=None):
    """WKV recurrence over any S >= 1. r,k,v,w: (B,H,S,hd); u: (H,hd) f32;
    s0: (B,H,hd,hd) f32. Returns (y (B,H,S,hd) f32, sT (B,H,hd,hd) f32).

    ``state_out`` receives sT and is returned as it; it may be ``s0`` itself,
    so a decode step updates its cache's state in place (on the card the
    kernel writes it directly; each CTA reads its own columns before it
    writes them). It is refused when a gradient is required: autograd would
    have saved the state the write overwrites."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (r, k, v, w, u, s0))):
        fwd = rwkv6_scan_fwd if r.is_cuda else rwkv6_scan_ref
        return fwd(r, k, v, w, u, s0, state_out=state_out)
    if state_out is not None:
        raise ValueError("rwkv6_scan: state_out (an in-place state write) is "
                         "refused when a gradient is required")
    return _WKV.apply(r, k, v, w, u, s0)
