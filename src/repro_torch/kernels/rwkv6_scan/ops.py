"""Public RWKV-6 WKV op: the CUDA kernels for a CUDA tensor, the plain
PyTorch versions for a CPU tensor, no fallback from one to the other.

Under autograd the op is a ``torch.autograd.Function`` (the counterpart of
the reference's ``jax.custom_vjp`` in ``repro.kernels.rwkv6_scan.ops``):
its forward saves the chunk-start states, its backward rewinds each chunk
from them and runs the reverse recurrence (B7 on the card,
``rwkv6_scan_bwd_ref`` on the CPU). The tests' yardstick is autograd
through the plain forward, ``rwkv6_scan_ref``, called directly.

``rwkv6_scan_cost`` and ``rwkv6_scan_bwd_cost`` are B5's and B7's work
(``parallel.cost``), each input read once, each output written once, the
chunk-start states and du partials counted at the reference's 64-step
chunk. The plain versions' y, dr, dk, dv and dw take the kernels' layout
(``kernel_layout``), so the ops around the op are the same on every
device; on ``meta`` tensors the op returns what the plain versions return,
without their step-by-step loops (``rwkv6_scan_meta``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, refuse_dtensor
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd, rwkv6_scan_fwd
from repro_torch.kernels.rwkv6_scan.ref import n_chunks, rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.parallel.cost import (Cost, acc_dtype, kernel_op, nbytes, ref_chunk_bytes,
                                       tensor_bytes)


def rwkv6_scan_cost(r, k, v, w, u, s0, *, save_states=False, **_):
    """B5's work, the least the function needs per (b, h, t): r.S one FMA
    and w*S + k*v a multiply and an FMA per state element (5), the bonus
    as (r . (u*k)) v, 5 a key row. y and sT written, and with
    ``save_states`` the chunk-start states."""
    B, H, S, hd = r.shape
    out = nbytes(r.shape, acc_dtype(r)) + tensor_bytes(s0)
    starts = ref_chunk_bytes(B, H, S, hd * hd) if save_states else 0
    return Cost(float(B * H * S * (5 * hd * hd + 5 * hd)),
                tensor_bytes(r, k, v, w, u, s0) + out + starts)


def rwkv6_scan_bwd_cost(r, k, v, w, dy, u, s_starts, dsT):
    """B7's work: per state element and step the replay (2), dr, dk, dw,
    dv (an FMA each) and the G update (2), 14; ~15 a row for the bonus and
    du. The inputs but the saved states; the states and du partials at the
    reference's chunk; dr, dk, dv in r's dtype, dw and ds0."""
    B, H, S, hd = r.shape
    grads = 3 * nbytes(r.shape, r.dtype) + nbytes(r.shape, acc_dtype(r)) + tensor_bytes(dsT)
    return Cost(float(B * H * S * (14 * hd * hd + 15 * hd)),
                tensor_bytes(r, k, v, w, dy, u, dsT) + grads
                + ref_chunk_bytes(B, H, S, hd * hd + hd))


def _bshd(like, dtype):
    """A (B,H,S,hd) view of new (B,S,H,hd) storage: the layout the kernels
    write y, dr, dk, dv and dw in."""
    B, H, S, hd = like.shape
    return like.new_empty((B, S, H, hd), dtype=dtype).transpose(1, 2)


def kernel_layout(t):
    """``t`` (B,H,S,hd) in the kernels' layout (``_bshd``); the plain
    versions' outputs take it too, so the ops around the op, and their
    backward, are the same on every device."""
    return _bshd(t, t.dtype).copy_(t)


def rwkv6_scan_meta(r, k, v, w, u, s0, *, state_out=None, save_states=False):
    """What the op's plain forward returns, on ``meta`` tensors: the
    outputs' shapes, dtypes and layout without the step-by-step loop, which
    has no values to compute there."""
    B, H, S, hd = r.shape
    acc = acc_dtype(r)
    out = (_bshd(r, acc),
           s0.new_empty(s0.shape, dtype=acc) if state_out is None else state_out)
    if save_states:
        out += (r.new_empty((B, H, n_chunks(S), hd, hd), dtype=acc),)
    return out


def rwkv6_scan_bwd_meta(r, k, v, w, dy, u, s_starts, dsT):
    """What the op's plain backward returns, on ``meta`` tensors (see
    ``rwkv6_scan_meta``)."""
    B, H, S, hd = r.shape
    acc = acc_dtype(r)
    return (_bshd(r, r.dtype), _bshd(r, r.dtype), _bshd(r, r.dtype), _bshd(r, acc),
            r.new_empty((B, H, n_chunks(S), hd), dtype=acc), dsT.new_empty(dsT.shape, dtype=acc))


def _plain_fwd(r, k, v, w, u, s0, **kw):
    y, *rest = rwkv6_scan_ref(r, k, v, w, u, s0, **kw)
    return (kernel_layout(y), *rest)


def _plain_bwd(*args):
    dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd_ref(*args)
    return (*(kernel_layout(t) for t in (dr, dk, dv, dw)), du, ds0)


def _fwd(r, k, v, w, u, s0, **kw):
    with kernel_op("rwkv6_scan", rwkv6_scan_cost, r, k, v, w, u, s0, **kw):
        fwd = rwkv6_scan_fwd if r.is_cuda else (rwkv6_scan_meta if r.is_meta else _plain_fwd)
        return tuple(fwd(r, k, v, w, u, s0, **kw))


class _WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, sT, s_starts = _fwd(r, k, v, w, u, s0, save_states=True)
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
        bwd = rwkv6_scan_bwd if r.is_cuda else (rwkv6_scan_bwd_meta if r.is_meta
                                                else _plain_bwd)
        args = (r, k, v, w, dy, u, s_starts, dsT)
        with kernel_op("rwkv6_scan_bwd", rwkv6_scan_bwd_cost, *args):
            dr, dk, dv, dw, du_chunks, ds0 = bwd(*args)
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
    refuse_dtensor("rwkv6_scan", r, k, v, w, u, s0)
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (r, k, v, w, u, s0))):
        return _fwd(r, k, v, w, u, s0, state_out=state_out)
    if state_out is not None:
        raise ValueError("rwkv6_scan: state_out (an in-place state write) is "
                         "refused when a gradient is required")
    return _WKV.apply(r, k, v, w, u, s0)
