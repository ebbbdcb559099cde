"""Public RWKV-6 WKV op (forward only: the port serves; the training
backward, B7, is later work): the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor."""

from __future__ import annotations

from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_fwd
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref


def rwkv6_scan(r, k, v, w, u, s0, *, state_out=None):
    """WKV recurrence over any S >= 1. r,k,v,w: (B,H,S,hd); u: (H,hd) f32;
    s0: (B,H,hd,hd) f32. Returns (y (B,H,S,hd) f32, sT (B,H,hd,hd) f32).

    ``state_out`` receives sT and is returned as it; it may be ``s0`` itself,
    so a decode step updates its cache's state in place (on the card the
    kernel writes it directly; each CTA reads its own columns before it
    writes them)."""
    if r.is_cuda:
        return rwkv6_scan_fwd(r, k, v, w, u, s0, state_out=state_out)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, s0, state_out=state_out)
    raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
