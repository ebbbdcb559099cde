"""Plain PyTorch version of the RWKV-6 WKV recurrence (twin of the
reference's ``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref``), one time step
at a time in f32:

    y_t = r_t . (S_{t-1} + u * (k_t v_t^T))
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

r,k,v,w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd) f32, indexed
[key_dim, value_dim]. Returns (y (B,H,S,hd) f32, sT (B,H,hd,hd) f32).
``state_out``, as for the kernel, receives sT (it may be ``s0``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS


def rwkv6_scan_ref(r, k, v, w, u, s0, *, state_out=None):
    PLAIN_CALLS["rwkv6_scan"] += 1
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s + uu * kv))
        s = w[:, :, t, :, None] * s + kv
    y = torch.stack(ys, dim=2)
    return (y, s) if state_out is None else (y, state_out.copy_(s))
