"""Plain PyTorch version of the Mamba selective scan (twin of the
reference's ``repro.kernels.ssm_scan.ref.ssm_scan_ref``), one time step at
a time in f32:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
    y_t = <h_t, C_t> + D * x_t

x, dt: (B, S, Di); Bc, Cc: (B, S, N); A: (Di, N); D: (Di,); h0: (B, Di, N).
Returns (y (B,S,Di) f32, hT (B,Di,N) f32); ``state_out``, as for the
kernel, receives hT (it may be ``h0``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS


def ssm_scan_ref(x, dt, A, Bc, Cc, D, h0, *, state_out=None):
    PLAIN_CALLS["ssm_scan"] += 1
    f32 = torch.float32
    x, dt, Bc, Cc = (t.to(f32) for t in (x, dt, Bc, Cc))
    A, D = A.to(f32), D.to(f32)
    h = h0.to(f32)
    ys = []
    for t in range(x.shape[1]):
        dt_t, x_t = dt[:, t], x[:, t]
        da = torch.exp(dt_t[..., None] * A)
        h = da * h + (dt_t * x_t)[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]) + D * x_t)
    y = torch.stack(ys, dim=1)
    return (y, h) if state_out is None else (y, state_out.copy_(h))
