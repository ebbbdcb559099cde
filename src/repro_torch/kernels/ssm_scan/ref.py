"""Plain PyTorch versions of the Mamba selective scan and its backward
(twins of the reference's ``repro.kernels.ssm_scan.ref.ssm_scan_ref`` and of
its Pallas backward ``_bwd_kernel``), one time step at a time in f32:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
    y_t = <h_t, C_t> + D * x_t

x, dt: (B, S, Di); Bc, Cc: (B, S, N); A: (Di, N); D: (Di,); h0: (B, Di, N).
The forward returns (y (B,S,Di) f32, hT (B,Di,N) f32); ``state_out``, as for
the kernel, receives hT (it may be ``h0``). ``save_states=True`` adds the
states before every ``CHECKPOINT``-th step, (B, nc, Di, N) f32 with
nc = ceil(S / CHECKPOINT): the checkpoints the backward replays from. Both
functions compute in f32, or in f64 when x is f64 (for ``gradcheck``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS

CHECKPOINT = 8  # time steps between saved states (the backward kernel's history)


def n_chunks(S: int) -> int:
    return -(-S // CHECKPOINT)


def _acc(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssm_scan_ref(x, dt, A, Bc, Cc, D, h0, *, state_out=None, save_states=False):
    PLAIN_CALLS["ssm_scan"] += 1
    acc = _acc(x)
    x, dt, Bc, Cc, A, D = (t.to(acc) for t in (x, dt, Bc, Cc, A, D))
    h = h0.to(acc)
    ys, starts = [], []
    for t in range(x.shape[1]):
        if t % CHECKPOINT == 0:
            starts.append(h)
        dt_t, x_t = dt[:, t], x[:, t]
        da = torch.exp(dt_t[..., None] * A)
        h = da * h + (dt_t * x_t)[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]) + D * x_t)
    y = torch.stack(ys, dim=1)
    out = (y, h) if state_out is None else (y, state_out.copy_(h))
    return out + (torch.stack(starts, dim=1),) if save_states else out


def ssm_scan_bwd_ref(x, dt, A, Bc, Cc, D, dy, h_starts, dhT):
    """The reverse recurrence: for each chunk, last first, replay h from its
    checkpoint, then walk its steps backwards with g (= dL/dh_t):
        g   += dy_t C_t
        gh   = g * h_{t-1} * exp(dt_t A)
        ddt_t = sum_n gh A + x_t sum_n g B_t
        dx_t  = dt_t sum_n g B_t + D dy_t
        dB_t  = sum_d g dt_t x_t,   dC_t = sum_d dy_t h_t
        dA   += gh dt_t,            dD  += dy_t x_t
        g    <- exp(dt_t A) g
    Any S >= 1 (the last chunk may be ragged). Returns (dx, ddt (B,S,Di);
    dA (Di,N); dB, dC (B,S,N); dD (Di,); dh0 (B,Di,N)), f32, or f64 for f64
    inputs; dA and dD are summed over the batch."""
    PLAIN_CALLS["ssm_scan_bwd"] += 1
    B, S, Di = x.shape
    N = A.shape[-1]
    acc = _acc(x)
    xf, dtf, Bf, Cf, dyf, Af, Df = (t.to(acc) for t in (x, dt, Bc, Cc, dy, A, D))
    dx, ddt = (torch.empty((B, S, Di), dtype=acc, device=x.device) for _ in range(2))
    dB, dC = (torch.empty((B, S, N), dtype=acc, device=x.device) for _ in range(2))
    dA = torch.zeros((B, Di, N), dtype=acc, device=x.device)
    dD = torch.zeros((B, Di), dtype=acc, device=x.device)
    g = dhT.to(acc)
    for c in reversed(range(n_chunks(S))):
        t0, t1 = c * CHECKPOINT, min(S, (c + 1) * CHECKPOINT)
        hist = [h_starts[:, c].to(acc)]  # hist[t - t0] = h_{t-1}
        for t in range(t0, t1 - 1):
            da = torch.exp(dtf[:, t, :, None] * Af)
            hist.append(da * hist[-1]
                        + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            h_pre = hist[t - t0]
            dt_t, x_t, dy_t = dtf[:, t], xf[:, t], dyf[:, t]
            b_t, c_t = Bf[:, t, None, :], Cf[:, t, None, :]
            dtx = (dt_t * x_t)[..., None]
            da = torch.exp(dt_t[..., None] * Af)
            h_t = da * h_pre + dtx * b_t
            g = g + dy_t[..., None] * c_t
            gh = g * h_pre * da
            gb = (g * b_t).sum(-1)
            ddt[:, t] = (gh * Af).sum(-1) + x_t * gb
            dx[:, t] = dt_t * gb + Df * dy_t
            dB[:, t] = (g * dtx).sum(1)
            dC[:, t] = (dy_t[..., None] * h_t).sum(1)
            dA = dA + gh * dt_t[..., None]
            dD = dD + dy_t * x_t
            g = da * g
    return dx, ddt, dA.sum(0), dB, dC, dD.sum(0), g
