"""Plain PyTorch versions of the RWKV-6 WKV recurrence and its backward
(twins of the reference's ``repro.kernels.rwkv6_scan.ref.rwkv6_scan_ref``
and of its Pallas backward ``_bwd_kernel``), one time step at a time in f32:

    y_t = r_t . (S_{t-1} + u * (k_t v_t^T))
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

r,k,v,w: (B, H, S, hd); u: (H, hd); s0: (B, H, hd, hd) f32, indexed
[key_dim, value_dim]. The forward returns (y (B,H,S,hd) f32, sT (B,H,hd,hd)
f32); ``state_out``, as for the kernel, receives sT (it may be ``s0``).
``save_states=True`` adds the states before every ``CHECKPOINT``-th step,
(B, H, nc, hd, hd) f32 with nc = ceil(S / CHECKPOINT): the checkpoints the
backward rewinds from. Both functions compute in f32, or in f64 when r is
f64 (for ``gradcheck``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS

CHECKPOINT = 8  # time steps between saved states (the backward kernel's history)


def n_chunks(S: int) -> int:
    return -(-S // CHECKPOINT)


def _acc(r):
    return torch.float64 if r.dtype == torch.float64 else torch.float32


def rwkv6_scan_ref(r, k, v, w, u, s0, *, state_out=None, save_states=False):
    PLAIN_CALLS["rwkv6_scan"] += 1
    acc = _acc(r)
    r, k, v, w = (t.to(acc) for t in (r, k, v, w))
    uu = u.to(acc)[None, :, :, None]
    s = s0.to(acc)
    ys, starts = [], []
    for t in range(r.shape[2]):
        if t % CHECKPOINT == 0:
            starts.append(s)
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s + uu * kv))
        s = w[:, :, t, :, None] * s + kv
    y = torch.stack(ys, dim=2)
    out = (y, s) if state_out is None else (y, state_out.copy_(s))
    return out + (torch.stack(starts, dim=2),) if save_states else out


def rwkv6_scan_bwd_ref(r, k, v, w, dy, u, s_starts, dsT):
    """The reverse recurrence: for each chunk, last first, rewind the states
    from its checkpoint, then walk its steps backwards with G (= dL/dS_t)
        dr_t = S_{t-1} dy_t + u k_t (dy_t . v_t)
        dk_t = G v_t + u r_t (dy_t . v_t)
        dv_t = G^T k_t + (r_t . u k_t) dy_t
        dw_t = rowsum(G * S_{t-1}),   du += r_t k_t (dy_t . v_t)
        G <- w_t G + r_t dy_t^T
    Any S >= 1 (the last chunk may be ragged). Returns (dr, dk, dv in
    ``r.dtype``; dw (B,H,S,hd), du_partials (B,H,nc,hd) per chunk, ds0
    (B,H,hd,hd), all f32, or f64 for f64 inputs)."""
    PLAIN_CALLS["rwkv6_scan_bwd"] += 1
    B, H, S, hd = r.shape
    acc = _acc(r)
    rf, kf, vf, wf, dyf = (t.to(acc) for t in (r, k, v, w, dy))
    uf = u.to(acc)[None]  # (1, H, hd)
    nc = n_chunks(S)
    dr, dk, dv, dw = (torch.empty((B, H, S, hd), dtype=acc, device=r.device)
                      for _ in range(4))
    du = torch.empty((B, H, nc, hd), dtype=acc, device=r.device)
    g = dsT.to(acc)
    for c in reversed(range(nc)):
        t0, t1 = c * CHECKPOINT, min(S, (c + 1) * CHECKPOINT)
        hist = [s_starts[:, :, c].to(acc)]  # hist[t - t0] = S_{t-1}
        for t in range(t0, t1 - 1):
            hist.append(wf[:, :, t, :, None] * hist[-1]
                        + kf[:, :, t, :, None] * vf[:, :, t, None, :])
        du_c = torch.zeros((B, H, hd), dtype=acc, device=r.device)
        for t in reversed(range(t0, t1)):
            s_pre = hist[t - t0]
            r_t, k_t, v_t, w_t, dy_t = (x[:, :, t] for x in (rf, kf, vf, wf, dyf))
            dyv = (dy_t * v_t).sum(-1, keepdim=True)
            dr[:, :, t] = (s_pre * dy_t[..., None, :]).sum(-1) + uf * k_t * dyv
            dk[:, :, t] = (g * v_t[..., None, :]).sum(-1) + uf * r_t * dyv
            dv[:, :, t] = ((g * k_t[..., :, None]).sum(-2)
                           + (r_t * uf * k_t).sum(-1, keepdim=True) * dy_t)
            dw[:, :, t] = (g * s_pre).sum(-1)
            du_c = du_c + r_t * k_t * dyv
            g = w_t[..., :, None] * g + r_t[..., :, None] * dy_t[..., None, :]
        du[:, :, c] = du_c
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, g
