"""Mamba-1 selective SSM block, Jamba variant with RMSNorm on dt/B/C (twin
of ``repro.models.mamba``).

Recurrence (per channel c, state dim n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
    y_t = <h_t, C_t> + D * x_t
with input-dependent dt (softplus), B, C.

The reference sends S=1 and any S that does not tile its 64-step chunk to a
jnp scan and the rest to its Pallas kernel; both compute the same
recurrence. The port runs every S >= 1 through the ``ssm_scan`` op (the CUDA
kernel on a CUDA tensor, the plain version on a CPU tensor); ``plain=True``
calls the plain version (``ssm_scan_ref``, the reference's ``_scan_ssm``)
on any device, the yardstick the kernel path is held against on the card.

Leaf dtypes follow the reference: ``A_log``, ``D``, ``dt_bias`` and the
three inner norm scales are f32 in every model, the rest in the model dtype;
the ``ssm`` state is f32, the ``conv`` state in the model dtype.
``mamba_train`` differentiates through the scan op's ``autograd.Function``
(B4 with its checkpoints forward, B6 backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import is_dtensor, logical, logical_placements
from repro_torch.parallel.local import dense, local_call, partial_where_split


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, di, n, r, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank,
                      cfg.ssm_conv_width)
    f32 = torch.float32
    # S4D-real A init: A[c, j] = -(j + 1)
    a = torch.arange(1, n + 1, dtype=f32, device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype, device),
        "conv_w": dense_init(gen, (w, di), dtype, device, in_axis=0),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": dense_init(gen, (di, r + 2 * n), dtype, device),
        "dt_proj": dense_init(gen, (r, di), dtype, device),
        "dt_bias": torch.zeros(di, dtype=f32, device=device),
        "A_log": torch.log(a),
        "D": torch.ones(di, dtype=f32, device=device),
        "out_proj": dense_init(gen, (di, d), dtype, device),
        "dt_norm": torch.ones(r, dtype=f32, device=device),
        "b_norm": torch.ones(n, dtype=f32, device=device),
        "c_norm": torch.ones(n, dtype=f32, device=device),
    }


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,di), w: (W,di). state: (B,W-1,di) or
    None. Returns (y, new_state) where new_state holds the trailing W-1
    inputs. The sum of W shifted products fixes the reference's summation
    order (no library convolution)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+W-1, di)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    # a copy, so a prefill's cache does not hold the whole padded input
    return y, xp[:, xp.shape[1] - (W - 1):].clone()


def _ssm_params(p, xc, cfg: ModelConfig):
    """From conv output xc (B,S,di) derive (dt (B,S,di), Bc, Cc (B,S,n)), all
    f32 (``_rms`` returns f32); the dt projection runs in f32."""
    n, r = cfg.ssm_state_dim, cfg.dt_rank
    dbc = dense(xc, p["x_proj"])
    dt_r, Bc, Cc = torch.split(dbc, [r, n, n], dim=-1)
    dt_r = _rms(dt_r, p["dt_norm"])
    Bc = _rms(Bc, p["b_norm"])
    Cc = _rms(Cc, p["c_norm"])
    dt = F.softplus(dense(dt_r, p["dt_proj"].float()) + p["dt_bias"])
    return dt, Bc, Cc


def _mix(p, x, cfg: ModelConfig, conv_state, h0, *, state_out=None,
         plain: bool = False):
    """Shared forward core. Returns (y, conv_state', hT); ``state_out``
    receives hT (it may be ``h0``)."""
    di = cfg.d_inner
    xz = logical(dense(x, p["in_proj"]), "batch", "act_seq", "ssm_inner2")
    xin, z = xz[..., :di], xz[..., di:]
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt, Bc, Cc = _ssm_params(p, xc, cfg)
    A = -torch.exp(p["A_log"])
    scan = ssm_scan_ref if plain else ssm_scan
    if is_dtensor(xc):
        y, hT = _mesh_scan(scan, xc.float(), dt, A, Bc, Cc, p["D"], h0)
        if state_out is not None:
            state_out.copy_(hT)
    else:
        y, hT = scan(xc.float(), dt, A, Bc, Cc, p["D"], h0, state_out=state_out)
    y = logical((y * F.silu(z.float())).to(x.dtype), "batch", "act_seq", "ssm_inner")
    return logical(dense(y, p["out_proj"]), "batch", "act_seq", None), conv_state, hT


def _mesh_scan(scan, x, dt, A, Bc, Cc, D, h0):
    """The selective scan on local shards: each rank scans its rows and its
    ``ssm_inner`` channels over the whole sequence (the recurrence is
    elementwise in the channels)."""
    xpl = logical_placements(x, "batch", None, "ssm_inner")
    apl = logical_placements(A, "ssm_inner", None)
    bpl = logical_placements(Bc, "batch", None, None)
    dpl = logical_placements(D, "ssm_inner")
    hpl = logical_placements(h0, "batch", "ssm_inner", None)
    ins = (xpl, xpl, apl, bpl, bpl, dpl, hpl)
    grads = tuple(partial_where_split(pl, ins) for pl in ins)
    return local_call(lambda *a: scan(*a), (x, dt, A, Bc, Cc, D, h0), ins,
                      (xpl, hpl), x.device_mesh, grad_placements=grads)


def mamba_train(p, x, cfg: ModelConfig, *, plain: bool = False):
    """The training forward of one layer from a zero state, no cache.
    Returns y; the scan op's backward is B6 on the card (the plain
    version's, differentiated by autograd, under ``plain``)."""
    B = x.shape[0]
    h0 = torch.zeros((B, cfg.d_inner, cfg.ssm_state_dim), dtype=torch.float32,
                     device=x.device)
    y, _, _ = _mix(p, x, cfg, None, h0, plain=plain)
    return y


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_prefill(p, x, cfg: ModelConfig, *, plain: bool = False):
    B = x.shape[0]
    h0 = torch.zeros((B, cfg.d_inner, cfg.ssm_state_dim), dtype=torch.float32,
                     device=x.device)
    y, conv_state, hT = _mix(p, x, cfg, None, h0, plain=plain)
    return y, {"conv": conv_state, "ssm": hT}


def mamba_decode(p, x, cache, cfg: ModelConfig, *, plain: bool = False):
    """x: (B,1,d). Updates ``cache`` ({"conv", "ssm"}) in place, the ssm
    state through the scan's ``state_out``. Returns (y, cache)."""
    y, conv_state, _ = _mix(p, x, cfg, cache["conv"], cache["ssm"],
                            state_out=cache["ssm"], plain=plain)
    cache["conv"].copy_(conv_state)
    return y, cache
