"""Shared layer primitives: norms, activations, RoPE, masks.

Twin of ``repro.models.common``. Everything is a plain function over a params
dict of tensors; each computes in the same precision as the reference
(norms and RoPE in f32, then cast back to the input dtype).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

NEG_INF = -2.3819763e38  # ~ finfo(f32).min/1.5; finite, safe under +/- arithmetic


# ---------------------------------------------------------------------------
# init helpers (the port's own seeded init; parity runs convert the
# reference's weights instead, see repro_torch.convert)


def dense_init(gen: torch.Generator, shape, dtype, device, in_axis: int = 0):
    """Scaled normal init: std = 1/sqrt(fan_in), drawn on ``device``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * shape[in_axis] ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * shape[-1] ** -0.5).to(dtype)


def init_norm(cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    fill = 0.0 if cfg.norm_plus_one else 1.0
    p = {"scale": torch.full((d,), fill, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# norms


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm (optionally gemma (1+w)) or LayerNorm, computed in f32 with the
    population variance."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        scale = p["scale"].float()
        if cfg.norm_plus_one:
            scale = 1.0 + scale
        y = y * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name in ("swiglu",):
        return F.silu
    if name in ("geglu", "gelu"):
        return _gelu_tanh
    raise ValueError(name)


def softcap(x, cap: float):
    """Gemma2-style logit soft-capping: cap * tanh(x / cap), in f32."""
    if cap and cap > 0.0:
        return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# positional encodings


def apply_rope(x, positions, theta: float):
    """NeoX split-half RoPE. x: (..., S, H, hd); positions: broadcastable
    (..., S). Frequencies and rotation in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int):
    """Classic transformer sinusoidal embedding. positions: (..., S) ->
    (..., S, d), f32. A copy of the reference's, which no layer applies:
    a config with ``pos_type="sinusoidal"`` (musicgen) runs with no
    position term in both packages (ROADMAP Queue C)."""
    half = d_model // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=positions.device)
    angles = positions.float()[..., None] * freqs  # (..., S, half)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# attention masks (position-based so they work for prefill and cached paths)


def allow_mask(q_pos, k_pos, *, window: int = 0, prefix_len: int = 0):
    """Boolean attention permission from absolute positions.

    q_pos: (..., Sq), k_pos: (..., Sk). Negative k_pos marks invalid cache
    slots. Rules: causal; optional sliding window (relative distance <
    window); optional bidirectional prefix (any query may see k_pos <
    prefix_len).
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = k <= q
    if window and window > 0:
        ok = ok & ((q - k) < window)
    if prefix_len and prefix_len > 0:
        ok = ok | (k < prefix_len)
    return ok & (k >= 0)


def mask_bias(ok):
    """Additive f32 bias from a boolean mask: 0 where allowed, NEG_INF else."""
    return torch.where(ok, 0.0, NEG_INF).float()
