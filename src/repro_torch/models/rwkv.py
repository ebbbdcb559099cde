"""RWKV-6 ("Finch") block: data-dependent-decay linear attention, attn-free
(twin of ``repro.models.rwkv``).

Time-mix (per head of size hd, state S in R^{hd x hd}):
    y_t = r_t . (S_{t-1} + (u k_t^T) v_t)        (read with bonus u)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (data-dependent decay w_t)
with w_t = exp(-exp(w0 + tanh(mix_w @ W1) @ W2)) per channel. Token-shift
mixes x_{t-1} into the five projections with LoRA-modulated coefficients.

Channel-mix: token-shifted squared-ReLU MLP with receptance gate.

The reference sends S=1 and any S that does not tile its TPU chunk to a jnp
scan and the rest to its Pallas kernel; both compute the same recurrence.
The port runs every S >= 1 through the ``rwkv6_scan`` op (the CUDA kernel
on a CUDA tensor, the plain version on a CPU tensor); ``plain=True`` calls
the plain version on any device, the yardstick the kernel path is held
against on the card.

Leaf dtypes follow the reference: ``decay_base``, ``bonus`` and ``ln_x``
are f32 in every model, the rest in the model dtype; the ``wkv`` state is
f32, the shift states in the model dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import is_dtensor, logical, logical_placements, split_last
from repro_torch.parallel.local import local_call, partial_where_split

_TM_LORA = 32  # token-mix lora rank (the reference ignores cfg.rwkv_lora_dim)
_DECAY_LORA = 64


def init_rwkv_tm(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    f32 = torch.float32
    return {
        "maa_x": torch.zeros(d, dtype=dtype, device=device),
        "maa_rkvwg": torch.zeros((5, d), dtype=dtype, device=device),
        "tm_w1": dense_init(gen, (d, 5 * _TM_LORA), dtype, device),
        "tm_w2": dense_init(gen, (5, _TM_LORA, d), dtype, device, in_axis=1),
        "decay_base": torch.full((d,), -6.0, dtype=f32, device=device),
        "decay_w1": dense_init(gen, (d, _DECAY_LORA), dtype, device),
        "decay_w2": dense_init(gen, (_DECAY_LORA, d), dtype, device),
        "bonus": dense_init(gen, (H, hd), f32, device, in_axis=1),
        "wr": dense_init(gen, (d, d), dtype, device),
        "wk": dense_init(gen, (d, d), dtype, device),
        "wv": dense_init(gen, (d, d), dtype, device),
        "wg": dense_init(gen, (d, d), dtype, device),
        "wo": dense_init(gen, (d, d), dtype, device),
        "ln_x": torch.ones(d, dtype=f32, device=device),
    }


def init_rwkv_cm(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "maa_k": torch.zeros(d, dtype=dtype, device=device),
        "maa_r": torch.zeros(d, dtype=dtype, device=device),
        "wk": dense_init(gen, (d, ff), dtype, device),
        "wv": dense_init(gen, (ff, d), dtype, device),
        "wr": dense_init(gen, (d, d), dtype, device),
    }


def _shift(x, state):
    """Shift the sequence right by one; ``state`` (B,d) fills position 0.

    Returns (shifted, new_state = a copy of the last token)."""
    if state is None:
        state = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    shifted = torch.cat([state[:, None, :], x[:, :-1, :]], dim=1)
    return shifted, x[:, -1, :].clone()


def _group_norm(x, scale, H, eps=1e-5):
    """Per-head layernorm over head_dim (population variance). x: (B,S,d)."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    y = (xh - mean) * torch.rsqrt(var + eps)
    return (y.reshape(B, S, d) * scale).to(x.dtype)


def _tm_projections(p, x, shifted):
    """Data-dependent token-shift mixing -> r,k,v,w,g inputs, (5,B,S,d)."""
    xx = shifted - x
    xxx = x + xx * p["maa_x"]
    sx = torch.tanh(xxx @ p["tm_w1"])
    B, S = x.shape[:2]
    sx = split_last(sx, (5, _TM_LORA), "batch", "act_seq", None, None)
    sx = sx.permute(2, 0, 1, 3)  # (5,B,S,lora)
    offs = torch.einsum("nbsl,nld->nbsd", sx, p["tm_w2"])
    return x[None] + xx[None] * (p["maa_rkvwg"][:, None, None, :] + offs)


def rwkv_time_mix(p, x, cfg: ModelConfig, shift_state=None, wkv_state=None, *,
                  state_out=None, plain: bool = False):
    """Returns (y, shift_state', wkv_state'). ``state_out`` receives the new
    wkv state (it may be ``wkv_state``: a decode step then updates its cache
    in place)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    shifted, new_shift = _shift(x, shift_state)
    mr, mk, mv, mw, mg = logical(_tm_projections(p, x, shifted), None, "batch", "act_seq")

    # (B,S,H,hd) projections, passed to the scan as (B,H,S,hd) views
    r = split_last(mr @ p["wr"], (H, hd), "batch", "act_seq", "heads", None).transpose(1, 2)
    k = split_last(mk @ p["wk"], (H, hd), "batch", "act_seq", "heads", None).transpose(1, 2)
    v = split_last(mv @ p["wv"], (H, hd), "batch", "act_seq", "heads", None).transpose(1, 2)
    g = F.silu(mg @ p["wg"])
    decay = p["decay_base"] + torch.tanh(mw @ p["decay_w1"]).float() @ p[
        "decay_w2"].float()
    w = split_last(torch.exp(-torch.exp(decay.float())), (H, hd), "batch", "act_seq",
                   "heads", None).transpose(1, 2)

    if wkv_state is None:
        wkv_state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=x.device)
    scan = rwkv6_scan_ref if plain else rwkv6_scan
    if is_dtensor(r):
        y, sT = _mesh_scan(scan, r, k, v, w, p["bonus"].float(), wkv_state)
        if state_out is not None:
            state_out.copy_(sT)
    else:
        y, sT = scan(r, k, v, w, p["bonus"].float(), wkv_state, state_out=state_out)
    y = y.transpose(1, 2).reshape(B, S, d)
    y = _group_norm(y.to(x.dtype), p["ln_x"], H)
    y = (y * g).to(x.dtype)
    return logical(y @ p["wo"], "batch", "act_seq", None), new_shift, sT


def _mesh_scan(scan, r, k, v, w, u, s0):
    """The WKV scan on local shards: each rank scans its rows (and its
    heads, where the layout shards them) over the whole sequence."""
    rpl = logical_placements(r, "batch", "heads", None, None)
    upl = logical_placements(u, "heads", None)
    spl = logical_placements(s0, "batch", "heads", None, None)
    ins = (rpl, rpl, rpl, rpl, upl, spl)
    grads = tuple(partial_where_split(pl, ins) for pl in ins)
    return local_call(lambda *a: scan(*a), (r, k, v, w, u, s0), ins, (rpl, spl),
                      r.device_mesh, grad_placements=grads)


def rwkv_channel_mix(p, x, cfg: ModelConfig, shift_state=None):
    """Returns (y, shift_state')."""
    shifted, new_shift = _shift(x, shift_state)
    xx = shifted - x
    xk = x + xx * p["maa_k"]
    xr = x + xx * p["maa_r"]
    h = logical(torch.square(torch.relu(xk @ p["wk"])), "batch", "act_seq_mlp", "act_ff")
    y = torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"])
    return logical(y, "batch", "act_seq", None), new_shift


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device):
    d = cfg.d_model
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }
