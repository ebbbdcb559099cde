"""Plain PyTorch version of flash attention (twin of the reference's
``repro.kernels.flash_attention.ref.attention_ref``).

Semantics: GQA causal attention with optional sliding window, gemma2-style
logit soft-capping, prefix-LM bidirectional prefix and a query offset.
Layout: q (B, H, Sq, hd); k, v (B, KV, Sk, hd); H % KV == 0. Scores and the
PV product are accumulated in f32; probabilities are cast to V's dtype
before the PV product, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS

NEG_INF = -2.3819763e38  # the model's finite mask value (models.common.NEG_INF)


def allowed(Sq, Sk, device, *, causal=True, window=0, prefix_len=0, q_offset=0):
    """(Sq, Sk) bool: which keys each query sees."""
    q_pos = torch.arange(Sq, device=device) + q_offset
    k_pos = torch.arange(Sk, device=device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    if prefix_len and prefix_len > 0:
        ok = ok | (k_pos[None, :] < prefix_len)
    return ok


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  prefix_len=0, q_offset=0):
    PLAIN_CALLS["flash_attention"] += 1
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, Sq, hd)
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    ok = allowed(Sq, Sk, q.device, causal=causal, window=window,
                 prefix_len=prefix_len, q_offset=q_offset)
    logits = logits.masked_fill(~ok, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
