"""Plain PyTorch version of flash attention (twin of the reference's
``repro.kernels.flash_attention.ref.attention_ref``).

Semantics: GQA causal attention with optional sliding window, gemma2-style
logit soft-capping, prefix-LM bidirectional prefix and a query offset.
Layout: q (B, H, Sq, hd); k, v (B, KV, Sk, hd); H % KV == 0. Scores and the
PV product are accumulated in f32; probabilities are cast to V's dtype
before the PV product, as in the reference.

``chunked_attention_ref`` is the same function computed as the reference's
doubly chunked online softmax (``repro.models.attention._chunked_attention``
with ``with_stats=True``), which also returns each row's statistics (m, l):
the plain version of B2 launched with ``stats=True``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS

NEG_INF = -2.3819763e38  # the model's finite mask value (models.common.NEG_INF)


def allowed(Sq, Sk, device, *, causal=True, window=0, prefix_len=0, q_offset=0):
    """(Sq, Sk) bool: which keys each query sees."""
    return block_mask(slice(0, Sq), slice(0, Sk), device, causal=causal, window=window,
                      prefix_len=prefix_len, q_offset=q_offset)


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


def block_visible(q_lo, q_hi, k_lo, k_hi, *, causal=True, window=0, prefix_len=0):
    """Whether any query in [q_lo, q_hi] sees any key in [k_lo, k_hi] (the
    kernel's tile test). A block that fails it adds exactly nothing to a
    row that sees a key elsewhere, so the chunked loops skip it."""
    visible = not causal or q_hi >= k_lo
    if window and window > 0:
        visible = visible and q_lo - k_hi < window
    if prefix_len and prefix_len > 0:
        visible = visible or k_lo < prefix_len
    return visible


def block_mask(qs, ks, device, *, causal=True, window=0, prefix_len=0, q_offset=0):
    """``allowed`` restricted to the queries ``qs`` and keys ``ks`` (slices)."""
    q_pos = torch.arange(qs.start, qs.stop, device=device) + q_offset
    k_pos = torch.arange(ks.start, ks.stop, device=device)
    ok = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool, device=device)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        ok = ok & ((q_pos[:, None] - k_pos[None, :]) < window)
    if prefix_len and prefix_len > 0:
        ok = ok | (k_pos[None, :] < prefix_len)
    return ok


def chunk_pairs(Sq, Sk, chunk_q, chunk_k, *, causal=True, window=0, prefix_len=0,
                q_offset=0):
    """The visible (q slice, k slice) block pairs, k chunks outer, q chunks
    inner (the reference's backward order); the last chunk of each axis may
    be short."""
    out = []
    for k0 in range(0, Sk, chunk_k):
        k1 = min(k0 + chunk_k, Sk)
        for q0 in range(0, Sq, chunk_q):
            q1 = min(q0 + chunk_q, Sq)
            if block_visible(q0 + q_offset, q1 - 1 + q_offset, k0, k1 - 1, causal=causal,
                             window=window, prefix_len=prefix_len):
                out.append((slice(q0, q1), slice(k0, k1)))
    return out


def chunked_attention_ref(q, k, v, *, chunk_q, chunk_k, causal=True, window=0,
                          softcap=0.0, prefix_len=0, q_offset=0):
    """Returns (out (B,H,Sq,hd), m (B,H,Sq), l (B,H,Sq)): the online softmax
    over k chunks of ``chunk_k`` for each q chunk of ``chunk_q``, in f32 (f64
    for f64 inputs); m is a row's largest logit after softcap and mask, l =
    sum exp(s - m) floored at 1e-37; probabilities are cast to V's dtype
    before the PV product."""
    PLAIN_CALLS["flash_attention_stats"] += 1
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    acc_dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, Sq, hd)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=acc_dt, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=acc_dt, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=acc_dt, device=q.device)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    # q chunks outer, k chunks inner, as the reference's forward scans
    for qs, ks in sorted(chunk_pairs(Sq, Sk, chunk_q, chunk_k, q_offset=q_offset, **kw),
                         key=lambda pair: pair[0].start):
        s = torch.einsum("bkgqh,bksh->bkgqs", qg[..., qs, :].to(acc_dt),
                         k[:, :, ks].to(acc_dt)) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = s.masked_fill(~block_mask(qs, ks, q.device, q_offset=q_offset, **kw), NEG_INF)
        m_i, l_i, a_i = m[..., qs], l[..., qs], acc[..., qs, :]
        m_new = torch.maximum(m_i, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_i - m_new)
        l[..., qs] = l_i * alpha + p.sum(-1)
        pv = torch.einsum("bkgqs,bksh->bkgqh", p.to(v.dtype).to(acc_dt),
                          v[:, :, ks].to(acc_dt))
        acc[..., qs, :] = a_i * alpha[..., None] + pv
        m[..., qs] = m_new
    l = torch.clamp(l, min=1e-37)
    out = (acc / l[..., None]).to(v.dtype).reshape(B, H, Sq, hd)
    return out, m.reshape(B, H, Sq), l.reshape(B, H, Sq)
