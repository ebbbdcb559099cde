"""Plain PyTorch versions of single-token decode attention (twins of the
reference's ``repro.kernels.decode_attention.ref``).

q: (B, H, hd) — one new token per sequence.
k, v: (B, KV, L, hd) — dense cache (RoPE'd keys at absolute slots).
bias: additive f32 mask (0 = attend, NEG_INF = blocked), (L,) shared by the
batch as in the reference, or (B, L) per sequence.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import PLAIN_CALLS


def _bias_rows(bias):
    return bias[None, None, None, :] if bias.dim() == 1 else bias[:, None, None, :]


def decode_attention_ref(q, k, v, bias, *, softcap=0.0, stats=False):
    """Returns (B,H,hd) in q's dtype; with ``stats`` (o, m, l): o in f32
    (rounded to q's dtype, the o without statistics), m the row max of the
    scores after softcap and bias, l = sum exp(s - m), both (B,H) f32."""
    PLAIN_CALLS["decode_attention_stats" if stats else "decode_attention"] += 1
    B, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bklh->bkgl", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + _bias_rows(bias)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,bklh->bkgh", p.to(v.dtype).float(), v.float())
    o = o.reshape(B, H, hd)
    if not stats:
        return o.to(q.dtype)
    m = s.amax(-1, keepdim=True)
    return o, m.reshape(B, H), torch.exp(s - m).sum(-1).reshape(B, H)


def merge_stats(o, m, l):
    """Merge the (o, m, l) of shards of one cache, stacked on a leading
    shard axis, as the mesh decode merges its ranks' (an all-reduce max of
    m, then an all-reduce sum of o*l*e^(m-M) and l*e^(m-M)): a shard whose
    every key is masked has m near NEG_INF and weight 0 unless every shard
    is masked, and then the merge averages V as the unsplit row does.
    o: (n,B,H,hd) f32; m, l: (n,B,H). Returns (B,H,hd) f32."""
    w = l * torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / w.sum(0).clamp_min(1e-37)[..., None]


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, bias, *,
                               k_scale=None, v_scale=None, softcap=0.0):
    """Gather each sequence's cache through the page table, dequantize int8
    pools, then the same masked softmax attention as
    ``decode_attention_ref`` with a per-sequence bias.

    q: (B,H,hd); k_pages/v_pages: (n_phys, bs, KV, hd); page_table: (B,P)
    int32; bias: (B, P*bs) f32; k_scale/v_scale: (n_phys, bs, KV, 1) f32.
    """
    PLAIN_CALLS["paged_decode_attention"] += 1
    B, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    P = page_table.shape[1]
    L = P * bs
    idx = page_table.long()
    k = k_pages[idx]  # (B, P, bs, KV, hd)
    v = v_pages[idx]
    if k_scale is not None:
        k = k.float() * k_scale[idx]
        v = v.float() * v_scale[idx]
    k = k.reshape(B, L, KV, hd)
    v = v.reshape(B, L, KV, hd)
    G = H // KV
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,blkh->bkgl", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def split_partials(q, k, v, bias, n_split, split_len, *, softcap=0.0):
    """Per-split softmax partials of ``decode_attention_ref``'s inputs, as
    the split pass of the CUDA routine keeps them: for each split of
    ``split_len`` keys, the f32 running max ``m``, the sum of exponentials
    ``l`` and the unnormalised ``acc`` of probabilities (rounded to V's
    dtype) times V. Returns m, l (B, H, n_split) and acc (B, H, n_split, hd).
    Used by the tests to check the combine."""
    B, H, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bkgh,bklh->bkgl", q.reshape(B, KV, G, hd).float(),
                     k.float()) * hd**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = (s + _bias_rows(bias)).reshape(B, H, L)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        part = s[..., i * split_len:(i + 1) * split_len]
        m = part.amax(-1)
        p = torch.exp(part - m[..., None])
        vi = v[:, :, i * split_len:(i + 1) * split_len].float()
        acc = torch.einsum("bkgl,bklh->bkgh",
                           p.to(v.dtype).float().reshape(B, KV, G, -1), vi)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(acc.reshape(B, H, hd))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


def combine(m, l, acc):
    """Merge per-split partials as the combine kernel does, in split order:
    weights exp(m_i - max m), the denominator floored at 1e-37.
    m, l: (B, H, n_split); acc: (B, H, n_split, hd). Returns (B, H, hd) f32."""
    top = m.amax(-1, keepdim=True)
    o = torch.zeros(acc.shape[:2] + acc.shape[3:], dtype=torch.float32)
    den = torch.zeros(m.shape[:2], dtype=torch.float32)
    for i in range(m.shape[-1]):
        w = torch.exp(m[..., i] - top[..., 0])
        o = o + acc[:, :, i] * w[..., None]
        den = den + l[..., i] * w
    return o / den.clamp_min(1e-37)[..., None]
