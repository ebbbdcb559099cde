"""Public flash-attention op: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor, no fallback from one to the other.

Under autograd the op is a ``torch.autograd.Function``, the twin of the
reference's ``_flash`` custom VJP (``repro.kernels.flash_attention.ops``):
its forward is the kernel (B2) and saves only q, k and v; its backward
recomputes attention from them (``flash_attention_bwd``), so no O(S^2)
probabilities are kept between the passes. The reference has no backward
kernel: its backward is plain jnp that XLA compiles, and the port's is
plain PyTorch math, counted in ``BWD_CALLS`` and not as a plain call of
the forward.

``flash_attention_vjp`` is the twin of the reference's ``flash_vjp`` path
(``repro.models.attention._flash_jnp``): its forward is B2 launched with the
rows' softmax statistics (``chunked_attention_ref`` on a CPU tensor) and
saves q, k, v, the output and (m, l); its backward
(``flash_attention_bwd_chunked``, the twin of ``_flash_jnp_bwd``) loops
over k chunks and, inside, q chunks, recomputing one block's probabilities
at a time from (m, l), so no (Sq, Sk) tensor ever exists.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import BWD_CALLS
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import (NEG_INF, allowed, attention_ref,
                                                    block_mask, chunk_pairs,
                                                    chunked_attention_ref)


def flash_attention_bwd(q, k, v, do, *, causal=True, window=0, softcap=0.0,
                        prefix_len=0, q_offset=0):
    """dq, dk, dv of ``attention_ref`` at (q, k, v) for the output gradient
    ``do`` (B,H,Sq,hd), recomputed in f32 (f64 for f64 inputs) as
    ``jax.vjp`` of the reference's oracle computes them: the probabilities
    are rounded to V's dtype before the PV product, so their gradient is
    too; masked logits get none."""
    BWD_CALLS["flash_attention_bwd"] += 1
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, Sq, hd).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    dog = do.reshape(B, KV, G, Sq, hd).to(acc)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, kf) * scale
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
    ok = allowed(Sq, Sk, q.device, causal=causal, window=window,
                 prefix_len=prefix_len, q_offset=q_offset)
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
    del s
    dv = torch.einsum("bkgqs,bkgqh->bksh", p.to(v.dtype).to(acc), dog)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, vf).to(v.dtype).to(acc)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    ds = ds.masked_fill(~ok, 0.0)
    if softcap:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf).reshape(B, H, Sq, hd)
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kw):
        fwd = flash_attention_fwd if q.is_cuda else attention_ref
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return fwd(q, k, v, **kw)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, do, **ctx.kw), None)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    prefix_len=0, q_offset=0):
    """GQA flash attention. q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd)."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len, q_offset=q_offset)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, kw)
    fwd = flash_attention_fwd if q.is_cuda else attention_ref
    return fwd(q, k, v, **kw)


def flash_attention_bwd_chunked(q, k, v, out, m, l, do, *, chunk_q, chunk_k,
                                causal=True, window=0, softcap=0.0, prefix_len=0,
                                q_offset=0):
    """dq, dk, dv from the residuals of ``flash_attention_vjp``'s forward,
    as ``_flash_jnp_bwd`` computes them: D = rowsum(do * out), then per
    visible block p = exp(s - m) / l (f32, not rounded), ds = p (do v^T -
    D), times the softcap's Jacobian 1 - tanh^2, masked entries getting p
    = 0. k chunks outer, q chunks inner; dq accumulates over the k chunks.
    Blocks that no query of the q chunk sees are skipped (they add exactly
    zero)."""
    BWD_CALLS["flash_attention_bwd_chunked"] += 1
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = hd**-0.5
    qg = q.reshape(B, KV, G, Sq, hd)
    dog = do.reshape(B, KV, G, Sq, hd).to(acc)
    D = (dog * out.reshape(B, KV, G, Sq, hd).to(acc)).sum(-1)
    mg, lg = m.reshape(B, KV, G, Sq).to(acc), l.reshape(B, KV, G, Sq).to(acc)
    dq = torch.zeros((B, KV, G, Sq, hd), dtype=acc, device=q.device)
    dk = torch.zeros((B, KV, Sk, hd), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    for qs, ks in chunk_pairs(Sq, Sk, chunk_q, chunk_k, q_offset=q_offset, **kw):
        qi, doi = qg[..., qs, :].to(acc), dog[..., qs, :]
        kj, vj = k[:, :, ks].to(acc), v[:, :, ks].to(acc)
        s = torch.einsum("bkgqh,bksh->bkgqs", qi, kj) * scale
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        s = s.masked_fill(~block_mask(qs, ks, q.device, q_offset=q_offset, **kw), NEG_INF)
        p = torch.exp(s - mg[..., qs, None]) / lg[..., qs, None]
        del s
        ds = p * (torch.einsum("bkgqh,bksh->bkgqs", doi, vj) - D[..., qs, None])
        if softcap:
            ds = ds * (1.0 - t * t)
            del t
        dq[..., qs, :] += torch.einsum("bkgqs,bksh->bkgqh", ds, kj) * scale
        dk[:, :, ks] += torch.einsum("bkgqs,bkgqh->bksh", ds, qi) * scale
        dv[:, :, ks] += torch.einsum("bkgqs,bkgqh->bksh", p, doi)
        del p, ds
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kw, chunks):
        if q.is_cuda:
            out, m, l = flash_attention_fwd(q, k, v, **kw, stats=True)
        else:
            out, m, l = chunked_attention_ref(q, k, v, chunk_q=chunks[0],
                                              chunk_k=chunks[1], **kw)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.kw, ctx.chunks = kw, chunks
        return out

    @staticmethod
    def backward(ctx, do):
        cq, ck = ctx.chunks
        return (*flash_attention_bwd_chunked(*ctx.saved_tensors, do, chunk_q=cq,
                                             chunk_k=ck, **ctx.kw), None, None)


def flash_attention_vjp(q, k, v, *, chunk_q, chunk_k, causal=True, window=0,
                        softcap=0.0, prefix_len=0, q_offset=0):
    """Flash attention whose backward is the chunked recompute from the
    forward's statistics (``cfg.flash_vjp``); chunks of ``chunk_q`` queries
    and ``chunk_k`` keys. Layouts as ``flash_attention``."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len, q_offset=q_offset)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_vjp: unsupported device {q.device}")
    return _FlashVJP.apply(q, k, v, kw, (int(chunk_q), int(chunk_k)))
