"""Public decode-attention ops (inference only): the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU tensor."""

from __future__ import annotations

from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_fwd, paged_decode_attention_fwd)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)


def decode_attention(q, k, v, bias, *, softcap=0.0, stats=False):
    """q: (B,H,hd); k,v: (B,KV,L,hd); bias: (L,) shared or (B,L) per
    sequence, f32 additive. Returns (B,H,hd); with ``stats`` (o in f32, m,
    l), each row's softmax statistics (B,H) f32 beside it."""
    refuse_dtensor("decode_attention", q, k, v, bias)
    if q.is_cuda:
        return decode_attention_fwd(q, k, v, bias, softcap=softcap, stats=stats)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, bias, softcap=softcap, stats=stats)
    raise ValueError(f"decode_attention: unsupported device {q.device}")


def paged_decode_attention(q, k_pages, v_pages, page_table, bias, *,
                           k_scale=None, v_scale=None, softcap=0.0):
    """Decode attention against a paged KV pool; the gather through
    ``page_table`` happens inside the kernel.

    q: (B,H,hd); k_pages/v_pages: (n_phys_blocks, block_size, KV, hd);
    page_table: (B,P) int32; bias: (B, P*block_size) f32 additive mask.
    k_scale/v_scale: (n_phys_blocks, block_size, KV, 1) f32 when the pools
    are int8. Returns (B,H,hd)."""
    refuse_dtensor("paged_decode_attention", q, k_pages, v_pages, page_table, bias)
    kw = dict(k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    if q.is_cuda:
        return paged_decode_attention_fwd(q, k_pages, v_pages, page_table,
                                          bias, **kw)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          bias, **kw)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
