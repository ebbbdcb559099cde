"""Public decode-attention ops (inference only): the CUDA kernel for a CUDA
tensor, the plain PyTorch version for a CPU or ``meta`` tensor.

``decode_attention_cost`` and ``paged_decode_attention_cost`` are B3's and
B1's work (``parallel.cost``): 4 operations a head and head element for
each key position read, those positions' K and V rows, and q, the bias, any
page table and the outputs each moved once. The op counts every position
of the cache (its shapes); a bound over the keys a bias leaves visible
passes ``visible``.
"""

from __future__ import annotations

from repro_torch.kernels import refuse_dtensor
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_fwd, paged_decode_attention_fwd)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.parallel.cost import Cost, acc_dtype, kernel_op, nbytes, tensor_bytes


def decode_attention_cost(q, k, v, bias, *, stats=False, visible=None, **_):
    """B3's work over ``visible`` key positions (summed over the rows;
    every position of the cache by default): flops and bytes."""
    B, H, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    visible = B * L if visible is None else visible
    if stats:
        out = nbytes((B, H, hd), acc_dtype(q)) + 2 * nbytes((B, H), acc_dtype(q))
    else:
        out = nbytes(q.shape, q.dtype)
    kv = 2 * visible * KV * hd * k.element_size()
    return Cost(4.0 * H * hd * visible, tensor_bytes(q, bias) + out + kv)


def paged_decode_attention_cost(q, k_pages, v_pages, page_table, bias, *,
                                k_scale=None, v_scale=None, visible=None, **_):
    """B1's work over ``visible`` key positions (every position the page
    table names by default): flops and bytes; an int8 pool's rows carry one
    f32 scale a kv head."""
    B, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    visible = B * page_table.shape[1] * bs if visible is None else visible
    row = KV * hd * k_pages.element_size() + (KV * k_scale.element_size()
                                              if k_scale is not None else 0)
    return Cost(4.0 * H * hd * visible,
                tensor_bytes(q, page_table, bias) + nbytes(q.shape, q.dtype)
                + 2 * visible * row)


def decode_attention(q, k, v, bias, *, softcap=0.0, stats=False):
    """q: (B,H,hd); k,v: (B,KV,L,hd); bias: (L,) shared or (B,L) per
    sequence, f32 additive. Returns (B,H,hd); with ``stats`` (o in f32, m,
    l), each row's softmax statistics (B,H) f32 beside it."""
    refuse_dtensor("decode_attention", q, k, v, bias)
    if q.is_cuda:
        fwd = decode_attention_fwd
    elif q.device.type in ("cpu", "meta"):
        fwd = decode_attention_ref
    else:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    name = "decode_attention_stats" if stats else "decode_attention"
    with kernel_op(name, decode_attention_cost, q, k, v, bias, stats=stats):
        return fwd(q, k, v, bias, softcap=softcap, stats=stats)


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
        fwd = paged_decode_attention_fwd
    elif q.device.type in ("cpu", "meta"):
        fwd = paged_decode_attention_ref
    else:
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    with kernel_op("paged_decode_attention", paged_decode_attention_cost, q, k_pages,
                   v_pages, page_table, bias, **kw):
        return fwd(q, k_pages, v_pages, page_table, bias, **kw)
