"""Launch wrappers of the CUDA decode-attention routine
(``src/repro_torch/csrc/decode_attention.cu``), the port of the Pallas
kernels ``repro.kernels.decode_attention.kernel.decode_attention_fwd`` (dense
cache) and ``paged_decode_attention_fwd`` (block pool + page table).

Both wrappers fill one ``DecodeParams`` and launch the same device routine:
the dense layout is the paged one with the identity table, so the two give
bitwise-identical results on the same cache contents. The routine splits
each sequence's keys across CTAs and merges the per-split partials in a
second kernel; ``split_plan`` picks the split from the shapes and the SM
count alone, never from the layout.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, refuse_dtensor
from repro_torch.kernels import _build

SPLIT_ALIGN = 16  # keys a warp takes from each chunk (KW in the source)
CTAS_PER_SM = 2   # the split puts at least this many CTAs on every SM

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_P = ctypes.c_void_p


class DecodeParams(ctypes.Structure):
    """Mirror of ``struct DecodeParams`` in decode_attention.cu."""

    _fields_ = [
        ("q", _P), ("k", _P), ("v", _P), ("k_scale", _P), ("v_scale", _P),
        ("table", _P), ("bias", _P), ("o", _P),
        ("part", _P), ("part_m", _P), ("part_l", _P),
        ("q_sb", _I64), ("q_sh", _I64),
        ("o_sb", _I64), ("o_sh", _I64),
        ("k_sbase", _I64), ("k_stok", _I64), ("k_skv", _I64),
        ("v_sbase", _I64), ("v_stok", _I64), ("v_skv", _I64),
        ("s_sbase", _I64), ("s_stok", _I64), ("s_skv", _I64),
        ("bias_sb", _I64),
        ("table_sb", _I64),
        ("B", _I32), ("H", _I32), ("KV", _I32), ("L", _I32), ("hd", _I32),
        ("block_size", _I32),
        ("paged", _I32), ("n_split", _I32), ("split_len", _I32),
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float),
        ("q_dtype", _I32), ("kv_dtype", _I32),
    ]


def split_plan(B, KV, L, n_sm):
    """``(n_split, split_len)`` of a decode launch: enough splits of each
    (sequence, kv head) for ``CTAS_PER_SM`` CTAs on each of ``n_sm`` SMs,
    each a whole number of ``SPLIT_ALIGN`` keys, and every split holding at
    least one of the ``L`` keys. It reads no layout, so a paged call and a
    dense call of one shape split alike."""
    want = -(-CTAS_PER_SM * n_sm // (B * KV))
    split_len = max(SPLIT_ALIGN, L // want // SPLIT_ALIGN * SPLIT_ALIGN)
    return -(-L // split_len), split_len


def _entry():
    lib = _build.lib("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = [ctypes.POINTER(DecodeParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_common(q, k, v, bias, KV):
    B, H, hd = q.shape
    tensors = [q, k, v, bias]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode attention takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}; need float32 or bfloat16")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias dtype {bias.dtype}; need float32")
    if hd not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_build.HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {KV}")
    _build.check_rows(q, "q")
    _build.check_rows(k, "k")
    _build.check_rows(v, "v")


def plan(prm: DecodeParams, n_sm: int) -> int:
    """Fill ``prm``'s split from ``split_plan`` (shapes and SM count only)
    and return the number of partial rows, B * H * n_split."""
    prm.n_split, prm.split_len = split_plan(prm.B, prm.KV, prm.L, n_sm)
    return prm.B * prm.H * prm.n_split


def _launch(prm: DecodeParams, device, name: str):
    """Plan the split, give the routine its f32 partials, launch it (the
    split pass and the combine) and count one launch of ``name``."""
    rows = plan(prm, _build.sm_count(device))
    part = torch.empty(rows * (prm.hd + 2), dtype=torch.float32, device=device)
    prm.part, prm.part_m, prm.part_l = (
        part.data_ptr(), part.data_ptr() + 4 * rows * prm.hd,
        part.data_ptr() + 4 * rows * (prm.hd + 1))
    lib, fn = _entry()
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(device)), name)
    LAUNCHES[name] += 1


def dense_params(q, k, v, bias, softcap=0.0) -> DecodeParams:
    """The routine's parameters for a dense cache (the identity table)."""
    B, H, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    code = _build.dtype_code(q)
    return DecodeParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
        bias.data_ptr(), None, None, None, None,
        q.stride(0), q.stride(1), H * hd, hd,
        k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1),
        0, 0, 0,
        bias.stride(0) if bias.dim() == 2 else 0,
        0,
        B, H, KV, L, hd, 1, 0, 0, 0,
        hd**-0.5, float(softcap or 0.0), code, code)


def paged_params(q, k_pages, v_pages, page_table, bias, k_scale=None,
                 v_scale=None, softcap=0.0) -> DecodeParams:
    """The routine's parameters for a paged pool and its page table."""
    B, H, hd = q.shape
    _, bs, KV, _ = k_pages.shape
    L = page_table.shape[1] * bs
    scales, s_strides = (None, None), (0, 0, 0)
    if k_scale is not None:
        scales = (k_scale.data_ptr(), v_scale.data_ptr())
        s_strides = (k_scale.stride(0), k_scale.stride(1), k_scale.stride(2))
    return DecodeParams(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        page_table.data_ptr(), bias.data_ptr(), None, None, None, None,
        q.stride(0), q.stride(1), H * hd, hd,
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        *s_strides,
        bias.stride(0), page_table.stride(0),
        B, H, KV, L, hd, bs, 1, 0, 0,
        hd**-0.5, float(softcap or 0.0),
        _build.dtype_code(q), _build.dtype_code(k_pages))


def decode_attention_fwd(q, k, v, bias, *, softcap=0.0):
    """q: (B,H,hd); k,v: (B,KV,L,hd) of q's dtype, any strides with a unit
    last stride (the model passes a transposed view of its (B,L,KV,hd)
    cache); bias: (L,) or (B,L) f32. Returns (B,H,hd)."""
    refuse_dtensor("decode_attention_fwd", q, k, v, bias)
    B, H, hd = q.shape
    KV, L = k.shape[1], k.shape[2]
    _check_common(q, k, v, bias, KV)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dense cache dtype {k.dtype}/{v.dtype} != q {q.dtype}")
    if k.shape != (B, KV, L, hd) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} {tuple(v.shape)}")
    if bias.shape not in ((L,), (B, L)) or bias.stride(-1) != 1:
        raise ValueError(f"bias shape {tuple(bias.shape)}; need ({L},) or ({B},{L})")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    prm = dense_params(q, k, v, bias, softcap)
    prm.o = out.data_ptr()
    _launch(prm, q.device, "decode_attention")
    return out


def paged_decode_attention_fwd(q, k_pages, v_pages, page_table, bias, *,
                               k_scale=None, v_scale=None, softcap=0.0):
    """q: (B,H,hd); k_pages,v_pages: (n_phys,bs,KV,hd) of q's dtype or int8;
    page_table: (B,P) int32, entries valid block ids; bias: (B, P*bs) f32;
    k_scale/v_scale: (n_phys,bs,KV,1) f32 for int8 pools. Returns (B,H,hd)."""
    refuse_dtensor("paged_decode_attention_fwd", q, k_pages, v_pages, page_table, bias)
    B, H, hd = q.shape
    n_phys, bs, KV, _ = k_pages.shape
    P = page_table.shape[1]
    L = P * bs
    _check_common(q, k_pages, v_pages, bias, KV)
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    want = torch.int8 if quantized else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pool dtype {k_pages.dtype}/{v_pages.dtype}, want {want}")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    if (page_table.dtype != torch.int32 or page_table.shape != (B, P)
            or not page_table.is_cuda or page_table.stride(1) != 1):
        raise ValueError(f"page_table must be a ({B},{P}) int32 CUDA tensor "
                         f"with a unit last stride")
    if bias.shape != (B, L) or bias.stride(1) != 1:
        raise ValueError(f"bias shape {tuple(bias.shape)}; need ({B},{L})")
    if quantized:
        for sc in (k_scale, v_scale):
            if (sc.dtype != torch.float32 or sc.shape != (n_phys, bs, KV, 1)
                    or not sc.is_cuda or sc.stride() != k_scale.stride()):
                raise ValueError(f"scales must be ({n_phys},{bs},{KV},1) f32 "
                                 f"CUDA tensors with equal strides")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    prm = paged_params(q, k_pages, v_pages, page_table, bias, k_scale, v_scale,
                       softcap)
    prm.o = out.data_ptr()
    _launch(prm, q.device, "paged_decode_attention")
    return out
