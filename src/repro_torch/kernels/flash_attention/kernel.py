"""Launch wrapper of the CUDA flash-attention forward
(``src/repro_torch/csrc/flash_attention.cu``), the port of the Pallas kernel
``repro.kernels.flash_attention.kernel.flash_attention_fwd``.

The kernel reads q/k/v through their strides (unit last stride), so the model
passes transposed views of its (B, S, heads, hd) projections without a copy,
and writes the output into a (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer,
which the model reshapes back for free. The bf16 kernel loads its tiles with
TMA through tensor maps built from those strides: a view must then start on
16 bytes and step by whole 16 bytes in every dimension but the last (TMA's
rules), or the wrapper raises.

With ``stats=True`` the kernel also writes each row's softmax statistics
(m, l) as (B, H, Sq) f32, the residuals of the chunked recompute backward
under ``cfg.flash_vjp``; such a launch counts as ``flash_attention_stats``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import _build

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in flash_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
        ("q_sb", _I64), ("q_sh", _I64), ("q_ss", _I64),
        ("k_sb", _I64), ("k_sh", _I64), ("k_ss", _I64),
        ("v_sb", _I64), ("v_sh", _I64), ("v_ss", _I64),
        ("o_sb", _I64), ("o_sh", _I64), ("o_ss", _I64),
        ("B", _I32), ("H", _I32), ("KV", _I32), ("Sq", _I32), ("Sk", _I32),
        ("hd", _I32),
        ("causal", _I32), ("window", _I32), ("prefix_len", _I32),
        ("q_offset", _I32),
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float),
        ("dtype", _I32),
        ("m", ctypes.c_void_p), ("l", ctypes.c_void_p),
    ]


def _entry():
    lib = _build.lib("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _tma_strides(t, name):
    """``t``'s (batch, head, seq) element strides for a TMA tensor map,
    raising on a view that breaks TMA's rules (16-byte base, strides of
    whole 16 bytes). A dimension of size 1 is never stepped over, so its
    stride is replaced by a legal one."""
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or t.stride(-1) != 1:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base and a unit "
                         f"last stride (base {t.data_ptr() % 16} bytes off, "
                         f"strides {t.stride()})")
    out = []
    for n, st in zip(t.shape[:3], t.stride()[:3]):
        if n == 1:
            st = vec
        elif st % vec:
            raise ValueError(f"{name}: TMA needs strides of whole 16 bytes; "
                             f"strides {t.stride()} of {t.dtype}")
        out.append(st)
    return out


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0,
                        prefix_len=0, q_offset=0, stats=False):
    """q: (B,H,Sq,hd); k,v: (B,KV,Sk,hd) CUDA tensors of one dtype (f32 or
    bf16), any strides with a unit last stride. Returns (B,H,Sq,hd), or
    with ``stats`` (out, m, l): each row's largest logit after softcap and
    mask, and sum exp(s - m) floored at 1e-37, (B,H,Sq) f32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}; need one "
                        f"of float32/bfloat16")
    if hd not in _build.HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_build.HEAD_DIMS}")
    if k.shape != (B, KV, Sk, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if q.dtype == torch.bfloat16:
        strides = [_tma_strides(t, name) for t, name in ((q, "q"), (k, "k"), (v, "v"))]
    else:
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            _build.check_rows(t, name)
        strides = [t.stride()[:3] for t in (q, k, v)]
    _build.check_rows(out, "out")
    m = l = None
    if stats:
        m, l = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
                for _ in range(2))
    prm = FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *strides[0], *strides[1], *strides[2], *out.stride()[:3],
        B, H, KV, Sq, Sk, hd,
        int(bool(causal)), int(window or 0), int(prefix_len or 0),
        int(q_offset), hd**-0.5, float(softcap or 0.0),
        _build.dtype_code(q), m.data_ptr() if stats else None,
        l.data_ptr() if stats else None)
    lib, fn = _entry()
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(q.device)),
                 "flash_attention_fwd")
    if stats:
        LAUNCHES["flash_attention_stats"] += 1
        return out, m, l
    LAUNCHES["flash_attention"] += 1
    return out
