"""Launch wrapper of the CUDA RWKV-6 WKV scan
(``src/repro_torch/csrc/rwkv6_scan.cu``), the port of the Pallas kernel
``repro.kernels.rwkv6_scan.kernel.rwkv6_scan_fwd``.

The kernel reads r/k/v/w through their strides (unit last stride), so the
model passes transposed views of its (B, S, H, hd) projections without a
copy, and writes y into a (B, H, S, hd) view of a (B, S, H, hd) buffer,
which the model reshapes back for free. ``state_out`` may be ``s0`` itself:
the final state then overwrites the initial one in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import _build

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_P = ctypes.c_void_p

HEAD_DIMS = (32, 64)  # the kernel is instantiated for these


class Rwkv6Params(ctypes.Structure):
    """Mirror of ``struct Rwkv6Params`` in rwkv6_scan.cu."""

    _fields_ = [
        ("r", _P), ("k", _P), ("v", _P), ("w", _P), ("u", _P), ("s0", _P),
        ("y", _P), ("sT", _P),
        ("r_sb", _I64), ("r_sh", _I64), ("r_ss", _I64),
        ("k_sb", _I64), ("k_sh", _I64), ("k_ss", _I64),
        ("v_sb", _I64), ("v_sh", _I64), ("v_ss", _I64),
        ("w_sb", _I64), ("w_sh", _I64), ("w_ss", _I64),
        ("y_sb", _I64), ("y_sh", _I64), ("y_ss", _I64),
        ("u_sh", _I64),
        ("B", _I32), ("H", _I32), ("S", _I32), ("hd", _I32),
        ("cols", _I32),
        ("dtype", _I32),
    ]


def _entry():
    lib = _build.lib("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = [ctypes.POINTER(Rwkv6Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def rwkv6_scan_fwd(r, k, v, w, u, s0, *, state_out=None, _cols=16):
    """r,k,v: (B,H,S,hd) CUDA tensors of one dtype (f32 or bf16); w: (B,H,S,hd)
    f32; u: (H,hd) f32; s0: (B,H,hd,hd) f32 contiguous. Any S >= 1; views
    with a unit last stride. ``state_out``: a contiguous (B,H,hd,hd) f32
    tensor for the final state (may be ``s0``); a new one by default.
    Returns (y (B,H,S,hd) f32, sT). ``_cols`` (value columns per CTA) is a
    test hook: the result must not depend on it."""
    B, H, S, hd = r.shape
    tensors = [r, k, v, w, u, s0] + ([] if state_out is None else [state_out])
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_scan_fwd takes CUDA tensors on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == r.dtype):
        raise TypeError(f"dtypes r={r.dtype} k={k.dtype} v={v.dtype}; need one "
                        f"of float32/bfloat16")
    if not (w.dtype == u.dtype == s0.dtype == torch.float32):
        raise TypeError(f"w/u/s0 dtypes {w.dtype}/{u.dtype}/{s0.dtype}; need float32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if S < 1 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"shapes r={tuple(r.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} w={tuple(w.shape)}")
    if u.shape != (H, hd) or u.stride(1) != 1:
        raise ValueError(f"u shape {tuple(u.shape)}; need ({H},{hd}), unit last stride")
    if s0.shape != (B, H, hd, hd) or not s0.is_contiguous():
        raise ValueError(f"s0 must be a contiguous ({B},{H},{hd},{hd}) tensor")
    if state_out is None:
        state_out = torch.empty_like(s0)
    elif (state_out.shape != s0.shape or state_out.dtype != torch.float32
          or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous f32 tensor shaped like s0")
    if _cols < 4 or _cols % 4 or hd % _cols:
        raise ValueError(f"_cols={_cols}: need a multiple of 4 dividing hd={hd}")
    y = torch.empty((B, S, H, hd), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        _build.check_rows(t, name)
    prm = Rwkv6Params(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *y.stride()[:3], u.stride(0),
        B, H, S, hd, _cols, _build.dtype_code(r))
    lib, fn = _entry()
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(r.device)),
                 "rwkv6_scan_fwd")
    LAUNCHES["rwkv6_scan"] += 1
    return y, state_out
