"""Launch wrappers of the CUDA RWKV-6 WKV scan and its backward
(``src/repro_torch/csrc/rwkv6_scan.cu``), the ports of the Pallas kernels
``repro.kernels.rwkv6_scan.kernel.rwkv6_scan_fwd`` and ``rwkv6_scan_bwd``.

The kernel reads r/k/v/w through their strides (unit last stride), so the
model passes transposed views of its (B, S, H, hd) projections without a
copy, and writes y into a (B, H, S, hd) view of a (B, S, H, hd) buffer,
which the model reshapes back for free. ``state_out`` may be ``s0`` itself:
the final state then overwrites the initial one in place. The backward
writes dr, dk, dv, dw the same way, into (B, S, H, hd) storage. Both
kernels load rows through TMA tensor maps, which need 16-byte aligned
rows: a view that breaks that is refused, never copied.

The forward's value columns per CTA come from a launch plan, ``fwd_plan``,
from the shapes and the SM count alone; its result does not depend on the
split at all. The backward splits each (b, h) over a thread-block cluster
of ``CLUSTER`` CTAs, always, and is bitwise repeatable.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, refuse_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import n_chunks

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_P = ctypes.c_void_p

HEAD_DIMS = (32, 64)  # the kernel is instantiated for these
KEY_ROWS = 4          # key rows a forward thread holds (KR_SCAN in the source)
FWD_MAX_THREADS = 512
FWD_CTAS_PER_SM = 2   # the forward's split aims at this many CTAs on each SM
CLUSTER = 4           # the backward's CTAs per (b, h), a thread-block cluster (BWD_NC)
BWD_COLS_PER_THREAD = 8  # value columns a backward thread holds (BWD_JM in the source)


class Rwkv6Params(ctypes.Structure):
    """Mirror of ``struct Rwkv6Params`` in rwkv6_scan.cu."""

    _fields_ = [
        ("r", _P), ("k", _P), ("v", _P), ("w", _P), ("u", _P), ("s0", _P),
        ("y", _P), ("sT", _P), ("s_starts", _P),
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


class Rwkv6BwdParams(ctypes.Structure):
    """Mirror of ``struct Rwkv6BwdParams`` in rwkv6_scan.cu."""

    _fields_ = [
        ("r", _P), ("k", _P), ("v", _P), ("w", _P), ("dy", _P), ("u", _P),
        ("s_starts", _P), ("dsT", _P),
        ("dr", _P), ("dk", _P), ("dv", _P), ("dw", _P), ("du", _P), ("ds0", _P),
        *[(f"{name}_{s}", _I64) for name in ("r", "k", "v", "w", "dy", "dr", "dk",
                                             "dv", "dw") for s in ("sb", "sh", "ss")],
        ("u_sh", _I64),
        ("B", _I32), ("H", _I32), ("S", _I32), ("hd", _I32),
        ("dtype", _I32),
    ]


def check_cols(hd, cols):
    """Refuse a forward split the kernel does not take: ``cols`` value
    columns per CTA must be a multiple of 4 dividing ``hd``, with at most
    ``FWD_MAX_THREADS`` threads (hd / 4 per column)."""
    if (cols < 4 or cols % 4 or hd % cols
            or hd // KEY_ROWS * cols > FWD_MAX_THREADS):
        raise ValueError(f"cols={cols}: need a multiple of 4 dividing hd={hd}, "
                         f"at most {FWD_MAX_THREADS} threads")


def fwd_plan(B, H, hd, n_sm):
    """Value columns per CTA of a forward launch: 16 when that still gives
    every one of ``n_sm`` SMs ``FWD_CTAS_PER_SM`` CTAs (a step's work is a
    sequential chain, so the card fills by CTAs), else 8. It reads no data
    and no layout. Other splits are for tests (``_cols``)."""
    cols = 16 if B * H * (hd // 16) >= FWD_CTAS_PER_SM * n_sm else 8
    check_cols(hd, cols)
    return cols


def bwd_threads(hd):
    """Threads of one backward CTA: every key row, ``BWD_COLS_PER_THREAD``
    of the CTA's hd / ``CLUSTER`` value columns a thread."""
    return hd * (hd // CLUSTER // BWD_COLS_PER_THREAD)


def _aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base not 16-byte aligned")


def _entry(name, params):
    lib = _build.lib("rwkv6_scan")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_inputs(what, r, k, v, w, u, state, others):
    """The checks both kernels share: CUDA tensors on one device, r/k/v of
    one dtype (f32 or bf16), the rest f32, shapes, and a contiguous
    (B,H,hd,hd) state."""
    B, H, S, hd = r.shape
    if not all(t.is_cuda and t.device == r.device for t in (r, k, v, w, u, state, *others)):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == r.dtype):
        raise TypeError(f"dtypes r={r.dtype} k={k.dtype} v={v.dtype}; need one "
                        f"of float32/bfloat16")
    if not all(t.dtype == torch.float32 for t in (w, u, state, *others)):
        raise TypeError(f"w/u/state dtypes {w.dtype}/{u.dtype}/{state.dtype}; "
                        f"need float32")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if S < 1 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"shapes r={tuple(r.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)} w={tuple(w.shape)}")
    if u.shape != (H, hd) or u.stride(1) != 1:
        raise ValueError(f"u shape {tuple(u.shape)}; need ({H},{hd}), unit last stride")
    if state.shape != (B, H, hd, hd) or not state.is_contiguous():
        raise ValueError(f"s0/dsT must be a contiguous ({B},{H},{hd},{hd}) tensor")
    _aligned(state, "s0/dsT")
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        _build.check_rows(t, name)


def _bshd(like, dtype):
    """A (B,H,S,hd) view of new (B,S,H,hd) storage."""
    B, H, S, hd = like.shape
    return torch.empty((B, S, H, hd), dtype=dtype, device=like.device).transpose(1, 2)


def rwkv6_scan_fwd(r, k, v, w, u, s0, *, state_out=None, save_states=False,
                   _cols=None):
    """r,k,v: (B,H,S,hd) CUDA tensors of one dtype (f32 or bf16); w: (B,H,S,hd)
    f32; u: (H,hd) f32; s0: (B,H,hd,hd) f32 contiguous. Any S >= 1; views
    with a unit last stride. ``state_out``: a contiguous (B,H,hd,hd) f32
    tensor for the final state (may be ``s0``); a new one by default.
    Returns (y (B,H,S,hd) f32, sT), plus with ``save_states`` the states
    before every ``CHECKPOINT``-th step, (B,H,nc,hd,hd) f32. ``_cols``
    (value columns per CTA, ``fwd_plan``'s by default) is a test hook: the
    result must not depend on it."""
    refuse_dtensor("rwkv6_scan_fwd", r, k, v, w, u, s0)
    B, H, S, hd = r.shape
    _check_inputs("rwkv6_scan_fwd", r, k, v, w, u, s0,
                  [] if state_out is None else [state_out])
    if state_out is None:
        state_out = torch.empty_like(s0)
    elif (state_out.shape != s0.shape or state_out.dtype != torch.float32
          or not state_out.is_contiguous()):
        raise ValueError("state_out must be a contiguous f32 tensor shaped like s0")
    _aligned(state_out, "state_out")
    cols = fwd_plan(B, H, hd, _build.sm_count(r.device)) if _cols is None else _cols
    check_cols(hd, cols)
    y = _bshd(r, torch.float32)
    starts = (torch.empty((B, H, n_chunks(S), hd, hd), dtype=torch.float32,
                          device=r.device) if save_states else None)
    prm = Rwkv6Params(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        None if starts is None else starts.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *y.stride()[:3], u.stride(0),
        B, H, S, hd, cols, _build.dtype_code(r))
    lib, fn = _entry("rwkv6_scan_fwd", Rwkv6Params)
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(r.device)),
                 "rwkv6_scan_fwd")
    LAUNCHES["rwkv6_scan"] += 1
    return (y, state_out) if starts is None else (y, state_out, starts)


def rwkv6_scan_bwd(r, k, v, w, dy, u, s_starts, dsT):
    """The backward of ``rwkv6_scan_fwd``. r,k,v,w,u as for the forward;
    dy: (B,H,S,hd) f32 (unit last stride); s_starts: the forward's saved
    states, (B,H,nc,hd,hd) f32 contiguous; dsT: (B,H,hd,hd) f32 contiguous.
    Returns (dr, dk, dv in r's dtype, dw f32: (B,H,S,hd) views of
    (B,S,H,hd) storage; du (B,H,nc,hd) per-chunk partials and ds0
    (B,H,hd,hd), f32)."""
    refuse_dtensor("rwkv6_scan_bwd", r, k, v, w, dy, u)
    B, H, S, hd = r.shape
    nc = n_chunks(S)
    _check_inputs("rwkv6_scan_bwd", r, k, v, w, u, dsT, [dy, s_starts])
    if dy.shape != r.shape:
        raise ValueError(f"dy shape {tuple(dy.shape)} != {tuple(r.shape)}")
    _build.check_rows(dy, "dy")
    if s_starts.shape != (B, H, nc, hd, hd) or not s_starts.is_contiguous():
        raise ValueError(f"s_starts must be a contiguous ({B},{H},{nc},{hd},{hd}) "
                         f"tensor")
    _aligned(s_starts, "s_starts")
    dr, dk, dv = (_bshd(r, r.dtype) for _ in range(3))
    dw = _bshd(r, torch.float32)
    du = torch.empty((B, H, nc, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(dsT)
    prm = Rwkv6BwdParams(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), dy.data_ptr(),
        u.data_ptr(), s_starts.data_ptr(), dsT.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(),
        *(s for t in (r, k, v, w, dy, dr, dk, dv, dw) for s in t.stride()[:3]),
        u.stride(0), B, H, S, hd, _build.dtype_code(r))
    lib, fn = _entry("rwkv6_scan_bwd", Rwkv6BwdParams)
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(r.device)),
                 "rwkv6_scan_bwd")
    LAUNCHES["rwkv6_scan_bwd"] += 1
    return dr, dk, dv, dw, du, ds0
