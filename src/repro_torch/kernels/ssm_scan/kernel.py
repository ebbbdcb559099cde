"""Launch wrapper of the CUDA Mamba selective scan
(``src/repro_torch/csrc/ssm_scan.cu``), the port of the Pallas kernel
``repro.kernels.ssm_scan.kernel.ssm_scan_fwd``.

Every tensor is f32 and contiguous, as the model hands them over (its
``float()`` casts and norms give new contiguous tensors). ``state_out`` may
be ``h0`` itself: the final state then overwrites the initial one in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I32 = ctypes.c_int32

STATE_DIMS = (8, 16)  # the kernel is instantiated for these


class SsmParams(ctypes.Structure):
    """Mirror of ``struct SsmParams`` in ssm_scan.cu."""

    _fields_ = [
        ("x", _P), ("dt", _P), ("A", _P), ("Bc", _P), ("Cc", _P), ("D", _P),
        ("h0", _P), ("y", _P), ("hT", _P),
        ("B", _I32), ("S", _I32), ("Di", _I32), ("N", _I32),
    ]


def ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0, *, state_out=None):
    """x, dt: (B,S,Di); A: (Di,N); Bc, Cc: (B,S,N); D: (Di,); h0: (B,Di,N):
    contiguous f32 CUDA tensors on one device, any S >= 1, N in
    ``STATE_DIMS``. ``state_out``: a contiguous (B,Di,N) f32 tensor for the
    final state (may be ``h0``); a new one by default. Returns (y (B,S,Di)
    f32, hT)."""
    tensors = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc, D=D, h0=h0)
    if state_out is not None:
        tensors["state_out"] = state_out
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError("ssm_scan_fwd takes CUDA tensors on one device")
    bad = {k: t.dtype for k, t in tensors.items() if t.dtype != torch.float32}
    if bad:
        raise TypeError(f"ssm_scan_fwd takes float32 tensors, got {bad}")
    if x.dim() != 3:
        raise ValueError(f"x shape {tuple(x.shape)}; need (B, S, Di)")
    B, S, Di = x.shape
    N = A.shape[-1]
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    want = dict(x=(B, S, Di), dt=(B, S, Di), A=(Di, N), Bc=(B, S, N),
                Cc=(B, S, N), D=(Di,), h0=(B, Di, N), state_out=(B, Di, N))
    shapes = {k: tuple(t.shape) for k, t in tensors.items() if tuple(t.shape) != want[k]}
    if S < 1 or shapes:
        raise ValueError(f"ssm_scan_fwd shapes {shapes}; want {want}, S >= 1")
    loose = [k for k, t in tensors.items() if not t.is_contiguous()]
    if loose:
        raise ValueError(f"ssm_scan_fwd takes contiguous tensors; {loose} are not")
    unaligned = [k for k in ("A", "h0", "state_out")
                 if k in tensors and tensors[k].data_ptr() % 16]
    if unaligned:
        raise ValueError(f"ssm_scan_fwd: {unaligned} not 16-byte aligned")
    if state_out is None:
        state_out = torch.empty_like(h0)
    y = torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
    prm = SsmParams(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                    Cc.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                    state_out.data_ptr(), B, S, Di, N)
    lib = _build.lib("ssm_scan")
    fn = lib.ssm_scan_fwd
    fn.argtypes = [ctypes.POINTER(SsmParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(x.device)),
                 "ssm_scan_fwd")
    LAUNCHES["ssm_scan"] += 1
    return y, state_out
