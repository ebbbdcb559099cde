"""Launch wrappers of the CUDA Mamba selective scan and its backward
(``src/repro_torch/csrc/ssm_scan.cu``), the ports of the Pallas kernels
``repro.kernels.ssm_scan.kernel.ssm_scan_fwd`` and ``ssm_scan_bwd``.

Both kernels split a channel's N states over ``LANES_PER_CHANNEL`` lanes
(lane q holds the states n = 4k + q) and sum over n as each lane's running
sum added pairwise across the four lanes. The forward takes 32 channels a
CTA and streams x, dt, B and C through a ring in shared memory; the
backward takes ``CHANNELS_PER_CTA`` channels a CTA, replays each 8-step
segment from its checkpoint into registers, and writes one dB/dC partial
per CTA, which ``ssm_scan_bwd`` sums here in a fixed order.

Every tensor is f32 and contiguous, as the model hands them over (its
``float()`` casts and norms give new contiguous tensors). ``state_out`` may
be ``h0`` itself: the final state then overwrites the initial one in place.
The backward writes nothing in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import n_chunks

_P = ctypes.c_void_p
_I32 = ctypes.c_int32

STATE_DIMS = (8, 16)  # the kernels are instantiated for these
LANES_PER_CHANNEL = 4  # ssm_scan.cu SSM_LANES: a channel's states over four lanes
CHANNELS_PER_CTA = 128  # ssm_scan.cu SSM_BWD_CHANNELS: one dB/dC partial per backward CTA


class SsmParams(ctypes.Structure):
    """Mirror of ``struct SsmParams`` in ssm_scan.cu."""

    _fields_ = [
        ("x", _P), ("dt", _P), ("A", _P), ("Bc", _P), ("Cc", _P), ("D", _P),
        ("h0", _P), ("y", _P), ("hT", _P), ("h_starts", _P),
        ("B", _I32), ("S", _I32), ("Di", _I32), ("N", _I32),
    ]


class SsmBwdParams(ctypes.Structure):
    """Mirror of ``struct SsmBwdParams`` in ssm_scan.cu."""

    _fields_ = [
        ("x", _P), ("dt", _P), ("A", _P), ("Bc", _P), ("Cc", _P), ("D", _P),
        ("dy", _P), ("h_starts", _P), ("dhT", _P),
        ("dx", _P), ("ddt", _P), ("dA", _P), ("dD", _P), ("dBp", _P),
        ("dCp", _P), ("dh0", _P),
        ("B", _I32), ("S", _I32), ("Di", _I32), ("N", _I32),
    ]


def _check_inputs(what, tensors, x, A):
    """The checks both kernels share: contiguous f32 CUDA tensors on one
    device, the shapes of ``want`` (filled in from x and A), N in
    ``STATE_DIMS``, 16-byte aligned state rows. Returns (B, S, Di, N)."""
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    bad = {k: t.dtype for k, t in tensors.items() if t.dtype != torch.float32}
    if bad:
        raise TypeError(f"{what} takes float32 tensors, got {bad}")
    if x.dim() != 3:
        raise ValueError(f"x shape {tuple(x.shape)}; need (B, S, Di)")
    B, S, Di = x.shape
    N = A.shape[-1]
    if N not in STATE_DIMS:
        raise ValueError(f"state dim {N} not in {STATE_DIMS}")
    seq, state = (B, S, Di), (B, Di, N)
    want = dict(x=seq, dt=seq, dy=seq, A=(Di, N), Bc=(B, S, N), Cc=(B, S, N),
                D=(Di,), h0=state, state_out=state, dhT=state,
                h_starts=(B, n_chunks(S), Di, N))
    want = {k: want[k] for k in tensors}
    shapes = {k: tuple(t.shape) for k, t in tensors.items() if tuple(t.shape) != want[k]}
    if S < 1 or shapes:
        raise ValueError(f"{what} shapes {shapes}; want {want}, S >= 1")
    loose = [k for k, t in tensors.items() if not t.is_contiguous()]
    if loose:
        raise ValueError(f"{what} takes contiguous tensors; {loose} are not")
    unaligned = [k for k in ("A", "h0", "state_out", "dhT", "h_starts")
                 if k in tensors and tensors[k].data_ptr() % 16]
    if unaligned:
        raise ValueError(f"{what}: {unaligned} not 16-byte aligned")
    return B, S, Di, N


def _entry(name, params):
    lib = _build.lib("ssm_scan")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.POINTER(params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0, *, state_out=None, save_states=False):
    """x, dt: (B,S,Di); A: (Di,N); Bc, Cc: (B,S,N); D: (Di,); h0: (B,Di,N):
    contiguous f32 CUDA tensors on one device, any S >= 1, N in
    ``STATE_DIMS``. ``state_out``: a contiguous (B,Di,N) f32 tensor for the
    final state (may be ``h0``); a new one by default. Returns (y (B,S,Di)
    f32, hT), plus with ``save_states`` the states before every
    ``CHECKPOINT``-th step, (B, nc, Di, N) f32."""
    tensors = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc, D=D, h0=h0)
    if state_out is not None:
        tensors["state_out"] = state_out
    B, S, Di, N = _check_inputs("ssm_scan_fwd", tensors, x, A)
    if state_out is None:
        state_out = torch.empty_like(h0)
    y = torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
    starts = (torch.empty((B, n_chunks(S), Di, N), dtype=torch.float32,
                          device=x.device) if save_states else None)
    prm = SsmParams(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                    Cc.data_ptr(), D.data_ptr(), h0.data_ptr(), y.data_ptr(),
                    state_out.data_ptr(), None if starts is None else starts.data_ptr(),
                    B, S, Di, N)
    lib, fn = _entry("ssm_scan_fwd", SsmParams)
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(x.device)),
                 "ssm_scan_fwd")
    LAUNCHES["ssm_scan"] += 1
    return (y, state_out) if starts is None else (y, state_out, starts)


def ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy, h_starts, dhT):
    """The backward of ``ssm_scan_fwd``. x, dt, A, Bc, Cc, D as for the
    forward; dy: (B,S,Di); h_starts: the forward's saved states,
    (B,nc,Di,N); dhT: (B,Di,N); all contiguous f32. Returns (dx, ddt
    (B,S,Di); dA (Di,N); dB, dC (B,S,N); dD (Di,); dh0 (B,Di,N)), f32. The
    kernel's per-CTA dB/dC partials and per-sequence dA/dD sums are summed
    here, in a fixed order."""
    tensors = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc, D=D, dy=dy, h_starts=h_starts,
                   dhT=dhT)
    B, S, Di, N = _check_inputs("ssm_scan_bwd", tensors, x, A)
    nblk = -(-Di // CHANNELS_PER_CTA)
    dx, ddt = (torch.empty((B, S, Di), dtype=torch.float32, device=x.device)
               for _ in range(2))
    dA = torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
    dD = torch.empty((B, Di), dtype=torch.float32, device=x.device)
    dBp, dCp = (torch.empty((B, nblk, S, N), dtype=torch.float32, device=x.device)
                for _ in range(2))
    dh0 = torch.empty_like(dhT)
    prm = SsmBwdParams(*(t.data_ptr() for t in (
        x, dt, A, Bc, Cc, D, dy, h_starts, dhT, dx, ddt, dA, dD, dBp, dCp, dh0)),
        B, S, Di, N)
    lib, fn = _entry("ssm_scan_bwd", SsmBwdParams)
    _build.check(lib, fn(ctypes.byref(prm), _build.stream_ptr(x.device)),
                 "ssm_scan_bwd")
    LAUNCHES["ssm_scan_bwd"] += 1
    return dx, ddt, dA.sum(0), dBp.sum(1), dCp.sum(1), dD.sum(0), dh0
