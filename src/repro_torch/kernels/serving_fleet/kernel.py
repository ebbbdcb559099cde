"""Launch wrapper of the serving-fleet kernel (``src/repro_torch/csrc/serving_fleet.cu``),
the card's version of the reference's ``repro.runtime.serving_jax._simulate``
(an XLA program there, with no Pallas kernel).

One thread block runs one lane (one grid point and seed) over the whole
horizon in one launch. The wrapper moves the shared request stream and the
lanes' parameters to the card, allocates each lane's state (the queues,
``n_replicas x queue_cap`` int32, the reroute ring and the per-request
arrays) and its outputs once per call, never per tick, and returns the
plain version's output dict on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I32 = ctypes.c_int32

SPEC_FIELDS = ("L", "R", "S", "Q", "N", "T", "W", "n_ond", "K", "NT", "P", "retries",
               "d", "FC", "AW", "HS", "HC", "LC", "drain_code", "spot")
CONST_FIELDS = ("arrival", "gen", "tenant", "arr_start", "arr_count", "pin")
PARAM_FIELDS = ("thr", "k_max", "m_slots", "hf", "rev_p", "spot_mttf", "cred_rate",
                "cred_burst", "key")
STATE_FIELDS = ("q_rid", "ring", "routed_at")
OUT_FIELDS = ("start", "finish", "hedged", "series", "lifetimes", "counters",
              "final_tr_online", "final_online_at", "final_credits")
#: None, or a list to which each launch appends its pair of CUDA events,
#: recorded on the launch's stream just before and just after the kernel
#: (the launch's device time, without the wrapper's uploads and allocations)
LAUNCH_EVENTS = None
#: serving_fleet.cu's counters, in its order
COUNTERS = ("n_hedges", "n_hedge_cancelled", "n_revocations", "n_rentals",
            "n_overflow", "n_lifetimes", "lifetime_sum", "n_throttled",
            "final_online_transients")


class FleetParams(ctypes.Structure):
    """Mirror of ``struct FleetParams`` in serving_fleet.cu."""

    _fields_ = ([(f, _I32) for f in SPEC_FIELDS]
                + [(f, _P) for f in CONST_FIELDS + PARAM_FIELDS + STATE_FIELDS
                   + OUT_FIELDS])


def spec_ints(spec, L: int) -> dict:
    """The kernel's shape fields of a ``FleetSpec`` run over ``L`` lanes."""
    if spec.hedge_scan + spec.slot_cap > 32:
        raise ValueError(f"hedge_scan + slot_cap = {spec.hedge_scan + spec.slot_cap} "
                         f"> 32: the kernel keeps a row's hedge window in one word")
    if (spec.probe_retries + 1) * spec.probe_d > 32:
        raise ValueError("probe_retries * probe_d + probe_d > 32: one warp lane a draw")
    return dict(L=L, R=spec.n_replicas, S=spec.slot_cap, Q=spec.queue_cap,
                N=spec.n_requests, T=spec.horizon, W=spec.route_cap,
                n_ond=spec.n_ondemand, K=spec.transient_cap, NT=spec.n_tenants,
                P=spec.pipe_len, retries=spec.probe_retries, d=spec.probe_d,
                FC=spec.flush_cap, AW=spec.admit_window, HS=spec.hedge_scan,
                HC=spec.hedge_cap, LC=spec.lifetime_cap, drain_code=spec.drain_code,
                spot=int(spec.spot_pricing))


def serving_fleet_fwd(spec, params, consts, key):
    """``spec``: a ``FleetSpec``; ``params``: the traced parameters, each
    with a leading lane axis L; ``consts``: ``build_consts``' numpy arrays;
    ``key``: a pair of (L,) int64 CUDA tensors (32-bit words). Returns the
    plain version's output dict (``ref.simulate_ref``), on the card."""
    k0, k1 = key
    dev = k0.device
    if dev.type != "cuda" or k1.device != dev:
        raise ValueError("serving_fleet_fwd takes its key on one CUDA device")
    L = int(k0.shape[0])
    if L < 1 or tuple(k1.shape) != (L,):
        raise ValueError(f"key shapes {tuple(k0.shape)}, {tuple(k1.shape)}; want (L,)")
    dims = spec_ints(spec, L)
    R, N, T, NT, LC = dims["R"], dims["N"], dims["T"], dims["NT"], dims["LC"]
    i32, f32 = torch.int32, torch.float32

    def on_card(x, dtype, shape):
        t = torch.as_tensor(np.asarray(x)).to(dtype).reshape(shape).contiguous()
        return t.to(dev)

    c = {"arrival": on_card(consts["arrival"], i32, (N,)),
         "gen": on_card(consts["gen"], i32, (N,)),
         "tenant": on_card(consts["tenant"], i32, (N,)),
         "arr_start": on_card(consts["arr_start"], i32, (T,)),
         "arr_count": on_card(consts["arr_count"], i32, (T,)),
         "pin": on_card(consts["pinned_target"], i32, (T,))}
    prm = {"thr": on_card(params["threshold"], f32, (L,)),
           "k_max": on_card(params["max_transient"], f32, (L,)),
           "m_slots": on_card(params["max_slots"], i32, (L,)),
           "hf": on_card(params["hedge_factor"], f32, (L,)),
           "rev_p": on_card(params["revoke_prob"], f32, (L,)),
           "spot_mttf": on_card(params["spot_mttf"], f32, (L,)),
           "cred_rate": on_card(params["credit_rate"], f32, (L, NT)),
           "cred_burst": on_card(params["credit_burst"], f32, (L, NT))}
    words = torch.stack([k0, k1], 1).to(torch.int64) & 0xFFFFFFFF
    prm["key"] = (words - (words >> 31) * (1 << 32)).to(i32).contiguous()
    st = {"q_rid": torch.empty((L, R, dims["Q"]), dtype=i32, device=dev),
          "ring": torch.empty((L, 2 * N), dtype=i32, device=dev),
          "routed_at": torch.empty((L, N), dtype=i32, device=dev)}
    out = {"start": torch.empty((L, N), dtype=i32, device=dev),
           "finish": torch.empty((L, N), dtype=i32, device=dev),
           "hedged": torch.empty((L, N), dtype=torch.uint8, device=dev),
           "series": torch.empty((L, T, 16 + 2 * NT), dtype=i32, device=dev),
           "lifetimes": torch.zeros((L, LC), dtype=f32, device=dev),
           "counters": torch.empty((L, len(COUNTERS)), dtype=i32, device=dev),
           "final_tr_online": torch.empty((L, R), dtype=torch.uint8, device=dev),
           "final_online_at": torch.empty((L, R), dtype=i32, device=dev),
           "final_credits": torch.empty((L, NT), dtype=f32, device=dev)}
    args = FleetParams(*(dims[f] for f in SPEC_FIELDS),
                       *(c[f].data_ptr() for f in CONST_FIELDS),
                       *(prm[f].data_ptr() for f in PARAM_FIELDS),
                       *(st[f].data_ptr() for f in STATE_FIELDS),
                       *(out[f].data_ptr() for f in OUT_FIELDS))
    lib = _build.lib("serving_fleet")
    fn = lib.serving_fleet_run
    fn.argtypes = [ctypes.POINTER(FleetParams), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    timing = LAUNCH_EVENTS
    if timing is not None:
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record(torch.cuda.current_stream(dev))
    _build.check(lib, fn(ctypes.byref(args), _build.stream_ptr(dev)), "serving_fleet")
    LAUNCHES["serving_fleet"] += 1
    if timing is not None:
        events[1].record(torch.cuda.current_stream(dev))
        timing.append(events)
    ys, cnt = out["series"], out["counters"]
    res = {
        "start": out["start"], "finish": out["finish"], "hedged": out["hedged"].bool(),
        "active_transients": ys[:, :, 0], "busy": ys[:, :, 1], "cap": ys[:, :, 2],
        "tr_busy": ys[:, :, 3], "tr_cap": ys[:, :, 4],
        "event_counts": ys[:, :, 6:16], "queue_depth": ys[:, :, 5],
        "lifetimes": out["lifetimes"],
        "final_tr_online": out["final_tr_online"].bool(),
        "final_online_at": out["final_online_at"],
        "tenant_admits": ys[:, :, 16:16 + NT], "tenant_wait_sums": ys[:, :, 16 + NT:],
        "final_credits": out["final_credits"],
    }
    res.update({name: cnt[:, i] for i, name in enumerate(COUNTERS)})
    return res


def smem_bytes(spec, L: int = 1) -> int:
    """Dynamic shared memory of one block for ``spec`` (the kernel's own
    count)."""
    dims = spec_ints(spec, L)
    args = FleetParams(*(dims[f] for f in SPEC_FIELDS))
    lib = _build.lib("serving_fleet")
    fn = lib.serving_fleet_smem_bytes
    fn.argtypes = [ctypes.POINTER(FleetParams)]
    fn.restype = ctypes.c_size_t
    return int(fn(ctypes.byref(args)))
