"""Public serving-fleet op: the CUDA kernel for keys on the card, the plain
PyTorch version for keys on the CPU, no fallback from one to the other.

``serving_fleet_cost`` is the kernel's work (``parallel.cost``): no
products, and the bytes ``fleet_bytes`` counts."""

from __future__ import annotations

from repro_torch.kernels.serving_fleet.kernel import COUNTERS, serving_fleet_fwd
from repro_torch.kernels.serving_fleet.ref import simulate_ref
from repro_torch.parallel.cost import Cost, kernel_op


def fleet_bytes(spec, lanes=1):
    """Bytes the serving-fleet kernel must move at least, each input read
    once and each output written once, as ``serving_fleet_fwd`` lays them
    out: the shared request stream and per-tick arrays, each lane's
    parameters and key, and each lane's outputs (the per-tick series, the
    per-request start, finish and hedge flag, the lifetimes, the counters,
    the final replica and credit state). A lane's hot state (flags, queue
    heads, slots, pipe, credits) stays in shared memory for the whole run,
    and its queues, reroute ring and routing ticks are scratch in global
    memory: the function need not move either, so neither counts."""
    R, N, T, NT = spec.n_replicas, spec.n_requests, spec.horizon, spec.n_tenants
    consts = 4 * (3 * N + 3 * T)
    params = 4 * (6 + 2 * NT) + 8
    outputs = (9 * N + 4 * T * (16 + 2 * NT) + 4 * spec.lifetime_cap
               + 4 * len(COUNTERS) + 5 * R + 4 * NT)
    return consts + lanes * (params + outputs)


def serving_fleet_cost(spec, params, consts, key):
    """The kernel's work for ``key``'s lanes (from the spec and the key's
    shape)."""
    return Cost(0.0, float(fleet_bytes(spec, int(key[0].shape[0]))))


def serving_fleet(spec, params, consts, key):
    """One fleet trajectory a lane (see ``ref.simulate_ref`` for the
    arguments). The lanes run where ``key`` lies: ``params`` and ``consts``
    are host data, moved there."""
    dev = key[0].device
    if dev.type == "cuda":
        fwd = serving_fleet_fwd
    elif dev.type == "cpu":
        fwd = simulate_ref
    else:
        raise ValueError(f"serving_fleet: unsupported device {dev}")
    with kernel_op("serving_fleet", serving_fleet_cost, spec, params, consts, key):
        return fwd(spec, params, consts, key)
