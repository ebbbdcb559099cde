"""Public serving-fleet op: the CUDA kernel for keys on the card, the plain
PyTorch version for keys on the CPU, no fallback from one to the other."""

from __future__ import annotations

from repro_torch.kernels.serving_fleet.kernel import serving_fleet_fwd
from repro_torch.kernels.serving_fleet.ref import simulate_ref


def serving_fleet(spec, params, consts, key):
    """One fleet trajectory a lane (see ``ref.simulate_ref`` for the
    arguments). The lanes run where ``key`` lies: ``params`` and ``consts``
    are host data, moved there."""
    dev = key[0].device
    if dev.type == "cuda":
        return serving_fleet_fwd(spec, params, consts, key)
    if dev.type != "cpu":
        raise ValueError(f"serving_fleet: unsupported device {dev}")
    return simulate_ref(spec, params, consts, key)
