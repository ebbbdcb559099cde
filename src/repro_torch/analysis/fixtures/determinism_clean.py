"""Allowlisted determinism patterns plus one in-place suppression — must
produce zero unsuppressed findings (note: no ``# BAD`` markers)."""

import time

import numpy as np


def elapsed():
    t0 = time.perf_counter()
    return time.perf_counter() - t0


def seeded(seed):
    rng = np.random.default_rng(seed)
    gen = np.random.Generator(np.random.PCG64(seed))
    return rng.normal(), gen.normal()


def wall_clock_for_display_only():
    return time.time()  # lint: disable=determinism
