"""Seeded determinism violations — every ``# BAD`` line must be flagged
by the determinism rule (exercised by ``lint --self-test``)."""

import random
import time
from datetime import datetime
from time import time as now_s

import numpy as np


def wall_clock():
    t0 = time.time()  # BAD
    t1 = now_s()  # BAD
    stamp = datetime.now()  # BAD
    elapsed = time.perf_counter()  # allowlisted
    return t0, t1, stamp, elapsed


def global_rng(n):
    a = random.random()  # BAD
    b = random.randint(0, n)  # BAD
    c = np.random.rand(n)  # BAD
    np.random.seed(0)  # BAD
    rng = np.random.default_rng()  # BAD
    good = np.random.default_rng(42)
    also_good = random.Random(7).random()
    return a, b, c, rng, good, also_good
