"""Cluster / scheduler configuration (paper §4 defaults) and server state."""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Tuple


@dataclass(frozen=True)
class SimConfig:
    """Paper §4: 4000 on-demand servers, N_s=80 short-only, p=0.5, r in 1..3,
    L_r^T=0.95, 120 s provisioning delay. ``replace_fraction=0`` disables the
    transient manager => the Eagle baseline."""

    n_servers: int = 4000
    n_short_reserved: int = 80  # N_s
    replace_fraction: float = 0.0  # p
    cost_ratio: float = 3.0  # r
    threshold: float = 0.95  # L_r^T
    provisioning_delay: float = 120.0  # seconds
    probe_d: int = 2  # power-of-d choices for short tasks
    probe_retries: int = 3  # re-probe rounds avoiding long-occupied servers
    revocation_mttf: float = 0.0  # seconds; 0 = no revocations (paper regime)
    duplicate_to_ondemand: bool = False  # paper §3.3 safety copy (metric only)
    hetero_slow_frac: float = 0.0  # fraction of general servers that are slow
    hetero_slow_speed: float = 1.0  # their relative service speed (<1 = slower)
    seed: int = 0

    @property
    def n_general(self) -> int:
        return self.n_servers - self.n_short_reserved

    @property
    def n_slow_general(self) -> int:
        return int(round(self.hetero_slow_frac * self.n_general))

    @property
    def mean_general_speed(self) -> float:
        """Average service speed of the general partition (fluid-capacity
        scale factor for heterogeneous-speed scenarios)."""
        n = self.n_general
        if n == 0 or self.n_slow_general == 0:
            return 1.0
        ns = self.n_slow_general
        return (ns * self.hetero_slow_speed + (n - ns)) / n

    @property
    def n_static_short(self) -> int:
        return self.n_short_reserved - self.n_replaced

    @property
    def n_replaced(self) -> int:
        return int(round(self.n_short_reserved * self.replace_fraction))

    @property
    def max_transient(self) -> int:
        """K = r * N_s * p — budget-equivalent transient servers."""
        return int(math.floor(self.cost_ratio * self.n_replaced))

    @property
    def max_short_partition(self) -> int:
        """T = N((r-1)p + 1) upper bound from the paper's cost model."""
        return self.n_static_short + self.max_transient


# mutable server record (engine-internal)
@dataclass
class Server:
    sid: int
    kind: str  # general | short | transient
    speed: float = 1.0  # service speed; a task of nominal work w runs w/speed
    queue: Deque = field(default_factory=deque)  # (duration, submit_t, is_long, job_id)
    running: Optional[Tuple[float, float, bool, int]] = None
    pending_work: float = 0.0  # queued + running remaining (approx: full durations)
    n_long: int = 0  # long tasks in queue+running
    run_gen: int = 0  # increments per task start; stale-finish detection
    draining: bool = False
    online_t: float = 0.0
    shutdown_t: Optional[float] = None

    @property
    def long_occupied(self) -> bool:
        return self.n_long > 0

    @property
    def idle(self) -> bool:
        return self.running is None and not self.queue
