"""Token-bucket burst credits + per-tenant SLO bookkeeping.

The admission half of the multi-tenant layer (BoPF, Le et al. 2019): each
tenant owns a token bucket that refills at (roughly) its fair share of
short-partition work per engine time unit and caps at a burst depth.
Every placement costs a request its service demand in credits; a tenant
whose bucket is empty has offered more load than its paid rate and is
*throttled* — confined to its home slice of the general partition
instead of riding the shared replicas and the protected transients (the
``TenantGuardProbing`` policy in ``repro_torch.sched.policy`` drives this,
both Python engines emit a THROTTLE event per redirect, and
``runtime/serving_jax`` carries the same credit vector through its
``lax.scan``).

Conservation invariant (property-tested in tests/test_tenancy.py): at any
time, ``granted == spent + tokens`` exactly — every credit the bucket
ever granted (the initial fill plus all refills, clipped at the burst
depth) was either spent on a transient placement or is still residual in
the bucket.

:class:`TenancyState` is the engine-side observer: it accumulates
per-tenant admitted waits and exposes the SLO *headroom* signal
(``slo_target − smoothed wait``) the serving fleet's drain/hedge victim
selection keys on — the tenant with the most headroom can afford to lose
a replica; the tenant deepest in SLO debt gets hedged first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["TokenBucket", "TenantCredits", "TenancyState"]


class TokenBucket:
    """One tenant's burst-credit account.

    ``rate`` is credits per engine time unit, ``burst`` the bucket depth.
    The bucket starts full (a tenant's first burst is paid for). Refill is
    lazy: :meth:`advance` moves the clock forward and grants the elapsed
    credits, clipped so the balance never exceeds ``burst``. ``granted``
    and ``spent`` are lifetime accounting for the conservation check.
    """

    __slots__ = ("rate", "burst", "tokens", "granted", "spent", "_t")

    def __init__(self, rate: float, burst: float, *, t0: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = self.burst
        self.granted = self.burst
        self.spent = 0.0
        self._t = float(t0)

    def advance(self, t: float) -> None:
        """Refill for the time elapsed since the last advance (monotone:
        a clock that goes backwards grants nothing)."""
        dt = float(t) - self._t
        if dt <= 0.0:
            return
        self._t = float(t)
        add = min(self.rate * dt, self.burst - self.tokens)
        if add > 0.0:
            self.tokens += add
            self.granted += add

    def try_spend(self, cost: float) -> bool:
        """Debit ``cost`` credits if the balance covers it."""
        if self.tokens >= cost:
            self.tokens -= cost
            self.spent += cost
            return True
        return False

    @property
    def residual(self) -> float:
        return self.tokens


class TenantCredits:
    """Per-tenant bucket vector — the Python mirror of the ``(n_tenants,)``
    credit carry in ``serving_jax._simulate``."""

    __slots__ = ("buckets",)

    def __init__(self, rates: Sequence[float], bursts: Sequence[float]):
        if len(rates) != len(bursts):
            raise ValueError(f"{len(rates)} rates vs {len(bursts)} bursts")
        self.buckets: List[TokenBucket] = [
            TokenBucket(r, b) for r, b in zip(rates, bursts)]

    @classmethod
    def from_tenant_set(cls, ts) -> "TenantCredits":
        return cls(ts.credit_rates(), ts.credit_bursts())

    def __len__(self) -> int:
        return len(self.buckets)

    def advance(self, t: float) -> None:
        for b in self.buckets:
            b.advance(t)

    def try_spend(self, tenant: int, cost: float) -> bool:
        return self.buckets[tenant % len(self.buckets)].try_spend(cost)

    def balances(self) -> Tuple[float, ...]:
        return tuple(b.tokens for b in self.buckets)


class TenancyState:
    """Per-tenant SLO bookkeeping for a running engine.

    Engines record each admitted request's wait (in engine time units —
    ticks in the serving fleet, seconds in the DES); the state keeps the
    full per-tenant wait lists for end-of-run metrics plus an
    exponentially-smoothed wait per tenant for the live *headroom* signal::

        headroom(tenant) = slo_target − ewma_wait

    Most-headroom = safest victim (drain its replica, skip its hedge);
    least-headroom = deepest SLO debt (hedge it first). ``slo_targets``
    are in engine time units (convert via ``tick_s`` at construction).
    """

    __slots__ = ("names", "slo_targets", "waits", "_ewma", "_alpha")

    def __init__(self, names: Sequence[str], slo_targets: Sequence[float],
                 *, alpha: float = 0.05):
        if len(names) != len(slo_targets):
            raise ValueError(f"{len(names)} names vs {len(slo_targets)} "
                             f"SLO targets")
        self.names = tuple(names)
        self.slo_targets = tuple(float(s) for s in slo_targets)
        self.waits: List[List[float]] = [[] for _ in names]
        self._ewma = [0.0 for _ in names]
        self._alpha = float(alpha)

    @classmethod
    def from_tenant_set(cls, ts, *, tick_s: float = 1.0) -> "TenancyState":
        return cls(ts.names, [s / tick_s for s in ts.slo_targets_s()])

    @property
    def n_tenants(self) -> int:
        return len(self.names)

    def record_wait(self, tenant: int, wait: float) -> None:
        i = tenant % self.n_tenants
        self.waits[i].append(float(wait))
        self._ewma[i] += self._alpha * (float(wait) - self._ewma[i])

    def headroom(self, tenant: Optional[int]) -> float:
        """SLO headroom; a tenant-less request (``None``) is maximally
        safe to victimize."""
        if tenant is None:
            return float("inf")
        i = tenant % self.n_tenants
        return self.slo_targets[i] - self._ewma[i]
