"""Composable arrival processes — the burstiness vocabulary of the repo.

CloudCoaster's case rests on arrival-rate heterogeneity (paper §2 Fig. 1):
over/under-subscription phases only exist if the arrival process has
structure beyond a homogeneous Poisson.  This module provides that
structure as small composable objects:

  * :class:`Poisson` — homogeneous baseline;
  * :class:`MMPP` — N-state Markov-modulated Poisson process (the 2-state
    calm/burst special case is the repo's historical trace generator and
    reproduces it bit-for-bit, see :meth:`MMPP.from_burst`);
  * :class:`Diurnal` — sinusoidal day/night modulation (Alibaba-style,
    Cheng et al. 2018);
  * :class:`FlashCrowd` — multiplicative rate spikes at (possibly random)
    instants (the bursty-tenant regime BoPF evaluates against);
  * :class:`Modulated` — multiply one process's rate by another's
    normalized rate profile (e.g. ``Modulated(MMPP, Diurnal)`` = bursty
    arrivals riding a diurnal envelope);
  * :class:`Superpose` — sum of independent processes.

Every process offers an **exact serial sampler** ``sample(seed, horizon)``
→ arrival times.  Deterministic: the same ``(seed, params)`` always yields
the identical array (property tests rely on this).  ``MMPP`` uses the exact
Markov sampler; everything else realizes its rate function and thins a
dominating homogeneous Poisson (Lewis & Shedler).  The slot-binned batch
sampler of the JAX package (``rate_grid``, ``sample_counts_jax``,
``batch_sample_counts``) has no counterpart here yet.

Processes are frozen dataclasses with tuple fields, so they hash.

Registering a new arrival process: subclass :class:`ArrivalProcess`,
implement ``rate profile`` hooks (``max_rate``/``mean_rate``/
``realize_rate``), and add a named factory to
``ARRIVAL_PROCESSES`` so scenario/trace builders can reference it by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def as_rng(seed) -> np.random.Generator:
    """Accept a seed or an existing Generator (shared-stream composition)."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


# =========================================================================
#                                base class
# =========================================================================


class ArrivalProcess:
    """A (possibly doubly stochastic) point process on [0, horizon)."""

    # ---------------------------------------------------------- rate profile

    def mean_rate(self, horizon: float) -> float:
        """Expected time-average arrival rate over the horizon."""
        raise NotImplementedError

    def max_rate(self, horizon: float) -> float:
        """Upper bound on the instantaneous rate (thinning dominator)."""
        raise NotImplementedError

    def realize_rate(self, rng: np.random.Generator,
                     horizon: float) -> Callable[[np.ndarray], np.ndarray]:
        """Draw any internal randomness (e.g. an MMPP state path) and return
        the realized deterministic rate function λ(t), vectorized over t."""
        raise NotImplementedError

    # -------------------------------------------------------- serial sampler

    def sample(self, seed, horizon: float) -> np.ndarray:
        """Exact serial sampler → sorted arrival times in [0, horizon).

        Default: realize λ(t), then thin a homogeneous Poisson(λ_max) —
        candidate count ~ Poisson(λ_max·T), candidates ~ sorted U(0,T),
        accepted where u·λ_max ≤ λ(t).  Exact and fully vectorized.
        """
        rng = as_rng(seed)
        lam = self.realize_rate(rng, horizon)
        lam_max = float(self.max_rate(horizon))
        if lam_max <= 0:
            return np.empty(0)
        n_cand = rng.poisson(lam_max * horizon)
        cand = np.sort(rng.random(n_cand) * horizon)
        keep = rng.random(n_cand) * lam_max <= lam(cand)
        return cand[keep]


# =========================================================================
#                              leaf processes
# =========================================================================


@dataclass(frozen=True)
class Poisson(ArrivalProcess):
    """Homogeneous Poisson process — the no-burstiness baseline."""

    rate: float = 1.0

    def mean_rate(self, horizon):
        return self.rate

    def max_rate(self, horizon):
        return self.rate

    def realize_rate(self, rng, horizon):
        return lambda t: np.full(np.shape(t), self.rate)


@dataclass(frozen=True)
class MMPP(ArrivalProcess):
    """N-state Markov-modulated Poisson process.

    ``rates[i]`` is the Poisson rate while in state ``i``; the chain dwells
    ``Exp(dwells[i])`` then moves on.  ``trans=None`` means a deterministic
    cyclic chain (state ``i`` → ``i+1 mod N``) — for N=2 this is the
    calm/burst toggle of the repo's historical 2-state generator, and the
    serial sampler consumes the RNG in the identical order, so
    :meth:`from_burst` traces are byte-identical to the pre-subsystem ones.
    A row-stochastic ``trans`` enables arbitrary embedded chains (one extra
    uniform per switch).
    """

    rates: Tuple[float, ...] = (1.0, 5.0)
    dwells: Tuple[float, ...] = (3600.0, 900.0)
    start_probs: Optional[Tuple[float, ...]] = None
    trans: Optional[Tuple[Tuple[float, ...], ...]] = None

    @classmethod
    def from_burst(cls, rate_avg: float, burst_mult: float = 5.0,
                   calm_frac: float = 0.8, dwell_calm: float = 3600.0,
                   dwell_burst: float = 900.0) -> "MMPP":
        """The historical 2-state calm/burst parameterization: a burst state
        at ``burst_mult`` × the calm rate, sized so the ``calm_frac``-weighted
        average is ``rate_avg``.

        Note the legacy quirk, preserved for byte-identity: ``calm_frac``
        sets the *start* distribution and the rate split, while the actual
        long-run time fraction is dwell-determined
        (``dwell_calm / (dwell_calm + dwell_burst)``).  The long-run mean
        equals ``rate_avg`` exactly only when the two coincide (the yahoo
        calibration: 0.8 = 3600/4500); otherwise ``mean_rate()`` reports the
        true dwell-stationary mean (e.g. the google calibration's
        ``calm_frac=0.75`` runs ~11% under ``rate_avg``).
        """
        rc = rate_avg / (calm_frac + (1 - calm_frac) * burst_mult)
        rb = burst_mult * rc
        return cls(rates=(rc, rb), dwells=(dwell_calm, dwell_burst),
                   start_probs=(calm_frac, 1 - calm_frac))

    # --------------------------------------------------------------- helpers

    @property
    def n_states(self) -> int:
        return len(self.rates)

    def _start(self) -> np.ndarray:
        if self.start_probs is not None:
            return np.asarray(self.start_probs, float)
        return self._stationary()

    def _stationary(self) -> np.ndarray:
        """Time-stationary state distribution π_i ∝ ν_i · dwell_i where ν is
        the stationary law of the embedded jump chain."""
        n = self.n_states
        if self.trans is None:
            nu = np.full(n, 1.0 / n)  # cyclic chain visits uniformly
        else:
            P = np.asarray(self.trans, float)
            a = np.vstack([P.T - np.eye(n), np.ones(n)])
            b = np.concatenate([np.zeros(n), [1.0]])
            nu, *_ = np.linalg.lstsq(a, b, rcond=None)
        w = nu * np.asarray(self.dwells, float)
        return w / w.sum()

    def _initial_state(self, u: float) -> int:
        cum = np.cumsum(self._start())
        for k in range(self.n_states):
            if u <= cum[k]:
                return k
        return self.n_states - 1

    def _next_state(self, state: int, rng: np.random.Generator) -> int:
        if self.trans is None:
            return (state + 1) % self.n_states
        cum = np.cumsum(self.trans[state])
        return min(int(np.searchsorted(cum, rng.random(), side="right")),
                   self.n_states - 1)

    # ---------------------------------------------------------- rate profile

    def mean_rate(self, horizon):
        return float(self._stationary() @ np.asarray(self.rates, float))

    def max_rate(self, horizon):
        return float(max(self.rates))

    def _realize_path(self, rng, horizon):
        """Draw the state path: (switch_times, states) with switch_times[0]=0."""
        state = self._initial_state(rng.random())
        switches = [0.0]
        states = [state]
        t = rng.exponential(self.dwells[state])
        while t < horizon:
            state = self._next_state(state, rng)
            switches.append(t)
            states.append(state)
            t += rng.exponential(self.dwells[state])
        return np.asarray(switches), np.asarray(states)

    def realize_rate(self, rng, horizon):
        switches, states = self._realize_path(rng, horizon)
        rates = np.asarray(self.rates, float)[states]

        def lam(t):
            idx = np.searchsorted(switches, t, side="right") - 1
            return rates[np.clip(idx, 0, len(rates) - 1)]

        return lam

    # -------------------------------------------------------- serial sampler

    def sample(self, seed, horizon: float) -> np.ndarray:
        """Exact Markov sampler; identical RNG order to the historical
        2-state generator (state draw, first dwell, then exponential
        inter-arrivals with dwell redraws as switches are crossed)."""
        rng = as_rng(seed)
        rates = self.rates
        dwells = self.dwells
        state = self._initial_state(rng.random())
        t = 0.0
        next_switch = t + rng.exponential(dwells[state])
        times = []
        while t < horizon:
            t = t + rng.exponential(1.0 / rates[state])
            while t >= next_switch:
                state = self._next_state(state, rng)
                next_switch += rng.exponential(dwells[state])
            if t < horizon:
                times.append(t)
        return np.asarray(times)


@dataclass(frozen=True)
class Diurnal(ArrivalProcess):
    """Sinusoidal day/night rate: λ(t) = rate·(1 + a·sin(2π(t-phase)/period)).

    ``rel_amplitude`` ∈ [0, 1); the time-average over whole periods is
    ``rate``.  Use directly as an inhomogeneous Poisson, or as the envelope
    of :class:`Modulated` for diurnal×bursty composition.
    """

    rate: float = 1.0
    rel_amplitude: float = 0.6
    period: float = 24 * 3600.0
    phase: float = 0.0

    def mean_rate(self, horizon):
        # exact integral of the sinusoid over [0, horizon): the partial-period
        # correction matters at quick/CI scale (4 h of a 24 h period)
        w = 2.0 * np.pi / self.period
        corr = (np.cos(w * self.phase) - np.cos(w * (horizon - self.phase)))
        return self.rate * (1.0 + self.rel_amplitude * corr / (w * horizon))

    def max_rate(self, horizon):
        return self.rate * (1.0 + abs(self.rel_amplitude))

    def _rate_at(self, t):
        w = 2.0 * np.pi / self.period
        return self.rate * (1.0 + self.rel_amplitude
                            * np.sin(w * (np.asarray(t) - self.phase)))

    def realize_rate(self, rng, horizon):
        return self._rate_at


@dataclass(frozen=True)
class FlashCrowd(ArrivalProcess):
    """Flash-crowd spike injection: rate jumps to ``spike_mult``×base inside
    ``n_spikes`` windows of ``spike_duration`` seconds.  Spike start times
    are drawn uniformly over the horizon unless pinned via ``spike_times``
    (fractions of the horizon in [0, 1])."""

    rate: float = 1.0
    spike_mult: float = 8.0
    spike_duration: float = 900.0
    n_spikes: int = 3
    spike_times: Optional[Tuple[float, ...]] = None  # fractions of horizon

    def _starts(self, rng, horizon) -> np.ndarray:
        if self.spike_times is not None:
            return np.asarray(self.spike_times, float) * horizon
        span = max(horizon - self.spike_duration, 0.0)
        return rng.random(self.n_spikes) * span

    def mean_rate(self, horizon):
        frac = min(self.n_spikes * self.spike_duration / max(horizon, 1e-9),
                   1.0)
        return self.rate * (1.0 + (self.spike_mult - 1.0) * frac)

    def max_rate(self, horizon):
        return self.rate * max(self.spike_mult, 1.0)

    def realize_rate(self, rng, horizon):
        starts = self._starts(rng, horizon)

        def lam(t):
            t = np.asarray(t, float)
            hot = np.zeros(t.shape, bool)
            for s in starts:
                hot |= (t >= s) & (t < s + self.spike_duration)
            return self.rate * np.where(hot, self.spike_mult, 1.0)

        return lam


# =========================================================================
#                               combinators
# =========================================================================


@dataclass(frozen=True)
class Modulated(ArrivalProcess):
    """Multiply ``base``'s rate by ``envelope``'s normalized rate profile:
    λ(t) = λ_base(t) · λ_env(t) / mean(λ_env).  The time-average rate stays
    ≈ base's mean (exact when base and envelope vary independently)."""

    base: ArrivalProcess = field(default_factory=Poisson)
    envelope: ArrivalProcess = field(default_factory=Diurnal)

    def mean_rate(self, horizon):
        return self.base.mean_rate(horizon)

    def max_rate(self, horizon):
        env_mean = max(self.envelope.mean_rate(horizon), 1e-12)
        return (self.base.max_rate(horizon)
                * self.envelope.max_rate(horizon) / env_mean)

    def realize_rate(self, rng, horizon):
        base = self.base.realize_rate(rng, horizon)
        env = self.envelope.realize_rate(rng, horizon)
        env_mean = max(self.envelope.mean_rate(horizon), 1e-12)
        return lambda t: base(t) * env(t) / env_mean


@dataclass(frozen=True)
class Superpose(ArrivalProcess):
    """Sum of independent processes (tenant mixes: steady + bursty + …)."""

    parts: Tuple[ArrivalProcess, ...] = ()

    def mean_rate(self, horizon):
        return sum(p.mean_rate(horizon) for p in self.parts)

    def max_rate(self, horizon):
        return sum(p.max_rate(horizon) for p in self.parts)

    def realize_rate(self, rng, horizon):
        fns = [p.realize_rate(rng, horizon) for p in self.parts]
        return lambda t: sum(f(t) for f in fns)

    def sample(self, seed, horizon):
        """Exact: merge each part's own exact sampler (one shared stream)."""
        rng = as_rng(seed)
        return np.sort(np.concatenate(
            [p.sample(rng, horizon) for p in self.parts] or [np.empty(0)]))


# =========================================================================
#                          slot-binned helpers
# =========================================================================


def n_slots(horizon: float, dt: float) -> int:
    return int(np.ceil(horizon / dt))


def counts_to_times(rng, counts: np.ndarray, dt: float) -> np.ndarray:
    """Expand slot counts into sorted arrival times (uniform within slots) —
    turns a row of slot counts back into a serial-compatible arrival
    vector."""
    rng = as_rng(rng)
    counts = np.asarray(counts)
    offsets = rng.random(int(counts.sum()))
    slot_of = np.repeat(np.arange(len(counts)), counts)
    return np.sort((slot_of + offsets) * dt)


# =========================================================================
#                                 registry
# =========================================================================

#: named factories so trace builders / scenario presets / docs can refer to
#: arrival processes by name; register new processes here.
ARRIVAL_PROCESSES: Dict[str, Callable[..., ArrivalProcess]] = {
    "poisson": Poisson,
    "mmpp": MMPP,
    "mmpp_burst": MMPP.from_burst,
    "diurnal": Diurnal,
    "flash_crowd": FlashCrowd,
    "modulated": Modulated,
    "superpose": Superpose,
}


def make_arrival_process(name: str, **kwargs) -> ArrivalProcess:
    try:
        return ARRIVAL_PROCESSES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown arrival process {name!r}; "
                         f"registered: {sorted(ARRIVAL_PROCESSES)}") from None
