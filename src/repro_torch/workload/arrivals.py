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

Every process offers two samplers:

  * an **exact serial sampler** ``sample(seed, horizon)`` → arrival times.
    Deterministic: the same ``(seed, params)`` always yields the identical
    array (property tests rely on this).  ``MMPP`` uses the exact Markov
    sampler; everything else realizes its rate function and thins a
    dominating homogeneous Poisson (Lewis & Shedler).
  * a **batch thinning sampler** over fixed slots, ``sample_counts_torch``
    / :func:`batch_sample_counts`, one tensor program over a batch of
    seeds: candidates ~ Poisson(λ_max·dt) per slot are thinned by
    Binomial(·, λ(t)/λ_max) — distributionally exact per slot given the
    realized rate path (the MMPP state path is discretized to slot
    granularity).  It is the twin of the JAX package's
    ``sample_counts_jax`` under ``vmap``: every draw goes through
    ``jax.random``'s threefry keys and algorithms
    (:mod:`repro_torch.runtime.threefry`), so a seed's row is the JAX
    package's row (the rate paths bit for bit where no transcendental
    function is applied per slot, the counts up to a last-bit difference
    of ``log``/``lgamma`` deciding a rejection test).  It runs on ``cuda``
    unless asked for the CPU.

Processes are frozen dataclasses with tuple fields, so they hash — the
batch sampler's constants are cached per ``(process, horizon, dt,
device)``.

Registering a new arrival process: subclass :class:`ArrivalProcess`,
implement ``rate profile`` hooks (``max_rate``/``mean_rate``/
``realize_rate``/``rate_grid``), and add a named factory to
``ARRIVAL_PROCESSES`` so scenario/trace builders can reference it by name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import threefry


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

    # --------------------------------------------------------- batch sampler

    def rate_grid(self, key, t_grid: torch.Tensor, dt: float) -> torch.Tensor:
        """Per-slot realized rates λ(t_grid), f32 ``(B, n)`` on ``t_grid``'s
        device, for a batch of ``B`` threefry keys (randomness from
        ``key``, each row as the JAX package's ``rate_grid`` draws it)."""
        raise NotImplementedError


def _f32_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python number ``c`` rounded once, as JAX divides by a
    weakly typed scalar (torch on the card multiplies by ``1 / c``)."""
    return torch.div(x, torch.full_like(x, c))


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

    def rate_grid(self, key, t_grid, dt):
        return torch.full(key[0].shape + t_grid.shape, self.rate,
                          dtype=torch.float32, device=t_grid.device)


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

    # --------------------------------------------------------- batch sampler

    def rate_grid(self, key, t_grid, dt):
        """Slot-discretized chain: per slot, switch with the CTMC hazard
        ``1 - exp(-dt / dwell[s])`` (at most one switch per slot). The
        reference's ``lax.scan`` is a loop over slots of one gather each:
        the draws are made up front, and slot ``t``'s move from every state
        is tabulated before the loop."""
        n, dev = t_grid.shape[0], t_grid.device
        rates, cum_start, p_switch, step = (
            torch.as_tensor(a, device=dev) for a in _mmpp_tables(self, float(dt)))
        k_start, k_path = threefry.split(key)
        s0 = torch.searchsorted(cum_start, threefry.uniform(k_start))
        s0 = s0.clamp(max=self.n_states - 1)
        u = threefry.uniform(k_path, (n, 2)).transpose(0, 1)     # (n, B, 2)
        if self.trans is None:
            s_next = step.expand(u.shape[:2] + step.shape)
        else:
            s_next = torch.stack([torch.searchsorted(step[s], u[..., 1].contiguous())
                                  for s in range(self.n_states)], dim=-1)
            s_next = s_next.clamp(max=self.n_states - 1)
        stay = torch.arange(self.n_states, device=dev)
        to = torch.where(u[..., :1] < p_switch, s_next, stay)    # (n, B, N)
        path = torch.empty((n + 1,) + s0.shape, dtype=torch.int64, device=dev)
        path[0] = s0
        for t in range(n):
            torch.gather(to[t], 1, path[t].unsqueeze(1), out=path[t + 1].unsqueeze(1))
        return rates[path[1:]].transpose(0, 1).contiguous()


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

    def rate_grid(self, key, t_grid, dt):
        w = 2.0 * np.pi / self.period
        rate = self.rate * (1.0 + self.rel_amplitude
                            * torch.sin(w * (t_grid - self.phase)))
        return rate.expand(key[0].shape + t_grid.shape).contiguous()


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

    def rate_grid(self, key, t_grid, dt):
        horizon = t_grid.shape[0] * dt
        if self.spike_times is not None:
            starts = torch.tensor(self.spike_times, dtype=torch.float32,
                                  device=t_grid.device) * horizon
            starts = starts.expand(key[0].shape + starts.shape)
        else:
            span = np.float32(max(horizon - self.spike_duration, 0.0))
            starts = threefry.uniform(key, (self.n_spikes,)) * float(span)
        t = t_grid[:, None]
        starts = starts.unsqueeze(-2)                            # (B, 1, spikes)
        hot = ((t >= starts) & (t < starts + self.spike_duration)).any(dim=-1)
        return self.rate * torch.where(hot, self.spike_mult, 1.0)


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

    def rate_grid(self, key, t_grid, dt):
        k1, k2 = threefry.split(key)
        env_mean = max(self.envelope.mean_rate(float(t_grid.shape[0] * dt)),
                       1e-12)
        return _f32_div(self.base.rate_grid(k1, t_grid, dt)
                        * self.envelope.rate_grid(k2, t_grid, dt), env_mean)


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

    def rate_grid(self, key, t_grid, dt):
        keys = threefry.split(key, max(len(self.parts), 1))
        out = torch.zeros(key[0].shape + t_grid.shape, dtype=torch.float32,
                          device=t_grid.device)
        for p, k in zip(self.parts, keys):
            out = out + p.rate_grid(k, t_grid, dt)
        return out

    def sample(self, seed, horizon):
        """Exact: merge each part's own exact sampler (one shared stream)."""
        rng = as_rng(seed)
        return np.sort(np.concatenate(
            [p.sample(rng, horizon) for p in self.parts] or [np.empty(0)]))


@lru_cache(maxsize=64)
def _mmpp_tables(proc: MMPP, dt: float):
    """An MMPP's f32 constants at slot length ``dt``, made on the host so
    every device gets the same bits: the rates, the cumulative start law,
    ``1 - exp(-dt / dwell[s])`` per state (the single f32 rounding of the
    exact ``exp`` of JAX's f32 quotient, which is what the JAX package's
    ``exp`` gives on these inputs; tests hold it bit for bit), and the
    cyclic successor of each state, or the cumulative rows of ``trans``."""
    f32 = np.float32
    rates = np.asarray(proc.rates, f32)
    cum_start = np.cumsum(np.asarray(proc._start(), f32), dtype=f32)
    x = f32(-dt) / np.asarray(proc.dwells, f32)
    p_switch = f32(1.0) - np.array([math.exp(float(v)) for v in x], f32)
    if proc.trans is None:
        step = (np.arange(proc.n_states) + 1) % proc.n_states
    else:
        step = np.cumsum(np.asarray(proc.trans, f32), axis=1, dtype=f32)
    return rates, cum_start, p_switch, step


# =========================================================================
#                        batch trace generation
# =========================================================================


def n_slots(horizon: float, dt: float) -> int:
    return int(np.ceil(horizon / dt))


def sample_counts_torch(process: ArrivalProcess, key, horizon: float,
                        dt: float, stats: Optional[dict] = None) -> torch.Tensor:
    """Slot-binned traces: per-slot arrival counts via thinning, the twin
    of the JAX package's ``sample_counts_jax``.

    Candidates ~ Poisson(λ_max·dt) per slot, thinned Binomial(·, λ/λ_max)
    against the realized rate path — per slot this is exactly
    Poisson(λ(t)·dt) given the path. ``key`` is a threefry key, or a batch
    of ``B`` keys (one per seed, as ``jax.vmap`` maps the reference over
    seeds); returns int32 ``(n_slots,)`` or ``(B, n_slots)`` counts on the
    key's device. ``stats``, a dict, gets the rejection loops' iteration
    counts added.
    """
    k0, k1 = key
    if k0.dim() == 0:
        return sample_counts_torch(process, (k0[None], k1[None]), horizon, dt,
                                   stats)[0]
    t_grid, lam_max = _slot_constants(process, horizon, dt, k0.device)
    return _thin(process, key, t_grid, lam_max, dt, stats)


def _slot_constants(process: ArrivalProcess, horizon: float, dt: float,
                    device: torch.device):
    """The slot midpoints ``(arange(n) + 0.5) * dt`` in f32 and λ_max."""
    n = n_slots(horizon, dt)
    t_grid = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * dt
    return t_grid, float(process.max_rate(horizon))


def _thin(process, key, t_grid, lam_max, dt, stats):
    """``sample_counts_jax``'s body on a ``(B,)`` batch of keys."""
    k_path, k_cand, k_thin = threefry.split(key, 3)
    rates = process.rate_grid(k_path, t_grid, dt)
    cand = threefry.poisson(k_cand, lam_max * dt, t_grid.shape[0], stats)
    accept_p = torch.clamp(_f32_div(rates, max(lam_max, 1e-12)), 0.0, 1.0)
    counts = threefry.binomial(k_thin, cand.to(torch.float32), accept_p, stats)
    return counts.to(torch.int32)


@lru_cache(maxsize=64)
def _batch_sampler(process: ArrivalProcess, horizon: float, dt: float,
                   device: torch.device):
    """The batch program for ``(process, horizon, dt)`` on ``device``:
    ``run(seeds, stats)`` → counts, with the slot grid on the device and
    λ_max made once (an MMPP's tables are cached by ``_mmpp_tables``)."""
    t_grid, lam_max = _slot_constants(process, horizon, dt, device)

    def run(seeds: torch.Tensor, stats: Optional[dict] = None) -> torch.Tensor:
        return _thin(process, threefry.seed_key(seeds), t_grid, lam_max, dt, stats)

    return run


def batch_sample_counts(process: ArrivalProcess, seeds, horizon: float,
                        dt: float = 60.0, device: DeviceLike = None,
                        stats: Optional[dict] = None) -> np.ndarray:
    """Batched slot-binned traces: (n_seeds, n_slots) int32 arrival counts,
    one tensor program over the seeds on ``device`` (``cuda`` unless asked
    for ``"cpu"``; without a card it raises). Seed ``s`` gives the JAX
    package's ``batch_sample_counts`` row of seed ``s`` (as uint32). The
    program is cached per ``(process, horizon, dt, device)``."""
    dev = resolve_device(device)
    fn = _batch_sampler(process, float(horizon), float(dt), dev)
    seeds = torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1) & 0xFFFFFFFF,
                            device=dev)
    return fn(seeds, stats).cpu().numpy()


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
