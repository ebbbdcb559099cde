"""The port's slot-binned batch sampler (``repro_torch.workload.arrivals``)
against the JAX package's (``repro.workload.arrivals``) on the CPU.

The port draws through ``repro_torch.runtime.threefry``, JAX's partitionable
threefry2x32 and ``jax.random``'s own Poisson and binomial algorithms in
f32, so the draws are the reference's: ``split`` and shaped ``uniform`` bit
for bit; the rate grids bit for bit where no transcendental function is
applied per slot (Poisson, MMPP, FlashCrowd, Superpose of those) and to rtol
1e-6 where ``sin`` is (Diurnal, Modulated); Poisson, binomial and slot
counts on at least 99.9% of entries, since a last-bit difference of
``log``/``lgamma`` between XLA's CPU lowering and torch may flip a
rejection test (each mismatch count is in the assertion message). The
reference's own statistical checks are repeated on the port.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.workload.arrivals as ra
from repro.workload import builders as rb
from repro.workload import jobmix as rj
from test_workload import HORIZON, PROCESSES

import repro_torch.workload.arrivals as ta
from repro_torch.runtime import threefry
from repro_torch.workload import batch_sample_counts, sample_counts_torch, slot_counts

MIN_MATCH = 0.999           # share of draws and counts equal to the reference's
RATE_RTOL = 1e-6            # Diurnal and Modulated grids
SIN_PROCESSES = ("diurnal", "modulated")
SEEDS = np.arange(16)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread: the rejection loops are
    many small eager ops, and with other test processes on every core
    torch's intra-op pool waits at each op for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(proc):
    """The port's twin of a reference process (same class name and fields)."""
    if isinstance(proc, ra.Superpose):
        return ta.Superpose(parts=tuple(port(p) for p in proc.parts))
    if isinstance(proc, ra.Modulated):
        return ta.Modulated(base=port(proc.base), envelope=port(proc.envelope))
    fields = {f.name: getattr(proc, f.name) for f in dataclasses.fields(proc)}
    return getattr(ta, type(proc).__name__)(**fields)


def yahoo_process():
    mix = rj.TwoClassLognormalMix()
    return rb.yahoo_arrivals(rb.yahoo_rate(4000, 80, 24 * 3600.0, 0.97, 0.65, mix))


#: PROCESSES, plus fig1's google process and the yahoo process at
#: yahoo_like's default rate (4000 servers, 80 short)
CATALOG = {**PROCESSES, "google": rb.google_arrivals(), "yahoo": yahoo_process()}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _keys(seeds):
    return threefry.seed_key(torch.as_tensor(np.asarray(seeds, np.int64)))


def _misses(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return int((got != want).sum())


# ------------------------------------------------------------ threefry

@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_jax_on_single_and_batched_keys(num):
    seeds = np.array([0, 1, 7, 123456789, 2**32 - 1], np.uint32)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.split(
        jax.random.PRNGKey(int(s)), num))) for s in seeds])             # (S, num, 2)
    got = threefry.split(_keys(seeds), num)
    for i in range(num):
        assert np.array_equal(got[i][0].numpy(), want[:, i, 0])
        assert np.array_equal(got[i][1].numpy(), want[:, i, 1])
    one = threefry.split(threefry.seed_key(int(seeds[3])), num)
    assert [(int(a), int(b)) for a, b in one] == [tuple(map(int, w)) for w in want[3]]
    # a split of a split: the keys the samplers' loops chain
    k2 = jax.random.split(jax.random.split(jax.random.PRNGKey(9))[1], num)
    t2 = threefry.split(threefry.split(threefry.seed_key(9))[1], num)
    assert [(int(a), int(b)) for a, b in t2] == \
        [tuple(map(int, w)) for w in np.asarray(jax.random.key_data(k2))]


@pytest.mark.parametrize("shape", [(), (5,), (7, 3), (2, 3, 4), (1440, 2)])
def test_shaped_uniform_matches_jax_on_single_and_batched_keys(shape):
    seeds = np.array([3, 11, 2**31 + 5], np.uint32)
    want = np.stack([np.asarray(jax.random.uniform(jax.random.PRNGKey(int(s)), shape))
                     for s in seeds])
    got = threefry.uniform(_keys(seeds), shape).numpy()
    assert got.shape == (len(seeds),) + shape
    assert np.array_equal(_bits(got), _bits(want))
    single = threefry.uniform(threefry.seed_key(11), shape).numpy()
    assert np.array_equal(_bits(single), _bits(want[1]))


@pytest.mark.parametrize("batched", [False, True], ids=["one_key", "four_keys"])
@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0, 9.99, 10.0, 87.46, 1000.0])
def test_poisson_matches_jax(lam, batched):
    """Knuth below 10, transformed rejection from 10 on, 0 at 0: 4,096
    draws, one key or four keys of 1,024 (``jax.vmap``: each key's loop
    runs until its own row has accepted)."""
    if batched:
        seeds = np.array([5, 6, 7, 8], np.uint32)
        want = np.asarray(jax.vmap(lambda k: jax.random.poisson(k, lam, (1024,)))(
            jax.vmap(jax.random.PRNGKey)(seeds)))
        stats = {}
        got = threefry.poisson(_keys(seeds), lam, 1024, stats).numpy()
    else:
        want = np.asarray(jax.random.poisson(jax.random.PRNGKey(3), lam, (4096,)))
        stats = {}
        got = threefry.poisson(threefry.seed_key(3), lam, 4096, stats).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    miss = _misses(got, want)
    assert miss <= (1 - MIN_MATCH) * want.size, f"{miss} of {want.size} draws differ"
    branch = "poisson_knuth" if lam < 10 else "poisson_rejection"
    assert (lam == 0) or stats[branch] > 0, stats
    if lam > 0:
        assert abs(got.mean() - lam) < 5 * math.sqrt(lam / got.size)


#: (count, p): both sides of count * q = 10 and of p = 0.5
BINOMIAL_CASES = [(20, 0.3), (50, 0.3), (20, 0.7), (50, 0.7), (300, 0.04), (1000, 0.5),
                  (87, 0.2), (40, 1.0), (0, 0.4)]


@pytest.mark.parametrize("count,p", BINOMIAL_CASES)
def test_binomial_matches_jax(count, p):
    """Inversion where count * q <= 10, BTRS elsewhere, flipped for p >= 0.5:
    4,096 draws of jittered counts and probabilities around ``(count, p)``
    (so a case also straddles its branch boundary), one key and four."""
    rng = np.random.default_rng(count * 100 + int(p * 100))
    n = rng.poisson(count, 4096).astype(np.float32)
    q = np.clip(rng.normal(p, 0.03, 4096), 0.0, 1.0).astype(np.float32)
    want = np.asarray(jax.random.binomial(jax.random.PRNGKey(11), n, q))
    got = threefry.binomial(threefry.seed_key(11), torch.from_numpy(n),
                            torch.from_numpy(q)).numpy()
    miss = _misses(got, want)
    assert miss <= (1 - MIN_MATCH) * want.size, f"{miss} of {want.size} draws differ"
    seeds = np.array([1, 2, 3, 4], np.uint32)
    want4 = np.asarray(jax.vmap(lambda k, a, b: jax.random.binomial(k, a, b))(
        jax.vmap(jax.random.PRNGKey)(seeds), n.reshape(4, 1024), q.reshape(4, 1024)))
    got4 = threefry.binomial(_keys(seeds), torch.from_numpy(n.reshape(4, 1024)),
                             torch.from_numpy(q.reshape(4, 1024))).numpy()
    miss = _misses(got4, want4)
    assert miss <= (1 - MIN_MATCH) * want4.size, f"{miss} of {want4.size} draws differ"
    assert ((got >= 0) & (got <= n)).all()


# ------------------------------------------------------------ rate grids

def _jax_switch_probs(proc, dt):
    """The reference's ``1 - exp(-dt / dwells[s])`` as its scan computes it
    (a traced state index)."""
    dwells = jnp.asarray(proc.dwells, jnp.float32)
    fn = jax.jit(jax.vmap(lambda s: 1.0 - jnp.exp(-dt / dwells[s])))
    return np.asarray(fn(jnp.arange(proc.n_states)))


def _mmpps():
    out = {}
    for name, proc in CATALOG.items():
        for p in (proc,) + getattr(proc, "parts", ()) + tuple(
                getattr(proc, a) for a in ("base", "envelope") if hasattr(proc, a)):
            if isinstance(p, ra.MMPP):
                out[f"{name}/{len(out)}"] = p
    return out


@pytest.mark.parametrize("dt", [60.0, 600.0])
def test_mmpp_switch_probabilities_are_the_reference_bits(dt):
    mmpps = _mmpps()
    assert len(mmpps) >= 5
    for name, proc in mmpps.items():
        rates, cum_start, p_switch, _ = ta._mmpp_tables(port(proc), dt)
        assert np.array_equal(_bits(p_switch), _bits(_jax_switch_probs(proc, dt))), name
        assert np.array_equal(_bits(cum_start), _bits(np.asarray(
            jnp.cumsum(jnp.asarray(proc._start(), jnp.float32))))), name
        assert np.array_equal(_bits(rates), _bits(np.asarray(proc.rates, np.float32)))


@pytest.mark.parametrize("dt", [60.0, 600.0])
@pytest.mark.parametrize("name", sorted(CATALOG))
def test_rate_grid_matches_reference(name, dt):
    proc = CATALOG[name]
    n = ra.n_slots(HORIZON, dt)
    t_ref = (jnp.arange(n, dtype=jnp.float32) + 0.5) * dt
    want = np.stack([np.asarray(proc.rate_grid(jax.random.PRNGKey(int(s)), t_ref, dt))
                     for s in SEEDS])
    t_grid = (torch.arange(n, dtype=torch.float32) + 0.5) * dt
    got = port(proc).rate_grid(_keys(SEEDS), t_grid, dt)
    assert got.dtype == torch.float32 and got.device == t_grid.device
    got = got.numpy()
    if name in SIN_PROCESSES:
        np.testing.assert_allclose(got, want, rtol=RATE_RTOL, atol=0)
    else:
        assert np.array_equal(_bits(got), _bits(want)), \
            f"{int((_bits(got) != _bits(want)).sum())} of {want.size} rates differ"


# ------------------------------------------------------------ the sampler

#: seeds a process's counts are compared on, and the slot lengths. 99.9% of
#: PROCESSES' 16 x 48 entries allows no miss at all; fig1's processes take
#: the rejection branch with lam_max * dt = 874 at dt = 600 (google), where
#: one f32 ulp of lgamma(k + 1) is 4.9e-4 and decides a test now and then,
#: so they are compared on 64 seeds at dt = 600 and 16 at dt = 60
COUNT_RUNS = {"google": ((64, 600.0), (16, 60.0)), "yahoo": ((64, 600.0), (16, 60.0))}


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_batch_sample_counts_matches_reference(name):
    """16 seeds, 8 h at dt = 600 (48 slots), as the reference's own sampler
    tests run; the fig1 processes as ``COUNT_RUNS`` says."""
    proc, tproc = CATALOG[name], port(CATALOG[name])
    for n_seeds, dt in COUNT_RUNS.get(name, ((16, 600.0),)):
        seeds = np.arange(n_seeds)
        want = ra.batch_sample_counts(proc, seeds, HORIZON, dt=dt)
        stats = {}
        got = batch_sample_counts(tproc, seeds, HORIZON, dt=dt, device="cpu", stats=stats)
        assert got.dtype == np.int32 and got.shape == (n_seeds, ra.n_slots(HORIZON, dt))
        miss = _misses(got, want)
        assert miss <= (1 - MIN_MATCH) * want.size, \
            f"dt={dt}: {miss} of {want.size} counts differ"
        assert stats and all(v > 0 for v in stats.values()), stats


def test_sample_counts_single_key_and_reference_entry_point():
    proc = CATALOG["mmpp_trans"]
    want = np.asarray(ra.sample_counts_jax(proc, jax.random.PRNGKey(5), HORIZON, 600.0))
    got = sample_counts_torch(port(proc), threefry.seed_key(5), HORIZON, 600.0)
    assert got.dtype == torch.int32 and got.shape == (48,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["mmpp3", "flash", "modulated", "superpose"])
def test_sampler_is_deterministic_and_rows_independent(name):
    proc = port(CATALOG[name])
    seeds = np.arange(8)
    batch = batch_sample_counts(proc, seeds, HORIZON, dt=600.0, device="cpu")
    assert np.array_equal(batch, batch_sample_counts(proc, seeds, HORIZON, dt=600.0,
                                                     device="cpu"))
    alone = batch_sample_counts(proc, [3], HORIZON, dt=600.0, device="cpu")
    assert np.array_equal(alone[0], batch[3])
    order = np.array([5, 0, 7, 2])
    assert np.array_equal(batch_sample_counts(proc, order, HORIZON, dt=600.0,
                                              device="cpu"), batch[order])
    assert not np.array_equal(batch[0], batch[1])


def test_batch_sample_counts_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_sample_counts(port(CATALOG["poisson"]), SEEDS, HORIZON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_sample_counts(port(CATALOG["poisson"]), SEEDS, HORIZON, device="cuda")


# -------------------------------------- the reference's statistical checks

@pytest.mark.parametrize("name",
                         ["poisson", "mmpp2", "diurnal", "flash_pinned",
                          "modulated"])
def test_sampler_matches_serial_slot_rates(name):
    """tests/test_workload.py's check on the port: the batch sampler's mean
    slot rate within 20% of the exact serial sampler's."""
    proc = port(CATALOG[name])
    dt = 600.0
    batch = batch_sample_counts(proc, SEEDS, HORIZON, dt=dt, device="cpu")
    assert batch.shape == (16, int(np.ceil(HORIZON / dt)))
    serial = np.stack([slot_counts(proc.sample(int(s), HORIZON), HORIZON, dt)
                       for s in SEEDS])
    rate_batch = batch.mean() / dt
    rate_serial = serial.mean() / dt
    assert abs(rate_batch - rate_serial) / rate_serial < 0.2, (rate_batch, rate_serial)


def test_sampler_tracks_deterministic_rate_profile():
    proc = port(CATALOG["diurnal"])
    dt = 600.0
    batch = batch_sample_counts(proc, np.arange(48), HORIZON, dt=dt, device="cpu")
    mean_counts = batch.mean(axis=0)
    t = (np.arange(mean_counts.size) + 0.5) * dt
    lam = proc.realize_rate(np.random.default_rng(0), HORIZON)(t) * dt
    corr = np.corrcoef(mean_counts, lam)[0, 1]
    assert corr > 0.9, corr
