"""JAX's default PRNG (threefry2x32, partitionable) as torch ops.

``repro.runtime.serving_jax`` draws its routing probes and revocations from
``jax.random``, and the arrival processes' batch sampler
(``repro.workload.arrivals.sample_counts_jax``) its rate paths, candidate
counts and thinning; every draw there is a pure function of the seed key
and a few integers (the tick, the entry, a sub-key tag, the slot).
Reproducing the same bits here lets the port match the reference draw for
draw. A key is a pair of 32-bit words ``(k0, k1)``; every word is held in
an ``int64`` tensor masked to 32 bits, so sums never overflow and shifts
are logical. A key's words may carry a batch shape (one key per seed):
every function here then works key by key, as ``jax.vmap`` runs it.
``seed_key(s)`` is ``jax.random.PRNGKey(s)`` for a seed in ``[0, 2**32)``:
``(0, s)``.

``poisson`` and ``binomial`` are ``jax.random``'s own algorithms on these
bits, in f32 as JAX runs them (``jax/_src/random.py``: ``_poisson`` and
``_binomial``), with the same key schedule: each loop splits its key once
an iteration and draws a whole row from the sub-key. In the rejection
loops a slot keeps the draw of the last iteration that accepted it, and
a row (one seed, under ``vmap``) loops until each of its slots has
accepted once, so they draw whole rows while any slot of the row is
open; the Knuth and inversion loops are monotone, and draw only the
slots still open. No float op here divides by a Python number: torch on
the card turns ``x / c`` into ``x * (1 / c)``, which rounds differently
from JAX's ``x / c``.

``csrc/serving_fleet.cu`` carries the block function in device code.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]
Shape = Union[int, Sequence[int]]


def _u32(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block of ``jax.random`` on broadcast
    ``int64`` words in ``[0, 2**32)``; returns the two output words."""
    k0, k1 = _u32(k0), _u32(k1)
    x0, x1 = _u32(x0, k0), _u32(x1, k0)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def seed_key(seed, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for seeds in ``[0, 2**32)``: ``(0, seed)``
    (a tensor of seeds gives a batch of keys)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK
    return torch.zeros_like(s), s


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: the block of ``key`` at counter ``(0, data)``."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, _u32(data, k0) & MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` under partitionable threefry: key ``i``
    is the block of ``key`` at counter ``(0, i)``, both words kept. Returns
    ``num`` keys, each with ``key``'s batch shape."""
    k0, k1 = key
    idx = torch.arange(num, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), 0, idx)
    return [(b0[..., i], b1[..., i]) for i in range(num)]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(key: Key, shape: Shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` under partitionable threefry:
    counters ``(hi, lo)`` of the row-major flat index, the two output words
    xored. A batched key (shape ``B``) gives ``B + shape`` bits."""
    k0, k1 = key
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1), idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(k0.shape + shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s map of 32 bits to f32 in ``[0, 1)``: the top
    23 bits as the mantissa of a float in ``[1, 2)``, minus one."""
    word = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0


def uniform(key: Key, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 (minval 0, maxval 1)."""
    return bits_to_uniform(random_bits(key, shape))


def _uniform_at(key: Key, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Entries ``cols`` of the rows ``rows`` of ``uniform(key, (n,))`` for a
    key of shape ``(B,)``: the draws of the slots a loop still holds open."""
    b0, b1 = threefry2x32(key[0][rows], key[1][rows], 0, cols)
    return bits_to_uniform(b0 ^ b1)


def _uniform_rows(key: Key, rows: torch.Tensor, n: int) -> torch.Tensor:
    """Rows ``rows`` of ``uniform(key, (n,))`` for a key of shape ``(B,)``."""
    return uniform((key[0][rows], key[1][rows]), n)


def _count(stats: Optional[dict], name: str, iters: int) -> None:
    if stats is not None:
        stats[name] = stats.get(name, 0) + iters


# --------------------------------------------------------------- poisson


def _poisson_knuth(key: Key, lam: torch.Tensor, stats) -> torch.Tensor:
    """JAX's ``_poisson_knuth`` on ``(B, n)`` rates: multiply uniforms until
    the product falls to ``exp(-lam)``, in log space. A slot stays open
    while ``log_prod > -lam``; every open slot counts one and adds
    ``log(u)``."""
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    rows, cols = torch.nonzero(log_prod > -lam, as_tuple=True)
    iters = 0
    while rows.numel():
        key, sub = split(key)
        k[rows, cols] += 1
        lp = log_prod[rows, cols] + torch.log(_uniform_at(sub, rows, cols))
        log_prod[rows, cols] = lp
        still = lp > -lam[rows, cols]
        rows, cols = rows[still], cols[still]
        iters += 1
    _count(stats, "poisson_knuth", iters)
    return k - 1


def _poisson_rejection(key: Key, lam: torch.Tensor, live: torch.Tensor,
                       stats) -> torch.Tensor:
    """JAX's ``_poisson_rejection`` (Hormann's transformed rejection) on
    ``(B, n)`` rates, for the rows of ``live``. As in JAX, a slot takes the
    draw of the last iteration that accepted it, and a row's loop runs
    until every slot of the row has accepted once (under ``vmap`` a row is
    one seed)."""
    log_lam = torch.log(lam)
    b = 2.53 * torch.sqrt(lam) + 0.931
    a = 0.02483 * b + -0.059
    inv_alpha = torch.div(torch.full_like(b, 1.1328), b - 3.4) + 1.1239
    v_r = 0.9277 - torch.div(torch.full_like(b, 3.6224), b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros_like(lam, dtype=torch.bool)
    rows = live.nonzero().squeeze(1)
    iters = 0
    while rows.numel():
        key, sub0, sub1 = split(key, 3)
        u = _uniform_rows(sub0, rows, lam.shape[1]) - 0.5
        v = _uniform_rows(sub1, rows, lam.shape[1])
        la, aa, bb = lam[rows], a[rows], b[rows]
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor(((2 * aa) / u_shifted + bb) * u + la + 0.43)
        s = torch.log(v * inv_alpha[rows] / (aa / (u_shifted * u_shifted) + bb))
        t = -la + k * log_lam[rows] - torch.lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r[rows])
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out[rows] = torch.where(accept, k, k_out[rows])
        acc = accepted[rows] | accept
        accepted[rows] = acc
        rows = rows[~acc.all(dim=1)]
        iters += 1
    _count(stats, "poisson_rejection", iters)
    return k_out


def poisson(key: Key, lam, n: int, stats: Optional[dict] = None) -> torch.Tensor:
    """``jax.random.poisson(key, lam, (n,))`` as int32, for a key of shape
    ``()`` or ``(B,)``; ``lam`` is a number or a tensor that broadcasts to
    the key's shape plus ``(n,)``. Knuth's method below ``lam = 10``,
    transformed rejection above, 0 where ``lam == 0``. ``stats``, a dict,
    gets each loop's iteration count added."""
    key, lam, squeeze = _batched(key, lam, n)
    use_knuth = torch.isnan(lam) | (lam < 10)
    out = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    if bool(use_knuth.any()):
        lam_knuth = torch.where(use_knuth, lam, torch.full_like(lam, 0.0))
        out = torch.where(use_knuth, _poisson_knuth(key, lam_knuth, stats), out)
    if not bool(use_knuth.all()):
        lam_rej = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
        rej = _poisson_rejection(key, lam_rej, ~use_knuth.all(dim=1), stats)
        out = torch.where(use_knuth, out, rej.to(torch.int32))
    out = torch.where(lam == 0, torch.zeros_like(out), out)
    return out[0] if squeeze else out


def _batched(key: Key, value, n: int):
    """``key`` as a ``(B,)`` batch and ``value`` as f32 ``(B, n)``; whether
    the key came without a batch axis."""
    k0, k1 = key
    squeeze = k0.dim() == 0
    if squeeze:
        k0, k1 = k0[None], k1[None]
    value = torch.as_tensor(value, dtype=torch.float32, device=k0.device)
    return (k0, k1), value.expand(k0.shape[0], n).contiguous(), squeeze


# -------------------------------------------------------------- binomial


_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                  0.00833056343336287)


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """JAX's ``_stirling_approx_tail``: the table below 10, else the series
    at ``k`` clamped to ``[0, 9]`` (JAX clamps before the series, so every
    ``k > 9`` gets the series at 9)."""
    table = torch.tensor(_STIRLING_TAIL, dtype=torch.float32, device=k.device)
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    inner = torch.full_like(k, 1.0 / 360) - torch.div(torch.full_like(k, 1.0 / 1260), kp1sq)
    approx = torch.div(torch.full_like(k, 1.0 / 12) - torch.div(inner, kp1sq), k + 1)
    return torch.where(use_table, table[torch.floor(k).to(torch.int64)], approx)


def _binomial_inversion(key: Key, count: torch.Tensor, prob: torch.Tensor,
                        live: torch.Tensor, stats) -> torch.Tensor:
    """JAX's ``_binomial_inversion`` on ``(B, n)`` counts and
    probabilities: count geometric gaps until their sum passes ``count``.
    A slot stays open while ``geom_sum <= count``."""
    log1mp = torch.log1p(-prob)
    num_geom = torch.zeros_like(prob)
    geom_sum = torch.zeros_like(prob)
    rows, cols = torch.nonzero(live & (geom_sum <= count), as_tuple=True)
    iters = 0
    while rows.numel():
        sub, key = split(key)
        num_geom[rows, cols] += 1
        u = _uniform_at(sub, rows, cols)
        gs = geom_sum[rows, cols] + torch.ceil(torch.log(u) / log1mp[rows, cols])
        geom_sum[rows, cols] = gs
        still = gs <= count[rows, cols]
        rows, cols = rows[still], cols[still]
        iters += 1
    _count(stats, "binomial_inversion", iters)
    return num_geom - 1


def _btrs(key: Key, count: torch.Tensor, prob: torch.Tensor, live: torch.Tensor,
          stats) -> torch.Tensor:
    """JAX's ``_btrs`` (Hormann's transformed rejection for the binomial)
    on ``(B, n)`` counts and probabilities, for the rows of ``live``, with
    :func:`_poisson_rejection`'s loop: last accepting draw, a row runs
    until each of its slots has accepted once."""
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 2.53 * stddev + 1.15
    a = 0.0248 * b + -0.0873 + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - torch.div(torch.full_like(b, 4.2), b)
    r = prob / (1 - prob)
    alpha = (torch.div(torch.full_like(b, 5.1), b) + 2.83) * stddev
    m = torch.floor((count + 1) * prob)
    ub_m = (m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
    st_m, st_nm = _stirling_approx_tail(m), _stirling_approx_tail(count - m)
    k_out = torch.full_like(prob, -1.0)
    accepted = torch.zeros_like(prob, dtype=torch.bool)
    rows = live.nonzero().squeeze(1)
    iters = 0
    while rows.numel():
        key, sub0, sub1 = split(key, 3)
        u = _uniform_rows(sub0, rows, prob.shape[1])
        v = _uniform_rows(sub1, rows, prob.shape[1])
        aa, bb, n_, mm, rr = a[rows], b[rows], count[rows], m[rows], r[rows]
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r[rows])
        k = torch.floor(((2 * aa) / us + bb) * u + c[rows])
        reject = (k < 0) | (k > n_)
        v = torch.log(v * alpha[rows] / (aa / (us * us) + bb))
        ub = (ub_m[rows]
              + (n_ + 1) * torch.log((n_ - mm + 1) / (n_ - k + 1))
              + (k + 0.5) * torch.log(rr * (n_ - k + 1) / (k + 1))
              + st_m[rows]
              + st_nm[rows]
              - _stirling_approx_tail(k)
              - _stirling_approx_tail(n_ - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out[rows] = torch.where(accept, k, k_out[rows])
        acc = accepted[rows] | accept
        accepted[rows] = acc
        rows = rows[~acc.all(dim=1)]
        iters += 1
    _count(stats, "binomial_btrs", iters)
    return k_out


def binomial(key: Key, count, prob, stats: Optional[dict] = None) -> torch.Tensor:
    """``jax.random.binomial(key, count, prob)`` in f32 for a key of shape
    ``()`` or ``(B,)`` and f32 ``count``/``prob`` of the key's shape plus
    ``(n,)`` (or broadcasting to it): inversion where ``count * q <= 10``
    and BTRS elsewhere, on ``q = min(p, 1 - p)`` with the draw flipped to
    ``count - k`` where ``p >= 0.5``; NaN for a NaN or negative count or
    a NaN or negative ``q``, inf for an infinite count. ``stats`` as in
    :func:`poisson`."""
    count = torch.as_tensor(count, dtype=torch.float32, device=key[0].device)
    prob = torch.as_tensor(prob, dtype=torch.float32, device=key[0].device)
    count, prob = torch.broadcast_tensors(count, prob)
    key, count, squeeze = _batched(key, count, count.shape[-1])
    prob = prob.expand_as(count).contiguous()
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inversion, count, torch.full_like(count, 0.0))
    count_btrs = torch.where(use_inversion, torch.full_like(count, 1e4), count)
    q_btrs = torch.where(use_inversion, torch.full_like(q, 0.5), q)
    samples = torch.zeros_like(q)
    if bool(use_inversion.any()):
        samples = torch.where(use_inversion, _binomial_inversion(
            key, count_inv, q, use_inversion, stats), samples)
    if not bool(use_inversion.all()):
        samples = torch.where(use_inversion, samples, _btrs(
            key, count_btrs, q_btrs, ~use_inversion.all(dim=1), stats))
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.full_like(samples, math.nan), samples)
    samples = torch.where(count_inf & ~invalid, torch.full_like(samples, math.inf), samples)
    samples = torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf,
                          samples, count - samples)
    return samples[0] if squeeze else samples
