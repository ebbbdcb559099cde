"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and makes the run's requests, their token ids
from ``--seed``.

A cell's requests follow one schedule of arrivals and lengths, whatever
the seed, so that runs with different seeds differ no more than two runs
of one seed; the seed draws the token ids (and the weights, and the
requests checked). A tail of first-token times is set by the few requests
that wait longest, and which lengths come just before them moves it: an
order of the same lengths drawn from the seed spread it far more than the
host's noise does.

* open loop: arrivals are one realisation of a Poisson process whose rate
  follows a fixed cycle of phases (``[start_s, end_s, multiple of
  rate_rps]``), conditioned on its counts: each phase of each cycle holds
  ``rate * multiple * length`` arrivals, placed uniformly at random inside
  it. Cycles are aligned to the window's start, so every window holds the
  same bursts. Each phase's requests take that many quantiles of each
  length distribution, once each, in one order drawn for the mix (prompt
  and output lengths apart);
* steady Poisson (``"loop": "poisson"``, what ``sweep.py`` offers): arrivals
  of a Poisson process at ``rate_rps``, drawn from the seed, with the
  lengths as one phase of the open loop;
* closed loop: ``clients`` clients each send their next request as soon as
  the last one finished (``think_s`` 0), starting staggered over the
  lead-in; each block of ``block`` consecutive requests holds the block's
  quantiles of each length distribution in one order drawn for the mix;
* token ids are uniform over the vocabulary, drawn from the seed.

Requests due before 0 s belong to the lead-in: they are served, and not
counted.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

PROMPTS, OUTPUTS, TOKENS = 2, 3, 4  # independent streams of a seed
ARRIVALS = 0  # the open loop's arrival times: one stream, whatever the seed
SCHEDULE = 0  # the seed of a cell's schedule (arrivals, length orders), whatever the run's
PROMPT_BUCKET = 16  # the batcher's default first prefill bucket, left in force


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@dataclass
class Planned:
    rid: int
    prompt_len: int
    max_new: int
    due: Optional[float] = None  # open loop: seconds from the window's start
    client: Optional[int] = None  # closed loop


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def quantiles(lo: int, hi: int, dist: str, n: int) -> np.ndarray:
    """The distribution's quantiles (i + 0.5) / n, i < n, as lengths."""
    u = (np.arange(n) + 0.5) / n
    if dist == "loguniform":
        q = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif dist == "uniform":
        q = lo + u * (hi - lo)
    else:
        raise ValueError(f"length distribution {dist!r}")
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


def lengths(t: dict, sizes, seed: int):
    """Prompt and output lengths of consecutive groups of ``sizes``
    requests: each group holds its size's quantiles once, in an order
    drawn from the seed."""
    rp, ro = _rng(seed, PROMPTS), _rng(seed, OUTPUTS)
    out = [], []
    for n in sizes:
        out[0].append(quantiles(*t["prompt_tokens"], t["prompt_dist"], n)[rp.permutation(n)])
        out[1].append(quantiles(*t["output_tokens"], t["output_dist"], n)[ro.permutation(n)])
    return np.concatenate(out[0]), np.concatenate(out[1])


def open_arrivals(t: dict, start: float, end: float) -> list:
    """Sorted arrival times in [start, end) of the mix's cycle of phases,
    one array a phase."""
    rng = _rng(SCHEDULE, ARRIVALS)
    cycle = float(t["cycle_s"])
    times = []
    k = int(np.floor(start / cycle))
    while k * cycle < end:
        for p0, p1, mult in t["phases"]:
            a, b = k * cycle + p0, k * cycle + p1
            lo, hi = max(a, start), min(b, end)
            if hi <= lo:
                continue
            n = int(round(t["rate_rps"] * mult * (hi - lo)))
            if n:
                times.append(np.sort(lo + rng.random(n) * (hi - lo)))
        k += 1
    return times


def plan(t: dict, seed: int, seconds: float, extra_s: float = 0.0) -> List[Planned]:
    """The run's requests in the order they are sent: open loop over
    [-lead_in_s, seconds + extra_s), closed loop enough for the clients."""
    lead = float(t["lead_in_s"])
    if t["loop"] == "open":
        phases = open_arrivals(t, -lead, seconds + extra_s)
        due = np.concatenate(phases)
        plens, outs = lengths(t, [len(p) for p in phases], SCHEDULE)
    elif t["loop"] == "poisson":
        rate, span = float(t["rate_rps"]), lead + seconds + extra_s
        gaps = _rng(seed, ARRIVALS).exponential(1.0 / rate, size=int(10 + 2 * rate * span))
        due = -lead + np.cumsum(gaps)
        due = due[due < seconds + extra_s]
        plens, outs = lengths(t, [len(due)], seed)
    elif t["loop"] == "closed":
        n, block = int(t["requests"]), int(t["block"])
        due = None
        plens, outs = lengths(t, [block] * -(-n // block), SCHEDULE)
    else:
        raise ValueError(f"loop {t['loop']!r}")
    reqs = []
    for i in range(len(due) if due is not None else int(t["requests"])):
        r = Planned(i, int(plens[i]), int(outs[i]))
        if due is not None:
            r.due = float(due[i])
        else:
            r.client = i % int(t["clients"])
        reqs.append(r)
    return reqs


def closed_start(t: dict, client: int) -> float:
    """When a closed-loop client sends its first request (lead-in)."""
    lead = float(t["lead_in_s"])
    return -lead + lead * client / int(t["clients"])


def prompts(reqs: List[Planned], vocab: int, seed: int) -> List[np.ndarray]:
    """Every request's prompt, token ids uniform over [1, vocab)."""
    rng = _rng(seed, TOKENS)
    flat = rng.integers(1, vocab, size=sum(r.prompt_len for r in reqs), dtype=np.int32)
    out, i = [], 0
    for r in reqs:
        out.append(flat[i:i + r.prompt_len])
        i += r.prompt_len
    return out


def bucket_for(plen: int, t: dict) -> int:
    """The prefill bucket of a prompt: the batcher doubles its first bucket
    until the prompt fits, capped at ``max_len``."""
    b = PROMPT_BUCKET
    while b < plen:
        b *= 2
    return min(b, int(t["max_len"]))
