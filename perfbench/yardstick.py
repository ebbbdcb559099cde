"""The benchmark's frozen yardstick: the H100's published peaks, the bounds
of the two attention kernels the served path launches, the model FLOPs of a
prefill and of a decode step, the statistics of a run, and the lengths of
unions of intervals (a trace's device time).

Everything here counts only what the traffic needs: the true prompt length
(not the padded bucket) and the keys each active slot can see (not every
position a page table names). A kernel or a step that does less padding
work therefore reads closer to 100%, never above it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit.
"""

from __future__ import annotations

import bisect
import math
import statistics
from typing import Iterable, List, Optional, Sequence

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------- attention


def visible_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of causal self-attention over S positions, keys
    limited to the last ``window`` positions when ``window`` > 0."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def decode_visible(pos: int, window: int = 0) -> int:
    """Keys a decode query at absolute position ``pos`` sees (itself
    included)."""
    return pos + 1 if window <= 0 else min(pos + 1, window)


def flash_attention_bound_s(S: int, H: int, KV: int, hd: int, window: int = 0,
                            elem: int = 2) -> float:
    """B2 (prefill attention, batch 1) at true length S: the larger of its
    operations (4 a head and head element for each visible pair) over the
    bf16 peak and its bytes (q, k, v read once, o written once) over the
    memory rate."""
    flops = 4.0 * H * hd * visible_pairs(S, window)
    nbytes = elem * S * hd * (2 * H + 2 * KV)
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def paged_decode_bound_s(visible: Sequence[int], H: int, KV: int, hd: int,
                         cache_len: int, block_size: int = 16, elem: int = 2) -> float:
    """B1 (paged decode attention) over the active slots, ``visible[i]``
    keys each, in a layer whose cache holds ``cache_len`` positions a slot:
    operations 4 a head and head element a key; bytes each visible key's K
    and V row, and each active slot's q, output, f32 bias row (one entry a
    position) and int32 page-table row (one entry a block) once."""
    keys = sum(visible)
    B = len(visible)
    flops = 4.0 * H * hd * keys
    nbytes = (2 * keys * KV * hd * elem + 2 * B * H * hd * elem
              + B * (cache_len // block_size) * 4 + B * cache_len * 4)
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------- model FLOPs


def layer_matmul_params(m: dict) -> float:
    """Weights a token multiplies through in one layer: attention's four
    projections, and the MLP, or the router and the top-k experts."""
    d, H, KV, hd, ff = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                        m["head_dim"], m["d_ff"])
    attn = d * (H + 2 * KV) * hd + H * hd * d
    gated = m.get("mlp_type", "swiglu") in ("swiglu", "geglu")
    ffn = (3 if gated else 2) * d * ff
    if m.get("num_experts", 0) and m.get("moe_period", 0) == 1:
        ffn = m["experts_per_token"] * ffn + d * m["num_experts"]
    elif m.get("num_experts", 0):
        raise ValueError("model FLOPs count MoE on every layer (moe_period 1) only")
    return float(attn + ffn)


def cache_len(m: dict, max_len: int) -> int:
    """Positions a slot's cache holds in each layer: the window, where a
    local layer's window is shorter than ``max_len``."""
    w = _window(m)
    return w if 0 < w < max_len else max_len


def _window(m: dict) -> int:
    pattern = tuple(m.get("attn_pattern", ("global",)))
    if pattern != ("local",) and pattern != ("global",):
        raise ValueError(f"model FLOPs take one attention kind, got {pattern}")
    return m.get("window_size", 0) if pattern == ("local",) else 0


def prefill_flops(m: dict, P: int) -> float:
    """A prefill of a true prompt of P tokens: every token through every
    layer's products and attention over its visible pairs, and the last
    token through the unembedding (the only logits a prefill returns)."""
    L = m["num_layers"]
    attn = 4.0 * m["num_heads"] * m["head_dim"] * visible_pairs(P, _window(m))
    return L * (2.0 * P * layer_matmul_params(m) + attn) \
        + 2.0 * m["d_model"] * m["vocab_size"]


def decode_flops(m: dict, positions: Iterable[int]) -> float:
    """A decode step of the active slots at absolute ``positions``: one
    token each through every layer, attention over its visible keys, and
    the unembedding."""
    positions = list(positions)
    L, w = m["num_layers"], _window(m)
    keys = sum(decode_visible(p, w) for p in positions)
    per_tok = L * 2.0 * layer_matmul_params(m) + 2.0 * m["d_model"] * m["vocab_size"]
    return len(positions) * per_tok + L * 4.0 * m["num_heads"] * m["head_dim"] * keys


# ---------------------------------------------------------------- statistics


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linearly interpolated
    between the two nearest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = (len(xs) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_seconds(intervals: List[tuple], lo: Optional[float] = None,
                  hi: Optional[float] = None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: List[tuple]) -> List[List[float]]:
    """The union of (start, end) intervals as disjoint [start, end] pairs,
    in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(union: List[List[float]], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the disjoint, ordered pairs ``union``
    (``merged``'s) cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(union, [lo, math.inf]) - 1)
    while i < len(union) and union[i][0] < hi:
        total += max(0.0, min(hi, union[i][1]) - max(lo, union[i][0]))
        i += 1
    return total
