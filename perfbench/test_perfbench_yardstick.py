"""The frozen yardstick against hand-worked numbers (the kernel table of
PERF.md) and against plain counts; never against the program's own cost
formulas, which later changes may alter."""

import json
import pathlib
import statistics

import numpy as np
import pytest

from perfbench import yardstick as Y

HERE = pathlib.Path(__file__).resolve().parent


def test_b1_bound_hand_worked():
    # B=4 H=24 KV=2 P=256 bs=16 hd=128 bf16 pool, 6,732 visible keys:
    # K and V 2*6732*2*128*2 B, q and o 2*4*24*128*2, page table 4*256*4,
    # f32 bias 4*4096*4: 7,012,352 B over 3.35 TB/s
    ms = 1e3 * Y.paged_decode_bound_s([1683] * 4, 24, 2, 128, cache_len=4096)
    assert round(ms, 5) == 0.00209
    assert ms == pytest.approx(7_012_352 / 3.35e12 * 1e3, rel=1e-12)


def test_b2_bound_hand_worked():
    # B=1 H=24 KV=2 S=4608 hd=128 window 4096: 10,487,808 visible pairs,
    # 4*24*128 flops each over 989 TFLOP/s (operations bound)
    assert Y.visible_pairs(4608, 4096) == 4096 * 4097 // 2 + 512 * 4096 == 10_487_808
    ms = 1e3 * Y.flash_attention_bound_s(4608, 24, 2, 128, window=4096)
    assert round(ms, 4) == 0.1303


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (7, 3), (40, 16), (16, 16), (5, 9)])
def test_visible_pairs_brute_force(S, window):
    n = sum(1 for q in range(S) for k in range(S)
            if k <= q and (window == 0 or q - k < window))
    assert Y.visible_pairs(S, window) == n
    assert sum(Y.decode_visible(p, window) for p in range(S)) == n


def test_model_flops_hand_worked():
    m = json.loads((HERE / "configs" / "starcoder2-3b.json").read_text())["model"]
    # per layer: attention 3072*(24+2*2)*128 + 24*128*3072, GeLU MLP 2*3072*12288
    assert Y.layer_matmul_params(m) == 95_944_704
    # the 8192-token prefill: 30 layers of products and B2's pairs, one
    # token's unembedding; PERF.md's counted step read 5.6437e13
    flops = Y.prefill_flops(m, 8192)
    assert flops == 30 * (2 * 8192 * 95_944_704 + 12288 * 25_167_872) + 2 * 3072 * 49152
    assert flops == pytest.approx(5.6437e13, rel=1e-3)
    assert Y.decode_flops(m, [4095, 5000]) == (
        2 * (30 * 2 * 95_944_704 + 2 * 3072 * 49152) + 30 * 12288 * (4096 + 4096))
    x = json.loads((HERE / "configs" / "mixtral-8x22b-8of56.json").read_text())["model"]
    # two of eight SwiGLU experts and the router
    assert Y.layer_matmul_params(x) == (6144 * 64 * 128 + 48 * 128 * 6144
                                        + 2 * 3 * 6144 * 16384 + 6144 * 8)


def test_statistics():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=201))
    for q in (50, 95, 99):
        assert Y.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert Y.spread(xs) == (q3 - q1) / q2
    assert Y.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert Y.union_seconds([(0, 2), (1, 3), (5, 6)], lo=1.5, hi=5.5) == 2.0
