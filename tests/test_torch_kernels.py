"""Port kernels, CPU side: the plain PyTorch versions of the hand-written CUDA
kernels against the reference's jnp oracles (``ref.py``) and its Pallas
kernels in interpret mode, at the reference's tolerance (atol 2e-5, f32).
Also the guards that keep the port standing alone: no import of JAX or of
the reference package, device dispatch without fallback, and the ctypes
parameter structs mirroring the CUDA sources field for field.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import ctypes
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_fwd as j_decode_kernel,
    paged_decode_attention_fwd as j_paged_kernel)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref,
    paged_decode_attention_ref as j_paged_ref)
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_fwd as j_flash_kernel)
from repro.kernels.flash_attention.ref import attention_ref as j_flash_ref  # noqa: E402
from repro.optim.compress import quantize_int8 as j_quantize  # noqa: E402
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    SPLIT_ALIGN, DecodeParams, decode_attention_fwd, dense_params,
    paged_decode_attention_fwd, paged_params, plan, split_plan)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine, decode_attention_ref, merge_stats, split_partials)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    FlashParams, _tma_strides, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as rwkv_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: E402
    Rwkv6BwdParams, Rwkv6Params, rwkv6_scan_bwd, rwkv6_scan_fwd)
from repro_torch.kernels.rwkv6_scan.ref import CHECKPOINT  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.kernel import (  # noqa: E402
    CHANNELS_PER_CTA, LANES_PER_CHANNEL, SsmBwdParams, SsmParams, ssm_scan_bwd,
    ssm_scan_fwd)
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402
from repro_torch.optim.compress import dequantize_int8, quantize_int8  # noqa: E402

NEG_INF = -2.3819763e38
ATOL = 2e-5
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(torch_out, *jax_outs, atol=ATOL):
    for ref in jax_outs:
        np.testing.assert_allclose(torch_out.float().numpy(),
                                   np.asarray(ref, np.float32), atol=atol,
                                   rtol=atol)


# ---------------------------------------------------------------- flash (B2)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(window=32),
    dict(softcap=30.0),
    dict(prefix_len=24),
    dict(q_offset=16),
    dict(window=48, softcap=20.0),
], ids=["causal", "window", "softcap", "prefix", "q_offset", "window_softcap"])
@pytest.mark.parametrize("H,KV,hd", [(4, 2, 32), (4, 4, 64), (8, 1, 32)],
                         ids=["gqa", "mha", "mqa"])
def test_flash_plain_matches_reference(kw, H, KV, hd):
    rng = np.random.default_rng(1)
    B, S = 2, 128
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    reset_counts()
    o = flash_attention(_t(q), _t(k), _t(v), causal=True, **kw)
    assert PLAIN_CALLS["flash_attention"] == 1 and LAUNCHES["flash_attention"] == 0
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_ref = j_flash_ref(jq, jk, jv, causal=True, **kw)
    o_pallas = j_flash_kernel(jq, jk, jv, causal=True, block_q=64, block_k=64,
                              interpret=True, **kw)
    _close(o, o_ref, o_pallas)


def test_flash_plain_bf16_matches_reference():
    rng = np.random.default_rng(2)
    B, H, KV, S, hd = 1, 4, 2, 64, 32
    q, k = rng.normal(size=(B, H, S, hd)), rng.normal(size=(B, KV, S, hd))
    v = rng.normal(size=(B, KV, S, hd))
    tq, tk, tv = (_t(a.astype(np.float32)).bfloat16() for a in (q, k, v))
    o = flash_attention(tq, tk, tv, window=16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    _close(o, j_flash_ref(jq, jk, jv, window=16), atol=2e-2)


# ---------------------------------------------------------- dense decode (B3)


@pytest.mark.parametrize("L,valid,softcap", [(64, 64, 0.0), (256, 77, 0.0),
                                             (128, 5, 50.0)])
def test_decode_plain_matches_reference(L, valid, softcap):
    rng = np.random.default_rng(3)
    B, H, KV, hd = 2, 4, 2, 32
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    bias = np.where(np.arange(L) < valid, 0.0, NEG_INF).astype(np.float32)
    reset_counts()
    o = decode_attention(_t(q), _t(k), _t(v), _t(bias), softcap=softcap)
    assert PLAIN_CALLS["decode_attention"] == 1
    args = tuple(map(jnp.asarray, (q, k, v, bias)))
    _close(o, j_decode_ref(*args, softcap=softcap),
           j_decode_kernel(*args, softcap=softcap, block_l=min(64, L),
                           interpret=True))


def test_decode_per_sequence_bias_matches_rowwise_reference():
    """The port's dense decode takes one bias row per sequence (its batcher
    writes the slot axis out); each row equals the reference's shared-bias
    call on that sequence alone."""
    rng = np.random.default_rng(4)
    B, H, KV, L, hd = 3, 4, 2, 64, 32
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    valid = np.array([64, 17, 1])
    bias = np.where(np.arange(L)[None] < valid[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    o = decode_attention(_t(q), _t(k), _t(v), _t(bias))
    for b in range(B):
        ref = j_decode_ref(*(jnp.asarray(a[b:b + 1]) for a in (q, k, v)),
                           jnp.asarray(bias[b]))
        _close(o[b:b + 1], ref)


# ------------------------------------- the split-KV plan and the combine (B1/B3)

H100_SMS = 132
# (B, KV, L) of the main path: starcoder2-3b's 4 slots over its 4096-slot
# window and 8192-slot paged tables, jamba's 4 slots over 8192 slots, and
# the edges (one key, fewer keys than a split, many slots)
MAIN_SHAPES = [(4, 2, 4096), (4, 2, 8192), (4, 8, 8192), (4, 2, 1), (4, 8, 17),
               (1, 2, 300), (64, 8, 8192)]


@pytest.mark.parametrize("B,KV,L", MAIN_SHAPES, ids=lambda x: str(x))
def test_decode_split_plan_keeps_a_key_in_every_split(B, KV, L):
    n_split, split_len = split_plan(B, KV, L, H100_SMS)
    assert split_len % SPLIT_ALIGN == 0 and split_len >= SPLIT_ALIGN
    assert n_split * split_len >= L > (n_split - 1) * split_len  # last split: >= 1 key
    if L >= 2 * H100_SMS * SPLIT_ALIGN // (B * KV):  # long enough to fill the card
        assert B * KV * n_split >= 2 * H100_SMS


def test_decode_split_plan_at_the_main_path_shapes():
    """starcoder2-3b's decode (B=4, KV=2, L=4096) and jamba's (B=4, KV=8,
    L=8192) on 132 SMs: 296 and 320 CTAs, over two per SM."""
    assert split_plan(4, 2, 4096, H100_SMS) == (37, 112)
    assert split_plan(4, 8, 8192, H100_SMS) == (10, 896)


@pytest.mark.parametrize("bs", [8, 16])
def test_decode_split_plan_is_independent_of_the_layout(bs):
    """A slot's paged call and its dense call fill the routine's parameters
    with the same split, whatever the page size."""
    rng = np.random.default_rng(21)
    B, H, KV, hd, L = 4, 24, 2, 128, 4096
    P = L // bs
    q = _t(rng.normal(size=(B, H, hd)).astype(np.float32))
    k = _t(rng.normal(size=(B, L, KV, hd)).astype(np.float32)).transpose(1, 2)
    bias = torch.zeros(B, L)
    pool = torch.zeros(2 + B * P, bs, KV, hd)
    table = torch.arange(B * P, dtype=torch.int32).reshape(B, P) + 2
    dense = dense_params(q, k, k, bias)
    paged = paged_params(q, pool, pool, table, bias)
    assert dense.L == paged.L == L and not dense.paged and paged.paged
    assert plan(dense, H100_SMS) == plan(paged, H100_SMS) == B * H * 37
    assert (dense.n_split, dense.split_len) == (paged.n_split, paged.split_len) == (37, 112)


def test_decode_split_align_matches_cuda_source():
    """Split lengths are whole multiples of the keys a warp takes from each
    chunk (KW = CH / NWARP), which the C entry checks."""
    text = (SRC / "repro_torch" / "csrc" / "decode_attention.cu").read_text()
    ch = int(re.search(r"constexpr int CH = (\d+);", text).group(1))
    nwarp = int(re.search(r"constexpr int NWARP = (\d+);", text).group(1))
    assert ch // nwarp == SPLIT_ALIGN


def _split_case(rng, B, H, KV, L, hd, valid):
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, L, hd)).astype(np.float32)
    bias = np.where(np.arange(L)[None] < np.asarray(valid)[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("L,n_sm,valid", [
    (320, 132, (320, 100, 0, 1)),   # 20 splits of 16; a NULL row (every key masked)
    (320, 20, (320, 150, 1, 0)),    # 5 splits of 64
    (320, 10, (300, 320, 77, 0)),   # splits of 96, 96, 96 and a ragged 32
    (256, 1, (256, 1, 0, 200)),     # one split: the single pass itself
], ids=["many", "64", "ragged", "one"])
def test_split_then_combine_equals_single_pass_and_reference(L, n_sm, valid):
    """The split pass's partials merged as the combine kernel merges them
    equal the plain single pass and the reference's Pallas decode kernel in
    interpret mode, row by row (the reference takes one shared bias row),
    within f32 rounding; a row whose every key is masked averages V."""
    rng = np.random.default_rng(22)
    B, H, KV, hd = 4, 8, 2, 32
    q, k, v, bias = _split_case(rng, B, H, KV, L, hd, [max(x, 0) for x in valid])
    bias[[i for i, x in enumerate(valid) if x == 0]] = NEG_INF
    n_split, split_len = split_plan(B, KV, L, n_sm)
    assert (n_split, split_len) == {132: (20, 16), 20: (5, 64), 10: (4, 96), 1: (1, 256)}[n_sm]
    tq, tk, tv, tb = map(_t, (q, k, v, bias))
    o = combine(*split_partials(tq, tk, tv, tb, n_split, split_len))
    _close(o, decode_attention_ref(tq, tk, tv, tb))
    for b in range(B):
        args = tuple(jnp.asarray(a[b:b + 1]) for a in (q, k, v)) + (jnp.asarray(bias[b]),)
        _close(o[b:b + 1], j_decode_kernel(*args, block_l=64, interpret=True))
    null = [i for i, x in enumerate(valid) if x == 0]
    if null:
        mean_v = tv[null].float().mean(2).reshape(len(null), KV, 1, hd).expand(
            -1, -1, H // KV, -1).reshape(len(null), H, hd)
        _close(o[null], mean_v.numpy())


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_then_combine_bf16_and_softcap(softcap):
    """bf16 inputs (probabilities rounded to bf16 before PV, per split) and
    softcap: split-then-combine within the bf16 tolerance of the plain
    single pass."""
    rng = np.random.default_rng(23)
    B, H, KV, L, hd = 2, 12, 1, 333, 64
    q, k, v, bias = _split_case(rng, B, H, KV, L, hd, (333, 40))
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    tb = _t(bias)
    n_split, split_len = split_plan(B, KV, L, 132)
    assert n_split > 1 and L % split_len
    o = combine(*split_partials(tq, tk, tv, tb, n_split, split_len, softcap=softcap))
    _close(o, decode_attention_ref(tq, tk, tv, tb, softcap=softcap).float(), atol=2e-2)


@pytest.mark.parametrize("n_shards,valid,softcap", [
    (4, (256, 100, 5, 0), 0.0),      # shards with every key masked; a NULL row
    (8, (256, 31, 1, 200), 30.0),    # softcap; most shards empty in three rows
    (2, (0, 0, 129, 256), 0.0),      # two NULL rows: the merge averages V
    (1, (256, 7, 0, 64), 0.0),       # one shard: the row itself
], ids=["4", "8-softcap", "2-null", "1"])
def test_decode_stats_merged_over_shards_equal_the_unsplit_row(n_shards, valid, softcap):
    """``decode_attention_ref(stats=True)``: its o rounds to the o without
    statistics; its (o, m, l) equal the split partials merged by
    ``combine`` (m the max of the splits', l their weighted sum); and the
    (o, m, l) of shards of the cache, merged as the mesh decode merges its
    ranks' (``merge_stats``), equal the unsplit row within 2e-5, also where
    every key of a shard, or of the row, is masked (NEG_INF, never -inf)."""
    rng = np.random.default_rng(24)
    B, H, KV, L, hd = 4, 8, 2, 256, 32
    q, k, v, bias = map(_t, _split_case(rng, B, H, KV, L, hd, valid))
    reset_counts()
    o, m, l = decode_attention(q, k, v, bias, softcap=softcap, stats=True)
    assert PLAIN_CALLS["decode_attention_stats"] == 1 and PLAIN_CALLS["decode_attention"] == 0
    assert o.dtype == m.dtype == l.dtype == torch.float32 and m.shape == (B, H)
    assert torch.equal(o, decode_attention_ref(q, k, v, bias, softcap=softcap))
    pm, pl, pacc = split_partials(q, k, v, bias, 8, L // 8, softcap=softcap)
    torch.testing.assert_close(o, combine(pm, pl, pacc), atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(m, pm.amax(-1), atol=2e-5, rtol=0)
    torch.testing.assert_close(l, (pl * torch.exp(pm - m[..., None])).sum(-1),
                               atol=0, rtol=2e-5)
    n = L // n_shards
    parts = [decode_attention_ref(q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n],
                                  bias[:, i * n:(i + 1) * n], softcap=softcap, stats=True)
             for i in range(n_shards)]
    if n_shards > 1:  # a shard whose every key is masked sits at NEG_INF, finite
        masked = (bias.reshape(B, n_shards, n) < 0).all(-1)
        assert masked.any()
        for i, (_, mi, li) in enumerate(parts):
            assert torch.isfinite(mi).all()
            assert (mi[masked[:, i]] == NEG_INF).all() and (li[masked[:, i]] == n).all()
    merged = merge_stats(*(torch.stack(t) for t in zip(*parts)))
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, o, atol=2e-5, rtol=2e-5)
    null = [i for i, x in enumerate(valid) if x == 0]
    if null:
        mean_v = v[null].mean(2).reshape(len(null), KV, 1, hd).expand(
            -1, -1, H // KV, -1).reshape(len(null), H, hd)
        torch.testing.assert_close(merged[null], mean_v, atol=2e-5, rtol=2e-5)


# ------------------------------------------- flash: TMA's rules on the views


def test_flash_tma_strides_of_model_layout_views():
    """The model's (B,S,H,hd) bf16 projections, transposed: the tensor map
    takes their (batch, head, seq) strides; a size-1 batch gets a legal one."""
    x = torch.zeros(1, 100, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert _tma_strides(x, "q") == [8, 128, 8 * 128]
    y = torch.zeros(2, 100, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert _tma_strides(y, "k") == [100 * 8 * 64, 64, 8 * 64]


@pytest.mark.parametrize("case", ["base", "stride", "last"])
def test_flash_tma_strides_refuse_views_that_break_the_rules(case):
    base = torch.zeros(2, 64, 4, 136, dtype=torch.bfloat16)
    if case == "base":
        t = base[..., 1:129].transpose(1, 2)          # 2 bytes past 16
    elif case == "stride":
        t = torch.zeros(2, 64, 4, 130, dtype=torch.bfloat16)[..., :128].transpose(1, 2)
    else:
        t = base.transpose(1, 3)                      # last stride not 1
    assert base.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="TMA"):
        _tma_strides(t, "q")


# ---------------------------------------------------------- paged decode (B1)


def _paged_inputs(rng, *, B=2, H=4, KV=2, hd=32, bs=16, P=4, n_phys=12,
                  valid=(33, 17)):
    L = P * bs
    kp = rng.standard_normal((n_phys, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((n_phys, bs, KV, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    tbl = np.stack([rng.permutation(np.arange(2, n_phys))[:P]
                    for _ in range(B)]).astype(np.int32)
    bias = np.where(np.arange(L)[None] < np.asarray(valid)[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, kp, vp, tbl, bias


@pytest.mark.parametrize("valid", [(64, 1), (16, 17), (15, 48), (33, 49)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_paged_plain_matches_reference(valid, softcap):
    """Lengths straddle the 16-token page boundaries."""
    rng = np.random.default_rng(5)
    q, kp, vp, tbl, bias = _paged_inputs(rng, valid=valid)
    reset_counts()
    o = paged_decode_attention(*map(_t, (q, kp, vp, tbl, bias)), softcap=softcap)
    assert PLAIN_CALLS["paged_decode_attention"] == 1
    args = tuple(map(jnp.asarray, (q, kp, vp, tbl, bias)))
    _close(o, j_paged_ref(*args, softcap=softcap),
           j_paged_kernel(*args, softcap=softcap, interpret=True))


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_paged_plain_int8_matches_reference(softcap):
    rng = np.random.default_rng(6)
    q, kp, vp, tbl, bias = _paged_inputs(rng)
    jqk, jks = j_quantize(jnp.asarray(kp))
    jqv, jvs = j_quantize(jnp.asarray(vp))
    qk, ks = quantize_int8(_t(kp))
    qv, vs = quantize_int8(_t(vp))
    np.testing.assert_array_equal(qk.numpy(), np.asarray(jqk))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    o = paged_decode_attention(_t(q), qk, qv, _t(tbl), _t(bias), k_scale=ks,
                               v_scale=vs, softcap=softcap)
    jargs = (jnp.asarray(q), jqk, jqv, jnp.asarray(tbl), jnp.asarray(bias))
    _close(o, j_paged_ref(*jargs, k_scale=jks, v_scale=jvs, softcap=softcap),
           j_paged_kernel(*jargs, k_scale=jks, v_scale=jvs, softcap=softcap,
                          interpret=True))


# ------------------------------------------------------------- int8 rounding


def test_quantize_int8_rounds_half_to_even_like_reference():
    # rows whose amax is 127 make scale exactly 1.0: x/scale lands on .5 ties
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49]],
                 np.float32)
    x = np.concatenate([x, np.random.default_rng(7).normal(size=(5, 8))
                        .astype(np.float32)])
    q, s = quantize_int8(_t(x))
    jq, js = j_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(jq, np.float32) * np.asarray(js))


# ------------------------------------------------------------------- guards


def test_kernel_wrappers_refuse_cpu_tensors():
    """A launch wrapper never runs the plain version: it takes CUDA tensors
    or raises (the ops choose by device, with no fallback)."""
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)
    qd = torch.zeros(1, 2, 32)
    kd = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        decode_attention_fwd(qd, kd, kd, torch.zeros(16))
    with pytest.raises(ValueError):
        paged_decode_attention_fwd(qd, torch.zeros(3, 16, 2, 32),
                                   torch.zeros(3, 16, 2, 32),
                                   torch.zeros(1, 1, dtype=torch.int32),
                                   torch.zeros(1, 16))
    qm = q.to("meta")
    with pytest.raises(ValueError):
        flash_attention_fwd(qm, qm, qm)
    assert flash_attention(qm, qm, qm).shape == q.shape  # meta: the plain version
    r = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        rwkv6_scan_fwd(r, r, r, r, torch.zeros(2, 32), torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError):
        rwkv6_scan_bwd(r, r, r, r, r, torch.zeros(2, 32),
                       torch.zeros(1, 2, 2, 32, 32), torch.zeros(1, 2, 32, 32))
    # a meta tensor (a traced step) takes the plain version's outputs; the
    # wrapper refuses it as it refuses a CPU tensor
    m = r.to("meta")
    um, sm = torch.zeros(2, 32).to("meta"), torch.zeros(1, 2, 32, 32).to("meta")
    with pytest.raises(ValueError):
        rwkv6_scan_fwd(m, m, m, m, um, sm)
    y, sT = rwkv6_scan(m, m, m, m, um, sm)
    assert y.is_meta and y.shape == r.shape and sT.shape == sm.shape
    x, A, bc, h0 = (torch.zeros(1, 4, 32), torch.zeros(32, 16),
                    torch.zeros(1, 4, 16), torch.zeros(1, 32, 16))
    with pytest.raises(ValueError):
        ssm_scan_fwd(x, x, A, bc, bc, torch.zeros(32), h0)
    meta = tuple(t.to("meta") for t in (x, x, A, bc, bc, torch.zeros(32), h0))
    with pytest.raises(ValueError):
        ssm_scan_fwd(*meta)
    y, hT = ssm_scan(*meta)
    assert y.is_meta and y.shape == x.shape and hT.shape == h0.shape
    with pytest.raises(ValueError):
        ssm_scan_bwd(x, x, A, bc, bc, torch.zeros(32), x, torch.zeros(1, 1, 32, 16), h0)


_CTYPE_SIZES = {"const void*": 8, "void*": 8, "const float*": 8, "float*": 8,
                "const int32_t*": 8, "int64_t": 8, "int32_t": 4, "float": 4}


@pytest.mark.parametrize("src,struct,mirror", [
    ("flash_attention.cu", "FlashParams", FlashParams),
    ("decode_attention.cu", "DecodeParams", DecodeParams),
    ("rwkv6_scan.cu", "Rwkv6Params", Rwkv6Params),
    ("rwkv6_scan.cu", "Rwkv6BwdParams", Rwkv6BwdParams),
    ("ssm_scan.cu", "SsmParams", SsmParams),
    ("ssm_scan.cu", "SsmBwdParams", SsmBwdParams),
])
def test_ctypes_struct_mirrors_cuda_source(src, struct, mirror):
    """The C entries take a pointer to a parameter struct; its ctypes mirror
    must list the same fields in the same order with the same sizes."""
    text = (SRC / "repro_torch" / "csrc" / src).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.match(r"((?:const )?\w+\*?)\s+(.*);", line).groups()
        fields += [(n.strip(), _CTYPE_SIZES[ctype]) for n in names.split(",")]
    got = [(name, ctypes.sizeof(ctype)) for name, ctype in mirror._fields_]
    assert got == fields


def test_rwkv_checkpoint_interval_matches_cuda_source():
    """The forward kernel saves, and the backward kernel rewinds from, a
    state every CK steps; the plain versions and the wrapper's buffer
    shapes use ``CHECKPOINT``."""
    text = (SRC / "repro_torch" / "csrc" / "rwkv6_scan.cu").read_text()
    assert int(re.search(r"constexpr int CK = (\d+);", text).group(1)) == CHECKPOINT


# ------------------------------------------- the RWKV-6 launch plan (B5) and cluster (B7)

# (B, H, hd) of the main path: rwkv6-3b's prefill (one sequence), training
# microbatch and 4-slot decode; the small test shapes; a large batch
RWKV_SHAPES = [(1, 40, 64), (2, 40, 64), (4, 40, 64), (2, 3, 64), (3, 5, 32), (16, 40, 64)]


@pytest.mark.parametrize("B,H,hd", RWKV_SHAPES, ids=lambda x: str(x))
@pytest.mark.parametrize("n_sm", [1, 20, 132])
def test_rwkv_fwd_plan_depends_on_shapes_and_sm_count_only(B, H, hd, n_sm):
    """The forward's plan reads nothing but the shapes and the SM count: the
    same answer on every call, a split the kernel takes, and 16 value
    columns per CTA exactly when that still gives every SM
    ``FWD_CTAS_PER_SM`` CTAs, else 8."""
    cols = rwkv_kernel.fwd_plan(B, H, hd, n_sm)
    assert cols == rwkv_kernel.fwd_plan(B, H, hd, n_sm)
    rwkv_kernel.check_cols(hd, cols)
    wide = B * H * (hd // 16) >= rwkv_kernel.FWD_CTAS_PER_SM * n_sm
    assert cols == (16 if wide else 8)
    assert rwkv_kernel.bwd_threads(hd) % 32 == 0


def test_rwkv_plans_at_the_main_path_shapes():
    """rwkv6-3b on 132 SMs: the 4500-token prefill splits each head's 64
    value columns 8 per CTA (320 CTAs), training's B=2 and decode's B=4
    16 per CTA (320 and 640 CTAs); B7 at the training microbatch runs
    clusters of 4 (320 CTAs of 128 threads, three to an SM)."""
    assert rwkv_kernel.fwd_plan(1, 40, 64, H100_SMS) == 8
    assert rwkv_kernel.fwd_plan(2, 40, 64, H100_SMS) == 16
    assert rwkv_kernel.fwd_plan(4, 40, 64, H100_SMS) == 16
    assert rwkv_kernel.CLUSTER == 4 and rwkv_kernel.bwd_threads(64) == 128


@pytest.mark.parametrize("hd,cols", [(64, 6), (64, 2), (64, 0), (64, 128), (32, 64), (64, 12)])
def test_rwkv_fwd_refuses_bad_column_splits(hd, cols):
    with pytest.raises(ValueError, match="cols"):
        rwkv_kernel.check_cols(hd, cols)


def test_rwkv_plan_constants_match_cuda_source():
    """The wrapper's thread counts follow the kernels': KR_SCAN key rows a
    forward thread, at most FWD_MAX_THREADS threads, BWD_NC CTAs a cluster
    and BWD_JM value columns a backward thread."""
    text = (SRC / "repro_torch" / "csrc" / "rwkv6_scan.cu").read_text()
    const = {name: int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))
             for name in ("KR_SCAN", "FWD_MAX_THREADS", "BWD_NC", "BWD_JM")}
    assert const == {"KR_SCAN": rwkv_kernel.KEY_ROWS,
                     "FWD_MAX_THREADS": rwkv_kernel.FWD_MAX_THREADS,
                     "BWD_NC": rwkv_kernel.CLUSTER,
                     "BWD_JM": rwkv_kernel.BWD_COLS_PER_THREAD}


def test_ssm_checkpoint_interval_and_cta_width_match_cuda_source():
    """B4 saves, and B6 replays from, a state every SSM_CK steps; both split
    a channel's states over SSM_LANES lanes; B6 writes one dB/dC partial per
    CTA of SSM_BWD_CHANNELS channels. The plain versions and the wrappers'
    buffer shapes use ``CHECKPOINT``, ``LANES_PER_CHANNEL`` and
    ``CHANNELS_PER_CTA``."""
    from repro_torch.kernels.ssm_scan.ref import CHECKPOINT as SSM_CHECKPOINT

    text = (SRC / "repro_torch" / "csrc" / "ssm_scan.cu").read_text()
    const = {name: int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))
             for name in ("SSM_CK", "SSM_LANES", "SSM_BWD_CHANNELS")}
    assert const == {"SSM_CK": SSM_CHECKPOINT, "SSM_LANES": LANES_PER_CHANNEL,
                     "SSM_BWD_CHANNELS": CHANNELS_PER_CTA}
    assert LANES_PER_CHANNEL == 4
    assert "SSM_BWD_THREADS = SSM_LANES * SSM_BWD_CHANNELS" in text


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch imports in a fresh interpreter with
    neither ``jax`` nor ``repro`` ending up in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(SRC)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 96
    assert {"repro_torch.checkpoint.checkpointer", "repro_torch.data.pipeline",
            "repro_torch.runtime.elastic", "repro_torch.runtime.straggler",
            "repro_torch.launch.train", "repro_torch.launch.steps",
            "repro_torch.optim.adamw", "repro_torch.optim.schedule"} <= names
    # the scheduler: DES, policies, controller, scenarios, workload
    # synthesis, experiment API, fluid engine, launcher
    assert {"repro_torch.core.engine", "repro_torch.core.simtorch",
            "repro_torch.core.cluster", "repro_torch.core.jobs",
            "repro_torch.core.metrics", "repro_torch.sched.controller",
            "repro_torch.sched.policy", "repro_torch.sched.scenarios",
            "repro_torch.workload.arrivals", "repro_torch.workload.builders",
            "repro_torch.workload.io", "repro_torch.traces.synthetic",
            "repro_torch.obs.events", "repro_torch.obs.trace",
            "repro_torch.tenancy.admission", "repro_torch.exp.runner",
            "repro_torch.exp.results", "repro_torch.exp.compare",
            "repro_torch.configs.cloudcoaster", "repro_torch.launch.sim"} <= names
    # the serving fleet, its launcher and its example
    assert {"repro_torch.runtime.serving", "repro_torch.launch.serve",
            "repro_torch.examples.serve_bursty"} <= names
    # the fleet as one device program: its engine, generator, kernel triple,
    # the catalog driver and the multi-tenant example
    assert {"repro_torch.runtime.serving_torch", "repro_torch.runtime.threefry",
            "repro_torch.kernels.serving_fleet.ref",
            "repro_torch.kernels.serving_fleet.ops",
            "repro_torch.kernels.serving_fleet.kernel", "repro_torch.launch.smoke",
            "repro_torch.examples.serve_multitenant"} <= names
    # the twins of the JAX package's quickstart and trace_replay examples
    assert {"repro_torch.examples.quickstart", "repro_torch.examples.trace_replay"} <= names
    # the ten model families' configs, the MoE layer and the decoder
    assert {"repro_torch.configs.mixtral_8x22b", "repro_torch.configs.llama4_scout_17b_a16e",
            "repro_torch.configs.deepseek_coder_33b", "repro_torch.configs.yi_34b",
            "repro_torch.configs.musicgen_medium", "repro_torch.configs.paligemma_3b",
            "repro_torch.configs.registry", "repro_torch.models.mlp",
            "repro_torch.models.decoder", "repro_torch.models.common",
            "repro_torch.convert"} <= names
    # the training variants' table (MoE training and the training extras)
    assert "repro_torch.configs.optimized" in names


def test_chip_smoke_imports_neither_jax_nor_reference():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", text, re.M)
