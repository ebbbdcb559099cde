"""Port kernels on the card: each hand-written CUDA kernel against its plain
PyTorch version on the same CUDA inputs, at the reference's tolerances
(attention: atol 2e-5 for f32 and int8-dequantised pools, 2e-2 for bf16;
the RWKV-6 scan: atol = rtol = 1e-3, its inputs widened to f32 exactly; its
backward: 1e-4 for f32 outputs, 2e-2 for bf16 ones; the Mamba selective
scan and its backward: atol = rtol = 1e-4, all f32).

Needs a CUDA device and ``nvcc``; the ``cuda`` fixture skips every test here
otherwise (decided inside the fixture, never at import, so every xdist
worker collects the same tests). Run on the card with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_fwd, paged_decode_attention_fwd)
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd, rwkv6_scan_fwd
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bwd, ssm_scan_fwd
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.optim.compress import quantize_int8

pytestmark = pytest.mark.gpu

NEG_INF = -2.3819763e38


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,S,hd,kw", [
    (4, 2, 128, 32, dict()),
    (4, 2, 100, 64, dict(window=32)),              # ragged S
    (8, 1, 77, 128, dict(softcap=30.0)),
    (4, 4, 130, 256, dict(prefix_len=24)),
    (6, 2, 96, 128, dict(q_offset=16, window=48, softcap=20.0)),
])
def test_flash_kernel_matches_plain(cuda, dtype, H, KV, S, hd, kw):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B = 2
    q = _randn(gen, (B, H, S, hd), dtype, cuda)
    k = _randn(gen, (B, KV, S, hd), dtype, cuda)
    v = _randn(gen, (B, KV, S, hd), dtype, cuda)
    reset_counts()
    o = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    ref = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_flash_kernel_reads_strided_views(cuda):
    """The model passes (B,S,H,hd) projections transposed, without a copy."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, S, H, KV, hd = 1, 200, 6, 2, 64
    q = _randn(gen, (B, S, H, hd), torch.float32, cuda).transpose(1, 2)
    k = _randn(gen, (B, S, KV, hd), torch.float32, cuda).transpose(1, 2)
    v = _randn(gen, (B, S, KV, hd), torch.float32, cuda).transpose(1, 2)
    o = flash_attention_fwd(q, k, v, window=64)
    torch.testing.assert_close(o, attention_ref(q.contiguous(), k.contiguous(),
                                                v.contiguous(), window=64),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,hd,softcap,per_seq", [
    (64, 32, 0.0, False), (77, 64, 0.0, True), (4096, 128, 0.0, True),
    (300, 256, 50.0, True)])
def test_decode_kernel_matches_plain(cuda, dtype, L, hd, softcap, per_seq):
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, H, KV = 4, 24 if hd == 128 else 8, 2
    q = _randn(gen, (B, H, hd), dtype, cuda)
    k = _randn(gen, (B, L, KV, hd), dtype, cuda).transpose(1, 2)  # model layout view
    v = _randn(gen, (B, L, KV, hd), dtype, cuda).transpose(1, 2)
    valid = torch.tensor([L, L // 2 + 1, 17, 1], device=cuda)
    bias = torch.where(torch.arange(L, device=cuda)[None] < valid[:, None],
                       0.0, NEG_INF).float()
    if not per_seq:
        bias = bias[1]
    reset_counts()
    o = decode_attention_fwd(q, k, v, bias, softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == 1
    ref = decode_attention_ref(q, k, v, bias, softcap=softcap)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def _paged_case(gen, dev, dtype, *, B=4, H=24, KV=2, hd=128, bs=16, P=16):
    n_phys = 2 + B * P
    kp = _randn(gen, (n_phys, bs, KV, hd), dtype, dev)
    vp = _randn(gen, (n_phys, bs, KV, hd), dtype, dev)
    q = _randn(gen, (B, H, hd), dtype, dev)
    perm = torch.randperm(B * P, generator=gen, device=dev) + 2
    table = perm.reshape(B, P).to(torch.int32)
    lens = torch.tensor([P * bs, 17, 16, 1 + (P * bs) // 3][:B], device=dev)
    bias = torch.where(torch.arange(P * bs, device=dev)[None] < lens[:, None],
                       0.0, NEG_INF).float()
    return q, kp, vp, table, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,softcap", [(32, 0.0), (128, 0.0), (128, 50.0), (256, 0.0)])
def test_paged_kernel_matches_plain(cuda, dtype, hd, softcap):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, kp, vp, table, bias = _paged_case(gen, cuda, dtype, hd=hd,
                                         H=24 if hd == 128 else 8)
    reset_counts()
    o = paged_decode_attention(q, kp, vp, table, bias, softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == 1
    assert PLAIN_CALLS["paged_decode_attention"] == 0
    ref = paged_decode_attention_ref(q, kp, vp, table, bias, softcap=softcap)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_kernel_int8_matches_plain(cuda, qdtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, kp, vp, table, bias = _paged_case(gen, cuda, torch.float32)
    qk, ks = quantize_int8(kp)
    qv, vs = quantize_int8(vp)
    q = q.to(qdtype)
    o = paged_decode_attention_fwd(q, qk, qv, table, bias, k_scale=ks, v_scale=vs)
    ref = paged_decode_attention_ref(q, qk, qv, table, bias, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(qdtype),
                               rtol=_tol(qdtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_and_paged_kernels_bitwise_identical(cuda, dtype):
    """One device routine serves both layouts: a slot's pages scattered from
    its dense cache give bit-identical output."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, H, KV, hd, bs, L = 4, 24, 2, 128, 16, 512
    P = L // bs
    k = _randn(gen, (B, L, KV, hd), dtype, cuda)
    v = _randn(gen, (B, L, KV, hd), dtype, cuda)
    q = _randn(gen, (B, H, hd), dtype, cuda)
    lens = torch.tensor([L, 300, 17, 1], device=cuda)
    bias = torch.where(torch.arange(L, device=cuda)[None] < lens[:, None],
                       0.0, NEG_INF).float()
    table = (torch.randperm(B * P, generator=gen, device=cuda) + 2).reshape(B, P)
    kp = torch.zeros((2 + B * P, bs, KV, hd), dtype=dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.reshape(B, P, bs, KV, hd)
    vp[table.long()] = v.reshape(B, P, bs, KV, hd)
    dense = decode_attention_fwd(q, k.transpose(1, 2), v.transpose(1, 2), bias)
    paged = paged_decode_attention_fwd(q, kp, vp, table.to(torch.int32), bias)
    assert torch.equal(dense, paged)


# ---- the new model families' head groupings (B1, B2, B3)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,hd,kw", [
    (48, 8, 128, dict(window=64)),     # mixtral: 6 query heads a kv head
    (40, 8, 128, dict(window=96)),     # llama4: 5
    (56, 8, 128, dict()),              # deepseek-coder, yi: 7
    (24, 24, 64, dict()),              # musicgen: MHA at hd 64
    (8, 1, 256, dict(prefix_len=64)),  # paligemma: MQA at hd 256, an image prefix
], ids=["g6_mixtral", "g5_llama4", "g7_deepseek_yi", "g1_musicgen", "g8_paligemma"])
def test_attention_kernels_at_new_head_groups(cuda, dtype, H, KV, hd, kw):
    """Flash prefill, dense decode and paged decode at each new family's
    (H, KV, hd): groups that are not powers of two, MHA, and MQA with a
    bidirectional prefix (the prefill's prefix keys seen by every query,
    the decode's through the bias)."""
    gen = torch.Generator(device=cuda).manual_seed(30 + H)
    S = 64 + 133
    q, k, v = (_randn(gen, (1, S, n, hd), dtype, cuda).transpose(1, 2) for n in (H, KV, KV))
    reset_counts()
    o = flash_attention_fwd(q, k, v, **kw)
    assert LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(o.float(), attention_ref(q, k, v, **kw).float(),
                               atol=_tol(dtype), rtol=_tol(dtype))
    B, bs, P = 4, 16, 20
    L = P * bs
    q = _randn(gen, (B, H, hd), dtype, cuda)
    kc = _randn(gen, (B, L, KV, hd), dtype, cuda)
    vc = _randn(gen, (B, L, KV, hd), dtype, cuda)
    valid = torch.tensor([L, 213, 17, 1], device=cuda)
    ok = torch.arange(L, device=cuda)[None] < valid[:, None]
    window, prefix = kw.get("window", 0), kw.get("prefix_len", 0)
    if window:  # the decode query at position valid-1 sees the last `window` keys
        ok &= torch.arange(L, device=cuda)[None] >= valid[:, None] - window
    if prefix:
        ok |= torch.arange(L, device=cuda)[None] < prefix
    bias = torch.where(ok, 0.0, NEG_INF).float()
    o = decode_attention_fwd(q, kc.transpose(1, 2), vc.transpose(1, 2), bias)
    torch.testing.assert_close(
        o.float(), decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                        bias).float(), atol=_tol(dtype), rtol=_tol(dtype))
    table = (torch.randperm(B * P, generator=gen, device=cuda) + 2).reshape(B, P)
    kp = torch.zeros((2 + B * P, bs, KV, hd), dtype=dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kp[table.long()] = kc.reshape(B, P, bs, KV, hd)
    vp[table.long()] = vc.reshape(B, P, bs, KV, hd)
    paged = paged_decode_attention_fwd(q, kp, vp, table.to(torch.int32), bias)
    assert torch.equal(paged, o)
    assert LAUNCHES["decode_attention"] == 1 and LAUNCHES["paged_decode_attention"] == 1


# ---- the split-KV decode routine (B1/B3): splits, head groups, tails

def _decode_case(gen, dev, dtype, B, KV, G, L, hd, null_row=False):
    q = _randn(gen, (B, KV * G, hd), dtype, dev)
    k = _randn(gen, (B, L, KV, hd), dtype, dev).transpose(1, 2)
    v = _randn(gen, (B, L, KV, hd), dtype, dev).transpose(1, 2)
    valid = torch.tensor([L, max(1, L // 3), 1, max(1, L - 17)][:B], device=dev)
    bias = torch.where(torch.arange(L, device=dev)[None] < valid[:, None],
                       0.0, NEG_INF).float()
    if null_row:  # a NULL slot: every position masked, the output averages V
        bias[1] = NEG_INF
    return q, k, v, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,G,hd", [
    (1, 8, 128),      # one key
    (15, 12, 64),     # fewer keys than one split
    (1000, 1, 32),    # L not a multiple of the split length
    (1000, 4, 256),
    (4099, 16, 128),
    (333, 12, 128),
    (500, 20, 64),    # two head groups of one kv head
], ids=lambda x: str(x))
def test_decode_split_kernel_matches_plain(cuda, dtype, L, G, hd):
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, bias = _decode_case(gen, cuda, dtype, 4, 2, G, L, hd)
    o = decode_attention_fwd(q, k, v, bias, softcap=30.0 if G == 12 else 0.0)
    ref = decode_attention_ref(q, k, v, bias, softcap=30.0 if G == 12 else 0.0)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("L,G,hd,softcap", [
    (1, 8, 128, 0.0),      # one key
    (15, 12, 64, 0.0),     # fewer keys than one split
    (1000, 1, 32, 30.0),   # L not a multiple of the split length; softcap
    (1000, 4, 256, 0.0),
    (4099, 6, 128, 0.0),   # mixtral's group, many splits
], ids=lambda x: str(x))
def test_decode_stats_kernel_matches_plain(cuda, dtype, L, G, hd, softcap):
    """B3 with statistics: its f32 o rounded to q's dtype is the o of the
    launch without them, bit for bit; o, m and l against
    ``decode_attention_ref(stats=True)`` (o at the dtype's tolerance, m
    within 2e-5, l at rtol 2e-5), a NULL row (every position masked at the
    finite NEG_INF) included; one ``decode_attention_stats`` launch."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, bias = _decode_case(gen, cuda, dtype, 4, 2, G, L, hd, null_row=True)
    reset_counts()
    o, m, l = decode_attention_fwd(q, k, v, bias, softcap=softcap, stats=True)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention_stats"] == 1 and LAUNCHES["decode_attention"] == 0
    assert o.dtype == m.dtype == l.dtype == torch.float32 and m.shape == (4, 2 * G)
    assert torch.equal(o.to(dtype), decode_attention_fwd(q, k, v, bias, softcap=softcap))
    ro, rm, rl = decode_attention_ref(q, k, v, bias, softcap=softcap, stats=True)
    torch.testing.assert_close(o, ro, atol=_tol(dtype), rtol=_tol(dtype))
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=0)
    torch.testing.assert_close(l, rl, atol=0, rtol=2e-5)
    assert (m[1] == NEG_INF).all() and (l[1] == L).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_null_slot_row_is_finite_and_matches_plain(cuda, dtype, layout):
    """A row whose bias is all NEG_INF (a NULL slot) averages V in every
    split, like the plain version, and stays finite."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, KV, G, hd, bs, L = 4, 2, 12, 128, 16, 1024
    q, k, v, bias = _decode_case(gen, cuda, dtype, B, KV, G, L, hd, null_row=True)
    if layout == "dense":
        o = decode_attention_fwd(q, k, v, bias)
        ref = decode_attention_ref(q, k, v, bias)
    else:
        P = L // bs
        table = (torch.randperm(B * P, generator=gen, device=cuda) + 2).reshape(B, P)
        kp = torch.zeros((2 + B * P, bs, KV, hd), dtype=dtype, device=cuda)
        vp = torch.zeros_like(kp)
        kp[table.long()] = k.transpose(1, 2).reshape(B, P, bs, KV, hd)
        vp[table.long()] = v.transpose(1, 2).reshape(B, P, bs, KV, hd)
        table = table.to(torch.int32)
        o = paged_decode_attention_fwd(q, kp, vp, table, bias)
        ref = paged_decode_attention_ref(q, kp, vp, table, bias)
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G,hd,P", [(8, 128, 64), (12, 64, 7), (1, 256, 3), (16, 32, 40)],
                         ids=lambda x: str(x))
def test_paged_split_kernel_int8_matches_plain(cuda, qdtype, G, hd, P):
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, kp, vp, table, bias = _paged_case(gen, cuda, torch.float32, H=2 * G, hd=hd, P=P)
    qk, ks = quantize_int8(kp)
    qv, vs = quantize_int8(vp)
    q = q.to(qdtype)
    o = paged_decode_attention_fwd(q, qk, qv, table, bias, k_scale=ks, v_scale=vs)
    ref = paged_decode_attention_ref(q, qk, qv, table, bias, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(o.float(), ref.float(), atol=_tol(qdtype), rtol=_tol(qdtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dense_and_paged_bitwise_identical_across_splits_and_repeatable(cuda, dtype):
    """jamba's decode shape (G=8) at an L of many splits: paged equals dense
    bit for bit, and a second run of each equals the first."""
    from repro_torch.kernels.decode_attention.kernel import split_plan

    gen = torch.Generator(device=cuda).manual_seed(14)
    B, KV, G, hd, bs, L = 4, 8, 8, 128, 16, 3000
    n_split, _ = split_plan(B, KV, L - L % bs, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert n_split > 1
    L -= L % bs
    P = L // bs
    q, k, v, bias = _decode_case(gen, cuda, dtype, B, KV, G, L, hd)
    table = (torch.randperm(B * P, generator=gen, device=cuda) + 2).reshape(B, P)
    kp = torch.zeros((2 + B * P, bs, KV, hd), dtype=dtype, device=cuda)
    vp = torch.zeros_like(kp)
    kp[table.long()] = k.transpose(1, 2).reshape(B, P, bs, KV, hd)
    vp[table.long()] = v.transpose(1, 2).reshape(B, P, bs, KV, hd)
    table = table.to(torch.int32)
    dense = decode_attention_fwd(q, k, v, bias)
    paged = paged_decode_attention_fwd(q, kp, vp, table, bias)
    assert torch.equal(dense, paged)
    assert torch.equal(dense, decode_attention_fwd(q, k, v, bias))
    assert torch.equal(paged, paged_decode_attention_fwd(q, kp, vp, table, bias))


# ---- the wgmma/TMA flash kernel (B2, bf16): tiles, masks, views

@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 65, 129, 200, 257])
def test_flash_bf16_ragged_lengths(cuda, hd, S):
    gen = torch.Generator(device=cuda).manual_seed(15)
    q = _randn(gen, (2, 4, S, hd), torch.bfloat16, cuda)
    k = _randn(gen, (2, 2, S, hd), torch.bfloat16, cuda)
    v = _randn(gen, (2, 2, S, hd), torch.bfloat16, cuda)
    o = flash_attention_fwd(q, k, v)
    torch.testing.assert_close(o.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("kw", [
    dict(window=100), dict(prefix_len=70), dict(softcap=30.0),
    dict(window=64, softcap=20.0, prefix_len=10),
], ids=["window", "prefix", "softcap", "window_softcap_prefix"])
def test_flash_bf16_masks_at_every_head_dim(cuda, hd, kw):
    gen = torch.Generator(device=cuda).manual_seed(16)
    S = 333
    q = _randn(gen, (1, 8, S, hd), torch.bfloat16, cuda)
    k = _randn(gen, (1, 2, S, hd), torch.bfloat16, cuda)
    v = _randn(gen, (1, 2, S, hd), torch.bfloat16, cuda)
    o = flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(o.float(), attention_ref(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bf16_q_offset_against_a_longer_cache(cuda, hd):
    """A chunk of 100 queries at positions 150.. against 250 keys."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    q = _randn(gen, (2, 6, 100, hd), torch.bfloat16, cuda)
    k = _randn(gen, (2, 2, 250, hd), torch.bfloat16, cuda)
    v = _randn(gen, (2, 2, 250, hd), torch.bfloat16, cuda)
    for kw in (dict(q_offset=150), dict(q_offset=150, window=80)):
        o = flash_attention_fwd(q, k, v, **kw)
        torch.testing.assert_close(o.float(), attention_ref(q, k, v, **kw).float(),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("hd", [32, 128, 256])
def test_flash_bf16_reads_model_layout_views_and_is_repeatable(cuda, hd):
    """(B,S,H,hd) projections transposed without a copy load through tensor
    maps built from their strides; two runs are bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    B, S, H, KV = 2, 300, 8, 2
    q = _randn(gen, (B, S, H, hd), torch.bfloat16, cuda).transpose(1, 2)
    k = _randn(gen, (B, S, KV, hd), torch.bfloat16, cuda).transpose(1, 2)
    v = _randn(gen, (B, S, KV, hd), torch.bfloat16, cuda).transpose(1, 2)
    o = flash_attention_fwd(q, k, v, window=128)
    ref = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), window=128)
    torch.testing.assert_close(o.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert torch.equal(o, flash_attention_fwd(q, k, v, window=128))


def test_flash_bf16_refuses_views_that_break_tma_rules(cuda):
    base = torch.zeros(1, 64, 4, 136, dtype=torch.bfloat16, device=cuda)
    good = base[..., :128].transpose(1, 2)
    shifted = base[..., 1:129].transpose(1, 2)  # base 2 bytes past 16
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_fwd(shifted, good, good)
    odd = torch.zeros(1, 64, 4, 130, dtype=torch.bfloat16, device=cuda)[..., :128]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_fwd(good, odd.transpose(1, 2), good)  # 260-byte row stride


def test_kernels_refuse_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_fwd(q[:, :, 0], q, q, torch.zeros(8, device=cuda))


# ------------------------------------------------------------ RWKV-6 scan (B5)

WKV_TOL = 1e-3


def _wkv_case(gen, dev, dtype, B, H, S, hd, *, model_layout=False):
    """r/k/v in ``dtype``, w in (0.2, 0.999), nonzero u and s0, all f32 but
    r/k/v. ``model_layout``: (B,H,S,hd) views of (B,S,H,hd) storage, as the
    model passes its projections."""
    def seq(scale=1.0, shift=0.0, rand=torch.randn):
        shape = (B, S, H, hd) if model_layout else (B, H, S, hd)
        t = rand(shape, generator=gen, device=dev) * scale + shift
        return t.transpose(1, 2) if model_layout else t

    r, k, v = (seq().to(dtype) for _ in range(3))
    w = seq(0.799, 0.2, torch.rand)
    u = torch.randn((H, hd), generator=gen, device=dev)
    s0 = 0.5 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 37, 64, 130])
def test_rwkv6_kernel_matches_plain(cuda, dtype, hd, S):
    gen = torch.Generator(device=cuda).manual_seed(6)
    args = _wkv_case(gen, cuda, dtype, 3, 5, S, hd)
    reset_counts()
    y, sT = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan"] == 1 and PLAIN_CALLS["rwkv6_scan"] == 0
    y_ref, sT_ref = rwkv6_scan_ref(*args)
    assert y.shape == (3, 5, S, hd) and y.dtype == sT.dtype == torch.float32
    torch.testing.assert_close(y, y_ref, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(sT, sT_ref, atol=WKV_TOL, rtol=WKV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rwkv6_kernel_reads_model_layout_views(cuda, dtype):
    """(B,H,S,hd) views of (B,S,H,hd) storage, read without a copy; y comes
    back as such a view too."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    args = _wkv_case(gen, cuda, dtype, 2, 40, 100, 64, model_layout=True)
    y, sT = rwkv6_scan_fwd(*args)
    assert y.transpose(1, 2).is_contiguous()
    y_ref, sT_ref = rwkv6_scan_ref(*(a.contiguous() for a in args))
    torch.testing.assert_close(y, y_ref, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(sT, sT_ref, atol=WKV_TOL, rtol=WKV_TOL)


def test_rwkv6_kernel_chained_calls_equal_one_call(cuda):
    """Two calls with the state carried equal one call over the whole
    sequence: the same per-column arithmetic, only the split differs."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    r, k, v, w, u, s0 = _wkv_case(gen, cuda, torch.bfloat16, 2, 4, 150, 64)
    y, sT = rwkv6_scan_fwd(r, k, v, w, u, s0)
    h = 70
    y1, s1 = rwkv6_scan_fwd(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0)
    y2, s2 = rwkv6_scan_fwd(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 2), y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2, sT, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [1, 37])
def test_rwkv6_kernel_in_place_state_equals_out_of_place(cuda, S):
    """``state_out=s0`` (a decode step updating its cache) gives the
    out-of-place result bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    r, k, v, w, u, s0 = _wkv_case(gen, cuda, torch.bfloat16, 4, 40, S, 64)
    y, sT = rwkv6_scan_fwd(r, k, v, w, u, s0)
    state = s0.clone()
    y2, sT2 = rwkv6_scan_fwd(r, k, v, w, u, state, state_out=state)
    assert sT2 is state
    assert torch.equal(y2, y) and torch.equal(state, sT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rwkv6_kernel_bitwise_independent_of_column_split(cuda, dtype):
    """The reduction over k has a fixed order per column, so the value
    columns per CTA (the wrapper's ``_cols`` hook, ``fwd_plan``'s by
    default) do not change a bit of y, sT or the saved states."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    args = _wkv_case(gen, cuda, dtype, 2, 3, 77, 64)
    y0, s0_, st0 = rwkv6_scan_fwd(*args, save_states=True)
    y1, s1 = rwkv6_scan_fwd(*args)
    assert torch.equal(y1, y0) and torch.equal(s1, s0_)
    for cols in (4, 8, 16, 32):
        y, s, st = rwkv6_scan_fwd(*args, save_states=True, _cols=cols)
        assert torch.equal(y, y0) and torch.equal(s, s0_) and torch.equal(st, st0), cols
        y, s = rwkv6_scan_fwd(*args, _cols=cols)
        assert torch.equal(y, y0) and torch.equal(s, s0_), cols


def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(11)
    r, k, v, w, u, s0 = _wkv_case(gen, cuda, torch.float32, 1, 2, 8, 64)
    with pytest.raises(ValueError, match="cols"):
        rwkv6_scan_fwd(r, k, v, w, u, s0, _cols=6)
    with pytest.raises(TypeError):
        rwkv6_scan_fwd(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="s0"):
        rwkv6_scan_fwd(r, k, v, w, u, s0.transpose(2, 3))
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        rwkv6_scan_fwd(q, q, q, q, torch.zeros(2, 48, device=cuda),
                       torch.zeros(1, 2, 48, 48, device=cuda))


def test_rwkv6_kernels_refuse_views_the_loads_cannot_take(cuda):
    """Rows are loaded by TMA, which needs 16-byte aligned row starts: a
    view whose base or row stride is not 16-byte aligned, or whose state is
    not, is refused (never copied or sent down the plain path)."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    r, k, v, w, u, s0 = _wkv_case(gen, cuda, torch.bfloat16, 1, 2, 9, 64)
    odd = torch.zeros(1 * 2 * 9 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    shifted = odd[1:1 + r.numel()].view(r.shape)          # base off by 2 bytes
    padded = torch.zeros(1, 2, 9, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    for bad in (shifted, padded):                           # row stride 136 bytes
        with pytest.raises(ValueError, match="16-byte"):
            rwkv6_scan_fwd(bad, k, v, w, u, s0)
        with pytest.raises(ValueError, match="16-byte"):
            rwkv6_scan_fwd(r, k, bad, w, u, s0, save_states=True)
    s_odd = torch.zeros(s0.numel() + 4, device=cuda)[1:1 + s0.numel()].view(s0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan_fwd(r, k, v, w, u, s_odd)
    _, _, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
    dy = torch.zeros(w.shape, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan_bwd(shifted, k, v, w, dy, u, starts, s0)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan_bwd(r, k, v, w, torch.zeros(1, 2, 9, 65, device=cuda)[..., :64],
                       u, starts, s0)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan_bwd(r, k, v, w, dy, u, starts, s_odd)


def test_rwkv_decoder_kernel_path_matches_plain_path(cuda):
    """rwkv6-3b smoke config in f32 on the card: prefill (S=37) and three
    decode steps, kernel path against the plain path, within 2e-4 of
    max |logit| (the two differ only in the scan's summation order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config("rwkv6-3b")
    kern, plain = build_model(cfg), build_model(cfg, plain=True)
    params = kern.init(torch.Generator(device=cuda).manual_seed(12), device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (2, 37), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(13))
    reset_counts()
    with torch.inference_mode():
        lk, ck = kern.prefill(params, tokens=toks)
        lp, cp = plain.prefill(params, tokens=toks)
        for step in range(4):
            scale = lp.abs().max()
            assert (lk - lp).abs().max() <= 2e-4 * scale, step
            if step == 3:
                break
            tok = torch.argmax(lp, -1)[:, None]
            lk, ck = kern.decode_step(params, ck, tokens=tok, pos=37 + step)
            lp, cp = plain.decode_step(params, cp, tokens=tok, pos=37 + step)
    assert LAUNCHES["rwkv6_scan"] == 4 * cfg.num_layers
    assert PLAIN_CALLS["rwkv6_scan"] == 4 * cfg.num_layers


# --------------------------------------------------- RWKV-6 scan backward (B7)

BWD_TOL = 1e-4  # the reference's backward tolerance (tests/test_kernels.py), f32


def _bwd_case(gen, dev, dtype, B, H, S, hd, *, model_layout=False):
    """A forward case plus dy (f32, in the model's layout when asked) and a
    nonzero dsT."""
    r, k, v, w, u, s0 = _wkv_case(gen, dev, dtype, B, H, S, hd,
                                  model_layout=model_layout)
    shape = (B, S, H, hd) if model_layout else (B, H, S, hd)
    dy = torch.randn(shape, generator=gen, device=dev)
    dy = dy.transpose(1, 2) if model_layout else dy
    dsT = 0.5 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
    return (r, k, v, w, u, s0), dy, dsT


def _assert_bwd_close(got, ref, dtype):
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for name, a, b in zip(names, got, ref):
        tol = 2e-2 if (name in ("dr", "dk", "dv") and dtype == torch.bfloat16) else BWD_TOL
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 37, 64, 130, 2048])
def test_rwkv6_bwd_kernel_matches_plain(cuda, dtype, hd, S):
    gen = torch.Generator(device=cuda).manual_seed(20)
    B, H = (2, 3) if S < 2048 else (1, 2)
    (r, k, v, w, u, s0), dy, dsT = _bwd_case(gen, cuda, dtype, B, H, S, hd)
    reset_counts()
    y, sT, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
    got = rwkv6_scan_bwd(r, k, v, w, dy, u, starts, dsT)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan"] == LAUNCHES["rwkv6_scan_bwd"] == 1
    y_ref, sT_ref, starts_ref = rwkv6_scan_ref(r, k, v, w, u, s0, save_states=True)
    torch.testing.assert_close(starts, starts_ref, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(y, y_ref, atol=WKV_TOL, rtol=WKV_TOL)
    _assert_bwd_close(got, rwkv6_scan_bwd_ref(r, k, v, w, dy, u, starts, dsT), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rwkv6_bwd_kernel_model_layout_and_bitwise_repeatable(cuda, dtype):
    """Strided (B,H,S,hd) views of (B,S,H,hd) storage in, the same layout
    out; two runs agree bit for bit (the cluster's partials are summed in
    rank order through shared memory, no float atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    (r, k, v, w, u, s0), dy, dsT = _bwd_case(gen, cuda, dtype, 2, 40, 100, 64,
                                             model_layout=True)
    _, _, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
    got = rwkv6_scan_bwd(r, k, v, w, dy, u, starts, dsT)
    for t in got[:4]:
        assert t.transpose(1, 2).is_contiguous()
    again = rwkv6_scan_bwd(r, k, v, w, dy, u, starts, dsT)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = rwkv6_scan_bwd_ref(*(t.contiguous() for t in (r, k, v, w, dy, u)),
                             starts, dsT)
    _assert_bwd_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 37, 130])
def test_rwkv6_bwd_kernel_matches_plain_on_model_layout_views(cuda, S, hd, dtype):
    """B7, each head split over a cluster of 4 CTAs, on (B,H,S,hd) views of
    (B,S,H,hd) storage against the plain backward, nonzero s0 and dsT,
    ragged and one-step chunks, and no plain call."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    (r, k, v, w, u, s0), dy, dsT = _bwd_case(gen, cuda, dtype, 2, 3, S, hd,
                                             model_layout=True)
    _, _, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
    reset_counts()
    got = rwkv6_scan_bwd(r, k, v, w, dy, u, starts, dsT)
    torch.cuda.synchronize()
    assert LAUNCHES["rwkv6_scan_bwd"] == 1 and PLAIN_CALLS["rwkv6_scan_bwd"] == 0
    for t in got[:4]:
        assert t.transpose(1, 2).is_contiguous()
    ref = rwkv6_scan_bwd_ref(*(t.contiguous() for t in (r, k, v, w, dy, u)), starts, dsT)
    _assert_bwd_close(got, ref, dtype)


@pytest.mark.parametrize("S", [37, 130])
def test_rwkv6_op_gradients_equal_autograd_through_plain(cuda, S):
    """The autograd op (B5 with save_states, then B7) against autograd
    through the plain forward, f32, every input's gradient, nonzero s0 and
    a used sT."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    args, dy, dsT = _bwd_case(gen, cuda, torch.float32, 2, 4, S, 64)
    grads = []
    for impl in ("kernel", "ref"):
        leaves = [a.clone().requires_grad_(True) for a in args]
        y, sT = (rwkv6_scan if impl == "kernel" else rwkv6_scan_ref)(*leaves)
        grads.append(torch.autograd.grad((y * dy).sum() + (sT * dsT).sum(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=BWD_TOL, rtol=BWD_TOL)


def test_rwkv6_op_refuses_state_out_under_grad_and_mixed_devices(cuda):
    gen = torch.Generator(device=cuda).manual_seed(23)
    r, k, v, w, u, s0 = _wkv_case(gen, cuda, torch.float32, 1, 2, 8, 64)
    rg = r.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="state_out"):
        rwkv6_scan(rg, k, v, w, u, s0, state_out=s0)
    _, _, starts = rwkv6_scan_fwd(r, k, v, w, u, s0, save_states=True)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan_bwd(r, k, v, w, r.cpu(), u, starts, s0)
    with pytest.raises(ValueError, match="s_starts"):
        rwkv6_scan_bwd(r, k, v, w, r, u, starts[:, :, :0], s0)


def test_rwkv_train_step_kernel_path_matches_plain_path(cuda):
    """rwkv6-3b smoke config in f32 on the card, two train steps (two
    microbatches, remat="full"): the kernel path's losses against the plain
    path's within 5e-4, and the kernels launched as the path predicts."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    cfg = smoke_config("rwkv6-3b").replace(num_microbatches=2, remat="full")
    data = SyntheticBatches(cfg, 4, 130, seed=0)
    losses = {}
    for plain in (False, True):
        model = build_model(cfg, plain=plain)
        opt = AdamW(lr=constant_schedule(1e-3))
        params = model.init(torch.Generator(device=cuda).manual_seed(24), device=cuda)
        state, step = opt.init_state(params), make_train_step(model, opt)
        reset_counts()
        losses[plain] = []
        for i in range(2):
            state, metrics = step(state, data.batch(i))
            losses[plain].append(float(metrics["loss"]))
        n = 2 * 2 * cfg.num_layers  # steps x microbatches x layers
        if plain:
            assert LAUNCHES["rwkv6_scan"] == LAUNCHES["rwkv6_scan_bwd"] == 0
        else:
            assert LAUNCHES["rwkv6_scan"] == 2 * n and LAUNCHES["rwkv6_scan_bwd"] == n
            assert PLAIN_CALLS["rwkv6_scan"] == PLAIN_CALLS["rwkv6_scan_bwd"] == 0
    np.testing.assert_allclose(losses[False], losses[True], atol=5e-4, rtol=5e-4)


# ------------------------------------------------- Mamba selective scan (B4)

SSM_TOL = 1e-4  # the reference's SSM tolerance (tests/test_kernels.py)


def _ssm_case(gen, dev, B, S, Di, N):
    """Inputs as the model makes them: dt > 0 (a softplus), A < 0 in the
    S4D-real init's range, unit-scale x, B, C, D and a nonzero h0."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = torch.nn.functional.softplus(randn(B, S, Di) - 1.0)
    A = -(0.5 + 15.5 * torch.rand((Di, N), generator=gen, device=dev))
    return (randn(B, S, Di), dt, A, randn(B, S, N), randn(B, S, N), randn(Di),
            0.5 * randn(B, Di, N))


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("Di", [200, 256, 16384])
@pytest.mark.parametrize("S", [1, 37, 64, 130, 1000])
@pytest.mark.parametrize("B", [1, 4])
def test_ssm_scan_kernel_matches_plain(cuda, B, S, Di, N):
    """Di=200 leaves the last CTA's channels ragged."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    args = _ssm_case(gen, cuda, B, S, Di, N)
    reset_counts()
    y, hT = ssm_scan(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == 1 and PLAIN_CALLS["ssm_scan"] == 0
    y_ref, hT_ref = ssm_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, atol=SSM_TOL, rtol=SSM_TOL)
    torch.testing.assert_close(hT, hT_ref, atol=SSM_TOL, rtol=SSM_TOL)


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("S", [1, 37])
def test_ssm_scan_kernel_in_place_state_and_bitwise_repeatable(cuda, S, N):
    """``state_out=h0`` (a decode step updating its cache) gives the
    out-of-place result bit for bit, and two runs agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    x, dt, A, Bc, Cc, D, h0 = _ssm_case(gen, cuda, 4, S, 16384, N)
    y, hT = ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0)
    y_again, hT_again = ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0)
    assert torch.equal(y, y_again) and torch.equal(hT, hT_again)
    state = h0.clone()
    y2, h2 = ssm_scan_fwd(x, dt, A, Bc, Cc, D, state, state_out=state)
    assert h2 is state
    assert torch.equal(y2, y) and torch.equal(state, hT)


def test_ssm_scan_kernel_chained_calls_equal_one_call(cuda):
    gen = torch.Generator(device=cuda).manual_seed(32)
    x, dt, A, Bc, Cc, D, h0 = _ssm_case(gen, cuda, 2, 150, 512, 16)
    y, hT = ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0)
    h = 70  # not a multiple of the kernel's 16-step chunk
    cut = [t[:, :h].contiguous() for t in (x, dt, Bc, Cc)]
    rest = [t[:, h:].contiguous() for t in (x, dt, Bc, Cc)]
    y1, h1 = ssm_scan_fwd(cut[0], cut[1], A, cut[2], cut[3], D, h0)
    y2, h2 = ssm_scan_fwd(rest[0], rest[1], A, rest[2], rest[3], D, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, hT)


def test_ssm_scan_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(33)
    x, dt, A, Bc, Cc, D, h0 = _ssm_case(gen, cuda, 1, 8, 64, 16)
    with pytest.raises(ValueError, match="state dim"):
        ssm_scan_fwd(x, dt, A[:, :4].contiguous(), Bc[..., :4].contiguous(),
                     Cc[..., :4].contiguous(), D, h0[..., :4].contiguous())
    with pytest.raises(TypeError):
        ssm_scan_fwd(x.bfloat16(), dt, A, Bc, Cc, D, h0)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)  # x's shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_fwd(strided, dt, A, Bc, Cc, D, h0)
    with pytest.raises(ValueError, match="shapes"):
        ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0[:, :32])
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_fwd(x, dt, A, Bc, Cc, D, h0.cpu())
    with pytest.raises(ValueError, match="state_out"):
        ssm_scan(x.clone().requires_grad_(True), dt, A, Bc, Cc, D, h0, state_out=h0)


def test_jamba_decoder_kernel_path_matches_plain_path(cuda):
    """jamba smoke config without experts (14 Mamba and 2 attention layers)
    in f32 on the card: prefill (S=37) and three decode steps, kernel path
    against the plain path, within 2e-4 of max |logit| (the two differ only
    in the kernels' summation order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config("jamba-1.5-large-398b").replace(
        moe_period=0, num_experts=0, experts_per_token=0)
    kern, plain = build_model(cfg), build_model(cfg, plain=True)
    params = kern.init(torch.Generator(device=cuda).manual_seed(34), device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (2, 37), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(35))
    reset_counts()
    with torch.inference_mode():
        lk, ck = kern.prefill(params, tokens=toks, max_len=64)
        lp, cp = plain.prefill(params, tokens=toks, max_len=64)
        for step in range(4):
            scale = lp.abs().max()
            assert (lk - lp).abs().max() <= 2e-4 * scale, step
            if step == 3:
                break
            tok = torch.argmax(lp, -1)[:, None]
            lk, ck = kern.decode_step(params, ck, tokens=tok, pos=37 + step)
            lp, cp = plain.decode_step(params, cp, tokens=tok, pos=37 + step)
    n_mamba = [s.mixer for s in kern.layer_specs].count("mamba")
    assert n_mamba == 14
    assert LAUNCHES["ssm_scan"] == PLAIN_CALLS["ssm_scan"] == 4 * n_mamba
    assert LAUNCHES["flash_attention"] == 2 and LAUNCHES["decode_attention"] == 6


# ------------------------------------------- Mamba selective-scan backward (B6)

SSM_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _ssm_bwd_case(gen, dev, B, S, Di, N):
    """A forward case, its checkpoints from B4's ``save_states``, and a
    nonzero dy and dhT."""
    fwd = _ssm_case(gen, dev, B, S, Di, N)
    _, _, starts = ssm_scan_fwd(*fwd, save_states=True)
    dy = torch.randn((B, S, Di), generator=gen, device=dev)
    dhT = 0.5 * torch.randn((B, Di, N), generator=gen, device=dev)
    return fwd, (*fwd[:6], dy, starts, dhT)


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("Di", [200, 16384])
@pytest.mark.parametrize("S", [1, 37, 130, 1024])
@pytest.mark.parametrize("B", [1, 2])
def test_ssm_bwd_kernel_matches_plain(cuda, B, S, Di, N):
    """B4's checkpoints against the plain forward's, then B6 against the
    plain backward on them; Di=200 leaves the last CTA's channels ragged."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    fwd, args = _ssm_bwd_case(gen, cuda, B, S, Di, N)
    _, _, starts_ref = ssm_scan_ref(*fwd, save_states=True)
    torch.testing.assert_close(args[7], starts_ref, atol=SSM_TOL, rtol=SSM_TOL)
    reset_counts()
    got = ssm_scan_bwd(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan_bwd"] == 1 and PLAIN_CALLS["ssm_scan_bwd"] == 0
    for name, a, b in zip(SSM_NAMES, got, ssm_scan_bwd_ref(*args)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, name
        torch.testing.assert_close(a, b, atol=SSM_TOL, rtol=SSM_TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("N", [8, 16])
def test_ssm_bwd_kernel_bitwise_repeatable_and_writes_nothing_in_place(cuda, N):
    gen = torch.Generator(device=cuda).manual_seed(41)
    _, args = _ssm_bwd_case(gen, cuda, 2, 130, 16384, N)
    before = [t.clone() for t in args]
    got = ssm_scan_bwd(*args)
    again = ssm_scan_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_ssm_save_states_leaves_the_scan_unchanged(cuda):
    """B4 with ``save_states`` (its own template instance) gives the
    serving instance's y and hT bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(42)
    args = _ssm_case(gen, cuda, 2, 150, 16384, 16)
    y, hT = ssm_scan_fwd(*args)
    y2, hT2, starts = ssm_scan_fwd(*args, save_states=True)
    assert torch.equal(y, y2) and torch.equal(hT, hT2)
    assert starts.shape == (2, 19, 16384, 16)
    assert torch.equal(starts[:, 0], args[6])


def test_ssm_bwd_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(43)
    _, args = _ssm_bwd_case(gen, cuda, 1, 20, 64, 16)
    x, dt, A, Bc, Cc, D, dy, starts, dhT = args
    with pytest.raises(ValueError, match="shapes"):
        ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy, starts[:, :2].contiguous(), dhT)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy.cpu(), starts, dhT)
    with pytest.raises(TypeError):
        ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy.double(), starts, dhT)
    strided = dy.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_bwd(x, dt, A, Bc, Cc, D, strided, starts, dhT)
    with pytest.raises(ValueError, match="aligned"):
        ssm_scan_bwd(x, dt, A, Bc, Cc, D, dy, starts,
                     torch.empty(dhT.numel() + 1, device=cuda)[1:].view_as(dhT))


@pytest.mark.parametrize("S", [37, 130])
def test_ssm_op_gradients_equal_autograd_through_plain(cuda, S):
    """The autograd op (B4 with save_states, then B6) against autograd
    through the plain forward, every input's gradient, nonzero h0 and a
    used hT."""
    gen = torch.Generator(device=cuda).manual_seed(44)
    args = _ssm_case(gen, cuda, 2, S, 512, 16)
    dy = torch.randn((2, S, 512), generator=gen, device=cuda)
    dhT = torch.randn((2, 512, 16), generator=gen, device=cuda)
    grads = []
    for impl in ("kernel", "ref"):
        leaves = [a.clone().requires_grad_(True) for a in args]
        reset_counts()
        y, hT = (ssm_scan if impl == "kernel" else ssm_scan_ref)(*leaves)
        grads.append(torch.autograd.grad((y * dy).sum() + (hT * dhT).sum(), leaves))
        assert LAUNCHES["ssm_scan_bwd"] == (impl == "kernel")
        assert PLAIN_CALLS["ssm_scan_bwd"] == 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=SSM_TOL, rtol=SSM_TOL)


# ----------------------------------------------------- flash op backward


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=48, softcap=30.0)],
                         ids=["causal", "window_softcap"])
def test_flash_op_backward_on_the_card(cuda, dtype, kw):
    """The flash op under autograd: B2 forward (no plain call), and dq, dk,
    dv from its recomputing backward against autograd through the plain
    version, at jamba's head grouping (G=8)."""
    gen = torch.Generator(device=cuda).manual_seed(45)
    B, H, KV, S, hd = 1, 16, 2, 300, 128
    q, do = (_randn(gen, (B, H, S, hd), dtype, cuda) for _ in range(2))
    k, v = (_randn(gen, (B, KV, S, hd), dtype, cuda) for _ in range(2))
    grads = []
    for op in (flash_attention, attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_counts()
        o = op(*leaves, **kw)
        grads.append(torch.autograd.grad(o, leaves, do))
        if op is flash_attention:
            assert LAUNCHES["flash_attention"] == 1 and PLAIN_CALLS["flash_attention"] == 0
            assert BWD_CALLS["flash_attention_bwd"] == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def test_jamba_train_step_kernel_path_matches_plain_path(cuda):
    """One block of the jamba smoke config without experts in f32 on the
    card, two train steps (two microbatches, remat="full", f32 moments):
    the kernel path's losses against the plain path's within 5e-4, and the
    kernels launched as the path predicts."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    cfg = smoke_config("jamba-1.5-large-398b").replace(
        num_layers=8, moe_period=0, num_experts=0, experts_per_token=0,
        num_microbatches=2, remat="full")
    data = SyntheticBatches(cfg, 4, 130, seed=0)
    losses = {}
    for plain in (False, True):
        model = build_model(cfg, plain=plain)
        opt = AdamW(lr=constant_schedule(1e-3))
        params = model.init(torch.Generator(device=cuda).manual_seed(46), device=cuda)
        state, step = opt.init_state(params), make_train_step(model, opt)
        reset_counts()
        losses[plain] = []
        for i in range(2):
            state, metrics = step(state, data.batch(i))
            losses[plain].append(float(metrics["loss"]))
        n = 2 * 2 * 7  # steps x microbatches x Mamba layers
        if plain:
            assert sum(LAUNCHES.values()) == 0
        else:
            assert LAUNCHES["ssm_scan"] == 2 * n and LAUNCHES["ssm_scan_bwd"] == n
            assert LAUNCHES["flash_attention"] == 2 * 2 * 2
            assert BWD_CALLS["flash_attention_bwd"] == 2 * 2
            assert sum(PLAIN_CALLS.values()) == 0
    np.testing.assert_allclose(losses[False], losses[True], atol=5e-4, rtol=5e-4)


# -------------------------------------------------------------- fluid engine
#
# The scheduler's fluid engine (``repro_torch.core.simtorch``) on the card
# against the same program on the CPU, at the quick scale (400 servers, 4 h):
# summaries to rtol 1e-5, series to 1e-5 of their max |value|.

def _fluid_close(got, ref):
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=1e-5, atol=0, err_msg=k)
    assert sorted(got.series) == sorted(ref.series)
    for k, v in ref.series.items():
        assert np.abs(got.series[k] - v).max() <= 1e-5 * np.abs(v).max(), k


@pytest.mark.parametrize("name", ["coaster_r3", "burst_guard_r3", "google_r3"])
def test_fluid_run_on_the_card_matches_cpu(cuda, name):
    from repro_torch import exp
    from repro_torch.sched import get_scenario

    trace = get_scenario(name).trace(quick=True)
    got = exp.run(name, "fluid", quick=True, trace=trace, device=cuda)
    ref = exp.run(name, "fluid", quick=True, trace=trace, device="cpu")
    _fluid_close(got, ref)


def test_fluid_cube_on_the_card_matches_cpu(cuda):
    from repro_torch import exp
    from repro_torch.sched import get_scenario

    grid = {"replace_fraction": [0.0, 0.25, 0.5, 0.75, 1.0],
            "threshold": list(np.linspace(0.85, 0.99, 8)),
            "max_transient": list(np.linspace(0.0, 24.0, 7))}
    trace = get_scenario("coaster_r3").trace(quick=True)
    got = exp.sweep("coaster_r3", grid, engine="fluid", quick=True, trace=trace,
                    device=cuda)
    ref = exp.sweep("coaster_r3", grid, engine="fluid", quick=True, trace=trace,
                    device="cpu")
    assert got.shape == ref.shape == (5, 8, 7)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, rtol=1e-5, atol=0, err_msg=k)
    assert got.best("short_avg_wait_s") == pytest.approx(
        ref.best("short_avg_wait_s"), rel=1e-5)


def test_fluid_slot_loop_never_waits_on_the_card(cuda):
    """Every slot is enqueued without a host sync: the whole run, uploads
    included, passes under the sync debug mode that raises on one."""
    from repro_torch.core import simtorch
    from repro_torch.sched import get_scenario

    lw, sw, fcfg, ctrl = get_scenario("spot_r3").fluid_setup(quick=True)
    pol = get_scenario("spot_r3").fluid_params(quick=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = simtorch.simulate_fluid(lw, sw, fcfg, policy=pol, device=cuda, **ctrl)
        grid = simtorch.sweep(lw, sw, fcfg, [0.9, 0.95], [0.0, 12.0],
                              policy=pol, replace_fractions=[0.5, 1.0],
                              n_short_reserved=8, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["series"]["lr"].device.type == "cuda"
    assert tuple(grid["avg_lr"].shape) == (2, 2, 2)
    assert torch.isfinite(out["avg_short_delay"]).item()


# ------------------------------------------------------------ serving fleet
#
# The elastic serving fleet on the host with a model on the card behind its
# decode hook (the example's gemma2-2b smoke decoder, paged KV), through
# serve_batched_yahoo's quick trace cut to 300 s: the scheduler's metrics and
# per-tick events equal the run without a model, every tick's decode runs
# through B1 and every admission's prefill through B2, and no plain version
# runs.

def test_serving_fleet_decodes_through_the_kernels(cuda):
    import json

    from repro_torch import exp
    from repro_torch.examples.serve_bursty import build_decoder

    kw = dict(quick=True, trace_overrides={"horizon": 300.0}, record_events=True)
    bare = exp.run("serve_batched_yahoo", "serving", **kw)
    decode_fn, stats = build_decoder("paged", device=cuda)
    reset_counts()
    got = exp.run("serve_batched_yahoo", "serving", decode_fn=decode_fn, **kw)
    torch.cuda.synchronize()
    launches, plain = dict(LAUNCHES), dict(PLAIN_CALLS)
    assert json.dumps(got.metrics) == json.dumps(bare.metrics)
    assert np.array_equal(got.series["event_counts"], bare.series["event_counts"])
    b = stats["batcher"]
    n_attn = sum(s.mixer == "attn" for s in b.model.layer_specs)
    assert stats["calls"] == b.step_count > 0
    assert launches["paged_decode_attention"] == b.step_count * n_attn
    assert launches["flash_attention"] == len(stats["requests"]) * n_attn
    assert sum(plain.values()) == 0, plain


# -------------------------------------------------------- serving fleet
#
# The serving-fleet kernel (one thread block a lane, the whole horizon in
# one launch) against its plain version on the CPU, bit for bit, on random
# workloads of the shape of tests/test_serving_jax.py:_rand_workload: lane
# counts 1, 7 and 54 over a (threshold x budget x slots x seed) grid, with
# revocations and spot pricing, and with three tenants' credit buckets and
# 8-entry queues that overflow.

def _fleet_lanes(kind, lanes, seed=0, n=200, T=400):
    from repro_torch.runtime import serving_torch as st
    from repro_torch.runtime.serving import Request, ServingFleetConfig

    rng = np.random.default_rng(seed)
    arr = np.sort(rng.integers(0, T - 20, n))
    n_t = 3 if kind == "tenants" else 1
    reqs = [Request(i, int(arr[i]), int(rng.integers(1, 9)), tenant_id=i % n_t)
            for i in range(n)]
    pin = np.zeros(T, int)
    pin[50:350] = int(rng.integers(1, 3))
    pin[350:T] = 3
    cfg = ServingFleetConfig(n_replicas=3, max_transient=3, max_slots=2, threshold=0.5,
                             provisioning_delay=3.0, tick_s=1.0,
                             revocation_mttf=40.0 if kind == "spot" else 0.0,
                             hedge_factor=1.0)
    spec = st.make_spec(cfg, n_requests=n, max_ticks=T,
                        max_arrivals_per_tick=int(np.bincount(arr).max()),
                        spot_pricing=kind == "spot", n_tenants=n_t,
                        queue_cap=8 if kind == "tenants" else None,
                        drain_preference="oldest" if kind == "spot" else "least_loaded")
    consts = st.build_consts(spec, reqs, pin)
    grid = [(s, t, k, m) for s in (0, 1, 2) for t in (0.25, 0.5, 0.75)
            for k in (1, 2, 3) for m in (1, 2)][:lanes]
    params = st.cube_params(cfg, grid)
    if kind == "tenants":
        params["credit_rate"] = np.tile(np.float32([0.5, 0.0, 2.0]), (lanes, 1))
        params["credit_burst"] = np.tile(np.float32([6.0, 3.0, 1e9]), (lanes, 1))
    keys = np.stack([st._seed_key(s + 7 * seed) for s, _, _, _ in grid])
    lanes_p = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    return spec, lanes_p, consts, torch.as_tensor(keys)


@pytest.mark.parametrize("kind", ["plain", "spot", "tenants"])
@pytest.mark.parametrize("lanes", [1, 7, 54])
def test_serving_fleet_kernel_matches_plain(cuda, kind, lanes):
    from repro_torch.kernels.serving_fleet.ops import serving_fleet

    spec, params, consts, keys = _fleet_lanes(kind, lanes, seed=lanes)
    reset_counts()
    got = serving_fleet(spec, params, consts, (keys[:, 0].to(cuda), keys[:, 1].to(cuda)))
    torch.cuda.synchronize()
    assert LAUNCHES["serving_fleet"] == 1 and sum(PLAIN_CALLS.values()) == 0
    ref = serving_fleet(spec, params, consts, (keys[:, 0], keys[:, 1]))
    assert PLAIN_CALLS["serving_fleet"] == 1
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        g = got[k].cpu()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g, v), k
    assert int(ref["event_counts"].sum()) > 0


def test_serving_fleet_launch_events_time_each_launch_alone(cuda):
    """``kernel.LAUNCH_EVENTS`` gets one pair of events a launch, and the
    outputs are those of an untimed launch."""
    from repro_torch.kernels.serving_fleet import kernel
    from repro_torch.kernels.serving_fleet.ops import serving_fleet

    spec, params, consts, keys = _fleet_lanes("plain", 7, seed=3)
    key = (keys[:, 0].to(cuda), keys[:, 1].to(cuda))
    plain = serving_fleet(spec, params, consts, key)
    kernel.LAUNCH_EVENTS = events = []
    try:
        timed = serving_fleet(spec, params, consts, key)
        timed_again = serving_fleet(spec, params, consts, key)
    finally:
        kernel.LAUNCH_EVENTS = None
    serving_fleet(spec, params, consts, key)
    torch.cuda.synchronize()
    assert len(events) == 2 and all(a.elapsed_time(b) > 0 for a, b in events)
    for k, v in plain.items():
        assert torch.equal(timed[k], v) and torch.equal(timed_again[k], v), k


# ------------------------------------------------- arrivals batch sampler
#
# The slot-binned batch sampler (``repro_torch.workload.arrivals``) on the
# card against the same program on the CPU, 512 seeds x 1,440 one-minute
# slots, to chip_smoke.py phase 10 (b)'s bounds: rate grids bit for bit
# (rtol 1e-6 where sin is applied per slot), counts on all but 1e-4 of the
# entries (a last-bit difference of log/lgamma may flip a rejection test),
# two card calls equal, a seed alone equal to its row, the mean rate within
# 10% of ``mean_rate``.

def _arrival_process(name):
    from repro_torch.workload import MMPP, Diurnal, google_arrivals

    return {"google": google_arrivals(),
            "mmpp_trans": MMPP(rates=(0.02, 0.2), dwells=(1800.0, 600.0),
                               trans=((0.3, 0.7), (0.9, 0.1))),
            "diurnal": Diurnal(rate=0.05, rel_amplitude=0.7, period=4 * 3600.0)}[name]


@pytest.mark.parametrize("name", ["google", "mmpp_trans", "diurnal"])
def test_arrivals_sampler_on_the_card_matches_cpu(cuda, name):
    from repro_torch.runtime import threefry
    from repro_torch.workload import batch_sample_counts

    proc = _arrival_process(name)
    H, dt, seeds = 24 * 3600.0, 60.0, np.arange(512)
    grids = []
    for dev in (cuda, torch.device("cpu")):
        key = threefry.split(threefry.seed_key(torch.arange(512, device=dev)), 3)[0]
        t_grid = (torch.arange(1440, dtype=torch.float32, device=dev) + 0.5) * dt
        grids.append(proc.rate_grid(key, t_grid, dt).cpu().numpy())
    if name == "diurnal":
        np.testing.assert_allclose(grids[0], grids[1], rtol=1e-6, atol=0)
    else:
        assert np.array_equal(grids[0].view(np.uint32), grids[1].view(np.uint32))
    card = batch_sample_counts(proc, seeds, H, dt, device=cuda)
    cpu = batch_sample_counts(proc, seeds, H, dt, device="cpu")
    assert card.shape == (512, 1440) and card.dtype == np.int32
    misses = int((card != cpu).sum())
    assert misses <= 1e-4 * card.size, f"{misses} of {card.size} counts differ"
    assert np.array_equal(card, batch_sample_counts(proc, seeds, H, dt, device=cuda))
    assert np.array_equal(batch_sample_counts(proc, [7], H, dt, device=cuda)[0], card[7])
    assert abs(card.mean() / dt - proc.mean_rate(H)) <= 0.1 * proc.mean_rate(H)


# ---- the model families on the card: kernel path vs the CPU's plain path

@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "musicgen-medium", "paligemma-3b"])
def test_model_families_on_the_card_match_the_cpu(cuda, arch):
    """Smoke configs in f32, one set of weights: prefill and 3 dense decode
    steps on the card (B2, B3) against the same on the CPU, within the
    reference's model tolerance (5e-4); the MoE layers route alike."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    cfg = smoke_config(arch)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(1)
    B, S = 2, 37
    kw = {}
    if cfg.family == "audio":
        kw["embeds"] = torch.as_tensor(rng.normal(size=(B, S, cfg.d_model)),
                                       dtype=torch.float32)
    else:
        kw["tokens"] = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S)))
    if cfg.family == "vlm":
        kw["prefix_embeds"] = torch.as_tensor(
            rng.normal(size=(B, cfg.prefix_len, cfg.d_model)), dtype=torch.float32)
    P = S + cfg.prefix_len
    reset_counts()
    with torch.inference_mode():
        lc, cc = m.prefill(params, max_len=P + 4, **kw)
        lg, cg = m.prefill(on_card, max_len=P + 4, **_to(kw, cuda))
        torch.testing.assert_close(lg.cpu(), lc, atol=5e-4, rtol=5e-4)
        for t in range(3):
            if cfg.family == "audio":
                step = dict(embeds=torch.as_tensor(rng.normal(size=(B, 1, cfg.d_model)),
                                                   dtype=torch.float32))
            else:
                step = dict(tokens=torch.argmax(lc, -1)[:, None])
            lc, cc = m.decode_step(params, cc, pos=P + t, **step)
            lg, cg = m.decode_step(on_card, cg, pos=P + t, **_to(step, cuda))
            torch.testing.assert_close(lg.cpu(), lc, atol=5e-4, rtol=5e-4)
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    assert LAUNCHES["decode_attention"] == 3 * cfg.num_layers


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---- MoE training and the training extras: B2 with its softmax statistics,
# the chunked recompute backward (``cfg.flash_vjp``), remat="dots"

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S,kw", [
    (300, dict()), (300, dict(window=48)), (300, dict(softcap=30.0)),
    (300, dict(prefix_len=24)), (1000, dict(window=256, softcap=30.0)),
], ids=["causal", "window", "softcap", "prefix", "window_softcap"])
def test_flash_stats_kernel_matches_plain_chunked(cuda, dtype, S, kw):
    """B2 with ``stats=True`` against the plain chunked online softmax on
    the same inputs: out at the attention tolerance, m and l at 2e-5 (f32)
    or 2e-2 (bf16), of (1 + |value|); the output equals the launch
    without statistics bit for bit."""
    from repro_torch.kernels.flash_attention.ref import chunked_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(47)
    B, H, KV, hd = 2, 8, 2, 128
    q = _randn(gen, (B, S, H, hd), dtype, cuda).transpose(1, 2)
    k, v = (_randn(gen, (B, S, KV, hd), dtype, cuda).transpose(1, 2) for _ in range(2))
    reset_counts()
    o, m, l = flash_attention_fwd(q, k, v, **kw, stats=True)
    assert LAUNCHES["flash_attention_stats"] == 1 and LAUNCHES["flash_attention"] == 0
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape == (B, H, S)
    ro, rm, rl = chunked_attention_ref(q, k, v, chunk_q=128, chunk_k=256, **kw)
    tol = _tol(dtype)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, rm, atol=tol, rtol=tol)
    torch.testing.assert_close(l, rl, atol=tol, rtol=tol)
    assert torch.equal(o, flash_attention_fwd(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [dict(), dict(window=48, softcap=30.0), dict(prefix_len=24)],
                         ids=["causal", "window_softcap", "prefix"])
def test_chunked_backward_on_the_card_matches_full_backward(cuda, dtype, kw):
    """``flash_attention_vjp`` on the card (B2 with statistics, then the
    chunked backward, ragged chunks) against the O(S^2) recompute backward
    of the flash op on the same inputs (1e-4 f32, 2e-2 bf16)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp

    gen = torch.Generator(device=cuda).manual_seed(48)
    B, H, KV, S, hd = 1, 16, 2, 300, 128
    q, do = (_randn(gen, (B, H, S, hd), dtype, cuda) for _ in range(2))
    k, v = (_randn(gen, (B, KV, S, hd), dtype, cuda) for _ in range(2))
    grads = []
    for op, extra in ((flash_attention_vjp, dict(chunk_q=64, chunk_k=128)),
                      (flash_attention, {})):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_counts()
        grads.append(torch.autograd.grad(op(*leaves, **kw, **extra), leaves, do))
        if op is flash_attention_vjp:
            assert LAUNCHES["flash_attention_stats"] == 1 and sum(PLAIN_CALLS.values()) == 0
            assert BWD_CALLS["flash_attention_bwd_chunked"] == 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def _moe_train_losses(cfg, dev, steps=2):
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule

    model = build_model(cfg)
    opt = AdamW(lr=constant_schedule(1e-3))
    params = _to(model.init(torch.Generator().manual_seed(49), device="cpu"), dev)
    state, step = opt.init_state(params), make_train_step(model, opt)
    data = SyntheticBatches(cfg, 4, 96, seed=0)
    losses = []
    for i in range(steps):
        state, metrics = step(state, data.batch(i))
        losses.append([float(metrics[k]) for k in ("loss", "ce", "aux")])
    return np.array(losses), state


def test_mixtral_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """mixtral's smoke config in f32 under its optimized training variant
    (two microbatches, flash_vjp, small attention chunks): two train steps
    on the card (B2 with statistics, the chunked backward) against the same
    on the CPU, loss, ce and aux within 5e-4."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.optimized import OPTIMIZED

    cfg = smoke_config("mixtral-8x22b").replace(
        **OPTIMIZED["mixtral-8x22b"]["train"], remat="full", attn_chunk_q=32, attn_chunk_k=64)
    cpu, _ = _moe_train_losses(cfg, torch.device("cpu"))
    reset_counts()
    card, _ = _moe_train_losses(cfg, cuda)
    n = 2 * 2 * cfg.num_layers  # steps x microbatches x attention layers
    assert LAUNCHES["flash_attention_stats"] == 2 * n and LAUNCHES["flash_attention"] == 0
    assert BWD_CALLS["flash_attention_bwd_chunked"] == n and sum(PLAIN_CALLS.values()) == 0
    np.testing.assert_allclose(card, cpu, atol=5e-4, rtol=5e-4)


def test_remat_dots_equals_full_on_the_card(cuda):
    """remat="dots" against "full" on the card, mixtral's smoke config in
    f32 through the kernels: loss and every gradient leaf within 2e-4 of
    its max (the saved matmul outputs are the recomputed ones)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, unflatten

    cfg = smoke_config("mixtral-8x22b").replace(flash_vjp=True)
    params = _to(build_model(cfg).init(torch.Generator().manual_seed(50), device="cpu"), cuda)
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 96)),
                           device=cuda)
    out = {}
    for remat in ("dots", "full"):
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        loss, _ = build_model(cfg.replace(remat=remat)).loss(unflatten(params, live),
                                                             {"tokens": toks})
        out[remat] = (float(loss), torch.autograd.grad(loss, live))
    assert abs(out["dots"][0] - out["full"][0]) <= 2e-4 * abs(out["full"][0])
    for a, b in zip(out["dots"][1], out["full"][1]):
        assert (a - b).abs().max() <= 2e-4 * b.abs().max()


def test_moe_backward_on_the_card_is_bitwise_repeatable(cuda):
    """The MoE layer's backward on the card, twice from the same inputs,
    bit for bit: the dispatch's ``index_add_`` and the backward of its
    token gather add atomically, but each row receives at most
    ``experts_per_token`` (<= 2) values into zeros, and two float additions
    into zero give one result in either order."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import mlp

    cfg = smoke_config("mixtral-8x22b")
    assert cfg.experts_per_token <= 2
    p = mlp.init_moe(torch.Generator(device=cuda).manual_seed(51), cfg, torch.float32, cuda)
    x = _randn(torch.Generator(device=cuda).manual_seed(52), (2, 300, cfg.d_model),
               torch.float32, cuda)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True)] + [
            t.clone().requires_grad_(True) for t in p.values()]
        y, aux = mlp.apply_moe(dict(zip(p, leaves[1:])), leaves[0], cfg)
        runs.append(torch.autograd.grad((y.square().sum() + aux), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------- meshes


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group and its (1, 1) (data, model) mesh on
    the card (NCCL refuses two ranks on one device: the multi-rank checks
    run on the CPU under gloo, tests/test_torch_mesh.py)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_smoke_mesh((1, 1), device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_kernel_wrappers_refuse_dtensors(nccl_mesh):
    """A kernel reads data_ptr(): every wrapper and op raises on a DTensor
    instead of launching on a wrapper with no storage of its own."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.decode_attention.ops import decode_attention

    rep = [Replicate(), Replicate()]

    def d(t):
        return distribute_tensor(t, nccl_mesh, rep)

    q = d(torch.zeros(1, 2, 16, 32, device="cuda"))
    qd, kd = d(torch.zeros(1, 2, 32, device="cuda")), d(torch.zeros(1, 2, 16, 32, device="cuda"))
    x, A, bc, h0 = (d(torch.zeros(1, 4, 32, device="cuda")), d(torch.zeros(32, 16, device="cuda")),
                    d(torch.zeros(1, 4, 16, device="cuda")), d(torch.zeros(1, 32, 16, device="cuda")))
    r, u, s0 = (d(torch.zeros(1, 2, 16, 32, device="cuda")), d(torch.zeros(2, 32, device="cuda")),
                d(torch.zeros(1, 2, 32, 32, device="cuda")))
    D = d(torch.zeros(32, device="cuda"))
    reset_counts()
    for call in (lambda: flash_attention_fwd(q, q, q), lambda: flash_attention(q, q, q),
                 lambda: decode_attention_fwd(qd, kd, kd, d(torch.zeros(16, device="cuda"))),
                 lambda: decode_attention(qd, kd, kd, d(torch.zeros(16, device="cuda"))),
                 lambda: ssm_scan_fwd(x, x, A, bc, bc, D, h0),
                 lambda: ssm_scan(x, x, A, bc, bc, D, h0),
                 lambda: rwkv6_scan_fwd(r, r, r, r, u, s0),
                 lambda: rwkv6_scan(r, r, r, r, u, s0)):
        with pytest.raises(TypeError, match="DTensor"):
            call()
    assert sum(LAUNCHES.values()) == 0


def test_local_attention_on_a_mesh_equals_meshless(nccl_mesh):
    """Attention on DTensors under cp_fsdp rules runs B2 on local shards
    (``models.attention._mesh_attention``) and equals the meshless call bit
    for bit, forward and gradients."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.models.attention import grouped_attention
    from repro_torch.models.config import block_structure
    from repro_torch.parallel import logical_placements, use_sharding_ctx
    from repro_torch.parallel.layouts import layout_rules

    cfg = smoke_config("deepseek-coder-33b").replace(head_dim=64)
    spec = block_structure(cfg)[2][0]
    gen = torch.Generator(device="cuda").manual_seed(60)
    B, S, H, KV, hd = 2, 128, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (_randn(gen, (B, S, n, hd), torch.bfloat16, torch.device("cuda"))
               for n in (H, KV, KV))
    pos = torch.arange(S, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_counts()
    ref = grouped_attention(*leaves, pos, pos, cfg, spec, train=True)
    ref_grads = torch.autograd.grad(ref.float().square().sum(), leaves)
    rules = layout_rules(nccl_mesh, cfg, "train", global_batch=B, layout="cp_fsdp")
    with use_sharding_ctx(nccl_mesh, rules):
        names = (("batch", "act_seq", "heads", None),
                 ("batch", "act_kv_seq", "kv_heads", None),
                 ("batch", "act_kv_seq", "kv_heads", None))
        dl = [distribute_tensor(t.clone(), nccl_mesh, logical_placements(t, *n))
              .requires_grad_(True) for t, n in zip((q, k, v), names)]
        out = grouped_attention(*dl, pos, pos, cfg, spec, train=True)
        grads = torch.autograd.grad(out.float().square().sum(), dl)
    assert LAUNCHES["flash_attention"] == 2 and sum(PLAIN_CALLS.values()) == 0
    assert torch.equal(out.full_tensor(), ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g.full_tensor(), r)


def test_mixtral_smoke_mesh_train_step_equals_meshless_on_the_card(nccl_mesh):
    """One train step of mixtral's smoke config (MoE twin of ``_moe_smap``
    at tp 1, B2 on local shards) on the (1, 1) mesh against the step
    without one: the same loss and params."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree, full_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings
    from repro_torch.tree import leaves, map_tree

    cfg = smoke_config("mixtral-8x22b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(61), device="cuda")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 64)), device="cuda")}
    opt = AdamW(lr=constant_schedule(1e-3))
    plain_state, pm = make_train_step(model, opt)(
        opt.init_state(map_tree(lambda _, t: t.clone(), params)), batch)
    rules = layout_rules(nccl_mesh, cfg, "train", global_batch=4)
    dp = distribute_tree(params, to_shardings(param_specs(params, nccl_mesh, rules), nccl_mesh))
    with use_sharding_ctx(nccl_mesh, rules):
        state, m = make_train_step(model, opt)(opt.init_state(dp), batch)
    assert abs(float(m["loss"]) - float(pm["loss"])) <= 1e-5
    for a, b in zip(leaves(full_tree(state["params"])), leaves(plain_state["params"])):
        assert (a - b).abs().max() <= 1e-4


def _nccl_rank_probe(rank):
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    return dist.get_backend(), torch.cuda.current_device(), x.cpu().tolist()


def test_spawned_nccl_rank_runs_on_its_card(cuda, tmp_path):
    """``parallel.spawn`` with ``backend="nccl"``: rank r on card r (the
    ranks of ``examples/train_elastic.py`` on cards)."""
    from repro_torch.parallel.spawn import run_ranks

    got = run_ranks(_nccl_rank_probe, 1, store_dir=str(tmp_path), timeout_s=120,
                    backend="nccl")
    assert got == [("nccl", 0, [1.0] * 4)]


def test_train_elastic_example_wants_eight_cards(cuda):
    """The example's default runs 8 NCCL ranks, one a card: with fewer
    cards it raises, naming ``--device cpu``."""
    from repro_torch.examples import train_elastic

    if torch.cuda.device_count() >= train_elastic.RANKS:
        pytest.skip("this machine has the cards; the refusal is for fewer")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_elastic.main([])


# ---------------------------------------------------------------- step cost
# Each kernel op under ``parallel.cost.CostMode`` on the card: one call,
# counted by its formula (``kernels/<name>/ops.py``), none of the kernel
# wrapper's own ops (allocations, a backward's partial sums), and the same
# count as the op on meta tensors, where it takes its plain version.


def _cost_cases(dev):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.kernels.ssm_scan import ops as sops

    gen = torch.Generator(device=dev).manual_seed(21)

    def f32(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    B, H, KV, S, hd = 2, 8, 2, 96, 64
    flash = (f32(B, H, S, hd).bfloat16(), f32(B, KV, S, hd).bfloat16(),
             f32(B, KV, S, hd).bfloat16())
    flash_kw = dict(causal=True, window=40, prefix_len=5)
    L = 80
    dec = (f32(B, H, hd).bfloat16(), f32(B, L, KV, hd).bfloat16().transpose(1, 2),
           f32(B, L, KV, hd).bfloat16().transpose(1, 2), torch.zeros(B, L, device=dev))
    bs, P = 16, 5
    paged = (dec[0], f32(2 + B * P, bs, KV, hd).bfloat16(), f32(2 + B * P, bs, KV, hd).bfloat16(),
             (torch.arange(B * P, dtype=torch.int32, device=dev) + 2).reshape(B, P), dec[3])
    Sx, Di, N = 20, 256, 16
    ssm = (f32(B, Sx, Di), torch.rand((B, Sx, Di), generator=gen, device=dev),
           -torch.rand((Di, N), generator=gen, device=dev) - 0.5, f32(B, Sx, N), f32(B, Sx, N),
           f32(Di), f32(B, Di, N))
    Hr, hr = 4, 64
    rwkv = tuple(f32(B, Hr, Sx, hr).bfloat16() for _ in range(3)) + (
        0.2 + 0.7 * torch.rand((B, Hr, Sx, hr), generator=gen, device=dev), f32(Hr, hr),
        f32(B, Hr, hr, hr))
    return {
        "flash_attention": (fops.flash_attention, flash, flash_kw, fops.flash_attention_cost),
        "flash_attention_stats": (
            fops.flash_attention_vjp, flash, dict(flash_kw, chunk_q=32, chunk_k=32),
            lambda *a, **kw: fops.flash_attention_cost(*a, **kw, stats=True)),
        "decode_attention": (dops.decode_attention, dec, {}, dops.decode_attention_cost),
        "decode_attention_stats": (dops.decode_attention, dec, dict(stats=True),
                                   dops.decode_attention_cost),
        "paged_decode_attention": (dops.paged_decode_attention, paged, {},
                                   dops.paged_decode_attention_cost),
        "ssm_scan": (sops.ssm_scan, ssm, {}, sops.ssm_scan_cost),
        "rwkv6_scan": (rops.rwkv6_scan, rwkv, {}, rops.rwkv6_scan_cost),
    }


def _grad_args(op, args, device):
    """``args`` on ``device``; B2 with statistics takes a q that needs a
    gradient (its op is an autograd function)."""
    out = tuple(a.to(device) for a in args)
    if op == "flash_attention_stats":
        out = (out[0].detach().clone().requires_grad_(),) + out[1:]
    return out


@pytest.mark.parametrize("op", ["flash_attention", "flash_attention_stats",
                                "decode_attention", "decode_attention_stats",
                                "paged_decode_attention", "ssm_scan", "rwkv6_scan"])
def test_kernel_op_cost_on_the_card_is_its_formula_and_its_meta_count(cuda, op):
    from repro_torch.parallel.cost import CostMode

    fn, args, kw, cost_fn = _cost_cases(cuda)[op]
    counts = {}
    for dev in ("cuda", "meta"):
        a = _grad_args(op, args, dev)
        reset_counts()
        with CostMode() as cm:
            fn(*a, **kw)
        counts[dev] = cm
        if dev == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES[op] == 1
    cost = cost_fn(*_grad_args(op, args, "cuda"), **kw)
    card = counts["cuda"]
    assert card.kernel_calls == {op: 1}
    assert (card.flops, card.bytes, card.bytes_min) == (cost.flops, cost.bytes, cost.bytes)
    assert card.totals() == counts["meta"].totals()


@pytest.mark.parametrize("op", ["ssm_scan", "rwkv6_scan"])
def test_scan_backward_cost_on_the_card_is_its_formula_and_its_meta_count(cuda, op):
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.parallel.cost import CostMode

    fn, args, _, _ = _cost_cases(cuda)[op]
    counts = {}
    for dev in ("cuda", "meta"):
        live = [a.to(dev).detach().clone().requires_grad_() for a in args]
        out = fn(*live)
        grads = (torch.ones_like(out[0]), torch.zeros_like(out[1]))
        reset_counts()
        with CostMode() as cm:
            torch.autograd.grad(out, live, grads)
        counts[dev] = cm
        if dev == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES[op + "_bwd"] == 1
            if op == "ssm_scan":
                starts = sops.ssm_scan_fwd(*args, save_states=True)[2]
                cost = sops.ssm_scan_bwd_cost(*args[:6], grads[0], starts, grads[1])
            else:
                starts = rops.rwkv6_scan_fwd(*args, save_states=True)[2]
                r, k, v, w, u, _ = args
                cost = rops.rwkv6_scan_bwd_cost(r, k, v, w, grads[0], u, starts, grads[1])
    card = counts["cuda"]
    assert card.kernel_calls == {op + "_bwd": 1}
    assert (card.flops, card.bytes_min) == (cost.flops, cost.bytes)
    assert card.totals() == counts["meta"].totals()


def test_serving_fleet_op_cost_on_the_card_is_its_formula_and_its_cpu_count(cuda):
    """The fleet op has no meta route (its program reads host data); its
    count on the card is its formula and the plain version's on the CPU."""
    from repro_torch.kernels.serving_fleet import ops as fleet_ops
    from repro_torch.parallel.cost import CostMode
    from repro_torch.runtime import serving_torch as st
    from repro_torch.runtime.serving import Request, ServingFleetConfig

    cfg = ServingFleetConfig(n_replicas=2, max_transient=2, threshold=0.5,
                             provisioning_delay=3.0, tick_s=1.0)
    reqs = [Request(i, 3 * i, 2) for i in range(10)]
    pin = np.zeros(60, int)
    counts = {}
    for dev in ("cuda", "cpu"):
        _, _, spec = st.run_workload(cfg, reqs, pin, 60, device=dev)
        with CostMode() as cm:
            st.run_workload(cfg, reqs, pin, 60, device=dev)
        counts[dev] = cm
    card = counts["cuda"]
    assert card.kernel_calls == {"serving_fleet": 1}
    assert card.flops == 0 and card.bytes_min == fleet_ops.fleet_bytes(spec, 1)
    assert card.kernel_calls == counts["cpu"].kernel_calls
    assert card.bytes_min == counts["cpu"].bytes_min
