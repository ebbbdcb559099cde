"""Port kernels on the card: each hand-written CUDA kernel against its plain
PyTorch version on the same CUDA inputs, at the reference's tolerances
(atol 2e-5 for f32 and int8-dequantised pools, 2e-2 for bf16).

Needs a CUDA device and ``nvcc``; the ``cuda`` fixture skips every test here
otherwise (decided inside the fixture, never at import, so every xdist
worker collects the same tests). Run on the card with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_fwd, paged_decode_attention_fwd)
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref
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


def test_kernels_refuse_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_fwd(q[:, :, 0], q, q, torch.zeros(8, device=cuda))
