"""Port RWKV-6 path against the reference on the CPU: the plain WKV scan
against the reference's jnp oracle and its Pallas kernel in interpret mode
(atol = rtol = 1e-3, the reference's RWKV tolerance in tests/test_kernels.py),
the time-mix / channel-mix blocks and ``DecoderLM`` prefill / dense decode on
the rwkv6-3b smoke config (5e-4, the reference's model tolerance) through
weights converted with ``params_from_jax``, and the port's seeded init
against the reference's leaf shapes and dtypes.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as j_scan  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_scan_ref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402

ARCH = "rwkv6-3b"
SCAN_TOL = 1e-3
TOL = 5e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def _scan_inputs(B, H, S, hd, seed=0, s0_zero=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, S, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.999, size=(B, H, S, hd)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = (np.zeros((B, H, hd, hd), np.float32) if s0_zero
          else rng.normal(size=(B, H, hd, hd)).astype(np.float32))
    return r, k, v, w, u, s0


# ------------------------------------------------------------------- scan (B5)


@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (2, 3, 128, 32, 32), (1, 2, 96, 64, 16), (2, 1, 64, 64, 64),
    (2, 3, 37, 32, 37), (3, 2, 1, 64, 1),
], ids=["ref_a", "ref_b", "ref_c", "ragged37", "decode1"])
def test_plain_scan_matches_reference(B, H, S, hd, chunk):
    """The reference test's shapes, a ragged S and S=1; the Pallas kernel
    takes one chunk of the whole S where S does not tile."""
    args = _scan_inputs(B, H, S, hd)
    reset_counts()
    y, sT = rwkv6_scan(*map(_t, args))
    assert PLAIN_CALLS["rwkv6_scan"] == 1 and LAUNCHES["rwkv6_scan"] == 0
    assert y.shape == (B, H, S, hd) and y.dtype == sT.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    y_ref, sT_ref = j_scan_ref(*jargs)
    y_pl, sT_pl = j_scan(*jargs, chunk=chunk, interpret=True)
    for ref_y, ref_s in ((y_ref, sT_ref), (y_pl, sT_pl)):
        _close(y, ref_y, SCAN_TOL)
        _close(sT, ref_s, SCAN_TOL)


def test_plain_scan_state_chaining():
    """Two half-sequences with the state carried equal one full run."""
    r, k, v, w, u, s0 = map(_t, _scan_inputs(1, 2, 64, 32, seed=1, s0_zero=True))
    y_full, sT_full = rwkv6_scan(r, k, v, w, u, s0)
    h = 32
    y1, s1 = rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0)
    y2, s2 = rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 2).numpy(), y_full.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), sT_full.numpy(), atol=1e-4)


def test_plain_scan_state_out_in_place_equals_out_of_place():
    r, k, v, w, u, s0 = map(_t, _scan_inputs(2, 3, 5, 32, seed=2))
    y, sT = rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    y2, sT2 = rwkv6_scan(r, k, v, w, u, state, state_out=state)
    assert sT2 is state
    assert torch.equal(y2, y) and torch.equal(state, sT)


# ------------------------------------------------------------- model blocks


def _block_params(seed):
    jcfg = j_smoke(ARCH)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jtm = JR.init_rwkv_tm(k1, jcfg, jnp.float32)
    jcm = JR.init_rwkv_cm(k2, jcfg, jnp.float32)
    # move the zero-initialised mixing coefficients off zero so every
    # token-shift path is exercised
    rng = np.random.default_rng(seed)
    for tree, names in ((jtm, ("maa_x", "maa_rkvwg")), (jcm, ("maa_k", "maa_r"))):
        for n in names:
            tree[n] = jnp.asarray(rng.uniform(-1, 1, tree[n].shape), jnp.float32)
    conv = lambda tree: {k: _t(np.array(v)) for k, v in tree.items()}  # noqa: E731
    return jcfg, jtm, jcm, conv(jtm), conv(jcm)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [64, 37, 1])
def test_time_mix_and_channel_mix_match_reference(S, with_state):
    jcfg, jtm, jcm, tm, cm = _block_params(3)
    cfg = smoke_config(ARCH)
    B, d, H, hd = 2, cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    sh = rng.normal(size=(B, d)).astype(np.float32) if with_state else None
    wkv = (rng.normal(size=(B, H, hd, hd)).astype(np.float32) * 0.1
           if with_state else None)
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    jy, jsh, jwkv = JR.rwkv_time_mix(jtm, jnp.asarray(x), jcfg,
                                     opt(sh, jnp.asarray), opt(wkv, jnp.asarray))
    reset_counts()
    ty, tsh, twkv = R.rwkv_time_mix(tm, _t(x), cfg, opt(sh, _t), opt(wkv, _t))
    assert PLAIN_CALLS["rwkv6_scan"] == 1  # every S goes through the scan op
    for t, j in ((ty, jy), (tsh, jsh), (twkv, jwkv)):
        _close(t, j, TOL)
    jy, jsh = JR.rwkv_channel_mix(jcm, jnp.asarray(x), jcfg, opt(sh, jnp.asarray))
    ty, tsh = R.rwkv_channel_mix(cm, _t(x), cfg, opt(sh, _t))
    _close(ty, jy, TOL)
    _close(tsh, jsh, TOL)


# ---------------------------------------------------------------- DecoderLM


def _models(use_pallas, key=0):
    jcfg = j_smoke(ARCH).replace(use_pallas=use_pallas)
    cfg = smoke_config(ARCH)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(key))
    return jm, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                        device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("S", [64, 37])
@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_decoder_prefill_and_decode_match_reference(S, use_pallas, plain):
    """Prefill logits and every cache entry, then 4 dense decode steps.
    S=64 takes the reference's Pallas path when ``use_pallas``; S=37 and the
    decode steps its jnp scan. The port runs the scan op every time."""
    jm, jp, cfg, tp = _models(use_pallas)
    m = build_model(cfg, plain=plain)
    rng = np.random.default_rng(5)
    B, ML = 2, 96
    toks = rng.integers(1, cfg.vocab_size, (B, S))
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=ML)
    reset_counts()
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks), max_len=ML)
    assert PLAIN_CALLS["rwkv6_scan"] == cfg.num_layers
    _close(tl, jl, TOL)
    for li in range(cfg.num_layers):
        blk, j = divmod(li, m.block_size)
        assert set(tc[li]) == {"shift_tm", "shift_cm", "wkv"}
        for name in tc[li]:
            _close(tc[li][name], np.asarray(jc[j][name])[blk], TOL)
    for t in range(4):
        nt = rng.integers(1, cfg.vocab_size, (B, 1))
        jl, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(nt, jnp.int32),
                                pos=jnp.int32(S + t))
        tl, tc2 = m.decode_step(tp, tc, tokens=torch.from_numpy(nt), pos=S + t)
        assert all(a is b for a, b in zip(tc2, tc))  # updated in place
        _close(tl, jl, TOL)
    for li in range(cfg.num_layers):
        blk, j = divmod(li, m.block_size)
        for name in tc[li]:
            _close(tc[li][name], np.asarray(jc[j][name])[blk], TOL)


def test_decoder_rwkv_refuses_paged_and_bucketed_prefill():
    _, _, cfg, tp = _models(False)
    m = build_model(cfg)
    with pytest.raises(NotImplementedError):
        m.init_paged_cache(8, 16, device="cpu")
    with pytest.raises(NotImplementedError):
        m.prefill(tp, tokens=torch.ones((1, 16), dtype=torch.int64), true_len=9)


def test_rwkv_params_match_reference_shapes_and_dtypes():
    """The port's seeded init and ``params_from_jax`` of the reference's init
    give the reference's leaf shapes and dtypes, f32 ``decay_base``/``bonus``/
    ``ln_x`` and ``ln0`` included, in a bf16 model."""
    jcfg = j_smoke(ARCH).replace(dtype="bfloat16", param_dtype="bfloat16")
    cfg = smoke_config(ARCH).replace(dtype="bfloat16", param_dtype="bfloat16")
    jm = j_build(jcfg)
    shapes = jm.init_shape()
    m = build_model(cfg)
    seeded = m.init(torch.Generator().manual_seed(0), device="cpu")
    converted = params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                                cfg, device="cpu")
    for params in (seeded, converted):
        assert set(params) == {"embed", "lm_head", "ln0", "final_norm", "layers"}
        for key in ("embed", "lm_head"):
            assert tuple(params[key].shape) == shapes[key].shape
        for li, lp in enumerate(params["layers"]):
            blk, j = divmod(li, m.block_size)
            ref = shapes["blocks"][j]
            assert set(lp) == set(ref) == {"norm1", "norm2", "tm", "cm"}
            for part in lp:
                assert set(lp[part]) == set(ref[part])
                for name, t in lp[part].items():
                    assert tuple(t.shape) == ref[part][name].shape[1:], (part, name)
                    assert str(t.dtype).split(".")[1] == str(ref[part][name].dtype)
        assert lp["tm"]["bonus"].dtype == torch.float32
        assert lp["tm"]["wr"].dtype == torch.bfloat16
    cache = m.init_cache(3, 16, device="cpu")[0]
    assert cache["wkv"].dtype == torch.float32 and cache["shift_tm"].dtype == torch.bfloat16
