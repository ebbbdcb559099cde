"""Port Mamba path against the reference on the CPU, on the jamba smoke config
without experts (``smoke_config("jamba-1.5-large-398b").replace(moe_period=0,
num_experts=0, experts_per_token=0)``: 16 layers, 14 Mamba and 2 attention,
d_inner 256, N 8):

- the plain selective scan against the reference's jnp oracle and its
  Pallas kernel in interpret mode, atol = rtol = 1e-4 (the reference's SSM
  tolerance in tests/test_kernels.py);
- the Mamba block's pieces (``_causal_conv`` with and without state,
  ``_ssm_params``) and ``mamba_prefill``/``mamba_decode``;
- ``DecoderLM`` prefill logits and caches and 3 dense decode steps, within
  5e-4 (the reference's model tolerance), with the reference on its jnp
  path and on its Pallas kernels, at prompt lengths 37 and 128 (the
  reference's Pallas scan, one and two chunks) and 100 (its jnp fallback);
- ``ContinuousBatcher`` greedy tokens equal to the reference batcher's, and
  the paged layout refused by both.

Weights come from the reference's init through ``params_from_jax``. The
CUDA kernel runs only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels.ssm_scan.ops import ssm_scan as j_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_scan_ref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.runtime.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.batching import GenRequest as JRequest  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.optim.schedule import constant_schedule  # noqa: E402
from repro_torch.runtime.batching import ContinuousBatcher, GenRequest  # noqa: E402

ARCH = "jamba-1.5-large-398b"
NO_MOE = dict(moe_period=0, num_experts=0, experts_per_token=0)
SCAN_TOL = 1e-4
TOL = 5e-4
MAX_LEN = 160


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread. The plain scan is
    thousands of small eager ops, and with other test processes on every
    core torch's intra-op pool waits at each op for descheduled threads:
    the smoke model's 128-token prefill and 3 decode steps took 0.23 s
    alone and 33.9 s on an 8-core CPU with every core busy, against 0.21 s
    on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def _scan_inputs(B, S, Di, N, seed=0):
    """The reference test's distributions (tests/test_kernels.py), nonzero h0."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, S, Di)).astype(f),
            rng.uniform(0.01, 0.2, size=(B, S, Di)).astype(f),
            -rng.uniform(0.5, 2, size=(Di, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(Di,)).astype(f),
            rng.normal(size=(B, Di, N)).astype(f))


# ------------------------------------------------------------------- scan (B4)


@pytest.mark.parametrize("B,S,Di,N,chunk,bd", [
    (2, 128, 64, 8, 32, 32), (1, 64, 128, 16, 64, 64), (2, 96, 32, 4, 16, 32),
    (2, 1, 64, 8, 1, 32), (2, 37, 64, 16, 37, 64),
], ids=["ref_a", "ref_b", "ref_c", "decode1", "ragged37"])
def test_plain_scan_matches_reference(B, S, Di, N, chunk, bd):
    """The reference test's three shapes, S=1 and a ragged S; the Pallas
    kernel takes one chunk of the whole S where S does not tile."""
    args = _scan_inputs(B, S, Di, N)
    reset_counts()
    y, hT = ssm_scan(*map(_t, args))
    assert PLAIN_CALLS["ssm_scan"] == 1 and LAUNCHES["ssm_scan"] == 0
    assert y.shape == (B, S, Di) and y.dtype == hT.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    for ref_y, ref_h in (j_scan_ref(*jargs),
                         j_scan(*jargs, chunk=chunk, block_d=bd, interpret=True)):
        _close(y, ref_y, SCAN_TOL)
        _close(hT, ref_h, SCAN_TOL)


def test_plain_scan_state_out_and_chaining():
    """``state_out=h0`` updates the state in place with the out-of-place
    result, and two halves with the state carried equal one run."""
    x, dt, A, Bc, Cc, D, h0 = map(_t, _scan_inputs(2, 40, 32, 8, seed=1))
    y, hT = ssm_scan(x, dt, A, Bc, Cc, D, h0)
    state = h0.clone()
    y2, h2 = ssm_scan(x, dt, A, Bc, Cc, D, state, state_out=state)
    assert h2 is state and torch.equal(y2, y) and torch.equal(state, hT)
    y1, h1 = ssm_scan(x[:, :17], dt[:, :17], A, Bc[:, :17], Cc[:, :17], D, h0)
    y3, h3 = ssm_scan(x[:, 17:], dt[:, 17:], A, Bc[:, 17:], Cc[:, 17:], D, h1)
    torch.testing.assert_close(torch.cat([y1, y3], 1), y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h3, hT, atol=1e-5, rtol=1e-5)


def test_scan_refuses_gradients():
    """Under a gradient the scan refuses ``state_out`` (an in-place state
    write would overwrite what autograd saved); under ``no_grad`` the same
    call updates the state in place. Without ``state_out`` a gradient flows
    (tests/test_torch_mamba_train.py holds its values)."""
    args = list(map(_t, _scan_inputs(1, 4, 16, 8)))
    args[0].requires_grad_(True)
    with pytest.raises(ValueError, match="state_out"):
        ssm_scan(*args, state_out=args[6])
    y, hT = ssm_scan(*args)
    assert y.requires_grad and hT.requires_grad
    state = args[6].clone()
    with torch.no_grad():
        y2, h2 = ssm_scan(*args[:6], state, state_out=state)
    assert h2 is state and torch.equal(y2, y.detach()) and torch.equal(state, hT.detach())


# ------------------------------------------------------------- model blocks


def _block_params(seed):
    jcfg = j_smoke(ARCH).replace(**NO_MOE)
    jp = JM.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # move the zero / one initialised leaves off their init so every term
    # (conv bias, dt bias, D, the inner norm scales) is exercised
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "dt_bias", "D", "dt_norm", "b_norm", "c_norm"):
        jp[name] = jnp.asarray(rng.uniform(0.5, 1.5, jp[name].shape), jnp.float32)
    return jcfg, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [1, 5, 37])
def test_causal_conv_and_ssm_params_match_reference(S, with_state):
    jcfg, jp, tp = _block_params(1)
    cfg = smoke_config(ARCH).replace(**NO_MOE)
    rng = np.random.default_rng(2)
    B, W, di = 2, cfg.ssm_conv_width, cfg.d_inner
    x = rng.normal(size=(B, S, di)).astype(np.float32)
    st = rng.normal(size=(B, W - 1, di)).astype(np.float32) if with_state else None
    jy, jst = JM._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                              None if st is None else jnp.asarray(st))
    ty, tst = M._causal_conv(_t(x), tp["conv_w"], tp["conv_b"],
                             None if st is None else _t(st))
    _close(ty, jy, 1e-6)
    _close(tst, jst, 0.0)
    for t, j in zip(M._ssm_params(tp, _t(x), cfg), JM._ssm_params(jp, jnp.asarray(x), jcfg)):
        _close(t, j, 1e-5)


@pytest.mark.parametrize("S", [37, 64])
def test_mamba_prefill_and_decode_match_reference(S):
    """Prefill output and state, then 3 decode steps with the state updated
    in place (the reference's jnp scan at both S: the block functions take
    the Pallas route only under ``use_pallas``)."""
    jcfg, jp, tp = _block_params(3)
    cfg = smoke_config(ARCH).replace(**NO_MOE)
    rng = np.random.default_rng(4)
    B, d = 2, cfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    jy, jc = JM.mamba_prefill(jp, jnp.asarray(x), jcfg)
    reset_counts()
    ty, tc = M.mamba_prefill(tp, _t(x), cfg)
    assert PLAIN_CALLS["ssm_scan"] == 1
    _close(ty, jy, TOL)
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name], TOL)
    ssm = tc["ssm"]
    for _ in range(3):
        xt = rng.normal(size=(B, 1, d)).astype(np.float32)
        jy, jc = JM.mamba_decode(jp, jnp.asarray(xt), jc, jcfg)
        ty, tc2 = M.mamba_decode(tp, _t(xt), tc, cfg)
        assert tc2 is tc and tc["ssm"] is ssm  # in place
        _close(ty, jy, TOL)
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name], TOL)


def test_mamba_train_raises():
    """``mamba_train`` (from a zero state, no cache) matches the reference's
    within 5e-4; the jamba config with its experts scores a batch (its
    ``loss`` adds the experts' aux loss) and takes a train step
    (tests/test_torch_moe_train.py holds the gradients)."""
    jcfg, jp, tp = _block_params(5)
    cfg = smoke_config(ARCH).replace(**NO_MOE)
    x = np.random.default_rng(6).normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    reset_counts()
    y = M.mamba_train(tp, _t(x), cfg)
    assert PLAIN_CALLS["ssm_scan"] == 1
    _close(y, JM.mamba_train(jp, jnp.asarray(x), jcfg), TOL)
    moe = build_model(smoke_config(ARCH))
    params = moe.init(torch.Generator().manual_seed(0), device="cpu")
    _, parts = moe.loss(params, {"tokens": torch.ones((1, 8), dtype=torch.int64)})
    assert torch.isfinite(parts["loss"]) and float(parts["aux"]) > 0
    opt = AdamW(lr=constant_schedule(1e-3))
    state, metrics = make_train_step(moe, opt)(
        opt.init_state(params), {"tokens": torch.ones((2, 8), dtype=torch.int64)})
    assert state["step"] == 1
    assert all(np.isfinite(float(v)) for v in metrics.values()) and float(metrics["aux"]) > 0


# ---------------------------------------------------------------- DecoderLM

_CACHE = {}


def _reference(use_pallas):
    """The reference model and params (one init per module: both routes
    share the weights) and its jitted decode step."""
    if use_pallas not in _CACHE:
        model = j_build(j_smoke(ARCH).replace(use_pallas=use_pallas, **NO_MOE))
        if "params" not in _CACHE:
            _CACHE["params"] = model.init(jax.random.PRNGKey(0))
        _CACHE[use_pallas] = (model, jax.jit(model.decode_step))
    return _CACHE[use_pallas] + (_CACHE["params"],)


def _port_params():
    if "port" not in _CACHE:
        _, _, jp = _reference(False)
        _CACHE["port"] = params_from_jax(jax.tree.map(np.asarray, jp),
                                         smoke_config(ARCH).replace(**NO_MOE),
                                         device="cpu")
    return _CACHE["port"]


def _reference_run(use_pallas, S):
    """Prefill logits and caches of a (2, S) prompt, then 3 decode steps'
    logits and the caches after them; computed once per (route, S)."""
    key = ("run", use_pallas, S)
    if key not in _CACHE:
        jm, dec, jp = _reference(use_pallas)
        rng = np.random.default_rng(S)
        toks = rng.integers(1, jm.cfg.vocab_size, (2, S))
        steps = rng.integers(1, jm.cfg.vocab_size, (3, 2, 1))
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=MAX_LEN)
        out = dict(toks=toks, steps=steps, prefill=(np.asarray(jl), jax.tree.map(np.asarray, jc)))
        logits = []
        for t in range(3):
            jl, jc = dec(jp, jc, tokens=jnp.asarray(steps[t], jnp.int32),
                         pos=jnp.int32(S + t))
            logits.append(np.asarray(jl))
        out["decode"] = (logits, jax.tree.map(np.asarray, jc))
        _CACHE[key] = out
    return _CACHE[key]


def _close_caches(tc, jc, m):
    for li, spec in enumerate(m.layer_specs):
        blk, j = divmod(li, m.block_size)
        want = {"conv", "ssm"} if spec.mixer == "mamba" else {"k", "v", "pos"}
        assert set(tc[li]) == want
        for name in tc[li]:
            # the reference keeps one (L,) row of positions; the port one per row
            want = np.broadcast_to(jc[j][name][blk], tc[li][name].shape)
            _close(tc[li][name], want, TOL)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("S", [37, 128, 100])
@pytest.mark.parametrize("plain", [False, True], ids=["ops", "plain"])
def test_decoder_prefill_and_decode_match_reference(S, use_pallas, plain):
    """Prefill logits and every cache entry, then 3 dense decode steps and
    the caches after them. The port runs the scan op at every S."""
    ref = _reference_run(use_pallas, S)
    cfg = smoke_config(ARCH).replace(**NO_MOE)
    m = build_model(cfg, plain=plain)
    assert [s.mixer for s in m.layer_specs].count("mamba") == 14
    tp = _port_params()
    reset_counts()
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(ref["toks"]), max_len=MAX_LEN)
    assert PLAIN_CALLS["ssm_scan"] == 14 and sum(LAUNCHES.values()) == 0
    jl, jc = ref["prefill"]
    _close(tl, jl, TOL)
    _close_caches(tc, jc, m)
    for t in range(3):
        tl, tc2 = m.decode_step(tp, tc, tokens=torch.from_numpy(ref["steps"][t]),
                                pos=S + t)
        assert all(a is b for a, b in zip(tc2, tc))  # updated in place
        _close(tl, ref["decode"][0][t], TOL)
    _close_caches(tc, ref["decode"][1], m)


def test_decoder_params_match_reference_shapes_and_dtypes():
    """The port's seeded init and the converted reference weights give the
    reference's leaf shapes and dtypes, f32 ``A_log``/``D``/``dt_bias`` and
    inner norm scales in a bf16 model; the Mamba caches' too (a bf16 conv
    state, an f32 ssm state)."""
    jcfg = j_smoke(ARCH).replace(dtype="bfloat16", param_dtype="bfloat16", **NO_MOE)
    cfg = smoke_config(ARCH).replace(dtype="bfloat16", param_dtype="bfloat16", **NO_MOE)
    jm = j_build(jcfg)
    shapes = jm.init_shape()
    m = build_model(cfg)
    seeded = m.init(torch.Generator().manual_seed(0), device="cpu")
    converted = params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                                cfg, device="cpu")
    for params in (seeded, converted):
        assert set(params) == set(shapes) - {"blocks"} | {"layers"}
        for li, lp in enumerate(params["layers"]):
            blk, j = divmod(li, m.block_size)
            ref = shapes["blocks"][j]
            assert set(lp) == set(ref)
            for part in lp:
                assert set(lp[part]) == set(ref[part])
                for name, t in lp[part].items():
                    assert tuple(t.shape) == ref[part][name].shape[1:], (part, name)
                    assert str(t.dtype).split(".")[1] == str(ref[part][name].dtype)
    mamba = seeded["layers"][0]["mamba"]
    assert mamba["A_log"].dtype == torch.float32 and mamba["in_proj"].dtype == torch.bfloat16
    jcache = jm.init_cache(3, 16)
    for li, entry in enumerate(m.init_cache(3, 16, device="cpu")):
        j = li % m.block_size
        if m.layer_specs[li].mixer != "mamba":
            continue
        assert set(entry) == {"conv", "ssm"}
        for name, t in entry.items():
            assert tuple(t.shape) == jcache[j][name].shape[1:]
            assert str(t.dtype).split(".")[1] == str(jcache[j][name].dtype)


# --------------------------------------------------------------- batcher

SHAPES = [(5, 6), (64, 6), (37, 7)]  # (prompt length, max_new)


def test_batcher_tokens_match_reference_batcher():
    """Greedy tokens through ``ContinuousBatcher`` (dense, exact-length
    prefill) equal the reference batcher's on its jnp path; state bytes too."""
    jm, _, jp = _reference(False)
    rng = np.random.default_rng(42)
    prompts = [(rng.integers(1, jm.cfg.vocab_size, p).astype(np.int32), n)
               for p, n in SHAPES]
    jb = JBatcher(jm, jp, max_slots=2, max_len=MAX_LEN)
    jreqs = [JRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    b = ContinuousBatcher(build_model(smoke_config(ARCH).replace(**NO_MOE)),
                          _port_params(), max_slots=2, max_len=MAX_LEN, device="cpu")
    reqs = [GenRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    reset_counts()
    b.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert PLAIN_CALLS["ssm_scan"] > 0 and sum(LAUNCHES.values()) == 0
    assert b.kv_cache_bytes() == jb.kv_cache_bytes()


def test_batcher_refuses_paged_layout_like_reference():
    jm, _, jp = _reference(False)
    with pytest.raises(NotImplementedError):
        JBatcher(jm, jp, max_slots=2, max_len=MAX_LEN, kv_layout="paged")
    model = build_model(smoke_config(ARCH).replace(**NO_MOE))
    for kw in (dict(kv_layout="paged"), dict(kv_layout="paged", kv_quant="int8")):
        with pytest.raises(NotImplementedError):
            ContinuousBatcher(model, _port_params(), max_slots=2, max_len=MAX_LEN,
                              device="cpu", **kw)
