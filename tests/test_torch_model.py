"""Port model layers against the reference on the CPU: the shared primitives,
the dense MLP, the attention entry points and ``DecoderLM`` prefill / dense
decode / paged decode logits on the starcoder2 (sliding window, LayerNorm +
biases, GeLU) and gemma2 (local/global, softcaps, sandwich RMSNorm, GeGLU)
smoke configs, through weights converted with ``params_from_jax``. Tolerance
is the reference's model tolerance, 5e-4 (tests/test_models_consistency.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402
from repro_torch.models.config import block_structure  # noqa: E402

TOL = 5e-4
ARCHS = ["starcoder2-3b", "gemma2-2b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_copies_equal_reference(arch):
    """The port keeps its own copies of ModelConfig / the arch configs /
    smoke_config; they equal the reference field for field."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(j_smoke(arch))
    assert ([f.name for f in dataclasses.fields(get_config(arch))]
            == [f.name for f in dataclasses.fields(j_get_config(arch))])


# ---------------------------------------------------------------- primitives


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_norm_matches_reference(arch):
    cfg = smoke_config(arch)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=cfg.d_model).astype(np.float32)}
    if cfg.norm_type == "layernorm":
        p["bias"] = rng.normal(size=cfg.d_model).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(C.apply_norm(tp, torch.from_numpy(x), cfg),
           JC.apply_norm(jp, jnp.asarray(x), j_smoke(arch)), atol=1e-5)


@pytest.mark.parametrize("name", ["gelu", "geglu", "swiglu"])
def test_act_softcap_rope_mask_match_reference(name):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 4, 32)) * 4).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(C.act_fn(name)(tx), JC.act_fn(name)(jx), atol=1e-6)
    _close(C.softcap(tx, 30.0), JC.softcap(jx, 30.0), atol=1e-5)
    pos = np.arange(7) + 4000
    _close(C.apply_rope(tx, torch.from_numpy(pos), 100000.0),
           JC.apply_rope(jx, jnp.asarray(pos), 100000.0), atol=1e-5)
    qp = np.array([[5], [40], [70]])
    kp = np.array([[-1, 0, 3, 5, 6, 33, 40, 41, 70, 69, 12, -1]] * 3)
    for kw in (dict(), dict(window=32), dict(prefix_len=4),
               dict(window=8, prefix_len=2)):
        got = C.allow_mask(torch.from_numpy(qp), torch.from_numpy(kp), **kw)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JC.allow_mask(jnp.asarray(qp), jnp.asarray(kp), **kw)))
    assert C.NEG_INF == JC.NEG_INF


@pytest.mark.parametrize("mlp_type,use_bias", [("gelu", True), ("geglu", False),
                                               ("swiglu", True)])
def test_apply_mlp_matches_reference(mlp_type, use_bias):
    cfg = smoke_config("starcoder2-3b").replace(mlp_type=mlp_type, use_bias=use_bias)
    jcfg = j_smoke("starcoder2-3b").replace(mlp_type=mlp_type, use_bias=use_bias)
    jp = JM.init_mlp(jax.random.PRNGKey(2), jcfg, jnp.float32)
    jp = {k: (v + 0.1 if k.startswith("b_") else v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    _close(M.apply_mlp(tp, torch.from_numpy(x), cfg),
           JM.apply_mlp(jp, jnp.asarray(x), jcfg), atol=1e-5)
    # the dense MLP ignores the expert fields, as the reference's does (a
    # shared expert of an MoE config is such a dense MLP)
    _close(M.apply_mlp(tp, torch.from_numpy(x), cfg.replace(num_experts=4)),
           JM.apply_mlp(jp, jnp.asarray(x), jcfg.replace(num_experts=4)), atol=1e-5)


# ------------------------------------------------------ attention entry points


def _attn_setup(arch, layer):
    cfg, jcfg = smoke_config(arch), j_smoke(arch)
    _, _, specs = block_structure(cfg)
    spec = specs[layer % len(specs)]
    jp = JA.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jp = {k: (v + 0.05 if k.startswith("b") else v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg, jcfg, spec, tp, jp


@pytest.mark.parametrize("arch,layer", [("starcoder2-3b", 0), ("gemma2-2b", 0),
                                        ("gemma2-2b", 1)])
@pytest.mark.parametrize("true_len", [None, 19, 50])
def test_attn_prefill_matches_reference(arch, layer, true_len):
    """Output and cache, exact-length and bucketed (the rolling-window gather
    runs where the window is shorter than the bucket)."""
    cfg, jcfg, spec, tp, jp = _attn_setup(arch, layer)
    S, max_len = 64, 96
    x = np.random.default_rng(4).normal(size=(1, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    tl = None if true_len is None else jnp.int32(true_len)
    jy, jc = JA.attn_prefill(jp, jnp.asarray(x), jcfg, spec, jnp.asarray(pos),
                             max_len=max_len, true_len=tl)
    ty, tc = A.attn_prefill(tp, torch.from_numpy(x), cfg, spec,
                            torch.from_numpy(pos), max_len=max_len,
                            true_len=true_len)
    _close(ty, jy)
    np.testing.assert_array_equal(tc["pos"][0].numpy(), np.asarray(jc["pos"]))
    valid = np.asarray(jc["pos"]) >= 0
    _close(tc["k"][0][torch.from_numpy(valid)], np.asarray(jc["k"])[0][valid])
    _close(tc["v"][0][torch.from_numpy(valid)], np.asarray(jc["v"])[0][valid])


@pytest.mark.parametrize("arch,layer", [("starcoder2-3b", 0), ("gemma2-2b", 1)])
def test_attn_decode_dense_and_paged_match_reference(arch, layer):
    """One decode step per slot at per-slot positions: the port's
    slot-batched dense step and its paged step (shuffled page table) both
    against the reference's single-sequence dense step on each slot."""
    cfg, jcfg, spec, tp, jp = _attn_setup(arch, layer)
    rng = np.random.default_rng(5)
    B, S, max_len, bs = 2, 40, 64, 16
    plens = [40, 23]
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    xn = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    # reference dense: one single-sequence cache per slot
    j_out = []
    for b in range(B):
        _, jc = JA.attn_prefill(jp, jnp.asarray(x[b:b + 1]), jcfg, spec,
                                jnp.arange(S), max_len=max_len,
                                true_len=jnp.int32(plens[b]))
        jy, _ = JA.attn_decode(jp, jnp.asarray(xn[b:b + 1]), jc, jcfg, spec,
                               jnp.int32(plens[b]))
        j_out.append(np.asarray(jy))
    j_out = np.concatenate(j_out)
    # port dense: slot axis written out
    L = A.cache_len_for(cfg, spec, max_len)
    cache = A.init_cache_entry(cfg, spec, B, max_len, torch.float32, "cpu")
    for b in range(B):
        _, one = A.attn_prefill(tp, torch.from_numpy(x[b:b + 1]), cfg, spec,
                                torch.arange(S), max_len=max_len, true_len=plens[b])
        for name in cache:
            cache[name][b] = one[name][0]
    pos_vec = torch.tensor(plens)
    ty, cache = A.attn_decode(tp, torch.from_numpy(xn), cache, cfg, spec, pos_vec)
    _close(ty, j_out)
    # port paged: the same contents scattered into a shuffled block pool
    P = max_len // bs
    n_phys = 2 + B * P
    pool = A.init_paged_entry(cfg, spec, n_phys, bs, torch.float32, "cpu")
    table = torch.from_numpy(
        (2 + rng.permutation(B * P)).reshape(B, P).astype(np.int32))
    for b in range(B):
        _, one = A.attn_prefill(tp, torch.from_numpy(x[b:b + 1]), cfg, spec,
                                torch.arange(S), max_len=max_len, true_len=plens[b])
        rows = table[b, :L // bs].long()
        pool["k"][rows] = one["k"][0].reshape(-1, bs, *one["k"].shape[2:])
        pool["v"][rows] = one["v"][0].reshape(-1, bs, *one["v"].shape[2:])
        pool["pos"][rows] = one["pos"][0].reshape(-1, bs)
    py, pool = A.attn_decode_paged(tp, torch.from_numpy(xn), pool, cfg, spec,
                                   pos_vec, table)
    _close(py, j_out)
    # the plain model-level math agrees with the kernel-op path
    reset_counts()
    cache2 = {k: v.clone() for k, v in cache.items()}
    qy, _ = A.attn_decode(tp, torch.from_numpy(xn), cache2, cfg, spec, pos_vec,
                          plain=True)
    assert PLAIN_CALLS["model_attention"] == 1 and PLAIN_CALLS["decode_attention"] == 0
    _close(qy, j_out)


# ---------------------------------------------------------------- DecoderLM


def _models(arch, key=0):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(key))
    return jcfg, jm, jp, cfg, params_from_jax(_np_tree(jp), cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plain", [False, True], ids=["kernel_ops", "plain"])
def test_decoder_prefill_and_decode_logits_match_reference(arch, plain):
    jcfg, jm, jp, cfg, tp = _models(arch)
    m = build_model(cfg, plain=plain)
    rng = np.random.default_rng(6)
    B, S, ML = 2, 40, 64
    toks = rng.integers(1, cfg.vocab_size, (B, S))
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=ML)
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks), max_len=ML)
    _close(tl, jl)
    for t in range(4):
        nt = rng.integers(1, cfg.vocab_size, (B, 1))
        jl, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(nt, jnp.int32),
                                pos=jnp.int32(S + t))
        tl, tc = m.decode_step(tp, tc, tokens=torch.from_numpy(nt), pos=S + t)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_bucketed_prefill_and_paged_decode_match_reference(arch):
    """``true_len`` prefill into a 64-token bucket, then paged decode steps
    against the reference's ``decode_step_paged`` on the same page table."""
    jcfg, jm, jp, cfg, tp = _models(arch, key=1)
    m = build_model(cfg)
    rng = np.random.default_rng(7)
    S, ML, bs, plen = 64, 64, 16, 37
    toks = np.zeros((1, S), np.int64)
    toks[0, :plen] = rng.integers(1, cfg.vocab_size, plen)
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=ML,
                        true_len=jnp.int32(plen))
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks), max_len=ML, true_len=plen)
    _close(tl, jl)
    P = ML // bs
    n_phys = 2 + P
    table = (2 + rng.permutation(P)).astype(np.int32)[None]
    jpools = jm.init_paged_cache(n_phys, bs)
    tpools = m.init_paged_cache(n_phys, bs, device="cpu")
    # scatter both caches through the same table
    for li, spec in enumerate(m.layer_specs):
        blk, j = divmod(li, m.block_size)
        L = A.cache_len_for(cfg, spec, ML)
        rows = table[0, :L // bs]
        for name in ("k", "v"):
            src = tc[li][name][0].reshape(L // bs, bs, *tc[li][name].shape[2:])
            tpools[li][name][torch.from_numpy(rows).long()] = src
            jpools[j][name] = jpools[j][name].at[blk, rows].set(
                np.asarray(jc[j][name])[blk, 0].reshape(L // bs, bs, -1, cfg.head_dim))
        tpools[li]["pos"][torch.from_numpy(rows).long()] = tc[li]["pos"][0].reshape(-1, bs)
        jpools[j]["pos"] = jpools[j]["pos"].at[blk, rows].set(
            np.asarray(jc[j]["pos"])[blk].reshape(-1, bs))
    tok = np.array([[int(np.argmax(np.asarray(jl)[0]))]])
    for t in range(3):
        pv = np.array([plen + t], np.int32)
        jl, jpools = jm.decode_step_paged(jp, jpools, tokens=jnp.asarray(tok, jnp.int32),
                                          pos_vec=jnp.asarray(pv),
                                          pages=jnp.asarray(table))
        tl, tpools = m.decode_step_paged(tp, tpools, tokens=torch.from_numpy(tok),
                                         pos_vec=torch.from_numpy(pv),
                                         pages=torch.from_numpy(table))
        _close(tl, jl)
        tok = np.array([[int(np.argmax(np.asarray(jl)[0]))]])


def test_decoder_refuses_unported_mixers_and_default_device(tmp_path):
    """jamba's smoke config with its experts builds, the serving launcher
    serves it, and it trains: ``make_train_step`` takes a step with its
    experts, and the training launcher trains mixtral's smoke config.
    ``remat="dots"`` runs the forward the other policies run. What the port
    still refuses: more than one device. Entry points default to cuda and
    raise without a card."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.runtime.elastic import _one_device

    jamba = build_model(smoke_config("jamba-1.5-large-398b"))
    assert sum("moe" in lp for lp in jamba.init(
        torch.Generator(), device="meta")["layers"]) == jamba.cfg.num_layers // 2
    serve_main(["--arch", "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt", "5", "--gen", "2"])
    sc_params = build_model(smoke_config("starcoder2-3b")).init(
        torch.Generator().manual_seed(0), device="cpu")
    toks = torch.ones((1, 4), dtype=torch.int64)
    dots, _ = build_model(smoke_config("starcoder2-3b").replace(remat="dots")).forward(
        sc_params, toks)
    full, _ = build_model(smoke_config("starcoder2-3b").replace(remat="full")).forward(
        sc_params, toks)
    assert torch.equal(dots, full)
    with pytest.raises(NotImplementedError, match="devices"):
        _one_device(["cpu", "cpu"])
    opt = AdamW(lr=constant_schedule(1e-3))
    jparams = jamba.init(torch.Generator().manual_seed(0), device="cpu")
    state, metrics = make_train_step(jamba, opt)(
        opt.init_state(jparams), {"tokens": np.ones((2, 8), np.int64)})
    assert state["step"] == 1 and np.isfinite(float(metrics["loss"]))
    assert float(metrics["aux"]) > 0
    train_main(["--arch", "mixtral-8x22b", "--smoke", "--steps", "1",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert (tmp_path / "ck" / "step_00000000").is_dir()
    m = build_model(smoke_config("starcoder2-3b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            m.init(torch.Generator().manual_seed(0))  # default device: cuda
        with pytest.raises(RuntimeError):
            m.init_cache(1, 16)
        with pytest.raises(RuntimeError):
            jamba.init(torch.Generator().manual_seed(0))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert len(params["layers"]) == m.cfg.num_layers
    assert params["embed"].shape == (m.cfg.vocab_size, m.cfg.d_model)
