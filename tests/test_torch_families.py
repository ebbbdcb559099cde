"""Port ``DecoderLM`` on the six model families the registry added, and
jamba with its experts, against the reference's decoder on the CPU.

Through weights converted with ``params_from_jax`` (the MoE subtrees, an
f32 router, a tree without ``embed`` or with a tied one): prefill, dense
decode and paged decode logits of the smoke configs of mixtral-8x22b,
llama4-scout-17b-a16e, deepseek-coder-33b, yi-34b and jamba-1.5-large-398b
with its experts (dense only: its Mamba layers take no pages, in either
package), at the reference's model tolerance 5e-4
(tests/test_models_consistency.py); ``forward``/``loss`` with the summed
MoE aux loss; musicgen-medium (frame embeddings in, audio labels) and
paligemma-3b (a bidirectional prefix of embeddings before the text)
through ``forward``, ``loss``, ``prefill`` and ``decode_step``;
``ContinuousBatcher`` greedy tokens equal to the reference batcher's in
both layouts on mixtral's smoke config with a capacity that binds; the
serving launcher on the new archs; ``param_count`` and
``active_param_count`` of all ten full configs. Every input comes from a
numpy seed.
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
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.batching import GenRequest as JRequest  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_counts  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.batching import ContinuousBatcher, GenRequest  # noqa: E402

TOL = 5e-4
MOE = ["mixtral-8x22b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"]
ATTN = ["mixtral-8x22b", "llama4-scout-17b-a16e", "deepseek-coder-33b", "yi-34b"]
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread, as
    tests/test_torch_batching.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def _models(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, cfg = j_smoke(arch).replace(**kw), smoke_config(arch).replace(**kw)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _CACHE[key] = (jm, jp, build_model(cfg), tp)
    return _CACHE[key]


def test_registry_lists_the_reference_ids_in_order():
    assert ARCH_IDS == J_ARCH_IDS
    assert len(ARCH_IDS) == 10


def test_converted_trees_carry_moe_router_and_embeddings():
    """The f32 router of a bf16 model, the experts' stacked shapes, the
    shared expert; no ``embed`` for musicgen, no ``lm_head`` for
    paligemma (tied)."""
    jcfg = j_smoke("llama4-scout-17b-a16e").replace(dtype="bfloat16",
                                                     param_dtype="bfloat16")
    jp = j_build(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), smoke_config(
        "llama4-scout-17b-a16e").replace(dtype="bfloat16", param_dtype="bfloat16"),
        device="cpu")
    moe = tp["layers"][0]["moe"]
    E, d, ff = jcfg.num_experts, jcfg.d_model, jcfg.d_ff
    assert moe["router"].dtype == torch.float32 and moe["router"].shape == (d, E)
    assert moe["w_gate"].dtype == torch.bfloat16 and moe["w_gate"].shape == (E, d, ff)
    assert moe["w_out"].shape == (E, ff, d)
    assert set(moe["shared"]) == {"w_gate", "w_up", "w_out"}
    np.testing.assert_array_equal(
        moe["router"].numpy(), np.asarray(jp["blocks"][0]["moe"]["router"][0]))
    # the port's own init has the same tree, router f32 too
    own = build_model(smoke_config("llama4-scout-17b-a16e").replace(
        dtype="bfloat16", param_dtype="bfloat16")).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert own["layers"][0]["moe"]["router"].dtype == torch.float32
    for a, b in zip(own["layers"], tp["layers"]):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, a)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, b))
    _, _, _, mg = _models("musicgen-medium")
    assert "embed" not in mg and "lm_head" in mg
    _, _, _, pg = _models("paligemma-3b")
    assert "embed" in pg and "lm_head" not in pg


# ------------------------------------------------------- token families


@pytest.mark.parametrize("arch", ATTN + ["jamba-1.5-large-398b"])
def test_prefill_and_dense_decode_logits_match_reference(arch):
    jm, jp, m, tp = _models(arch)
    rng = np.random.default_rng(6)
    B, S, ML = 2, 40, 64
    toks = rng.integers(1, m.cfg.vocab_size, (B, S))
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=ML)
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks), max_len=ML)
    _close(tl, jl)
    for t in range(4):
        nt = rng.integers(1, m.cfg.vocab_size, (B, 1))
        jl, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(nt, jnp.int32),
                                pos=jnp.int32(S + t))
        tl, tc = m.decode_step(tp, tc, tokens=torch.from_numpy(nt), pos=S + t)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ATTN)
def test_bucketed_prefill_and_paged_decode_logits_match_reference(arch):
    """Two sequences, each prefilled into a 64-token bucket (``true_len``:
    the pad tokens are routed too), scattered through one shuffled page
    table, then paged decode steps of both rows against the reference's
    ``decode_step_paged`` (MoE layers route the two rows as one group)."""
    jm, jp, m, tp = _models(arch)
    cfg = m.cfg
    rng = np.random.default_rng(7)
    S, ML, bs = 64, 64, 16
    plens = [37, 21]
    P = ML // bs
    n_phys = 2 + 2 * P
    table = (2 + rng.permutation(2 * P)).astype(np.int32).reshape(2, P)
    jpools = jm.init_paged_cache(n_phys, bs)
    tpools = m.init_paged_cache(n_phys, bs, device="cpu")
    first = []
    for b, plen in enumerate(plens):
        toks = np.zeros((1, S), np.int64)
        toks[0, :plen] = rng.integers(1, cfg.vocab_size, plen)
        jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32), max_len=ML,
                            true_len=jnp.int32(plen))
        tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks), max_len=ML,
                           true_len=plen)
        _close(tl, jl)
        first.append(int(np.argmax(np.asarray(jl)[0])))
        for li, spec in enumerate(m.layer_specs):
            blk, j = divmod(li, m.block_size)
            L = A.cache_len_for(cfg, spec, ML)
            rows = table[b, :L // bs]
            for name in ("k", "v"):
                src = tc[li][name][0].reshape(L // bs, bs, *tc[li][name].shape[2:])
                tpools[li][name][torch.from_numpy(rows).long()] = src
                jpools[j][name] = jpools[j][name].at[blk, rows].set(
                    np.asarray(jc[j][name])[blk, 0].reshape(L // bs, bs, -1,
                                                            cfg.head_dim))
            tpools[li]["pos"][torch.from_numpy(rows).long()] = \
                tc[li]["pos"][0].reshape(-1, bs)
            jpools[j]["pos"] = jpools[j]["pos"].at[blk, rows].set(
                np.asarray(jc[j]["pos"])[blk].reshape(-1, bs))
    tok = np.array(first)[:, None]
    for t in range(3):
        pv = np.array(plens, np.int32) + t
        jl, jpools = jm.decode_step_paged(jp, jpools, tokens=jnp.asarray(tok, jnp.int32),
                                          pos_vec=jnp.asarray(pv),
                                          pages=jnp.asarray(table))
        tl, tpools = m.decode_step_paged(tp, tpools, tokens=torch.from_numpy(tok),
                                         pos_vec=torch.from_numpy(pv),
                                         pages=torch.from_numpy(table))
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None]


@pytest.mark.parametrize("arch", MOE + ["deepseek-coder-33b"])
def test_forward_and_loss_match_reference(arch):
    """Training forward logits, the summed MoE aux loss, and ``loss``'s
    loss/ce/aux."""
    jm, jp, m, tp = _models(arch)
    toks = np.random.default_rng(8).integers(1, m.cfg.vocab_size, (2, 33))
    jl, jaux = jm.forward(jp, tokens=jnp.asarray(toks, jnp.int32))
    tl, taux = m.forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    _close(taux, jaux, atol=1e-5)
    if arch in MOE:
        assert float(taux) > 0
    jloss, jparts = jm.loss(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tloss, tparts = m.loss(tp, {"tokens": torch.from_numpy(toks)})
    for name in ("loss", "ce", "aux"):
        _close(tparts[name], jparts[name], atol=1e-5)


def test_jamba_with_experts_paged_layout_raises_in_both_batchers():
    jm, jp, m, tp = _models("jamba-1.5-large-398b")
    with pytest.raises(NotImplementedError):
        JBatcher(jm, jp, max_slots=2, max_len=64, kv_layout="paged")
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(m, tp, max_slots=2, max_len=64, kv_layout="paged",
                          device="cpu")


# ------------------------------------------------------ embedding inputs


def _audio_inputs(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    return emb, labels


def _vlm_inputs(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    prefix = rng.normal(size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (B, S))
    return prefix, toks


def test_musicgen_forward_and_loss_match_reference():
    jm, jp, m, tp = _models("musicgen-medium")
    emb, labels = _audio_inputs(m.cfg, 9)
    jl, jaux = jm.forward(jp, embeds=jnp.asarray(emb))
    tl, taux = m.forward(tp, embeds=torch.from_numpy(emb))
    _close(tl, jl)
    assert float(taux) == 0.0
    jloss, jparts = jm.loss(jp, {"embeds": jnp.asarray(emb),
                                 "labels": jnp.asarray(labels, jnp.int32)})
    tloss, tparts = m.loss(tp, {"embeds": torch.from_numpy(emb),
                                "labels": torch.from_numpy(labels)})
    for name in ("loss", "ce", "aux"):
        _close(tparts[name], jparts[name], atol=1e-5)


def test_musicgen_prefill_and_decode_match_reference():
    """Frame embeddings in at prefill and at every decode step; no position
    term in either package (``pos_type="sinusoidal"`` is never applied)."""
    jm, jp, m, tp = _models("musicgen-medium")
    assert m.cfg.pos_type == "sinusoidal"
    emb, _ = _audio_inputs(m.cfg, 10, S=30)
    ML = 48
    jl, jc = jm.prefill(jp, embeds=jnp.asarray(emb), max_len=ML)
    tl, tc = m.prefill(tp, embeds=torch.from_numpy(emb), max_len=ML)
    _close(tl, jl)
    rng = np.random.default_rng(11)
    for t in range(4):
        e = rng.normal(size=(2, 1, m.cfg.d_model)).astype(np.float32)
        jl, jc = jm.decode_step(jp, jc, embeds=jnp.asarray(e), pos=jnp.int32(30 + t))
        tl, tc = m.decode_step(tp, tc, embeds=torch.from_numpy(e), pos=30 + t)
        _close(tl, jl)


def test_paligemma_forward_and_loss_match_reference():
    jm, jp, m, tp = _models("paligemma-3b")
    prefix, toks = _vlm_inputs(m.cfg, 12)
    jl, _ = jm.forward(jp, tokens=jnp.asarray(toks, jnp.int32),
                       prefix_embeds=jnp.asarray(prefix))
    tl, _ = m.forward(tp, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(prefix))
    assert tl.shape == (2, m.cfg.prefix_len + 24, m.cfg.vocab_size)
    _close(tl, jl)
    jloss, jparts = jm.loss(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                 "prefix_embeds": jnp.asarray(prefix)})
    tloss, tparts = m.loss(tp, {"tokens": torch.from_numpy(toks),
                                "prefix_embeds": torch.from_numpy(prefix)})
    for name in ("loss", "ce", "aux"):
        _close(tparts[name], jparts[name], atol=1e-5)


def test_paligemma_prefill_and_decode_match_reference():
    """The prefix is seen bidirectionally at prefill and from every decode
    step, which starts at ``prompt + prefix_len``."""
    jm, jp, m, tp = _models("paligemma-3b")
    prefix, toks = _vlm_inputs(m.cfg, 13, S=20)
    P = m.cfg.prefix_len
    ML = P + 20 + 8
    jl, jc = jm.prefill(jp, tokens=jnp.asarray(toks, jnp.int32),
                        prefix_embeds=jnp.asarray(prefix), max_len=ML)
    tl, tc = m.prefill(tp, tokens=torch.from_numpy(toks),
                       prefix_embeds=torch.from_numpy(prefix), max_len=ML)
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    for t in range(4):
        jl, jc = jm.decode_step(jp, jc, tokens=jnp.asarray(tok, jnp.int32),
                                pos=jnp.int32(P + 20 + t))
        tl, tc = m.decode_step(tp, tc, tokens=torch.from_numpy(tok), pos=P + 20 + t)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None]


# ---------------------------------------------------------------- batcher

SHAPES = [(8, 6), (5, 9), (12, 7), (15, 5), (3, 12), (40, 6)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batcher_tokens_match_reference_with_binding_capacity(layout):
    """mixtral's smoke config at capacity_factor 0.5: a bucketed prefill of
    16 tokens keeps 4 assignments an expert, the paged step's two rows one
    each (routed together), the dense step's rows one each (routed alone).
    The port's greedy tokens equal the reference batcher's in each
    layout."""
    jm, jp, m, tp = _models("mixtral-8x22b", capacity_factor=0.5)
    rng = np.random.default_rng(42)
    prompts = [(rng.integers(1, m.cfg.vocab_size, p).astype(np.int32), n)
               for p, n in SHAPES]
    jb = JBatcher(jm, jp, max_slots=2, max_len=64, kv_layout=layout)
    jreqs = [JRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    b = ContinuousBatcher(m, tp, max_slots=2, max_len=64, kv_layout=layout,
                          device="cpu")
    reqs = [GenRequest(i, p, n) for i, (p, n) in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    reset_counts()
    b.run()
    assert sum(LAUNCHES.values()) == 0
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(len(r.tokens) == n for r, (_, n) in zip(reqs, prompts))


def test_route_rows_is_the_dense_batchers_grouping():
    """``decode_step`` routes the whole batch as one group unless asked to
    route rows alone; under a binding capacity the two differ, and
    ``route_rows`` equals one-row steps."""
    _, _, m, tp = _models("mixtral-8x22b", capacity_factor=0.5)
    rng = np.random.default_rng(14)
    toks = rng.integers(1, m.cfg.vocab_size, (4, 10))
    nt = torch.from_numpy(rng.integers(1, m.cfg.vocab_size, (4, 1)))

    def one_row_caches():  # each row prefilled alone, as the batcher admits
        return [m.prefill(tp, tokens=torch.from_numpy(toks[b:b + 1]), max_len=16)[1]
                for b in range(4)]

    def stacked():
        rows = one_row_caches()
        return [{name: torch.cat([c[li][name] for c in rows]) for name in rows[0][li]}
                for li in range(len(rows[0]))]

    whole, _ = m.decode_step(tp, stacked(), tokens=nt, pos=10)
    rows, _ = m.decode_step(tp, stacked(), tokens=nt, pos=10, route_rows=True)
    one = [m.decode_step(tp, c1, tokens=nt[b:b + 1], pos=10)[0]
           for b, c1 in enumerate(one_row_caches())]
    _close(rows, torch.cat(one).numpy(), atol=1e-5)
    assert not torch.allclose(whole, rows, atol=1e-3)


# ---------------------------------------------------------- launcher, counts


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "musicgen-medium", "paligemma-3b",
                                  "deepseek-coder-33b", "yi-34b"])
def test_serve_launcher_runs_each_new_arch(arch, capsys):
    serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch} smoke=True device=cpu batch=2 prompt=9 gen=3" in out
    assert "sample continuation (seq 0):" in out


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_counts_equal_reference(arch):
    jm = j_build(j_get_config(arch))
    m = build_model(get_config(arch))
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_smoke_param_tree_shapes_equal_reference(arch):
    """Each layer of the port's own init has the reference's leaves at the
    reference's shapes (one block row of the stacked tree)."""
    jm = j_build(j_smoke(arch))
    shapes = jm.init_shape()
    m = build_model(smoke_config(arch))
    own = m.init(torch.Generator(), device="meta")
    for li, lp in enumerate(own["layers"]):
        blk, j = divmod(li, m.block_size)
        ref = jax.tree.map(lambda s: s.shape[1:], shapes["blocks"][j])
        got = jax.tree.map(lambda t: tuple(t.shape), lp)
        assert got == ref
    assert set(own) - {"layers"} == set(shapes) - {"blocks"}
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(jm.cfg)
