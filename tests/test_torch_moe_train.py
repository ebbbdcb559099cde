"""Port MoE training and the training extras against the reference on the
CPU, from the same numpy-seeded inputs and the reference's weights
(``params_from_jax``):

- ``DecoderLM.loss`` gradients with experts against ``jax.grad`` of the
  reference's (loss within 5e-4, each leaf within 1e-4 of its max |grad|):
  mixtral-8x22b and llama4-scout-17b-a16e (a shared expert) smoke, with
  capacity dispatch and with every expert on every token, and at a
  binding capacity (cf 0.5); one 8-layer block of jamba-1.5-large-398b
  with its experts, where a leaf that misses 1e-4 must lie as close to
  the reference's float64 gradient as 4x the reference's own f32 one
  (tests/test_torch_mamba_train.py says why), and its whole smoke config
  with both sides in float64;
- three ``make_train_step`` steps with two microbatches against the
  reference's, losses compared (after step 1 AdamW moves each parameter by
  about lr * sign(g), so parameters are not): mixtral in f32 under its
  optimized training variant (``configs/optimized.py``: flash_vjp) and in
  bf16 with its f32 router, musicgen-medium (frame embeddings and labels)
  and paligemma-3b (an image prefix), every batch leaf split;
- ``remat="dots"``: gradients bitwise equal to "full" and "none", and
  against ``jax.grad`` under the reference's ``checkpoint_dots``;
- ``flash_vjp``: the reference's tests/test_perf_variants.py
  ``test_flash_vjp_matches_direct`` cases against its ``_flash_jnp`` (out
  2e-5, gradients 2e-4), the plain chunked statistics against
  ``_chunked_attention(with_stats=True)``, the backward's counts and the
  size of the largest tensor it makes;
- ``make_train_step`` on all ten registry ids' smoke configs, the
  ``RECORD`` hook once per MoE call under every remat, ``ElasticTrainer``
  and ``launch.train`` on mixtral, and ``configs/optimized.py`` equal to
  the reference's text.

The CUDA kernels run only on the card: tests/test_torch_gpu.py.
"""

import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import SyntheticBatches as JBatches  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.config import LayerSpec as JLayerSpec  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedule import constant_schedule as j_constant  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.configs.optimized import OPTIMIZED  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticBatches  # noqa: E402
from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_bwd_chunked, flash_attention_vjp)
from repro_torch.kernels.flash_attention.ref import chunked_attention_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decoder as decoder_module  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.schedule import constant_schedule  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from repro_torch.tree import leaves_with_paths, map_tree, unflatten  # noqa: E402

TOL = 5e-4          # loss (the reference's model tolerance)
LEAF_TOL = 1e-4     # each gradient leaf, of its max |grad|
DEPTH_RATIO = 4     # jamba: port's distance from the f64 gradient over the reference's
MIXTRAL, LLAMA4, JAMBA = "mixtral-8x22b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread, as tests/test_torch_mamba.py
    does: with other test processes on every core, torch's intra-op pool
    waits at each small eager op for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_grads(model, params, batch):
    flat = list(leaves_with_paths(params))
    live = [p.detach().requires_grad_(True) for _, p in flat]
    loss, _ = model.loss(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.item(), [path for path, _ in flat], grads


def _ref_leaf(j_tree, path, block_size):
    """The reference's leaf at the port's ``path`` (layer i of the port is
    block i // block_size, position i % block_size)."""
    if path[0] != "layers":
        node = j_tree
        for p in path:
            node = node[p]
        return np.asarray(node)
    blk, pos = divmod(path[1], block_size)
    node = j_tree["blocks"][pos]
    for p in path[2:]:
        node = node[p]
    return np.asarray(node)[blk]


def _reference(arch, **kw):
    """(reference model, its params, port model, converted params), cached."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, cfg = j_smoke(arch).replace(**kw), smoke_config(arch).replace(**kw)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _CACHE[key] = (jm, jp, build_model(cfg), tp)
    return _CACHE[key]


def _tokens(cfg, B=2, S=32, seed=0):
    return JBatches(cfg, B, S, seed=seed).batch(0)["tokens"]


def _assert_grads_match(m, paths, grads, jg, exact=None):
    for path, g in zip(paths, grads):
        ref = _ref_leaf(jg, path, m.block_size)
        assert g.shape == ref.shape, path
        g = g.float().numpy()
        if np.abs(g - ref).max() > LEAF_TOL * np.abs(ref).max():
            assert exact is not None, path
            ex = _ref_leaf(exact, path, m.block_size)
            assert np.abs(g - ex).max() <= DEPTH_RATIO * np.abs(ref - ex).max(), path


# ------------------------------------------------------- MoE gradients


@pytest.mark.parametrize("arch", [MIXTRAL, LLAMA4])
@pytest.mark.parametrize("kw", [dict(moe_impl="auto"), dict(moe_impl="dense"),
                                dict(moe_impl="auto", capacity_factor=0.5)],
                         ids=["dispatch", "dense", "binding_cf0.5"])
def test_moe_loss_gradients_match_reference(arch, kw):
    """Loss and every gradient leaf, the f32 router's included, of the
    smoke config with experts (llama4: top-1 of 16 and a shared expert)."""
    jm, jp, m, tp = _reference(arch, **kw)
    toks = _tokens(m.cfg)
    (jl, jparts), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    loss, paths, grads = _flat_grads(m, tp, {"tokens": torch.from_numpy(toks)})
    assert abs(loss - float(jl)) <= TOL * (1 + abs(float(jl)))
    assert float(jparts["aux"]) > 0
    routers = [g for path, g in zip(paths, grads) if path[-1] == "router"]
    assert routers and all(g.dtype == torch.float32 and g.abs().max() > 0 for g in routers)
    _assert_grads_match(m, paths, grads, jax.tree.map(np.asarray, jg))


def _jamba_f64_grads(jm_cfg, jp, toks):
    """The reference's gradients in float64 on its jnp route, under
    ``jax.enable_x64`` with ``jnp.float32`` pointed at float64 while it
    traces (its model casts to f32 by that name)."""
    with jax.enable_x64():
        f32, jnp.float32 = jnp.float32, jnp.float64
        try:
            jm = j_build(jm_cfg.replace(dtype="float64", param_dtype="float64"))
            jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
            _, jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
                jp64, {"tokens": jnp.asarray(toks)})
            jg = jax.tree.map(np.asarray, jg)
        finally:
            jnp.float32 = f32
    assert all(a.dtype == np.float64 for a in jax.tree.leaves(jg))
    return jg


def test_jamba_with_experts_loss_gradients_match_reference():
    """One 8-layer block of jamba's smoke config with its experts (7 Mamba
    layers and 1 attention layer, MoE on every other layer): loss within
    5e-4; each leaf within 1e-4 of its max or, for the ill-conditioned
    Mamba leaves where f32 rounding alone moves the gradient, within 4x
    the reference's own distance from its float64 gradient (the block
    measured: every leaf within 1e-4). The whole 16-layer smoke config is
    held in float64 below: in f32 its deeper chain moves leaves up to
    ~3e-4 of their max between any two f32 orders."""
    jm, jp, m, tp = _reference(JAMBA, num_layers=8)
    assert any(s.is_moe for s in m.specs) and any(s.mixer == "mamba" for s in m.specs)
    toks = _tokens(m.cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    loss, paths, grads = _flat_grads(m, tp, {"tokens": torch.from_numpy(toks)})
    assert abs(loss - float(jl)) <= TOL * (1 + abs(float(jl)))
    _assert_grads_match(m, paths, grads, jax.tree.map(np.asarray, jg),
                        exact=_jamba_f64_grads(jm.cfg, jp, toks))


def test_jamba_with_experts_gradients_match_reference_in_float64(monkeypatch):
    """jamba's 16-layer smoke config with its experts, both sides in
    float64 (the port with ``Tensor.float`` and its compute dtype pointed
    at float64): loss within 5e-4 and every leaf within 1e-4 of its max,
    with no rounding floor to hide a wrong gradient (measured: ~4e-13)."""
    jm, jp, m, tp = _reference(JAMBA)
    toks = _tokens(m.cfg)
    exact = _jamba_f64_grads(jm.cfg, jp, toks)
    with jax.enable_x64():
        f32, jnp.float32 = jnp.float32, jnp.float64
        try:
            j64 = j_build(jm.cfg.replace(dtype="float64", param_dtype="float64"))
            jl = float(j64.loss(jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                             jp), {"tokens": jnp.asarray(toks)})[0])
        finally:
            jnp.float32 = f32
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setattr(decoder_module, "torch_dtype", lambda name: torch.float64)
        loss, paths, grads = _flat_grads(m, map_tree(lambda _, t: t.double(), tp),
                                         {"tokens": torch.from_numpy(toks)})
    assert abs(loss - jl) <= TOL * (1 + abs(jl))
    for path, g in zip(paths, grads):
        ref = _ref_leaf(exact, path, m.block_size)
        assert g.dtype == torch.float64 and g.shape == ref.shape, path
        assert np.abs(g.numpy() - ref).max() <= LEAF_TOL * np.abs(ref).max(), path


# ------------------------------------------------------------ train steps


def _batches(cfg, seed=3, B=4, S=32):
    data = JBatches(cfg, B, S, seed=seed)
    return [data.batch(i) for i in range(3)]


@pytest.mark.parametrize("case", [
    (MIXTRAL, dict(OPTIMIZED[MIXTRAL]["train"], attn_chunk_q=8, attn_chunk_k=16), 5e-4),
    (MIXTRAL, dict(num_microbatches=2, dtype="bfloat16", param_dtype="bfloat16"), 2e-2),
    ("musicgen-medium", dict(num_microbatches=2), 5e-4),
    ("paligemma-3b", dict(num_microbatches=2), 5e-4),
], ids=["mixtral_f32_optimized", "mixtral_bf16", "musicgen", "paligemma"])
def test_train_step_losses_match_reference(case):
    """Three steps of two microbatches from the same params and batches;
    loss, ce and aux of each step within ``tol`` (5e-4 in f32; bf16 params
    and activations at the reference's bf16 tolerance, 2e-2)."""
    arch, kw, tol = case
    jm, jp, m, tp = _reference(arch, **kw)
    assert m.cfg.num_microbatches == 2
    if m.cfg.param_dtype == "bfloat16":
        routers = [t for path, t in leaves_with_paths(tp) if path[-1] == "router"]
        assert routers and all(t.dtype == torch.float32 for t in routers)
    jopt = JAdamW(lr=j_constant(1e-3))
    jstep = jax.jit(j_make_train_step(jm, jopt))
    jstate = jopt.init_state(jp)
    opt = AdamW(lr=constant_schedule(1e-3))
    state = opt.init_state(tp)
    step = make_train_step(m, opt)
    reset_counts()
    for i, batch in enumerate(_batches(m.cfg)):
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, metrics = step(state, batch)
        for name in ("loss", "ce", "aux"):
            assert abs(float(metrics[name]) - float(jmetrics[name])) <= tol * (
                1 + abs(float(jmetrics[name]))), (i, name)
    n_attn = sum(s.mixer == "attn" for s in m.layer_specs)
    bwd = "flash_attention_bwd_chunked" if m.cfg.flash_vjp else "flash_attention_bwd"
    assert BWD_CALLS[bwd] == 3 * 2 * n_attn and sum(LAUNCHES.values()) == 0


def test_train_step_refuses_a_batch_that_does_not_split():
    _, _, m, tp = _reference("paligemma-3b")
    opt = AdamW(lr=constant_schedule(1e-3))
    step = make_train_step(m, opt, num_microbatches=2)
    batch = SyntheticBatches(m.cfg, 3, 32, seed=0).batch(0)
    with pytest.raises(ValueError, match="prefix_embeds"):
        step(opt.init_state(tp), batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_runs_every_registry_id(arch):
    """One step of two microbatches on each of the ten smoke configs:
    finite metrics, every parameter moved or kept finite."""
    cfg = smoke_config(arch).replace(num_microbatches=2)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    before = [t.clone() for _, t in leaves_with_paths(params)]
    opt = AdamW(lr=constant_schedule(1e-3))
    state, metrics = make_train_step(m, opt)(
        opt.init_state(params), SyntheticBatches(cfg, 4, 32, seed=0).batch(0))
    assert state["step"] == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = [t for _, t in leaves_with_paths(state["params"])]
    assert all(torch.isfinite(t.float()).all() for t in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    if any(s.is_moe for s in m.specs):
        assert float(metrics["aux"]) > 0


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("arch", [MIXTRAL, "starcoder2-3b"])
def test_remat_dots_gradients_equal_full_and_none(arch):
    """Selective checkpointing keeps every matmul's output and recomputes
    the rest; the gradients do not depend on the policy, bit for bit
    (mixtral: experts; starcoder2-3b: the flash op's recompute)."""
    _, _, m, tp = _reference(arch)
    toks = torch.from_numpy(_tokens(m.cfg))
    out = {}
    for remat in ("dots", "full", "none"):
        reset_counts()
        out[remat] = _flat_grads(build_model(m.cfg.replace(remat=remat)), tp,
                                 {"tokens": toks})
        n_attn = sum(s.mixer == "attn" for s in m.layer_specs)
        assert PLAIN_CALLS["flash_attention"] == (1 if remat == "none" else 2) * n_attn
    for remat in ("full", "none"):
        assert out[remat][0] == out["dots"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[remat][2], out["dots"][2]))


def test_remat_dots_matches_reference_checkpoint_dots():
    """mixtral's smoke config under remat="dots" on both sides:
    ``jax.checkpoint(policy=checkpoint_dots)`` against the port's
    selective checkpoint."""
    jm, jp, m, tp = _reference(MIXTRAL, remat="dots", num_layers=4)
    toks = _tokens(m.cfg)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)})
    loss, paths, grads = _flat_grads(m, tp, {"tokens": torch.from_numpy(toks)})
    assert abs(loss - float(jl)) <= TOL * (1 + abs(float(jl)))
    _assert_grads_match(m, paths, grads, jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_record_holds_each_moe_call_once_under_remat(remat):
    """A block recomputed in the backward records nothing: one training
    forward and backward records each MoE layer once."""
    _, _, m, tp = _reference(MIXTRAL)
    m = build_model(m.cfg.replace(remat=remat))
    mlp.RECORD = calls = []
    try:
        _flat_grads(m, tp, {"tokens": torch.from_numpy(_tokens(m.cfg))})
    finally:
        mlp.RECORD = None
    assert len(calls) == sum(s.is_moe for s in m.layer_specs)


# ------------------------------------------------------------- flash_vjp


def _vjp_cfgs(window, cap, prefix, H=4, KV=2, hd=32):
    base = dict(name="t", family="dense", num_layers=1, d_model=hd * H,
                num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=64,
                vocab_size=64, window_size=window, attn_softcap=cap,
                prefix_len=prefix, attn_chunk_q=64, attn_chunk_k=64,
                dtype="float32", param_dtype="float32",
                attn_pattern=("local",) if window else ("global",))
    spec = ("attn", "local" if window else "global", False, 0)
    return (ModelConfig(**base, flash_vjp=True), LayerSpec(*spec),
            JModelConfig(**base, flash_vjp=True), JLayerSpec(*spec))


VJP_CASES = [(0, 0.0, 0), (48, 0.0, 0), (0, 25.0, 0), (0, 0.0, 24), (48, 25.0, 0)]


def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("window,cap,prefix", VJP_CASES)
def test_flash_vjp_matches_reference_flash_jnp(window, cap, prefix):
    """The reference's test_flash_vjp_matches_direct shapes (B=2, H=4,
    KV=2, S=192, hd=32, 64-chunks) through ``grouped_attention`` in
    training with ``flash_vjp`` on both sides: out within 2e-5, the
    gradients of sum(out**2) within 2e-4; one stats forward and one
    chunked backward."""
    cfg, spec, jcfg, jspec = _vjp_cfgs(window, cap, prefix)
    B, S = 2, 192
    q, k, v = _qkv(B, S, 4, 2, 32)
    pos = np.arange(S, dtype=np.int32)
    jpos = jnp.asarray(pos)

    def jf(*a):
        return JA.grouped_attention(*a, jpos, jpos, jcfg, jspec)

    jo = jf(*map(jnp.asarray, (q, k, v)))
    jgr = jax.grad(lambda *a: (jf(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos).long()
    reset_counts()
    to = A.grouped_attention(tq, tk, tv, tpos, tpos, cfg, spec, train=True)
    (to ** 2).sum().backward()
    assert PLAIN_CALLS["flash_attention_stats"] == 1 and PLAIN_CALLS["flash_attention"] == 0
    assert BWD_CALLS == {"flash_attention_bwd": 0, "flash_attention_bwd_chunked": 1}
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=2e-5)
    for a, b in zip((tq, tk, tv), jgr):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("window,cap,prefix", VJP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_stats_match_reference_chunked_attention(window, cap, prefix, dtype):
    """``chunked_attention_ref``'s (out, m, l) against the reference's
    ``_chunked_attention(with_stats=True)`` at ragged-free 64-chunks (f32
    at 2e-5; bf16 inputs at 2e-2, the reference's bf16 tolerance)."""
    B, S, H, KV, hd = 2, 192, 4, 2, 32
    q, k, v = _qkv(B, S, H, KV, hd, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pos = jnp.arange(S, dtype=jnp.int32)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jo, jm_, jl = JA._chunked_attention(
        jq.reshape(B, S, KV, H // KV, hd), jk, jv, pos, pos, window=window,
        prefix_len=prefix, cap=cap, scale=hd**-0.5, chunk_q=64, chunk_k=64,
        with_stats=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).transpose(1, 2) for a in (q, k, v))
    to, tm, tl = chunked_attention_ref(tq, tk, tv, chunk_q=64, chunk_k=64, window=window,
                                       softcap=cap, prefix_len=prefix)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to.transpose(1, 2).float().numpy(),
                               np.asarray(jo.astype(jnp.float32)).reshape(B, S, H, hd),
                               atol=tol, rtol=tol)
    for t, j in ((tm, jm_), (tl, jl)):
        assert t.dtype == torch.float32 and t.shape == (B, H, S)
        np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(B, H, S),
                                   atol=2e-5, rtol=2e-5)


class _Biggest(TorchDispatchMode):
    """The most elements of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("S", [192, 200], ids=["tiled", "ragged"])
def test_chunked_backward_never_makes_a_whole_score_tensor(S):
    """The backward's largest tensor is one block's scores (or a gradient
    of q, k, v): no (Sq, Sk) tensor of a head exists, and a ragged last
    chunk works, equal to the gradients through the O(S^2) op."""
    B, H, KV, hd, cq, ck = 1, 4, 2, 32, 64, 32
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in _qkv(B, S, H, KV, hd, seed=2))
    out, m, l = chunked_attention_ref(q, k, v, chunk_q=cq, chunk_k=ck, window=48)
    do = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    with _Biggest() as big:
        grads = flash_attention_bwd_chunked(q, k, v, out, m, l, do, chunk_q=cq,
                                            chunk_k=ck, window=48)
    assert big.numel <= max(B * H * cq * ck, B * H * S * hd) < B * H * S * S
    from repro_torch.kernels.flash_attention.ops import flash_attention

    live = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention(*live, window=48), live, do)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4)
    # the op: the same backward under autograd
    live = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention_vjp(*live, chunk_q=cq, chunk_k=ck, window=48),
                              live, do)
    assert all(torch.equal(a, b) for a, b in zip(got, grads))


# ------------------------------------------------- trainer, launcher, configs


def test_elastic_trainer_trains_mixtral_with_revocation(tmp_path):
    """mixtral's smoke config under its optimized training variant through
    ``ElasticTrainer`` on one CPU device: 4 steps, a revocation before step
    2, losses finite and bitwise equal to an uninterrupted run's."""
    cfg = smoke_config(MIXTRAL).replace(**OPTIMIZED[MIXTRAL]["train"], attn_chunk_q=16,
                                        attn_chunk_k=16)

    def trainer(sub):
        return ElasticTrainer(build_model(cfg), AdamW(lr=constant_schedule(3e-3)),
                              SyntheticBatches(cfg, global_batch=4, seq_len=32, seed=0),
                              Checkpointer(tmp_path / sub, keep=2), devices=["cpu"])

    tr = trainer("a")
    tr.run(4, preempt_at={2: 1}, checkpoint_every=0)
    assert tr.rescales == 1 and [h[0] for h in tr.history] == list(range(4))
    losses = [h[1] for h in tr.history]
    assert all(np.isfinite(losses))
    ref = trainer("b")
    ref.run(4, checkpoint_every=0)
    assert [h[1] for h in ref.history] == losses


@pytest.mark.parametrize("arch", [MIXTRAL, "musicgen-medium", "paligemma-3b"])
def test_launch_train_smoke_trains_moe_audio_and_vlm(arch, tmp_path, capsys):
    train_main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step     2 loss" in out
    assert (tmp_path / "ck" / "step_00000002").is_dir()


def test_optimized_configs_equal_reference_text():
    ref = (SRC / "repro" / "configs" / "optimized.py").read_text()
    port = (SRC / "repro_torch" / "configs" / "optimized.py").read_text()
    assert port == ref.replace("repro.", "repro_torch.")
    assert OPTIMIZED[MIXTRAL]["train"] == dict(num_microbatches=2, flash_vjp=True)
