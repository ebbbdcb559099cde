"""Port mixture-of-experts layer against ``repro.models.mlp`` on the CPU.

The capacity dispatch (``_moe_local``) and the every-expert form
(``_moe_dense``) for (E, k) in {(4, 1), (4, 2), (8, 2)} with and without a
shared expert, at the reference's MoE tolerance (1e-5, tests/test_moe.py);
a binding capacity (cf = 0.2) whose kept assignments equal the
reference's exactly; routing ties resolved as ``jax.lax.top_k`` resolves
them (lower expert first); rows routed as groups equal to ``jax.vmap`` of
the reference over rows; the load-balancing loss; bf16 activations with
their gate rounding; the f32 router of a bf16 init; ``sinusoidal_pos``.
Every input comes from a numpy seed.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402

TOL = 1e-5
ARCH = "mixtral-8x22b"
EK = [(4, 1), (4, 2), (8, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread, as
    tests/test_torch_batching.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return smoke_config(ARCH).replace(**kw), j_smoke(ARCH).replace(**kw)


def _params(jcfg, seed, dtype=jnp.float32):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, _torch_tree(jp)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("E,k", EK)
def test_apply_moe_matches_reference(E, k, shared, impl):
    """``apply_moe`` (the whole batch as one group) and the implementation
    beneath it, output and aux loss."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, shared_expert=shared,
                      moe_impl=impl)
    jp, tp = _params(jcfg, E + k)
    x = _x((2, 7, cfg.d_model), 10 * E + k)
    jy, jaux = JM.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = M.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(ty, jy)
    _close(taux, jaux)
    fn, jfn = ((M._moe_local, JM._moe_local) if impl == "dispatch"
               else (M._moe_dense, JM._moe_dense))
    jy, jaux = jfn(jp, jnp.asarray(x), jcfg)
    ty, taux = fn(tp, torch.from_numpy(x).reshape(1, 14, cfg.d_model), cfg)
    _close(ty.reshape(2, 7, -1), jy)
    _close(taux[0], jaux)


def _reference_book(jp, x, jcfg, C):
    T = x.shape[0]
    gates, idx, probs = JM._route(jnp.asarray(x), jp["router"], jcfg.experts_per_token)
    _, (e_flat, slot, keep, tok_ids) = JM._dispatch(jnp.asarray(x), gates, idx,
                                                     jcfg.num_experts, C)
    assert tok_ids.shape == (T * jcfg.experts_per_token,)
    return np.asarray(idx), np.asarray(e_flat), np.asarray(slot), np.asarray(keep)


@pytest.mark.parametrize("E,k", EK)
def test_binding_capacity_keeps_the_reference_assignments(E, k):
    """cf = 0.2: most assignments overflow. The kept set, the slot each
    kept assignment takes and the output equal the reference's."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, capacity_factor=0.2)
    jp, tp = _params(jcfg, 3 + E)
    T = 40
    x = _x((T, cfg.d_model), 7 + k)
    C = M._capacity(T, k, E, 0.2)
    assert C == JM._capacity(T, k, E, 0.2) == max(1, int(np.ceil(T * k / E * 0.2)))
    idx, e_flat, slot, keep = _reference_book(jp, x, jcfg, C)
    assert 0 < keep.sum() < keep.size  # capacity binds
    _, tidx, _ = M._route(torch.from_numpy(x)[None], tp["router"], k)
    np.testing.assert_array_equal(tidx[0].numpy(), idx)
    disp, (row, tkeep) = M._dispatch(torch.from_numpy(x)[None], tidx, E, C)
    np.testing.assert_array_equal(tkeep[0].numpy(), keep)
    np.testing.assert_array_equal(row.numpy(), e_flat * C + slot)
    jdisp, _ = JM._dispatch(jnp.asarray(x), *JM._route(jnp.asarray(x), jp["router"], k)[:2],
                            E, C)
    _close(disp[0], jdisp, atol=0)
    jy, jaux = JM._moe_local(jp, jnp.asarray(x)[None], jcfg)
    ty, taux = M._moe_local(tp, torch.from_numpy(x)[None], cfg)
    _close(ty, jy)
    _close(taux[0], jaux)


@pytest.mark.parametrize("impl", ["dispatch", "dense"])
@pytest.mark.parametrize("E,k", EK)
def test_record_keeps_the_reference_routing_and_kept_set(E, k, impl):
    """``mlp.RECORD`` (off by default) takes each call's routing choices,
    probabilities and, under capacity dispatch, kept set, equal to the
    reference's at a binding capacity, and changes no output."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, capacity_factor=0.2,
                      moe_impl=impl)
    jp, tp = _params(jcfg, 5 + E)
    T = 40
    x = _x((T, cfg.d_model), 11 + k)
    idx, _, _, keep = _reference_book(jp, x, jcfg, M._capacity(T, k, E, 0.2))
    assert M.RECORD is None
    fn = M._moe_local if impl == "dispatch" else M._moe_dense
    y_off, _ = fn(tp, torch.from_numpy(x)[None], cfg)
    M.RECORD = calls = []
    try:
        y_on, _ = fn(tp, torch.from_numpy(x)[None], cfg)
    finally:
        M.RECORD = None
    assert torch.equal(y_on, y_off)
    [(ridx, rprobs, rkeep)] = calls
    np.testing.assert_array_equal(ridx[0].numpy(), idx)
    _close(rprobs[0], JM._route(jnp.asarray(x), jp["router"], k)[2])
    if impl == "dispatch":
        np.testing.assert_array_equal(rkeep[0].numpy(), keep)
    else:
        assert rkeep is None


@pytest.mark.parametrize("probs", [
    [0.25] * 4,
    [1 / 16] * 16,
    [0.1, 0.3, 0.3, 0.3],
    [0.2, 0.2, 0.4, 0.1, 0.1],
    [0.05, 0.3, 0.05, 0.3, 0.3],
], ids=["4_equal", "16_equal", "three_tied_top", "tie_below_top", "tied_at_k"])
@pytest.mark.parametrize("k", [1, 2])
def test_top_k_breaks_ties_like_reference(probs, k):
    p = np.asarray([probs, probs[::-1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(p), k)
    tv, ti = M._top_k(torch.from_numpy(p), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("E,k", [(4, 2), (16, 1)])
def test_tied_router_routes_like_reference(E, k):
    """A zero router gives every expert the same probability: the whole
    layer (routing, capacity and combine) matches the reference's."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, capacity_factor=1.0)
    jp, tp = _params(jcfg, 5)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((1, 12, cfg.d_model), 8)
    _, jidx, _ = JM._route(jnp.asarray(x[0]), jp["router"], k)
    _, tidx, _ = M._route(torch.from_numpy(x), tp["router"], k)
    np.testing.assert_array_equal(tidx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx[0].numpy(), np.tile(np.arange(k), (12, 1)))
    jy, jaux = JM.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = M.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("E,k", EK)
def test_rows_as_groups_equal_vmap_of_reference(E, k, cf):
    """``route_rows``: each row routes alone under its own capacity, as the
    reference's dense batcher's vmap of a one-row step does; aux is the
    mean of the rows'."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, capacity_factor=cf)
    jp, tp = _params(jcfg, 9 + E)
    x = _x((4, 3, cfg.d_model), 11 + k)
    jy, jaux = jax.vmap(lambda r: JM._moe_local(jp, r[None], jcfg))(jnp.asarray(x))
    ty, taux = M.apply_moe(tp, torch.from_numpy(x), cfg, route_rows=True)
    _close(ty, np.asarray(jy)[:, 0])
    _close(taux, np.asarray(jaux).mean())
    # one group of all 12 tokens routes differently once capacity binds
    jy1, _ = JM._moe_local(jp, jnp.asarray(x), jcfg)
    ty1, _ = M.apply_moe(tp, torch.from_numpy(x), cfg)
    _close(ty1, jy1)


@pytest.mark.parametrize("E,k", EK)
def test_aux_loss_matches_reference(E, k):
    rng = np.random.default_rng(E * k)
    logits = rng.normal(size=(3, 10, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1)[..., :k]
    taux = M._aux_loss(torch.from_numpy(probs), torch.from_numpy(idx), E)
    for g in range(3):
        _close(taux[g], JM._aux_loss(jnp.asarray(probs[g]), jnp.asarray(idx[g]), E))


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2)])
def test_bf16_moe_matches_reference(E, k):
    """bf16 weights and activations, f32 router: the same routing and kept
    set, the gates rounded to bf16 before the combine, within bf16's
    tolerance (2e-2, the reference's bf16 kernel bound)."""
    cfg, jcfg = _cfgs(num_experts=E, experts_per_token=k, capacity_factor=0.5,
                      dtype="bfloat16", param_dtype="bfloat16")
    jp, tp = _params(jcfg, 13, jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32 and tp["router"].dtype == torch.float32
    x = _x((2, 9, cfg.d_model), 14)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _, jidx, _ = JM._route(xb.reshape(-1, cfg.d_model), jp["router"], k)
    _, tidx, _ = M._route(tx.reshape(1, -1, cfg.d_model), tp["router"], k)
    np.testing.assert_array_equal(tidx[0].numpy(), np.asarray(jidx))
    jy, _ = JM.apply_moe(jp, xb, jcfg)
    ty, _ = M.apply_moe(tp, tx, cfg)
    assert ty.dtype == torch.bfloat16
    _close(ty, np.asarray(jy.astype(jnp.float32)), atol=2e-2)


@pytest.mark.parametrize("shared", [False, True])
def test_init_moe_shapes_and_router_dtype(shared):
    """The port's own init: the reference's shapes, an f32 router in a bf16
    model, weight scales 1/sqrt(fan_in)."""
    cfg, jcfg = _cfgs(shared_expert=shared)
    tp = M.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    jp = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    flat_t = {k: v for k, v in tp.items() if k != "shared"}
    for name, t in flat_t.items():
        assert tuple(t.shape) == jp[name].shape
        assert str(t.dtype).split(".")[-1] == jp[name].dtype.name
    assert ("shared" in tp) == shared
    if shared:
        assert {k: tuple(v.shape) for k, v in tp["shared"].items()} == {
            k: v.shape for k, v in jp["shared"].items()}
    std = tp["w_out"].float().std().item()
    assert abs(std - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5


@pytest.mark.parametrize("d_model", [64, 1536])
def test_sinusoidal_pos_matches_reference(d_model):
    pos = np.arange(0, 700, 3)[None].repeat(2, 0)
    _close(C.sinusoidal_pos(torch.from_numpy(pos), d_model),
           JC.sinusoidal_pos(jnp.asarray(pos), d_model), atol=1e-5)
