"""Port jamba training path against the reference on the CPU, on one 8-layer
block of the jamba smoke config without experts (``smoke_config(
"jamba-1.5-large-398b").replace(num_layers=8, moe_period=0, num_experts=0,
experts_per_token=0)``: 7 Mamba layers and 1 attention layer, d_inner 256,
N 8):

- the plain selective-scan backward against the reference's Pallas
  backward (interpret mode, its per-block partials summed as its ``ops.py``
  sums them) and ``jax.vjp`` of its oracle, atol = rtol = 1e-4 (the
  reference's backward tolerance in tests/test_kernels.py), and the plain
  forward's chunk-start states against the reference's ``save_states``;
- the autograd op (``gradcheck`` in float64, and against autograd through
  the plain forward);
- the flash op's gradients against ``jax.vjp`` of the reference's
  ``flash_attention`` (interpret), within 1e-4 (the reference's
  flash-gradient tolerance);
- one Mamba layer's ``mamba_train`` and its gradients against the
  reference's, within 1e-4 of each gradient's max;
- gradients of ``DecoderLM.loss`` against ``jax.grad`` of the reference's
  (loss within 5e-4, each leaf within 1e-4 of its max |grad| or, where
  f32 rounding moves it farther, as close to the reference's float64
  gradient as 4x the reference's own f32 one: see the test) on the
  reference's jnp and Pallas routes, and ``remat="full"`` bit for bit;
  both sides in float64 on the jnp route, every leaf within 1e-4;
- three train steps with the config's bf16 accumulation, with int8 and
  with f32 moments, against the reference's ``make_train_step``; the train
  step's params and moments bitwise equal to a straightforward step's that
  holds every gradient at once; ``ElasticTrainer`` with a revocation; the
  training launcher on the config with experts.

Weights come from the reference's init through ``params_from_jax``. The
CUDA kernels run only on the card: tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import SyntheticBatches as JBatches  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.ssm_scan.kernel import (  # noqa: E402
    ssm_scan_bwd as j_bwd_kernel, ssm_scan_fwd as j_fwd_kernel)
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_scan_ref  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedule import constant_schedule as j_constant  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticBatches  # noqa: E402
from repro_torch.device import torch_dtype  # noqa: E402
from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    CHECKPOINT, n_chunks, ssm_scan_bwd_ref, ssm_scan_ref)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decoder as decoder_module  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim import adamw as adamw_module  # noqa: E402
from repro_torch.optim.compress import dequantize_int8, quantize_int8  # noqa: E402
from repro_torch.optim.schedule import constant_schedule  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from repro_torch.tree import get, leaves, leaves_with_paths, map_tree, unflatten  # noqa: E402

ARCH = "jamba-1.5-large-398b"
BLOCK = dict(num_layers=8, moe_period=0, num_experts=0, experts_per_token=0)
BWD_TOL = 1e-4
TOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread (see tests/test_torch_mamba.py:
    the plain scan is thousands of small eager ops, and torch's intra-op
    pool stalls on them when other test processes hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def _bwd_inputs(B, S, Di, N, seed=0):
    """The reference test's distributions (tests/test_kernels.py), nonzero
    h0, dy and dhT."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, S, Di)).astype(f),
            rng.uniform(0.01, 0.2, size=(B, S, Di)).astype(f),
            -rng.uniform(0.5, 2, size=(Di, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(B, S, N)).astype(f),
            rng.normal(size=(Di,)).astype(f),
            rng.normal(size=(B, Di, N)).astype(f),
            rng.normal(size=(B, S, Di)).astype(f),
            rng.normal(size=(B, Di, N)).astype(f))


# ------------------------------------------------------- scan backward (B6)


@pytest.mark.parametrize("S", [64, 128])
def test_plain_bwd_matches_pallas_bwd_and_states(S):
    """The plain backward fed the JAX forward's ``save_states`` (at the
    port's checkpoint interval) against the Pallas backward in interpret
    mode, partials summed as the reference's ``ops.py`` sums them; the plain
    forward's chunk-start states against the reference's at its interval
    and at its default 64-step chunk, where the intervals meet."""
    x, dt, A, Bc, Cc, D, h0, dy, dhT = _bwd_inputs(2, S, 64, 8, seed=S)
    j = tuple(map(jnp.asarray, (x, dt, A, Bc, Cc, D, h0)))
    _, _, j_starts = j_fwd_kernel(*j, chunk=CHECKPOINT, block_d=32, interpret=True,
                                  save_states=True)
    _, _, j_starts64 = j_fwd_kernel(*j, chunk=64, block_d=32, interpret=True,
                                    save_states=True)
    dx, ddt, dA_c, dB_p, dC_p, dD_c, dh0 = j_bwd_kernel(
        *j[:6], jnp.asarray(dy), j_starts, jnp.asarray(dhT), chunk=CHECKPOINT,
        block_d=32, interpret=True)
    j_out = (dx, ddt, dA_c.sum(axis=(0, 1)), dB_p.sum(axis=1), dC_p.sum(axis=1),
             dD_c.sum(axis=(0, 1)), dh0)
    reset_counts()
    _, _, starts = ssm_scan_ref(*map(_t, (x, dt, A, Bc, Cc, D, h0)), save_states=True)
    assert starts.shape == (2, n_chunks(S), 64, 8)
    _close(starts, j_starts, BWD_TOL)
    _close(starts[:, ::64 // CHECKPOINT], j_starts64, BWD_TOL)
    out = ssm_scan_bwd_ref(*map(_t, (x, dt, A, Bc, Cc, D, dy)), _t(j_starts), _t(dhT))
    assert PLAIN_CALLS["ssm_scan_bwd"] == 1 and LAUNCHES["ssm_scan_bwd"] == 0
    for a, b in zip(out, j_out):
        assert tuple(a.shape) == b.shape
        _close(a, b, BWD_TOL)


@pytest.mark.parametrize("S", [37, 100, 1], ids=["ragged37", "ragged100", "one"])
def test_plain_bwd_matches_jax_vjp(S):
    """Any S (the last checkpoint chunk ragged), nonzero h0, dy and dhT,
    against ``jax.vjp`` of the reference's jnp oracle."""
    x, dt, A, Bc, Cc, D, h0, dy, dhT = _bwd_inputs(2, S, 32, 8, seed=S + 1)
    _, vjp = jax.vjp(j_scan_ref, *map(jnp.asarray, (x, dt, A, Bc, Cc, D, h0)))
    j_grads = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    _, _, starts = ssm_scan_ref(*map(_t, (x, dt, A, Bc, Cc, D, h0)), save_states=True)
    out = ssm_scan_bwd_ref(*map(_t, (x, dt, A, Bc, Cc, D, dy)), starts, _t(dhT))
    for a, b in zip(out, j_grads):
        assert tuple(a.shape) == b.shape
        _close(a, b, BWD_TOL)


def test_op_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    B, S, Di, N = 1, 11, 4, 4  # two checkpoint chunks, the second ragged

    def rand(*shape, lo=None, scale=1.0):
        if lo is None:
            return scale * torch.randn(*shape, generator=g, dtype=torch.float64)
        return lo + scale * torch.rand(*shape, generator=g, dtype=torch.float64)

    args = [rand(B, S, Di), rand(B, S, Di, lo=0.05, scale=0.2), rand(Di, N, lo=-2.0),
            rand(B, S, N), rand(B, S, N), rand(Di), rand(B, Di, N)]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(lambda *a: ssm_scan(*a), args)


@pytest.mark.parametrize("S", [37, 130])
def test_op_gradients_equal_autograd_through_plain(S):
    x, dt, A, Bc, Cc, D, h0, dy, dhT = _bwd_inputs(2, S, 32, 8, seed=S + 2)
    grads = []
    for impl in ("kernel", "ref"):
        leaves_ = [_t(a).requires_grad_(True) for a in (x, dt, A, Bc, Cc, D, h0)]
        reset_counts()
        y, hT = (ssm_scan if impl == "kernel" else ssm_scan_ref)(*leaves_)
        grads.append(torch.autograd.grad((y * _t(dy)).sum() + (hT * _t(dhT)).sum(),
                                         leaves_))
        assert PLAIN_CALLS["ssm_scan_bwd"] == (impl == "kernel")
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_TOL, rtol=BWD_TOL)


# ------------------------------------------------------------- flash op


@pytest.mark.parametrize("kw", [dict(), dict(window=32, softcap=20.0)],
                         ids=["causal", "window_softcap"])
def test_flash_op_gradients_match_reference_vjp(kw):
    """Output and dq, dk, dv of the flash op (its backward recomputes from
    q, k, v) against ``jax.vjp`` of the reference's flash op, whose forward
    is its Pallas kernel in interpret mode and whose backward is ``jax.vjp``
    of its oracle."""
    rng = np.random.default_rng(5)
    B, H, KV, S, hd = 1, 4, 2, 128, 32
    q, do = (rng.normal(size=(B, H, S, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, KV, S, hd)).astype(np.float32) for _ in range(2))
    j_o, vjp = jax.vjp(lambda *a: j_flash(*a, block_q=64, block_k=64,
                                          interpret=True, **kw),
                       *map(jnp.asarray, (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    reset_counts()
    o = flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    assert PLAIN_CALLS["flash_attention"] == 1 and BWD_CALLS["flash_attention_bwd"] == 1
    _close(o.detach(), j_o, 2e-5)
    for a, b in zip(grads, j_grads):
        assert tuple(a.shape) == b.shape
        _close(a, b, BWD_TOL)


# ------------------------------------------------------------------- model


def _flat_grads(model, params, tokens):
    flat = list(leaves_with_paths(params))
    live = [p.detach().requires_grad_(True) for _, p in flat]
    loss, _ = model.loss(unflatten(params, live), {"tokens": tokens})
    grads = torch.autograd.grad(loss, live)
    return loss.item(), [path for path, _ in flat], grads


def _ref_leaf(j_tree, path, block_size):
    """The reference's gradient leaf at the port's ``path`` (layer i of the
    port is block i // block_size, position i % block_size)."""
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


_CACHE = {}


def _reference_params():
    if "params" not in _CACHE:
        _CACHE["params"] = j_build(j_smoke(ARCH).replace(**BLOCK)).init(
            jax.random.PRNGKey(0))
    return _CACHE["params"]


DEPTH_RATIO = 4  # port's distance from the exact gradient over the reference's own


def _reference_grads(S, use_pallas=False, x64=False):
    """Tokens, loss and gradient tree (numpy) of the reference's loss on the
    block from its seeded weights, cached. ``x64``: on its jnp route in
    float64, under ``jax.enable_x64`` with ``jnp.float32`` pointed at
    float64 while it traces, since its model casts to f32 by that name."""
    key = (S, use_pallas, x64)
    if key not in _CACHE:
        jcfg = j_smoke(ARCH).replace(use_pallas=use_pallas, **BLOCK)
        tokens = JBatches(jcfg, 2, S, seed=0).batch(0)["tokens"]
        jp = _reference_params()
        if not x64:
            (jl, _), jg = jax.jit(jax.value_and_grad(j_build(jcfg).loss, has_aux=True))(
                jp, {"tokens": jnp.asarray(tokens)})
        else:
            with jax.enable_x64():
                f32, jnp.float32 = jnp.float32, jnp.float64
                try:
                    jm = j_build(jcfg.replace(dtype="float64", param_dtype="float64"))
                    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
                    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
                        jp, {"tokens": jnp.asarray(tokens)})
                    jl, jg = float(jl), jax.tree.map(np.asarray, jg)
                finally:
                    jnp.float32 = f32
            assert all(a.dtype == np.float64 for a in jax.tree.leaves(jg))
        _CACHE[key] = (tokens, float(jl), jax.tree.map(np.asarray, jg))
    return _CACHE[key]


def _port_model_and_params(dtype=torch.float32):
    cfg = smoke_config(ARCH).replace(**BLOCK)
    params = params_from_jax(jax.tree.map(np.asarray, _reference_params()), cfg,
                             device="cpu")
    return build_model(cfg), map_tree(lambda _, t: t.to(dtype), params)


@pytest.mark.parametrize("use_pallas,S", [(False, 128), (True, 128), (False, 100)],
                         ids=["jnp", "pallas", "jnp_fallback100"])
def test_decoder_loss_gradients_match_reference(use_pallas, S):
    """Loss and every gradient leaf of ``DecoderLM.loss`` against
    ``jax.grad`` of the reference's from the same weights and batch (S=128
    takes the reference's Pallas scan and flash kernels when
    ``use_pallas``; S=100 does not tile its 64-step chunk and falls back to
    its jnp scan); then the same gradients again under remat="full", bit
    for bit.

    Each leaf is held within 1e-4 of its max |grad|. Where that misses,
    the port's distance from the reference's float64 gradient must be
    within DEPTH_RATIO times the reference's own f32 distance from it. At
    this random init the 8-layer block is ill-conditioned (each Mamba
    layer amplifies a relative perturbation of its input 2-6x), so f32
    rounding alone moves the early layers' gradients: the reference's f32
    gradients lie up to ~1.9e-4 of a leaf's max from its f64 ones, and
    the port's f32 ones up to ~1.5e-4 from the reference's (``layers/1``'s
    ``b_norm`` and ``c_norm`` on the jnp routes). In float64 the two agree
    to ~7e-13 (test_decoder_loss_gradients_match_reference_in_float64), so
    the port computes the reference's function. A wrong gradient moves a
    leaf by O(1) of its max."""
    tokens, jl, jg = _reference_grads(S, use_pallas)
    _, _, jg64 = _reference_grads(S, x64=True)
    m, params = _port_model_and_params()
    assert [s.mixer for s in m.layer_specs].count("mamba") == 7
    tokens = torch.from_numpy(tokens)
    reset_counts()
    loss, paths, grads = _flat_grads(m, params, tokens)
    assert PLAIN_CALLS["ssm_scan_bwd"] == 7 and BWD_CALLS["flash_attention_bwd"] == 1
    assert PLAIN_CALLS["ssm_scan"] == 7 and PLAIN_CALLS["flash_attention"] == 1
    assert sum(LAUNCHES.values()) == 0
    assert abs(loss - jl) <= TOL * (1 + abs(jl))
    for path, g in zip(paths, grads):
        ref, exact = _ref_leaf(jg, path, m.block_size), _ref_leaf(jg64, path, m.block_size)
        assert g.shape == ref.shape, path
        g = g.float().numpy()
        if np.abs(g - ref).max() > 1e-4 * np.abs(ref).max():
            assert np.abs(g - exact).max() <= DEPTH_RATIO * np.abs(ref - exact).max(), path
    m_remat = build_model(m.cfg.replace(remat="full"))
    reset_counts()
    loss_r, _, grads_r = _flat_grads(m_remat, params, tokens)
    assert PLAIN_CALLS["ssm_scan"] == 14 and PLAIN_CALLS["ssm_scan_bwd"] == 7
    assert loss_r == loss
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


@pytest.mark.parametrize("S", [128, 100])
def test_decoder_loss_gradients_match_reference_in_float64(S, monkeypatch):
    """The same loss and gradients with both sides in float64 (the
    reference on its jnp route, see ``_reference_grads``; the port with
    ``Tensor.float`` and its model's compute dtype pointed at float64, as
    its model casts to f32 by that call): the loss within 5e-4 and every
    leaf within 1e-4 of its max |grad|, the f32 test's tolerances, with no
    rounding floor to hide a wrong gradient (measured: ~7e-13)."""
    tokens, jl, jg = _reference_grads(S, x64=True)
    m, params = _port_model_and_params(torch.float64)
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setattr(decoder_module, "torch_dtype", lambda name: torch.float64)
        loss, paths, grads = _flat_grads(m, params, torch.from_numpy(tokens))
    assert abs(loss - jl) <= TOL * (1 + abs(jl))
    for path, g in zip(paths, grads):
        ref = _ref_leaf(jg, path, m.block_size)
        assert g.dtype == torch.float64 and g.shape == ref.shape, path
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), path


def test_mamba_train_gradients_match_reference():
    """One Mamba layer's ``mamba_train`` and its input and weight gradients
    against the reference's, from a zero state."""
    jcfg = j_smoke(ARCH).replace(**BLOCK)
    jp = JM.init_mamba(jax.random.PRNGKey(7), jcfg, jnp.float32)
    rng = np.random.default_rng(8)
    for name in ("conv_b", "dt_bias", "D", "dt_norm", "b_norm", "c_norm"):
        jp[name] = jnp.asarray(rng.uniform(0.5, 1.5, jp[name].shape), jnp.float32)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda p, x: JM.mamba_train(p, x, jcfg), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    from repro_torch.models import mamba as M

    tp = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    tx = _t(x).requires_grad_(True)
    reset_counts()
    y = M.mamba_train(tp, tx, smoke_config(ARCH).replace(**BLOCK))
    names = sorted(tp)
    grads = torch.autograd.grad(y, [tx] + [tp[k] for k in names], _t(dy))
    assert PLAIN_CALLS["ssm_scan_bwd"] == 1
    _close(y.detach(), jy, TOL)
    for g, ref in zip(grads, [jgx] + [jgp[k] for k in names]):
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


# -------------------------------------------------------------- train step


@pytest.mark.parametrize("moments", ["int8", "float32"])
def test_train_step_losses_match_reference(moments):
    """Three steps with two microbatches and the config's bf16 gradient
    accumulation, from the same params and batches, with the config's int8
    AdamW moments and with f32 ones; losses within 5e-4 (see
    tests/test_torch_train.py: after step 1 a last-bit difference in a
    near-zero gradient moves a parameter by 2 lr, so parameters are not
    compared).

    With int8 moments the third loss is held only to be finite. The
    second update loads the quantized moments, and an entry whose v
    rounded to 0 in its row while its m did not moves by lr * m / eps:
    the reference's own step moves 6,942 entries by more than 0.01 (the
    largest by 86), and which entries depends on last-bit rounding. So the
    third loss is chaotic: the reference jitted and eager differs by 1.7e-2
    (34x the tolerance), and half an f32 ulp on the weights moves the
    port's by up to 0.25. The update itself is held to the reference's
    bit for bit in tests/test_torch_optim.py."""
    jcfg = j_smoke(ARCH).replace(num_microbatches=2, **BLOCK)
    cfg = smoke_config(ARCH).replace(num_microbatches=2, **BLOCK)
    assert cfg.grad_acc_dtype == "bfloat16" and cfg.opt_moments_dtype == "int8"
    jm = j_build(jcfg)
    jp = _reference_params()
    jopt = JAdamW(lr=j_constant(1e-3), moments_dtype=moments)
    jstep = jax.jit(j_make_train_step(jm, jopt))
    jstate = jopt.init_state(jp)
    opt = AdamW(lr=constant_schedule(1e-3), moments_dtype=moments)
    state = opt.init_state(params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                           device="cpu"))
    step = make_train_step(build_model(cfg), opt)
    data = JBatches(jcfg, 4, 32, seed=3)
    for i in range(3):
        batch = data.batch(i)
        jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        state, metrics = step(state, batch)
        assert state["step"] == i + 1
        for name in ("loss", "ce", "aux"):
            got, want = float(metrics[name]), float(jmetrics[name])
            if moments == "int8" and i == 2:
                assert np.isfinite(got), (i, name)
            else:
                assert abs(got - want) <= TOL * (1 + abs(want)), (i, name)


def _straightforward_step(model, opt, M):
    """The train step written plainly: every gradient of a microbatch at
    once from ``torch.autograd.grad``, added to the buffers, an f32 copy of
    every gradient divided by M, and a whole-leaf AdamW update."""
    acc_dt = torch_dtype(model.cfg.grad_acc_dtype)

    def update(grads, opt_state, params, step):
        count = np.float32(step) + np.float32(1)
        lr = opt.lr(step)
        c1 = float(np.float32(1) - np.float32(opt.b1) ** count)
        c2 = float(np.float32(1) - np.float32(opt.b2) ** count)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        for (path, p), g in zip(leaves_with_paths(params), grads):
            m, v = get(opt_state["m"], path), get(opt_state["v"], path)
            gf = g.float() * clip
            mf = opt.b1 * dequantize_int8(m["q"], m["s"]) + (1 - opt.b1) * gf
            vf = opt.b2 * dequantize_int8(v["q"], v["s"]) + (1 - opt.b2) * torch.square(gf)
            upd = (mf / c1) / (torch.sqrt(vf / c2) + opt.eps)
            if adamw_module.decays(path, p):
                upd = upd + opt.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
            for mom, val in ((m, mf), (v, vf)):
                q, s = quantize_int8(val)
                mom["q"].copy_(q)
                mom["s"].copy_(s)

    def step(state, batch):
        params = state["params"]
        flat = leaves(params)
        tokens = torch.as_tensor(batch["tokens"])
        gacc = [torch.zeros(p.shape, dtype=acc_dt) for p in flat]
        for mb in tokens.reshape((M, tokens.shape[0] // M) + tokens.shape[1:]):
            live = [p.detach().requires_grad_(True) for p in flat]
            loss, _ = model.loss(unflatten(params, live), {"tokens": mb})
            for a, g in zip(gacc, torch.autograd.grad(loss, live)):
                a.add_(g.to(acc_dt))
        with torch.no_grad():
            update([a.float().div_(M) for a in gacc], state["opt"], params,
                   state["step"])
        return {"params": params, "opt": state["opt"], "step": state["step"] + 1}

    return step


def test_train_step_equals_straightforward_step_bitwise(monkeypatch):
    """Two steps of the train step (gradients accumulated by hooks as
    autograd produces them, cast and divided by M inside AdamW, large
    leaves updated in row slices; slices made small here so every matrix
    is cut) give params and int8 moments bitwise equal to the
    straightforward step's."""
    monkeypatch.setattr(adamw_module, "SLICE_ELEMENTS", 1000)
    cfg = smoke_config(ARCH).replace(num_microbatches=2, **BLOCK)
    jp = jax.tree.map(np.asarray, _reference_params())
    opt = AdamW(lr=constant_schedule(1e-3), moments_dtype="int8")
    model = build_model(cfg)
    states = [opt.init_state(params_from_jax(jp, cfg, device="cpu")) for _ in range(2)]
    steps = [make_train_step(model, opt), _straightforward_step(model, opt, 2)]
    data = SyntheticBatches(cfg, 4, 32, seed=4)
    for i in range(2):
        states[0], _ = steps[0](states[0], data.batch(i))
        states[1] = steps[1](states[1], data.batch(i))
    for part in ("params", "opt"):
        a, b = leaves(states[0][part]), leaves(states[1][part])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), part


# ----------------------------------------------------------------- elastic


def test_elastic_trainer_runs_jamba_with_revocation_deterministically(tmp_path):
    """The jamba block through ``ElasticTrainer`` on one CPU device: 4 steps
    with a revocation before step 2 (checkpoint, release, restore), losses
    finite and bitwise equal to an uninterrupted run's."""
    cfg = smoke_config(ARCH).replace(num_microbatches=2, **BLOCK)

    def trainer(sub):
        return ElasticTrainer(build_model(cfg),
                              AdamW(lr=constant_schedule(3e-3), moments_dtype="int8"),
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


def test_launch_train_refuses_jamba_with_experts(tmp_path):
    """The published jamba config has MoE layers, and the training
    launcher trains its smoke config with them: one step, a checkpoint."""
    train_main(["--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "ck")])
    assert (tmp_path / "ck" / "step_00000000").is_dir()
