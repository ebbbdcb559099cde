"""Port training path against the reference on the CPU: the plain WKV
backward against the reference's Pallas backward (interpret mode) and
``jax.vjp`` of its oracle (atol = rtol = 1e-4, the reference's backward
tolerance in tests/test_kernels.py); the autograd op (``gradcheck`` in
float64, and against autograd through the plain forward); gradients of
``DecoderLM.loss`` on the rwkv6-3b smoke config, and on the starcoder2-3b
one (attention), against ``jax.grad`` of the reference's (loss within 5e-4,
each leaf within 1e-4 of its max |grad|);
three train steps against the reference's ``make_train_step``; and the
one-device ``ElasticTrainer`` and ``launch.train``.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import SyntheticBatches as JBatches  # noqa: E402
from repro.kernels.rwkv6_scan.kernel import (  # noqa: E402
    rwkv6_scan_bwd as j_bwd_kernel, rwkv6_scan_fwd as j_fwd_kernel)
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_scan_ref  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.schedule import constant_schedule as j_constant  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticBatches  # noqa: E402
from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    CHECKPOINT, rwkv6_scan_bwd_ref, rwkv6_scan_ref)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.schedule import constant_schedule  # noqa: E402
from repro_torch.runtime.elastic import ElasticTrainer  # noqa: E402
from repro_torch.tree import leaves_with_paths, unflatten  # noqa: E402

ARCH = "rwkv6-3b"
BWD_TOL = 1e-4
TOL = 5e-4
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Run this module's torch ops on one thread, as tests/test_torch_mamba.py
    does: with other test processes on every core, torch's intra-op pool
    waits at each small eager op for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def _bwd_inputs(B, H, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(size=(B, H, S, hd)).astype(np.float32) for _ in range(4))
    w = rng.uniform(0.2, 0.999, size=(B, H, S, hd)).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    dsT = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0, dy, dsT


# ------------------------------------------------------- scan backward (B7)


@pytest.mark.parametrize("S", [64, 128])
def test_plain_bwd_matches_pallas_bwd_and_states(S):
    """The plain backward fed the JAX forward's ``save_states`` (at the
    port's checkpoint interval) against the Pallas backward in interpret
    mode, and the plain forward's chunk-start states against those."""
    r, k, v, w, u, s0, dy, dsT = _bwd_inputs(2, 3, S, 32, seed=S)
    j = tuple(map(jnp.asarray, (r, k, v, w, u, s0)))
    _, _, j_starts = j_fwd_kernel(*j, chunk=CHECKPOINT, interpret=True,
                                  save_states=True)
    j_out = j_bwd_kernel(*j[:4], jnp.asarray(dy), j[4], j_starts, jnp.asarray(dsT),
                         chunk=CHECKPOINT, interpret=True)
    reset_counts()
    _, _, starts = rwkv6_scan_ref(*map(_t, (r, k, v, w, u, s0)), save_states=True)
    _close(starts, j_starts, BWD_TOL)
    out = rwkv6_scan_bwd_ref(*map(_t, (r, k, v, w, dy, u)), _t(j_starts), _t(dsT))
    assert PLAIN_CALLS["rwkv6_scan_bwd"] == 1 and LAUNCHES["rwkv6_scan_bwd"] == 0
    for a, b in zip(out, j_out):
        assert tuple(a.shape) == b.shape
        _close(a, b, BWD_TOL)


@pytest.mark.parametrize("S", [64, 37, 1], ids=["tiled", "ragged37", "one"])
def test_plain_bwd_matches_jax_vjp(S):
    """Any S (the last checkpoint chunk ragged), nonzero s0 and dsT, against
    ``jax.vjp`` of the reference's jnp oracle; du summed over the chunks."""
    r, k, v, w, u, s0, dy, dsT = _bwd_inputs(2, 3, S, 32, seed=S + 1)
    _, vjp = jax.vjp(j_scan_ref, *map(jnp.asarray, (r, k, v, w, u, s0)))
    j_grads = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
    _, _, starts = rwkv6_scan_ref(*map(_t, (r, k, v, w, u, s0)), save_states=True)
    dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd_ref(*map(_t, (r, k, v, w, dy, u)),
                                                 starts, _t(dsT))
    assert du.shape == (2, 3, -(-S // CHECKPOINT), 32)
    for a, b in zip((dr, dk, dv, dw, du.sum(dim=(0, 2)), ds0), j_grads):
        _close(a, b, BWD_TOL)


def test_op_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    B, H, S, hd = 1, 2, 11, 4  # two checkpoint chunks, the second ragged

    def rand(*shape, lo=None):
        if lo is None:
            return torch.randn(*shape, generator=g, dtype=torch.float64)
        return lo + 0.7 * torch.rand(*shape, generator=g, dtype=torch.float64)

    args = [rand(B, H, S, hd), rand(B, H, S, hd), rand(B, H, S, hd),
            rand(B, H, S, hd, lo=0.2), rand(H, hd), rand(B, H, hd, hd)]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(lambda *a: rwkv6_scan(*a), args)


@pytest.mark.parametrize("S", [37, 130])
def test_op_gradients_equal_autograd_through_plain(S):
    r, k, v, w, u, s0, dy, dsT = _bwd_inputs(2, 3, S, 32, seed=S + 2)
    grads = []
    for impl in ("kernel", "ref"):
        leaves = [_t(a).requires_grad_(True) for a in (r, k, v, w, u, s0)]
        reset_counts()
        y, sT = (rwkv6_scan if impl == "kernel" else rwkv6_scan_ref)(*leaves)
        grads.append(torch.autograd.grad((y * _t(dy)).sum() + (sT * _t(dsT)).sum(),
                                         leaves))
        assert PLAIN_CALLS["rwkv6_scan_bwd"] == (impl == "kernel")
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_TOL, rtol=BWD_TOL)


def test_op_refuses_state_out_under_grad_and_other_devices():
    r, k, v, w, u, s0, _, _ = map(_t, _bwd_inputs(1, 2, 5, 32))
    with pytest.raises(ValueError, match="state_out"):
        rwkv6_scan(r.requires_grad_(True), k, v, w, u, s0, state_out=s0)
    with torch.no_grad():  # serving: no gradient, the in-place write is fine
        rwkv6_scan(r, k, v, w, u, s0, state_out=s0.clone())
    # a meta tensor (a traced step) takes the plain version's outputs, under
    # autograd too; its in-place write is refused there as anywhere
    m = torch.zeros(1, 2, 4, 32, device="meta", requires_grad=True)
    um, sm = torch.zeros(2, 32, device="meta"), torch.zeros(1, 2, 32, 32, device="meta")
    y, sT = rwkv6_scan(m, m, m, m, um, sm)
    assert y.is_meta and y.shape == m.shape and y.requires_grad and sT.shape == sm.shape
    with pytest.raises(ValueError, match="state_out"):
        rwkv6_scan(m, m, m, m, um, sm, state_out=sm)


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


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_decoder_loss_gradients_match_reference(use_pallas):
    """Loss and every gradient leaf of ``DecoderLM.loss`` against
    ``jax.grad`` of the reference's, from the same weights and batch
    (S=64 takes the reference's Pallas path when ``use_pallas``); then the
    same gradients again under remat="full", bit for bit."""
    jcfg = j_smoke(ARCH).replace(use_pallas=use_pallas)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = JBatches(jcfg, 2, 64, seed=0).batch(0)["tokens"]
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tokens)})
    cfg = smoke_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    m = build_model(cfg)
    reset_counts()
    loss, paths, grads = _flat_grads(m, params, torch.from_numpy(tokens))
    assert PLAIN_CALLS["rwkv6_scan_bwd"] == cfg.num_layers
    assert abs(loss - float(jl)) <= TOL * (1 + abs(float(jl)))
    jg = jax.tree.map(np.asarray, jg)
    for path, g in zip(paths, grads):
        ref = _ref_leaf(jg, path, m.block_size)
        assert g.shape == ref.shape, path
        scale = np.abs(ref).max()
        assert np.abs(g.float().numpy() - ref).max() <= 1e-4 * scale, path
    m_remat = build_model(cfg.replace(remat="full"))
    loss_r, _, grads_r = _flat_grads(m_remat, params, torch.from_numpy(tokens))
    assert loss_r == loss
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def test_train_mode_refuses_attention_and_dots_remat():
    """Attention layers train: loss and every gradient leaf of the
    starcoder2-3b smoke config (sliding-window attention, rotary positions,
    biases) against ``jax.grad`` of the reference's, on the reference's jnp
    route, within 5e-4 and 1e-4 of each leaf's max; the port's attention
    runs the flash op and its recomputing backward. remat="dots" (keep the
    matmuls' outputs, recompute the rest) gives the same loss and
    gradients bit for bit."""
    jcfg = j_smoke("starcoder2-3b")
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tokens = JBatches(jcfg, 2, 64, seed=1).batch(0)["tokens"]
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(tokens)})
    cfg = smoke_config("starcoder2-3b")
    assert cfg.window_size and cfg.window_size < 64
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    m = build_model(cfg)
    reset_counts()
    loss, paths, grads = _flat_grads(m, params, torch.from_numpy(tokens))
    assert BWD_CALLS["flash_attention_bwd"] == cfg.num_layers
    assert abs(loss - float(jl)) <= TOL * (1 + abs(float(jl)))
    jg = jax.tree.map(np.asarray, jg)
    for path, g in zip(paths, grads):
        ref = _ref_leaf(jg, path, m.block_size)
        assert g.shape == ref.shape, path
        assert np.abs(g.float().numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), path
    reset_counts()
    loss_d, _, grads_d = _flat_grads(build_model(cfg.replace(remat="dots")), params,
                                     torch.from_numpy(tokens))
    assert BWD_CALLS["flash_attention_bwd"] == cfg.num_layers
    assert PLAIN_CALLS["flash_attention"] == 2 * cfg.num_layers  # forward, recompute
    assert loss_d == loss
    assert all(torch.equal(a, b) for a, b in zip(grads_d, grads))


# -------------------------------------------------------------- train step


def test_train_step_losses_match_reference():
    """Three steps with two microbatches from the same params and batches.
    Losses only: after step 1 AdamW moves each parameter by about
    lr * sign(g), so a last-bit difference in a near-zero gradient moves a
    parameter by 2 lr; tests/test_torch_optim.py holds the update itself."""
    jcfg = j_smoke(ARCH).replace(num_microbatches=2)
    cfg = smoke_config(ARCH).replace(num_microbatches=2)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    jopt = JAdamW(lr=j_constant(1e-3))
    jstep = jax.jit(j_make_train_step(jm, jopt))
    jstate = jopt.init_state(jp)
    opt = AdamW(lr=constant_schedule(1e-3))
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
            assert abs(float(metrics[name]) - float(jmetrics[name])) <= TOL * (
                1 + abs(float(jmetrics[name]))), (i, name)


# ----------------------------------------------------------------- elastic


def _trainer(tmp_path, **kw):
    cfg = smoke_config(ARCH).replace(num_microbatches=2)
    return ElasticTrainer(build_model(cfg), AdamW(lr=constant_schedule(3e-3)),
                          SyntheticBatches(cfg, global_batch=8, seq_len=32, seed=0),
                          Checkpointer(tmp_path, keep=2), devices=["cpu"], **kw)


def test_elastic_trainer_preempt_resume_and_determinism(tmp_path):
    """As the reference's trainer test, on one CPU device: 16 steps, a
    revocation at step 8 (checkpoint, release, restore), checkpoints every 5;
    a resume continues at [16, 17]; and the preempted run's losses equal an
    uninterrupted run's bit for bit."""
    tr = _trainer(tmp_path / "a")
    tr.run(16, preempt_at={8: 1}, checkpoint_every=5)
    assert tr.rescales == 1
    losses = [h[1] for h in tr.history]
    assert [h[0] for h in tr.history] == list(range(16))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not list((tmp_path / "a").glob("tmp.*"))
    tr2 = _trainer(tmp_path / "a")
    tr2.run(18, checkpoint_every=0)
    assert [h[0] for h in tr2.history] == [16, 17]
    assert all(np.isfinite(h[1]) for h in tr2.history)
    tr3 = _trainer(tmp_path / "b")
    tr3.run(16, checkpoint_every=0)
    assert [h[1] for h in tr3.history] == losses


def test_elastic_trainer_refuses_meshes(tmp_path):
    """Without a process group the trainer is the one-device one: model
    parallelism, several devices and a revocation to several devices need a
    mesh, which trains once ``torch.distributed`` is initialised
    (tests/test_torch_mesh.py)."""
    with pytest.raises(ValueError, match="needs a mesh"):
        _trainer(tmp_path, model_par=2)
    with pytest.raises(ValueError, match="need a mesh"):
        ElasticTrainer(None, None, None, None, devices=["cpu", "cpu"])
    tr = _trainer(tmp_path)
    with pytest.raises(ValueError, match="needs a mesh"):
        tr.run(3, preempt_at={1: 2}, checkpoint_every=0)


def test_elastic_trainer_runs_back_to_back_revocations(tmp_path):
    """On one card every notice is a revocation of the card in use: a second
    one a step after the first still moves the run, and the losses equal an
    uninterrupted run's."""
    tr = _trainer(tmp_path / "a")
    tr.run(6, preempt_at={1: 1, 2: 1}, checkpoint_every=0)
    assert tr.rescales == 2
    assert [h[0] for h in tr.history] == list(range(6))
    ref = _trainer(tmp_path / "b")
    ref.run(6, checkpoint_every=0)
    assert [h[1] for h in tr.history] == [h[1] for h in ref.history]


def test_launch_train_smoke_runs_and_default_device_needs_a_card(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
           "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step     2 loss" in out.stdout
    assert (tmp_path / "ck" / "step_00000002").is_dir()
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
