"""Port training substrate against the reference on the CPU: AdamW (f32 and
int8 moments, with and without error feedback) fed the same gradients as
the reference's, within 1e-6 relative (int8 ``q`` equal); the weight-decay
rule on the reference's stacked layout; the schedules; error-feedback
compression; ``opt_state_from_jax``; the copied ``SyntheticBatches``
(byte-equal batches) and straggler watchdog; and the checkpointer
(bitwise round trip, atomic commit, retention, async errors).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import SyntheticBatches as JBatches  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.compress import error_feedback_compress as j_ef  # noqa: E402
from repro.optim.schedule import (constant_schedule as j_constant,  # noqa: E402
                                  cosine_schedule as j_cosine)
from repro.runtime.straggler import StragglerWatchdog as JWatchdog  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import checkpointer as ckmod  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.data import SyntheticBatches  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.compress import error_feedback_compress, init_residual  # noqa: E402
from repro_torch.optim.schedule import constant_schedule, cosine_schedule  # noqa: E402
from repro_torch.runtime.straggler import StragglerWatchdog  # noqa: E402
from repro_torch.tree import key, leaves_with_paths  # noqa: E402

ARCH = "rwkv6-3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_setup(seed=0):
    jcfg, cfg = j_smoke(ARCH), smoke_config(ARCH)
    jp = j_build(jcfg).init(jax.random.PRNGKey(seed))
    return cfg, jp


def _grads(jp, rng, scale):
    return jax.tree.map(lambda p: jnp.asarray(
        (scale * rng.normal(size=p.shape)).astype(np.float32), p.dtype), jp)


def _assert_tree_close(port, ref, rtol):
    """Same paths, shapes and dtypes; int8 leaves equal, the rest within
    ``rtol`` of each leaf's max |value|."""
    got = {key(p): t for p, t in leaves_with_paths(port)}
    want = {key(p): t for p, t in leaves_with_paths(ref)}
    assert sorted(got) == sorted(want)
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.int8:
            assert torch.equal(a, b), name
        else:
            scale = max(b.abs().max().item(), 1e-30)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("error_feedback", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_updates_match_reference(moments, error_feedback):
    """Three updates from the same params with the same gradients. For f32
    moments the second is clipped by the global norm. The int8 cases stay
    under the clip: the port sums the norm per layer and the reference per
    stacked leaf, so a clipped gradient differs in its last bit, and a
    moment on a rounding tie of ``quantize_int8`` may then round the other
    way; unclipped, the clip factor is exactly 1 and ``q`` is equal."""
    cfg, jp = _ref_setup()
    kw = dict(moments_dtype=moments, error_feedback=error_feedback)
    jopt = JAdamW(lr=j_constant(1e-2), **kw)
    opt = AdamW(lr=constant_schedule(1e-2), **kw)
    jstate = jopt.init_state(jp)
    params = params_from_jax(_np(jp), cfg, device="cpu")
    ostate = opt_state_from_jax(_np(jstate["opt"]), cfg, device="cpu")
    rng = np.random.default_rng(0)
    jparams, jopt_state = jp, jstate["opt"]
    scales = (1e-4, 1.0, 3e-4) if moments == "float32" else (1e-4, 1e-3, 3e-4)
    for step, scale in enumerate(scales):
        jg = _grads(jp, rng, scale)
        gnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for g in jax.tree.leaves(jg)))
        assert (gnorm > 1.0) == (scale == 1.0)
        jparams, jopt_state = jopt.update(jg, jopt_state, jparams, jnp.int32(step))
        out_p, out_o = opt.update(params_from_jax(_np(jg), cfg, device="cpu"),
                                  ostate, params, step)
        assert out_p is params and out_o is ostate  # updated in place
        _assert_tree_close(params, params_from_jax(_np(jparams), cfg, device="cpu"), 1e-6)
        _assert_tree_close(ostate, opt_state_from_jax(_np(jopt_state), cfg,
                                                      device="cpu"), 1e-6)


def test_adamw_decays_layer_vectors_like_the_stacked_reference():
    """The reference stacks layer leaves over blocks and decays every leaf
    with ndim >= 2 there: a per-layer 1-D leaf (a norm scale, ``ln_x``) is
    decayed, a top-level one (``ln0``, ``final_norm``) is not. With zero
    gradients the update is the decay alone."""
    cfg, jp = _ref_setup(1)
    jp = jax.tree.map(lambda p: p + 0.5, jp)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jopt, opt = JAdamW(lr=j_constant(0.1)), AdamW(lr=constant_schedule(0.1))
    jnew, _ = jopt.update(zeros, jopt.init(jp), jp, jnp.int32(0))
    params = params_from_jax(_np(jp), cfg, device="cpu")
    before = {key(p): t.clone() for p, t in leaves_with_paths(params)}
    opt.update(params_from_jax(_np(zeros), cfg, device="cpu"), opt.init(params),
               params, 0)
    _assert_tree_close(params, params_from_jax(_np(jnew), cfg, device="cpu"), 1e-6)
    after = {key(p): t for p, t in leaves_with_paths(params)}
    for name in ("layers/0/norm1/scale", "layers/1/tm/ln_x", "layers/0/tm/maa_x"):
        assert after[name].ndim == 1
        torch.testing.assert_close(after[name], before[name] * (1 - 0.1 * 0.1))
    for name in ("ln0/scale", "final_norm/scale", "final_norm/bias"):
        assert torch.equal(after[name], before[name])


def test_schedules_equal_reference():
    """The same f32 arithmetic. numpy's and XLA's f32 cosines may differ in
    the last bit, which ``1 + cos`` near the end of the decay magnifies to
    a few ulps, so the cosine branch is held to 1e-6 relative (the AdamW
    tolerance); warmup is exact."""
    j_cos, cos = j_cosine(1e-3, 20, 40), cosine_schedule(1e-3, 20, 40)
    for step in range(46):
        want = float(j_cos(jnp.int32(step)))
        if step <= 20:  # warmup (and its end) is exact
            assert cos(step) == want, step
        assert abs(cos(step) - want) <= 1e-6 * want, step
    assert cos(0) == 0.0
    assert constant_schedule(3e-3)(7) == float(j_constant(3e-3)(jnp.int32(7)))


def test_error_feedback_compress_equals_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(4, 8)).astype(np.float32),
         "b": [rng.normal(size=(16,)).astype(np.float32)]}
    r = {"a": 0.01 * rng.normal(size=(4, 8)).astype(np.float32),
         "b": [np.zeros((16,), np.float32)]}
    jd, jr = j_ef(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    d, nr = error_feedback_compress(t(g), t(r))
    for (_, a), (_, b) in zip(leaves_with_paths(d), leaves_with_paths(_np(jd))):
        np.testing.assert_array_equal(a.numpy(), b)
    for (_, a), (_, b) in zip(leaves_with_paths(nr), leaves_with_paths(_np(jr))):
        np.testing.assert_array_equal(a.numpy(), b)
    z = init_residual(t(g))
    assert z["b"][0].dtype == torch.float32 and not z["a"].any()


@pytest.mark.parametrize("error_feedback", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_opt_state_from_jax_matches_port_init(moments, error_feedback):
    """The reference's ``AdamW.init_state`` carried over equals the port's
    own ``init_state`` of the carried params: per-layer layout, int8
    ``{"q", "s"}`` with one (..., 1) scale per layer, ``ef`` residuals."""
    cfg, jp = _ref_setup()
    kw = dict(moments_dtype=moments, error_feedback=error_feedback)
    jstate = JAdamW(lr=j_constant(1e-3), **kw).init_state(jp)
    state = AdamW(lr=constant_schedule(1e-3), **kw).init_state(
        params_from_jax(_np(jp), cfg, device="cpu"))
    assert state["step"] == int(jstate["step"]) == 0
    carried = opt_state_from_jax(_np(jstate["opt"]), cfg, device="cpu")
    assert set(carried) == set(state["opt"]) == ({"m", "v", "ef"} if error_feedback
                                                 else {"m", "v"})
    _assert_tree_close(carried, state["opt"], 0.0)
    if moments == "int8":
        s = carried["m"]["layers"][1]["norm1"]["scale"]["s"]
        assert s.shape == (1,)


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("family", ["ssm", "audio", "vlm"])
def test_synthetic_batches_byte_equal_reference(family):
    jcfg = j_smoke(ARCH).replace(family=family, prefix_len=8 if family == "vlm" else 0)
    cfg = smoke_config(ARCH).replace(family=family, prefix_len=jcfg.prefix_len)
    for host_id in (0, 1):
        jb = JBatches(jcfg, 8, 32, seed=5, host_id=host_id, host_count=2)
        b = SyntheticBatches(cfg, 8, 32, seed=5, host_id=host_id, host_count=2)
        for i in (0, 3, 11):
            got, want = b.batch(i), jb.batch(i)
            assert sorted(got) == sorted(want)
            for name in want:
                assert got[name].dtype == want[name].dtype
                assert got[name].tobytes() == want[name].tobytes()
    it = SyntheticBatches(cfg, 4, 16, seed=1).iterate(start=2, prefetch=2)
    first = next(it)
    assert first["tokens" if family != "audio" else "labels"].tobytes() == \
        JBatches(jcfg, 4, 16, seed=1).batch(2)["tokens" if family != "audio"
                                               else "labels"].tobytes()
    it.close()


def test_straggler_watchdog_copy_flags_like_reference():
    rng = np.random.default_rng(3)
    a, b = StragglerWatchdog(), JWatchdog()
    for step in range(20):
        for wid in range(4):
            t = float(rng.uniform(1, 1.2) * (3.0 if wid == 2 and step > 5 else 1.0))
            a.observe(wid, t)
            b.observe(wid, t)
        assert a.flagged() == b.flagged()
    assert a.flagged() == [2]


# -------------------------------------------------------------- checkpoints


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(4, 6, generator=g).bfloat16(),
                   "layers": [{"s": torch.randn(6, generator=g)} for _ in range(2)]},
        "opt": {"m": {"w": {"q": torch.randint(-127, 128, (4, 6), generator=g,
                                               dtype=torch.int8),
                            "s": torch.rand(4, 1, generator=g)},
                      "layers": [{"s": {"q": torch.zeros(6, dtype=torch.int8),
                                        "s": torch.ones(1)}} for _ in range(2)]}},
        "step": 7,
    }


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    ck.save(7, state, blocking=True)
    assert not list(tmp_path.glob("tmp.*")) and ck.latest_step() == 7
    meta = _state()
    meta["params"] = {"w": meta["params"]["w"].to("meta"),
                      "layers": [{"s": x["s"].to("meta")} for x in meta["params"]["layers"]]}
    want = {key(p): t for p, t in leaves_with_paths(state)}
    for template, device in ((state, None), (meta, "cpu")):
        got, step = ck.restore(template, device=device)
        assert step == 7 and got["step"] == 7
        got = {key(p): t for p, t in leaves_with_paths(got)}
        assert sorted(got) == sorted(want)
        for name, b in want.items():
            a = got[name]
            if isinstance(b, int):
                assert a == b
            else:
                assert a.dtype == b.dtype and a.device.type == "cpu"
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    bad = _state()
    bad["params"]["w"] = torch.zeros(3, 6, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params/w"):
        ck.restore(bad)


def test_checkpoint_async_copy_retention_and_errors(tmp_path, monkeypatch):
    """The host copy is taken at save time (a later in-place update does
    not reach the file); ``keep`` checkpoints stay; a writer error surfaces
    on the next ``wait()``."""
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    for step in range(4):
        ck.save(step, state)
        state["params"]["layers"][0]["s"].add_(1.0)
    ck.wait()
    assert ck.all_steps() == [2, 3]
    got, _ = ck.restore(_state(), step=2)
    want = _state()["params"]["layers"][0]["s"] + 1.0 + 1.0
    assert torch.equal(got["params"]["layers"][0]["s"], want)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckmod.np, "savez", boom)
    ck.save(9, state)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # reported once
    with pytest.raises(OSError, match="disk full"):
        ck.save(10, state, blocking=True)
    assert ck.all_steps() == [2, 3]
