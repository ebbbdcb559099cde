"""The port on a mesh: 8 gloo ranks on the CPU (``repro_torch.parallel.spawn``),
held to the reference on its 8 fake CPU devices (``tests/conftest.py``).

One 8-rank group runs every mesh case once for the module (a module-scoped
fixture; its ``FileStore`` lies under ``tmp_path``, so concurrent workers
never share a port; one torch thread per rank). It starts before the first
test and runs while the tests compute the reference's side; each test then
reads its case from the group's results. Inputs are numpy-seeded, and
weights are the reference's ``init`` converted by ``params_from_jax`` (the
``tp`` / ``tp_ffn`` cases, which are held to the port on one device, use the
port's seeded init). The cases:

  * the three ``_moe_smap`` cases of ``tests/test_moe.py`` (EP at tp 4 and
    2, ETP at E=6 over tp 4) against the reference's shard_map, at 2e-5;
  * one train step of deepseek-coder's smoke config on a (2, 4) mesh under
    ``cp_fsdp`` and under ``fsdp`` with ``flash_vjp``
    (``tests/test_perf_variants.py``): in f32 the loss within 1e-4 of the
    reference's; in float64 the loss and every param within 1e-4 of the
    port's step on one device, and of each other;
  * AdamW's int8 moments on DTensor leaves whose last dim is split (``tp``,
    two steps in float64): codes, scales and params equal the port's on one
    device;
  * the loss's embedding on each rank's own rows and sequence chunk;
  * decode over a sharded cache (``DECODE_CASES``: deepseek-coder's smoke
    config at B = 8, ``cache_len`` over "model", and B = 1, over both
    axes; gemma2's, softcap and local caches; mixtral's under
    ``decode_ws``): three steps from a fresh cache, each rank's decode op
    on its own slots with statistics merged by all-reduces, against the
    reference's jitted decode on its mesh at 3e-5 with equal greedy tokens,
    and ``decode_ws`` against the reference on one device;
  * ``tp`` train steps of jamba's smoke config with its experts (Mamba
    scans on local ``d_inner`` shards, EP dispatch) and ``tp_ffn`` steps of
    rwkv6's smoke config, two steps each in float64, losses within 1e-4 of
    the port on one device;
  * the twin of ``tests/test_runtime.py``'s elastic scenario: 8 -> 4 ranks
    mid-run, a resume on 4 and a cold restore onto 8, the same step and
    device history as the reference's and its first three losses within
    5e-4 (AdamW's first step is lr * sign(g), so f32 noise in a near-zero
    gradient moves a param by up to 2 lr);
  * the ``train_elastic`` example twin's tiny preset, its steps and
    revocation step cut through ``PRESETS``;
  * paged decode on a mesh against the same step without one;
  * the card's phase 13 (a) at smoke size: the mesh trainer on a (1, 1)
    mesh (rank 0 alone) against the trainer without a process group, bit
    for bit;
  * ``parallel.local.dense`` on the three layouts it decides between,
    against the product of whole tensors in float64;
  * ``parallel.groups.mesh_over`` over an elastic run's meshes: one group
    a rank set, None off a mesh.
"""

from __future__ import annotations

import contextlib
import math
import pickle

import numpy as np
import pytest
import torch

N_RANKS = 8
MOE_CASES = [(4, 2, 4), (4, 2, 2), (6, 2, 4)]  # (E, k, model_par)


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------- rank side


def _moe_cfg(E, k):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name="moe-test", family="moe", num_layers=2, d_model=32, num_heads=4,
        num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64, num_experts=E,
        experts_per_token=k, moe_period=1, capacity_factor=8.0,
        dtype="float32", param_dtype="float32")


def _mesh(shape):
    from repro_torch.launch.mesh import make_smoke_mesh

    return make_smoke_mesh(shape)


def _train_step(cfg, layout, mesh, state0_params, batch, opt_lr=1e-3, steps=1,
                moments="float32", with_opt=False):
    """``steps`` train steps on ``mesh`` (None: one device) from params
    ``state0_params`` (a plain tree), AdamW's moments in ``moments``.
    Returns (losses, full params), and the full optimizer state after them
    with ``with_opt``."""
    from repro_torch.launch.specs import batch_partition, batch_struct, fix_divisibility
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree, full_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings
    from repro_torch.tree import map_tree

    model = build_model(cfg)
    opt = AdamW(lr=constant_schedule(opt_lr), moments_dtype=moments)
    params = map_tree(lambda _, t: t.clone(), state0_params)
    B, S = batch["tokens"].shape
    if mesh is None:
        state = opt.init_state(params)
        step = make_train_step(model, opt)
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return (losses, state["params"]) + ((state["opt"],) if with_opt else ())
    rules = layout_rules(mesh, cfg, "train", global_batch=B, layout=layout)
    psh = to_shardings(param_specs(params, mesh, rules), mesh)
    bsh = to_shardings(fix_divisibility(batch_partition(cfg, "train", rules),
                                        batch_struct(cfg, "train", B, S), mesh), mesh)
    state = opt.init_state(distribute_tree(params, psh))
    step = make_train_step(model, opt)
    losses = []
    with use_sharding_ctx(mesh, rules):
        for _ in range(steps):
            state, m = step(state, distribute_tree(batch, bsh))
            losses.append(float(m["loss"]))
    return ((losses, full_tree(state["params"]))
            + ((full_tree(state["opt"]),) if with_opt else ()))


def _numpy(tree):
    from repro_torch.tree import map_tree

    return map_tree(lambda _, t: t.detach().numpy(), tree)


def _case_moe(inp):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models.mlp import apply_moe
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.layouts import layout_rules

    out = {}
    for (E, k, mp), (p_np, x_np) in zip(MOE_CASES, inp):
        cfg = _moe_cfg(E, k)
        mesh = _mesh((N_RANKS // mp, mp))
        rules = layout_rules(mesh, cfg, "train", global_batch=x_np.shape[0])
        rep = [Replicate()] * 2
        p = {n: distribute_tensor(torch.from_numpy(a), mesh, rep, src_data_rank=None)
             for n, a in p_np.items()}
        x = distribute_tensor(torch.from_numpy(x_np), mesh, rep, src_data_rank=None)
        with torch.no_grad(), use_sharding_ctx(mesh, rules):
            y, aux = apply_moe(p, x, cfg)
        out[(E, k, mp)] = (y.full_tensor().numpy(), float(aux.full_tensor()))
    return out


def _case_layouts(inp):
    """One train step of deepseek-coder's smoke config on a (2, 4) mesh
    under ``cp_fsdp`` and under ``fsdp`` with ``flash_vjp``: in f32 (the
    loss, for the reference) and in float64 (loss and params, for the port
    on one device). Returns {layout: (f32 loss, f64 loss, f64 params)}."""
    from repro_torch.convert import params_from_jax
    from repro_torch.tree import map_tree

    params_np, tokens = inp
    cfg = _layouts_cfg()
    params = params_from_jax(params_np, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens)}
    mesh = _mesh((2, 4))
    out = {}
    for layout, c in (("cp_fsdp", cfg), ("fsdp", cfg.replace(flash_vjp=True))):
        loss32 = _train_step(c, layout, mesh, params, batch)[0][0]
        with _float64():
            losses, full = _train_step(c, layout, mesh,
                                       map_tree(lambda _, t: t.double(), params), batch)
        out[layout] = (loss32, losses[0], _numpy(full))
    return out


def _layouts_cfg():
    from repro_torch.configs import smoke_config

    return smoke_config("deepseek-coder-33b").replace(
        num_microbatches=1, attn_chunk_q=16, attn_chunk_k=16)


# decode over a sharded cache: name -> (arch, batch, layout, config overrides).
# Under the decode rules on (2, 4) a batch of 8 shards ``cache_len`` over
# "model" (4 shards), a batch of 1 over both axes (8 shards).
DECODE_CASES = {
    "deepseek-b8": ("deepseek-coder-33b", 8, None, {}),
    "deepseek-b1": ("deepseek-coder-33b", 1, None, {}),
    "gemma2": ("gemma2-2b", 8, None, {}),  # softcap; local layers' 32-slot caches
    "decode_ws": ("mixtral-8x22b", 8, "decode_ws", dict(capacity_factor=8.0)),
}
DECODE_L = 64
# three successive steps: slots in shards 0, 1, 3 of 4 and 0, 2, 7 of 8; at
# the first every other shard holds only masked slots
DECODE_POSITIONS = (5, 21, 63)


def _decode_tokens(B):
    return np.random.default_rng(B).integers(0, 512, (len(DECODE_POSITIONS), B, 1))


def _case_decode(inp):
    """``DECODE_POSITIONS`` decode steps of each ``DECODE_CASES`` case on a
    (2, 4) mesh from a fresh cache laid out by the decode rules. Returns
    {case: (logits per step, the key length of every decode-attention
    call's local cache and whether it asked for statistics, the cache
    lengths of the attention layers, the shards of ``cache_len``, the
    collectives of each step)}."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.models.attention as attention
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import (axis_size, cache_specs, layout_rules,
                                              param_specs, to_shardings)

    out, op = {}, attention.decode_attention
    for name, (arch, B, layout, kw) in DECODE_CASES.items():
        params_np, toks = inp[name]
        cfg = smoke_config(arch).replace(**kw)
        model = build_model(cfg)
        params = params_from_jax(params_np, cfg, device="cpu")
        cache = model.init_cache(B, DECODE_L, device="cpu")
        mesh = _mesh((2, 4))
        rules = layout_rules(mesh, cfg, "decode", global_batch=B, layout=layout)
        seen, logits, comms = [], [], []

        def spy(q, k, v, bias, **opts):
            seen.append((k.shape[2], opts.get("stats", False)))
            return op(q, k, v, bias, **opts)

        attention.decode_attention = spy
        try:
            with torch.no_grad(), use_sharding_ctx(mesh, rules):
                dp = distribute_tree(params, to_shardings(param_specs(params, mesh, rules),
                                                          mesh))
                dc = distribute_tree(cache, to_shardings(
                    cache_specs(model, mesh, rules, B, DECODE_L, shapes=cache), mesh))
                for t, pos in zip(toks, DECODE_POSITIONS):
                    t = distribute_tensor(torch.from_numpy(t), mesh, [Replicate()] * 2,
                                          src_data_rank=None)
                    comm = CommDebugMode()
                    with comm:
                        lg, dc = model.decode_step(dp, dc, tokens=t, pos=pos)
                    logits.append(lg.full_tensor().numpy())
                    comms.append({str(o).split(".")[-1]: int(n)
                                  for o, n in comm.get_comm_counts().items()})
        finally:
            attention.decode_attention = op
        lens = sorted({e["k"].shape[1] for e in cache if "k" in e})
        out[name] = (logits, seen, lens, axis_size(mesh, rules.resolve("cache_len")), comms)
    return out


TP_CASES = {"jamba-1.5-large-398b": "tp", "rwkv6-3b": "tp_ffn"}


@contextlib.contextmanager
def _float64():
    """The port computing in float64 (``Tensor.float`` and the compute dtype
    pointed at float64, as ``tests/test_torch_moe_train.py`` does): f32
    gradients of jamba's 16 layers spread by ~2e-4 between any two summation
    orders, and AdamW's first step (lr * sign(g)) carries that into the
    next loss (ROADMAP Queue C); in float64 the mesh's arithmetic is held
    to one device's exactly."""
    import repro_torch.models.decoder as decoder_module

    f, td = torch.Tensor.float, decoder_module.torch_dtype
    torch.Tensor.float = torch.Tensor.double
    decoder_module.torch_dtype = lambda name: torch.float64
    try:
        yield
    finally:
        torch.Tensor.float, decoder_module.torch_dtype = f, td


def _tp_setup(arch):
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import map_tree

    cfg = smoke_config(arch).replace(num_microbatches=1)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))
    return (cfg, map_tree(lambda _, t: t.double(), params),
            {"tokens": torch.from_numpy(tokens)})


def _case_tp():
    """jamba with experts under ``tp`` and rwkv6 under ``tp_ffn``, (2, 4)
    mesh, two steps each in float64 (the port on one device runs in the
    parent)."""
    out = {}
    with _float64():
        for arch, layout in TP_CASES.items():
            cfg, params, batch = _tp_setup(arch)
            out[arch] = _train_step(cfg, layout, _mesh((2, 4)), params, batch, steps=2)[0]
    return out


INT8_ARCH = "deepseek-coder-33b"


def _case_int8():
    """deepseek-coder's smoke config under ``tp`` on a (2, 4) mesh, which
    splits the last dim of most of its weights, two steps in float64 with
    int8 AdamW moments (each row's scale the max over its shards). Returns
    (losses, full params, full optimizer state, the number of param leaves
    whose last dim is split)."""
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings
    from repro_torch.tree import leaves

    with _float64():
        cfg, params, batch = _tp_setup(INT8_ARCH)
        mesh = _mesh((2, 4))
        losses, full, opt = _train_step(cfg, "tp", mesh, params, batch, steps=2,
                                        moments="int8", with_opt=True)
    rules = layout_rules(mesh, cfg, "train", global_batch=8, layout="tp")
    split = sum(any(getattr(p, "dim", None) == len(t.shape) - 1 for p in sh.placements)
                for sh, t in zip(leaves(to_shardings(param_specs(params, mesh, rules), mesh)),
                                 leaves(params)))
    return losses, _numpy(full), _numpy(opt), split


def _case_embed_rows():
    """The tokens each rank's embedding receives in a loss on a (2, 4)
    mesh under ``cp_fsdp``: its own rows and sequence chunk, not the whole
    batch. Returns (DTensor or not, local shape) per call."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.specs import batch_partition, batch_struct, fix_divisibility
    from repro_torch.models import build_model
    from repro_torch.models.decoder import DecoderLM
    from repro_torch.parallel import is_dtensor, use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings

    cfg = smoke_config("deepseek-coder-33b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 64)))
    mesh = _mesh((2, 4))
    rules = layout_rules(mesh, cfg, "train", global_batch=8, layout="cp_fsdp")
    bsh = to_shardings(fix_divisibility(batch_partition(cfg, "train", rules),
                                        batch_struct(cfg, "train", 8, 64), mesh), mesh)
    seen, embed_in = [], DecoderLM._embed_in

    def spy(self, p, toks=None, *a, **kw):
        seen.append((is_dtensor(toks),
                     tuple((toks.to_local() if is_dtensor(toks) else toks).shape)))
        return embed_in(self, p, toks, *a, **kw)

    DecoderLM._embed_in = spy
    try:
        with torch.no_grad(), use_sharding_ctx(mesh, rules):
            dp = distribute_tree(params, to_shardings(param_specs(params, mesh, rules), mesh))
            model.loss(dp, distribute_tree({"tokens": tokens}, bsh))
    finally:
        DecoderLM._embed_in = embed_in
    return seen


def _case_elastic(rank, inp, ckpt_dir):
    """The twin of ``tests/test_runtime.py``'s rescale-and-resume scenario,
    from the reference's initial weights."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.data import SyntheticBatches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.runtime.elastic import ElasticTrainer

    cfg = smoke_config("starcoder2-3b").replace(num_microbatches=2)
    model = build_model(cfg)

    class Trainer(ElasticTrainer):
        def _init_state(self, seed):  # the reference's PRNGKey(seed) weights
            params = params_from_jax(inp, cfg, device="cpu")
            return self.opt.init_state(distribute_tree(params, self.state_shardings["params"]))

    opt = AdamW(lr=constant_schedule(3e-3))
    data = SyntheticBatches(cfg, global_batch=8, seq_len=32, seed=0)
    ck = Checkpointer(ckpt_dir, keep=2)
    tr = Trainer(model, opt, data, ck, model_par=2, devices=list(range(8)))
    tr.run(16, preempt_at={8: 4}, checkpoint_every=5)
    tr2 = Trainer(model, opt, data, ck, model_par=2, devices=list(range(4)))
    tr2.run(18, checkpoint_every=0)
    tr3 = Trainer(model, opt, data, ck, model_par=2, devices=list(range(8)))
    tr3.run(20, checkpoint_every=0)
    return tr.history, tr.rescales, tr2.history, tr3.history


def _case_example(rank, ckpt_dir):
    from repro_torch.examples import train_elastic as ex

    ex.PRESETS["tiny"] = dict(ex.PRESETS["tiny"], steps=4, preempt_step=2, seq=32)
    return ex.train(rank, "tiny", ex.PRESETS["tiny"], ckpt_dir, log=lambda s: None)


def _case_paged(rank):
    """Paged decode of starcoder2's smoke config on a (2, 4) mesh (every
    rank runs the whole batch) against the step without a mesh."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings

    cfg = smoke_config("starcoder2-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    B, bs, P = 4, 8, 4
    pages = torch.arange(B * P, dtype=torch.int32).reshape(B, P)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1)))
    pos = torch.tensor([0, 3, 9, 17])
    outs = []
    for mesh in (None, _mesh((2, 4))):
        pools = model.init_paged_cache(B * P, bs, device="cpu")
        with torch.no_grad():
            if mesh is None:
                logits, _ = model.decode_step_paged(params, pools, tokens=toks,
                                                    pos_vec=pos, pages=pages)
                outs.append(logits.numpy())
                continue
            rules = layout_rules(mesh, cfg, "decode", global_batch=B)
            with use_sharding_ctx(mesh, rules):
                dp = distribute_tree(params, to_shardings(param_specs(params, mesh, rules), mesh))
                t = distribute_tensor(toks, mesh, [Replicate()] * 2, src_data_rank=None)
                logits, _ = model.decode_step_paged(dp, pools, tokens=t, pos_vec=pos,
                                                    pages=pages)
            outs.append(logits.full_tensor().numpy())
    return outs


def _one_rank_runs(mesh_rank):
    """deepseek-coder's smoke config trained 3 steps of 2 x 64 tokens under
    its ``cp_fsdp`` (2 microbatches) and under the optimized variant
    (``fsdp``, flash_vjp): on one device (``mesh_rank`` None, no process
    group) or on a (1, 1) mesh over rank ``mesh_rank`` (the card's phase 13
    at smoke size). Returns {run: (losses, launches, backward calls, plain
    calls)}; None on a rank outside the mesh."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import smoke_config
    from repro_torch.configs.optimized import OPTIMIZED
    from repro_torch.data import SyntheticBatches
    from repro_torch.kernels import BWD_CALLS, LAUNCHES, PLAIN_CALLS, reset_counts
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedule import constant_schedule
    from repro_torch.runtime.elastic import ElasticTrainer

    class NoWrites(Checkpointer):
        def save(self, step, state, *, blocking=False):
            pass

    base = smoke_config("deepseek-coder-33b")
    out = {}
    for name, cfg in (("cp_fsdp", base.replace(num_microbatches=2)),
                      ("optimized", base.replace(**OPTIMIZED["deepseek-coder-33b"]["train"]))):
        with tempfile.TemporaryDirectory() as d:
            tr = ElasticTrainer(build_model(cfg), AdamW(lr=constant_schedule(1e-4)),
                                SyntheticBatches(cfg, 2, 64, seed=0), NoWrites(d),
                                devices=[torch.device("cpu")] if mesh_rank is None
                                else [mesh_rank])
            reset_counts()
            tr.run(3, seed=0, checkpoint_every=0)
        out[name] = ([h[1] for h in tr.history], dict(LAUNCHES), dict(BWD_CALLS),
                     sum(PLAIN_CALLS.values()))
    # every rank builds each trainer's mesh; only the member trains
    return out if mesh_rank is None or tr.member else None


def _case_remat_thread():
    """A remat "full" block recomputed by a backward that runs on another
    thread (as the CUDA autograd engine's device thread does) finds the
    sharding context of its forward: its gradients equal those of a
    backward on the forward's own thread."""
    import threading

    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.parallel import use_sharding_ctx
    from repro_torch.parallel.distribute import distribute_tree
    from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings
    from repro_torch.parallel.local import mesh_ops
    from repro_torch.tree import leaves, unflatten

    cfg = smoke_config("deepseek-coder-33b").replace(remat="full")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 32)))
    mesh = _mesh((2, 4))
    rules = layout_rules(mesh, cfg, "train", global_batch=8)
    dp = distribute_tree(params, to_shardings(param_specs(params, mesh, rules), mesh))
    grads = []
    for other_thread in (False, True):
        live = [t.detach().requires_grad_(True) for t in leaves(dp)]
        with use_sharding_ctx(mesh, rules):
            loss, _ = model.loss(unflatten(dp, live), {"tokens": tokens})
        def backward():
            with mesh_ops(loss):  # the engine hands its thread the caller's flags
                loss.backward()

        if other_thread:
            th = threading.Thread(target=backward)
            th.start()
            th.join()
        else:
            backward()
        grads.append([t.grad.full_tensor() for t in live])
    return all(torch.equal(a, b) for a, b in zip(*grads)), len(grads[1])


# ``parallel.local.dense`` layouts on (2, 4): x (4, 8, 16) and w (16, 12)
# placements, one per mesh dim; "S0"/"S1"/"S2" split that dim, "R" whole
DENSE_CASES = {
    "batch and sequence split": (("S0", "S1"), ("S0", "S1")),  # cp_fsdp: w gathered
    "column parallel": (("S0", "R"), ("S0", "S1")),            # tp: the output split on f
    "row parallel": (("S0", "S2"), ("R", "S0")),               # tp: the output a partial sum
}


def _case_dense():
    """``dense`` on DTensors laid out as ``DENSE_CASES`` against ``x @ w``
    on whole tensors: the largest gaps of the output and of both gradients
    (of the sum of the output's squares), and the output's placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel.local import dense

    def pl(names):
        return [Replicate() if n == "R" else Shard(int(n[1])) for n in names]

    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.normal(size=(4, 8, 16)))
    w0 = torch.from_numpy(rng.normal(size=(16, 12)))
    xr, wr = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    (xr @ wr).square().sum().backward()
    mesh = _mesh((2, 4))
    out = {}
    for name, (xp, wp) in DENSE_CASES.items():
        x = distribute_tensor(x0, mesh, pl(xp), src_data_rank=None).requires_grad_(True)
        w = distribute_tensor(w0, mesh, pl(wp), src_data_rank=None).requires_grad_(True)
        y = dense(x, w)
        y.square().sum().backward()
        out[name] = (max(float((a.full_tensor() - b).abs().max()) for a, b in
                         ((y, x0 @ w0), (x.grad, xr.grad), (w.grad, wr.grad))),
                     [(type(p).__name__, getattr(p, "dim", None)) for p in y.placements])
    return out


def _case_groups(rank):
    """``mesh_over`` for (2, 2) over ranks 0-3, (1, 2) over 0-1, (2, 2)
    again and (2, 4) over all 8, as an elastic run asks for them: on every
    rank, per mesh, None off it, else each dim's (group name, ranks); and
    the sum of the ranks over the (1, 2) mesh's "model" dim. Gathered from
    every rank."""
    import torch.distributed as dist

    from repro_torch.parallel.groups import mesh_over

    meshes = []
    for shape in ((2, 2), (1, 2), (2, 2), (2, 4)):
        m = mesh_over("cpu", torch.arange(math.prod(shape)).reshape(shape), ("data", "model"))
        meshes.append(m)
    names = [None if m is None else [(m.get_group(d).group_name,
                                      dist.get_process_group_ranks(m.get_group(d)))
                                     for d in ("data", "model")] for m in meshes]
    total = None
    if meshes[1] is not None:
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=meshes[1].get_group("model"))
        total = float(t)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (names, total))
    return got


def _rank_cases(rank, inputs_path, ckpt_root):
    import warnings

    warnings.filterwarnings("ignore")
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    out["moe"] = _case_moe(inp["moe"])
    out["layouts"] = _case_layouts(inp["layouts"])
    out["decode"] = _case_decode(inp["decode"])
    out["paged"] = _case_paged(rank)
    out["tp"] = _case_tp()
    out["int8"] = _case_int8()
    out["embed_rows"] = _case_embed_rows()
    out["elastic"] = _case_elastic(rank, inp["elastic"], f"{ckpt_root}/elastic")
    out["example"] = _case_example(rank, f"{ckpt_root}/example")
    out["one_rank"] = _one_rank_runs(0)
    out["remat_thread"] = _case_remat_thread()
    out["dense"] = _case_dense()
    out["groups"] = _case_groups(rank)
    return out if rank == 0 else None


# ----------------------------------------------------------- parent side


def _moe_setup(E, k, seed=0, B=4, S=8):
    """``tests/test_moe.py``'s ``_setup``: the reference's config, params
    and input."""
    import jax
    import jax.numpy as jnp

    from repro.models.config import ModelConfig as JConfig
    from repro.models.mlp import init_moe

    cfg = JConfig(
        name="moe-test", family="moe", num_layers=2, d_model=32, num_heads=4,
        num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64, num_experts=E,
        experts_per_token=k, moe_period=1, capacity_factor=8.0,
        dtype="float32", param_dtype="float32")
    p = init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(B, S, 32)), jnp.float32)
    return cfg, p, x


def _j_params(arch, **kw):
    import jax

    from repro.configs import smoke_config as j_smoke
    from repro.models import build_model as j_build

    cfg = j_smoke(arch).replace(**kw)
    model = j_build(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The module's 8-rank gloo group, started on the reference's inputs."""
    pytest.importorskip("jax")
    from repro_torch.parallel.spawn import Ranks

    tmp = tmp_path_factory.mktemp("mesh")
    moe = []
    for E, k, _ in MOE_CASES:
        _, p, x = _moe_setup(E, k)
        moe.append((_np_tree(p), np.asarray(x)))
    inputs = {
        "moe": moe,
        "layouts": (_np_tree(_j_params("deepseek-coder-33b", num_microbatches=1,
                                       attn_chunk_q=16, attn_chunk_k=16)[2]),
                    np.random.default_rng(0).integers(0, 512, (8, 64))),
        "decode": {name: (_np_tree(_j_params(arch, **kw)[2]), _decode_tokens(B))
                   for name, (arch, B, _, kw) in DECODE_CASES.items()},
        "elastic": _np_tree(_j_params("starcoder2-3b", num_microbatches=2)[2]),
    }
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    group = Ranks(_rank_cases, N_RANKS, (str(path), str(tmp / "ck")),
                      store_dir=str(tmp), timeout_s=300)
    yield group
    group.close()


def _results(ranks):
    return ranks.results(timeout=900)[0]


def test_mesh_over_makes_each_rank_sets_group_once(ranks):
    """An elastic run's meshes (2, 2) -> (1, 2) -> (2, 2), then (2, 4):
    a rank off a mesh gets None; a rank set asked for again takes the group
    made the first time (on NCCL a second group over it would be a second
    communicator, under a name torch has registered); every other rank set
    has a group of its own; the (1, 2) mesh's group sums over ranks 0-1."""
    got = _results(ranks)["groups"]
    names = {}
    for r, (meshes, total) in enumerate(got):
        first, sub, again, world = meshes
        assert (first is None, sub is None, again is None, world is None) == (
            r >= 4, r >= 2, r >= 4, False)
        if r < 4:
            assert again == first
            assert first[0][1] == [r % 2, r % 2 + 2] and first[1][1] == [r // 2 * 2,
                                                                       r // 2 * 2 + 1]
        if r < 2:
            assert sub == [(sub[0][0], [r]), first[1]] and total == 1.0
        assert world[0][1] == [r % 4, r % 4 + 4] and world[1][1] == list(
            range(r // 4 * 4, r // 4 * 4 + 4))
        for mesh in meshes:
            for name, members in mesh or ():
                assert names.setdefault(name, members) == members
    assert len(set(map(tuple, names.values()))) == len(names)


def test_elastic_rescale_and_resume_matches_reference(ranks, tmp_path):
    """The reference's scenario (8 -> 4 mid-run, resume on 4, cold restore
    onto 8) on its 8 fake devices, against the port's on 8 gloo ranks."""
    import jax

    from repro.checkpoint import Checkpointer
    from repro.data import SyntheticBatches
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.optim.schedule import constant_schedule
    from repro.runtime import ElasticTrainer

    cfg, _, _ = _j_params("starcoder2-3b", num_microbatches=2)
    model = build_model(cfg)
    opt = AdamW(lr=constant_schedule(3e-3))
    data = SyntheticBatches(cfg, global_batch=8, seq_len=32, seed=0)
    ck = Checkpointer(tmp_path, keep=2)
    tr = ElasticTrainer(model, opt, data, ck, model_par=2, devices=jax.devices()[:8])
    tr.run(16, preempt_at={8: 4}, checkpoint_every=5)
    tr2 = ElasticTrainer(model, opt, data, ck, model_par=2, devices=jax.devices()[:4])
    tr2.run(18, checkpoint_every=0)
    tr3 = ElasticTrainer(model, opt, data, ck, model_par=2, devices=jax.devices()[:8])
    tr3.run(20, checkpoint_every=0)

    hist, rescales, hist2, hist3 = _results(ranks)["elastic"]
    assert rescales == tr.rescales == 1
    for mine, ref in ((hist, tr.history), (hist2, tr2.history), (hist3, tr3.history)):
        assert [(s, d) for s, _, d in mine] == [(s, d) for s, _, d in ref]
        assert all(math.isfinite(v) for _, v, _ in mine)
    assert [h[0] for h in hist2] == [16, 17] and [h[0] for h in hist3] == [18, 19]
    assert hist[-1][1] < hist[0][1]
    np.testing.assert_allclose([v for _, v, _ in hist[:3]],
                               [v for _, v, _ in tr.history[:3]], atol=5e-4, rtol=0)


def _ref_train_loss(cfg, layout, params, tokens):
    """The loss of ``tests/test_perf_variants.py``'s ``_train_once``: one
    jitted step on a (2, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.launch.specs import batch_partition, batch_struct, fix_divisibility
    from repro.launch.steps import make_train_step, train_state_specs
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.optim.schedule import constant_schedule
    from repro.parallel import use_sharding_ctx
    from repro.parallel.layouts import layout_rules, param_specs, to_shardings

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    model = build_model(cfg)
    opt = AdamW(lr=constant_schedule(1e-3))
    state0 = opt.init_state(params)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    rules = layout_rules(mesh, cfg, "train", global_batch=8, layout=layout)
    sspec = train_state_specs(param_specs(model.init_shape(), mesh, rules), opt)
    bspec = fix_divisibility(batch_partition(cfg, "train", rules),
                             batch_struct(cfg, "train", *tokens.shape), mesh)
    with mesh, use_sharding_ctx(mesh, rules):
        jitted = jax.jit(make_train_step(model, opt),
                         in_shardings=(to_shardings(sspec, mesh), to_shardings(bspec, mesh)),
                         out_shardings=(to_shardings(sspec, mesh), None))
        _, metrics = jitted(jax.device_put(state0, to_shardings(sspec, mesh)),
                            jax.device_put(batch, to_shardings(bspec, mesh)))
    return float(metrics["loss"])


def _numpy_leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


def test_fsdp_layout_equivalent_to_cp_fsdp_and_reference(ranks):
    """One step of deepseek-coder's smoke config on (2, 4) under ``cp_fsdp``
    and ``fsdp`` (flash_vjp). In f32 each loss is within 1e-4 of the
    reference's. In float64 each loss and every param after the step is
    within 1e-4 of the port's step on one device (AdamW's first step moves
    a param by lr = 1e-3 times g / (|g| + eps), so a skipped or
    sign-flipped update is off by 1e-3 or more wherever |g| > eps; in f32
    the near-zero gradients' noise moved some params by up to 2 lr, which
    float64 removes), and the two layouts agree."""
    from repro_torch.convert import params_from_jax
    from repro_torch.tree import map_tree

    cfg_j, _, params = _j_params("deepseek-coder-33b", num_microbatches=1,
                                 attn_chunk_q=16, attn_chunk_k=16)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (8, 64))
    cfg = _layouts_cfg()
    got = _results(ranks)["layouts"]
    p64 = map_tree(lambda _, t: t.double(), params_from_jax(_np_tree(params), cfg,
                                                             device="cpu"))
    batch = {"tokens": torch.from_numpy(tokens)}
    for layout, c, cj in (("cp_fsdp", cfg, cfg_j),
                          ("fsdp", cfg.replace(flash_vjp=True), cfg_j.replace(flash_vjp=True))):
        loss32, loss64, mesh_params = got[layout]
        assert abs(loss32 - _ref_train_loss(cj, layout, params, tokens)) < 1e-4
        with _float64():
            one_losses, one_params = _train_step(c, None, None, p64, batch)
        assert abs(loss64 - one_losses[0]) < 1e-4
        gap = max(float(np.abs(a - b.numpy()).max()) for a, b in
                  zip(_numpy_leaves(mesh_params), _numpy_leaves(one_params)))
        assert gap < 1e-4, (layout, gap)
    (_, l_cp, p_cp), (_, l_fs, p_fs) = got["cp_fsdp"], got["fsdp"]
    assert abs(l_cp - l_fs) < 1e-4
    assert max(float(np.abs(a - b).max()) for a, b in
               zip(_numpy_leaves(p_cp), _numpy_leaves(p_fs))) < 1e-4


@pytest.mark.parametrize("arch", list(TP_CASES))
def test_tp_layouts_train_like_one_device(ranks, arch):
    with _float64():
        cfg, params, batch = _tp_setup(arch)
        one_losses = _train_step(cfg, None, None, params, batch, steps=2)[0]
    mesh_losses = _results(ranks)["tp"][arch]
    assert len(mesh_losses) == len(one_losses) == 2
    assert all(math.isfinite(v) for v in mesh_losses)
    np.testing.assert_allclose(mesh_losses, one_losses, atol=1e-4, rtol=0)


def test_int8_moments_on_split_last_dims_train_like_one_device(ranks):
    """AdamW with int8 moments on DTensor leaves whose last dim is split
    (``tp``): each row's scale is the max over its shards, so after two
    steps in float64 the int8 moments equal those of the port on one
    device, every code and every scale, and so do the params (the second
    step reads the first step's quantized moments). A scale taken from one
    shard's part of a row alone changes thousands of codes in each split
    leaf."""
    from repro_torch.tree import leaves_with_paths

    with _float64():
        cfg, params, batch = _tp_setup(INT8_ARCH)
        one_losses, one_params, one_opt = _train_step(
            cfg, None, None, params, batch, steps=2, moments="int8", with_opt=True)
    mesh_losses, mesh_params, mesh_opt, n_split = _results(ranks)["int8"]
    assert n_split > 0
    assert len(mesh_losses) == 2 and all(math.isfinite(v) for v in mesh_losses)
    np.testing.assert_allclose(mesh_losses, one_losses, atol=1e-4, rtol=0)
    gap = max(float(np.abs(a - b.detach().numpy()).max()) for a, b in
              zip(_numpy_leaves(mesh_params), _numpy_leaves(one_params)))
    assert gap < 1e-9, gap
    one = dict(leaves_with_paths(_numpy(one_opt)))
    codes = 0
    for path, a in leaves_with_paths(mesh_opt):
        if path[-1] == "q":
            np.testing.assert_array_equal(a, one[path], err_msg=str(path))
            codes += a.size
        elif path[-1] == "s":
            np.testing.assert_allclose(a, one[path], rtol=1e-9, atol=0, err_msg=str(path))
    assert codes == 2 * sum(t.numel() for t in _numpy_leaves(params))


def test_loss_embeds_each_ranks_own_rows(ranks):
    """On a (2, 4) mesh under ``cp_fsdp`` the embedding gets each rank's
    batch rows (8 / 2 "data") and sequence chunk (64 / 4 "model"), not the
    whole (8, 64) batch."""
    assert _results(ranks)["embed_rows"] == [(True, (4, 16))]


@pytest.mark.parametrize("E,k,model_par", MOE_CASES)
def test_moe_smap_matches_reference(ranks, E, k, model_par):
    import jax
    from jax.sharding import Mesh

    from repro.models.mlp import _moe_local, apply_moe
    from repro.parallel import use_sharding_ctx
    from repro.parallel.layouts import layout_rules

    cfg, p, x = _moe_setup(E, k)
    yl, auxl = _moe_local(p, x, cfg)
    devs = jax.devices()[: (8 // model_par) * model_par]
    mesh = Mesh(np.array(devs).reshape(-1, model_par), ("data", "model"))
    rules = layout_rules(mesh, cfg, "train", global_batch=x.shape[0])
    with mesh, use_sharding_ctx(mesh, rules):
        ys, auxs = jax.jit(lambda p, x: apply_moe(p, x, cfg))(p, x)
    y, aux = _results(ranks)["moe"][(E, k, model_par)]
    np.testing.assert_allclose(y, np.asarray(ys), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(y, np.asarray(yl), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(aux, float(auxs), atol=1e-4, rtol=1e-4)


def _ref_decode_steps(name, mesh_devices):
    """The reference's ``DECODE_POSITIONS`` decode steps of a ``DECODE_CASES``
    case from a fresh cache: jitted on its (2, 4) mesh with the same cache
    specs (as ``tests/test_perf_variants.py`` does), or on one device
    (``mesh_devices`` False). Returns the logits of each step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.parallel import use_sharding_ctx
    from repro.parallel.layouts import cache_specs, layout_rules, param_specs, to_shardings

    arch, B, layout, kw = DECODE_CASES[name]
    cfg, model, params = _j_params(arch, **kw)
    cache = model.init_cache(B, DECODE_L)
    toks = [jnp.asarray(t, jnp.int32) for t in _decode_tokens(B)]
    out = []
    if not mesh_devices:
        for t, pos in zip(toks, DECODE_POSITIONS):
            logits, cache = model.decode_step(params, cache, tokens=t, pos=jnp.int32(pos))
            out.append(np.asarray(logits))
        return out
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    rules = layout_rules(mesh, cfg, "decode", global_batch=B, layout=layout)
    psh = to_shardings(param_specs(model.init_shape(), mesh, rules), mesh)
    csh = to_shardings(cache_specs(model, mesh, rules, B, DECODE_L), mesh)
    with mesh, use_sharding_ctx(mesh, rules):
        step = jax.jit(lambda p, c, t, pos: model.decode_step(p, c, tokens=t, pos=pos),
                       in_shardings=(psh, csh, None, None), out_shardings=(None, csh))
        p, cache = jax.device_put(params, psh), jax.device_put(cache, csh)
        for t, pos in zip(toks, DECODE_POSITIONS):
            logits, cache = step(p, cache, t, jnp.int32(pos))
            out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_sharded_cache_decode_matches_reference(ranks, name):
    """Decode steps over a cache whose ``cache_len`` stays sharded: each
    rank's decode kernel op gets its own slots only (no gather of K or V)
    and asks for the softmax statistics, which are merged by all-reduces
    (at least two a layer); three successive steps (the new keys written
    into the shard that holds their slot, the first step's other shards
    all masked) within 3e-5 of the reference's jitted decode on its own
    mesh, with the same greedy tokens."""
    logits, seen, lens, shards, comms = _results(ranks)["decode"][name]
    arch, B, _, _ = DECODE_CASES[name]
    assert shards == (4 if B == 8 else 8)
    n_calls = len(DECODE_POSITIONS) * (len(seen) // len(DECODE_POSITIONS))
    assert len(seen) == n_calls > 0
    assert {n for n, _ in seen} == {L // shards for L in lens}
    assert all(stats for _, stats in seen)
    layers = len(seen) // len(DECODE_POSITIONS)
    assert all(c.get("all_reduce", 0) >= 2 * layers for c in comms), comms
    ref = _ref_decode_steps(name, True)
    for got, want in zip(logits, ref):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_decode_ws_matches_reference_single_device(ranks):
    """``decode_ws`` on (2, 4) against the reference's decode on one device,
    over the three steps of ``DECODE_POSITIONS``."""
    ref = _ref_decode_steps("decode_ws", False)
    for got, want in zip(_results(ranks)["decode"]["decode_ws"][0], ref):
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_paged_decode_on_mesh_equals_meshless(ranks):
    plain, mesh = _results(ranks)["paged"]
    np.testing.assert_allclose(mesh, plain, atol=1e-5, rtol=1e-5)


def test_train_elastic_example_tiny_preset(ranks):
    hist, rescales, n_params = _results(ranks)["example"]
    assert rescales == 1
    assert [(s, d) for s, _, d in hist] == [(s, 8 if s < 2 else 4) for s in range(4)]
    assert all(math.isfinite(v) for _, v, _ in hist)
    assert n_params > 1_000_000


def test_train_elastic_example_runs_on_the_cpu_only_when_asked():
    """Without ``--device cpu`` the example asks for cards, as every entry
    point of the port does, and raises where there is none."""
    from repro_torch.examples import train_elastic

    if torch.cuda.is_available():
        pytest.skip("a card is visible; the refusal is for a machine without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_elastic.main([])


def test_one_rank_mesh_trains_bitwise_like_one_device(ranks):
    """The card's phase 13 (a) at smoke size: the mesh trainer on a (1, 1)
    mesh equals the meshless one bit for bit, every kernel op called as
    often (here, on the CPU, as its plain version), under both layouts."""
    plain = _one_rank_runs(None)
    meshed = _results(ranks)["one_rank"]
    assert set(meshed) == set(plain) == {"cp_fsdp", "optimized"}
    for name in plain:
        assert meshed[name] == plain[name]
        assert len(meshed[name][0]) == 3 and meshed[name][3] > 0


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_on_local_shards_equals_the_whole_product(ranks, name):
    """``parallel.local.dense`` (every linear layer of attention, the MLP
    and the unembedding on a mesh) on each layout it decides between: the
    output and both gradients equal ``x @ w`` on whole tensors in float64,
    the output split as the layout says (a row-parallel product is a
    partial sum)."""
    gap, placements = _results(ranks)["dense"][name]
    assert gap < 1e-10, gap
    assert placements == {
        "batch and sequence split": [("Shard", 0), ("Shard", 1)],
        "column parallel": [("Shard", 0), ("Shard", 2)],
        "row parallel": [("Shard", 0), ("Partial", None)]}[name]


def test_remat_recompute_on_another_thread_keeps_the_mesh_context(ranks):
    equal, n_leaves = _results(ranks)["remat_thread"]
    assert equal and n_leaves > 10


def test_nestable_implicit_replication_pins_the_torch_flag():
    """``parallel.local`` enters implicit replication through the flag that
    torch's own ``implicit_replication`` writes, because torch's turns the
    flag off on leaving even when entered inside another one (a model entry
    inside a train step's backward), which ends the outer one too. Ours
    restores what it found. If torch renames the flag or makes its context
    nestable, this test says so."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.local import _implicit_replication

    dispatcher = DTensor._op_dispatcher
    assert dispatcher._allow_implicit_replication is False
    with implicit_replication():
        assert dispatcher._allow_implicit_replication is True
        with implicit_replication():
            pass
        assert dispatcher._allow_implicit_replication is False
    with _implicit_replication():
        with _implicit_replication():
            assert dispatcher._allow_implicit_replication is True
        assert dispatcher._allow_implicit_replication is True
    assert dispatcher._allow_implicit_replication is False


def test_elastic_rescale_plan_defers_grows_never_drops():
    """The twin of ``tests/test_sched.py``'s hysteresis plan: grows inside
    the provisioning window are deferred to its end (not dropped); shrinks
    always apply immediately."""
    from repro_torch.runtime.elastic import ElasticTrainer
    from repro_torch.sched import ControllerSpec

    t = ElasticTrainer.__new__(ElasticTrainer)  # plumbing only, no model
    t.spec = ControllerSpec(provisioning_delay=10)
    t.devices = [0, 1, 2, 3]
    t.log = lambda s: None
    t._last_rescale_step = None
    t._deferred_n_dev = None
    t.n_coalesced_rescales = 0

    assert t._plan_rescale(5, 2) == 2  # shrink: applies
    t.devices = [0, 1]
    t._last_rescale_step = 5
    assert t._plan_rescale(12, 4) is None  # grow inside window: deferred
    assert t._deferred_n_dev == 4 and t.n_coalesced_rescales == 1
    assert t._plan_rescale(13, None) is None  # still inside the window
    assert t._plan_rescale(15, None) == 4  # window over: grow applies
    assert t._deferred_n_dev is None
    # a shrink arriving while a grow is deferred supersedes it
    t._deferred_n_dev = 4
    assert t._plan_rescale(14, 1) == 1


def test_elastic_trainer_methods_are_the_reference_text():
    """``_within_hysteresis`` and ``_plan_rescale`` are copied verbatim."""
    import inspect

    from repro.runtime.elastic import ElasticTrainer as J
    from repro_torch.runtime.elastic import ElasticTrainer as T

    for name in ("_within_hysteresis", "_plan_rescale"):
        assert inspect.getsource(getattr(T, name)) == inspect.getsource(getattr(J, name))


def test_launch_train_host_devices_trains_on_a_mesh(tmp_path, capfd):
    """``launch.train --host-devices 2`` spawns 2 gloo ranks, trains on a
    (2, 1) mesh and, at ``--preempt 1:1``, rebuilds it on rank 0 alone and
    resumes resharded."""
    from repro_torch.launch.train import main

    main(["--arch", "starcoder2-3b", "--smoke", "--steps", "3", "--batch", "4",
          "--seq", "16", "--host-devices", "2", "--preempt", "1:1",
          "--ckpt-dir", str(tmp_path / "ck")])
    out = capfd.readouterr().out
    assert "mesh=DeviceMesh((data=2, model=1)" in out
    assert "rescale at step 1: 2 -> 1 devices" in out
    steps = [line.split() for line in out.splitlines() if line.startswith("step ")]
    assert [(int(s[1]), int(s[5])) for s in steps] == [(0, 2), (1, 1), (2, 1)]
    assert (tmp_path / "ck" / "step_00000002").is_dir()
