"""A rank's step cost (``repro_torch.parallel.cost``, the twin of
``repro.parallel.hlo``) on the CPU.

One product counts 2*M*N*K; a dense MLP counts the FLOPs the reference's
HLO walk counts for the same program; a smoke train step counts what its
config says it must; each smoke step (prefill, paged and dense decode,
RWKV-6, a jamba block and a mixtral MoE step in training) counts the same
on CPU tensors as on ``meta`` tensors; each hand-kernel op counts once, by
its formula, and none of its plain version's ops; and on 8 gloo ranks a
deepseek smoke ``fsdp`` step moves the collective bytes that the meta
count under a fake 8-rank group gives.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rwkv6_scan import ops as rops
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant_schedule
from repro_torch.parallel.cost import CostMode

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
NO_MOE = dict(moe_period=0, num_experts=0, experts_per_token=0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's torch ops on one thread, as
    tests/test_torch_batching.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(fn, *args, **kwargs):
    with CostMode() as cm:
        fn(*args, **kwargs)
    return cm


# ------------------------------------------------------------ the rules


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_one_product_counts_2mnk(device):
    a = torch.ones((32, 16), device=device)
    b = torch.ones((16, 48), device=device)
    cm = _count(torch.matmul, a, b)
    assert cm.flops == 2 * 32 * 48 * 16
    assert cm.bytes == cm.bytes_min == 4 * (32 * 16 + 16 * 48 + 32 * 48)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_composite_products_count_their_parts_in_every_grad_mode(mode):
    """``matmul``, ``linear`` and ``einsum`` reach the mode whole under
    ``inference_mode`` (the serving path's); they count as the products
    they decompose into, as under autograd."""
    a, w = torch.ones((4, 8, 16), device="meta"), torch.ones((16, 32), device="meta")
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    with ctx():
        cm = _count(lambda: (torch.matmul(a, w), torch.nn.functional.linear(a, w.t()),
                             torch.einsum("bsd,de->bse", a, w)))
    assert cm.flops == 3 * 2 * 4 * 8 * 32 * 16
    assert "aten.mm.default" in cm.by_op and "aten.linear.default" not in cm.by_op


def test_dense_mlp_flops_equal_the_reference_hlo_count():
    """A two-layer dense MLP with no loop, jitted by the reference: its HLO
    walk (``repro.parallel.hlo.analyze``) and the port's count of the same
    program give the same FLOPs, exactly."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.parallel.hlo import analyze

    rng = np.random.default_rng(0)
    x, w1, b1, w2 = (rng.standard_normal(s).astype(np.float32)
                     for s in ((24, 40), (40, 72), (72,), (72, 16)))

    def mlp_jax(x, w1, b1, w2):
        return jax.nn.relu(x @ w1 + b1) @ w2

    hlo = jax.jit(mlp_jax).lower(x, w1, b1, w2).compile().as_text()
    ref = analyze(hlo)
    tx, tw1, tb1, tw2 = (torch.from_numpy(a) for a in (x, w1, b1, w2))
    cm = _count(lambda: torch.relu(tx @ tw1 + tb1) @ tw2)
    assert cm.flops == ref["flops"] == 2 * 24 * 72 * 40 + 2 * 24 * 16 * 72
    assert cm.collectives == {} and ref["collectives"] == {}


def _train(cfg, device, B, S, seed=0):
    """(step, state, batch) of ``cfg`` on ``device``: the port's seeded
    init, or its meta tree; the batch's tokens already on ``device`` (from
    the host, the step would copy them there: a copy that only a device
    other than the CPU makes)."""
    model = build_model(cfg)
    if device == "meta":
        params = model.init_shape()
    else:
        params = model.init(torch.Generator(device=device).manual_seed(seed), device=device)
    opt = AdamW(lr=constant_schedule(1e-4), moments_dtype=cfg.opt_moments_dtype)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    return make_train_step(model, opt), opt.init_state(params), batch


def test_starcoder2_smoke_train_step_counts_its_configs_flops():
    """starcoder2-3b's smoke step (2 layers, no remat, one microbatch,
    tied embeddings, a non-gated MLP): every projection, the MLP and the
    unembedding forward and twice backward (dX and dW); attention's
    forward by B2's formula over the (query, key) pairs its window lets
    through, its plain backward five (B,H,S,S,hd) products."""
    cfg = smoke_config("starcoder2-3b")
    assert (cfg.remat, cfg.num_microbatches, cfg.mlp_type, cfg.tie_embeddings) == \
        ("none", 1, "gelu", True)
    B, S = 2, 16
    T, d, H, KV, hd = B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dense = cfg.num_layers * 2 * T * (d * H * hd + 2 * d * KV * hd + H * hd * d
                                      + 2 * d * cfg.d_ff) + 2 * T * d * cfg.vocab_size
    pairs = sum(min(q + 1, cfg.window_size) for q in range(S))
    attn = cfg.num_layers * (4 * B * H * hd * pairs + 10 * B * H * S * S * hd)
    step, state, batch = _train(cfg, "cpu", B, S)
    cm = _count(step, state, batch)
    assert cm.flops == 3 * dense + attn
    assert cm.kernel_calls == {"flash_attention": cfg.num_layers}


# ------------------------------------------------- meta equals real (CPU)


def _serve(cfg, device, kind, seed=0):
    """A bucketed prefill, a paged decode step or a dense decode step of
    ``cfg`` on ``device``, at smoke size."""
    model = build_model(cfg)
    meta = device == "meta"
    params = model.init_shape() if meta else model.init(
        torch.Generator(device=device).manual_seed(seed), device=device)
    B, bs, L = 3, 4, 32
    tok = torch.tensor([[5], [7], [11]], dtype=torch.int32).to(device)
    if kind == "prefill":
        tokens = torch.arange(1, 17, dtype=torch.int32)[None].to(device)
        step = lambda: model.prefill(params, tokens=tokens, max_len=L, true_len=13)  # noqa: E731
    elif kind == "paged":
        P = L // bs
        pools = model.init_paged_cache(2 + B * P, bs, device=device)
        pages = (torch.arange(B * P, dtype=torch.int32) + 2).reshape(B, P).to(device)
        pos = torch.tensor([3, 17, 30]).to(device)
        step = lambda: model.decode_step_paged(params, pools, tokens=tok,  # noqa: E731
                                               pos_vec=pos, pages=pages)
    else:
        cache = model.init_cache(B, L, device=device)
        pos = torch.tensor([3, 17, 30]).to(device)
        step = lambda: model.decode_step(params, cache, tokens=tok, pos=pos)  # noqa: E731

    def run():
        with torch.inference_mode():  # as the batcher serves
            step()
    return run


STEPS = {
    "starcoder2-prefill": lambda dev: _serve(smoke_config("starcoder2-3b"), dev, "prefill"),
    "starcoder2-paged-decode": lambda dev: _serve(smoke_config("starcoder2-3b"), dev,
                                                  "paged"),
    "starcoder2-dense-decode": lambda dev: _serve(smoke_config("starcoder2-3b"), dev,
                                                  "dense"),
    "rwkv6-train": lambda dev: _train(smoke_config("rwkv6-3b"), dev, 2, 16),
    "jamba-block-train": lambda dev: _train(
        smoke_config("jamba-1.5-large-398b").replace(num_layers=8, **NO_MOE), dev, 2, 16),
    "mixtral-moe-train": lambda dev: _train(smoke_config("mixtral-8x22b"), dev, 4, 16),
}
KERNELS = {
    "starcoder2-prefill": {"flash_attention": 2},
    "starcoder2-paged-decode": {"paged_decode_attention": 2},
    "starcoder2-dense-decode": {"decode_attention": 2},
    "rwkv6-train": {"rwkv6_scan": 2, "rwkv6_scan_bwd": 2},
    "jamba-block-train": {"flash_attention": 1, "ssm_scan": 7, "ssm_scan_bwd": 7},
    "mixtral-moe-train": {"flash_attention": 2},
}


@pytest.mark.parametrize("name", list(STEPS))
def test_step_counts_the_same_on_meta_tensors_as_on_the_cpu(name):
    got = {}
    for dev in ("cpu", "meta"):
        made = STEPS[name](dev)
        got[dev] = _count(*made) if isinstance(made, tuple) else _count(made)
    cpu = got["cpu"].totals()
    assert cpu == got["meta"].totals()
    assert cpu["kernel_calls"] == KERNELS[name]
    assert got["cpu"].by_op["aten.mm.default"][1] > 0  # the products, not the kernels alone
    assert cpu["bytes"] > cpu["bytes_min"] > 0


# ----------------------------------------------------------- kernel ops


def _f32(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _kernel_cases():
    """op name -> (the public op, its args, its keyword arguments, its
    cost function), at small shapes in f32."""
    B, H, KV, S, hd = 2, 4, 2, 24, 16
    flash = (_f32(B, H, S, hd, seed=1), _f32(B, KV, S, hd, seed=2), _f32(B, KV, S, hd, seed=3))
    flash_kw = dict(causal=True, window=8, prefix_len=3, q_offset=0)
    dec = (_f32(B, H, hd, seed=4), _f32(B, KV, 20, hd, seed=5), _f32(B, KV, 20, hd, seed=6),
           torch.zeros(B, 20))
    bs, P = 4, 5
    paged = (dec[0], _f32(2 + B * P, bs, KV, hd, seed=7), _f32(2 + B * P, bs, KV, hd, seed=8),
             (torch.arange(B * P, dtype=torch.int32) + 2).reshape(B, P), dec[3])
    Sx, Di, N = 10, 12, 4
    ssm = (_f32(B, Sx, Di, seed=9), torch.rand(B, Sx, Di), -torch.rand(Di, N) - 0.5,
           _f32(B, Sx, N, seed=10), _f32(B, Sx, N, seed=11), _f32(Di, seed=12),
           _f32(B, Di, N, seed=13))
    Hr, hr = 3, 8
    rwkv = tuple(_f32(B, Hr, Sx, hr, seed=14 + i) for i in range(3)) + (
        0.2 + 0.7 * torch.rand(B, Hr, Sx, hr), _f32(Hr, hr, seed=17),
        _f32(B, Hr, hr, hr, seed=18))
    return {
        "flash_attention": (fops.flash_attention, flash, flash_kw, fops.flash_attention_cost),
        "flash_attention_stats": (
            fops.flash_attention_vjp, flash, dict(flash_kw, chunk_q=8, chunk_k=8),
            lambda *a, **kw: fops.flash_attention_cost(*a, **kw, stats=True)),
        "decode_attention": (dops.decode_attention, dec, {}, dops.decode_attention_cost),
        "decode_attention_stats": (dops.decode_attention, dec, dict(stats=True),
                                   dops.decode_attention_cost),
        "paged_decode_attention": (dops.paged_decode_attention, paged, {},
                                   dops.paged_decode_attention_cost),
        "ssm_scan": (sops.ssm_scan, ssm, {}, sops.ssm_scan_cost),
        "rwkv6_scan": (rops.rwkv6_scan, rwkv, {}, rops.rwkv6_scan_cost),
    }


@pytest.mark.parametrize("op", list(_kernel_cases()))
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_op_counts_once_by_its_formula(op, device):
    """Called on its own (B2 with statistics: its forward, the op being an
    autograd function), an op counts its formula and nothing else: none of
    its plain version's aten ops."""
    fn, args, kw, cost_fn = _kernel_cases()[op]
    args = tuple(a.to(device) for a in args)
    if op == "flash_attention_stats":
        args = (args[0].clone().requires_grad_(),) + args[1:]
    cost = cost_fn(*args, **kw)
    cm = _count(fn, *args, **kw)
    assert cm.kernel_calls == {op: 1}
    assert (cm.flops, cm.bytes, cm.bytes_min) == (cost.flops, cost.bytes, cost.bytes)
    assert cost.flops > 0 and cost.bytes > 0


@pytest.mark.parametrize("op", ["ssm_scan", "rwkv6_scan"])
def test_scan_backward_counts_once_by_its_formula(op):
    """The scans' backward (B6, B7) under autograd, with f32 contiguous
    incoming gradients: one call, counted by its formula; what autograd
    adds around it is not a product and moves no kernel's bytes."""
    fn, args, _, _ = _kernel_cases()[op]
    live = [a.clone().requires_grad_() for a in args]
    out = fn(*live)
    grads = (torch.ones_like(out[0]), torch.zeros_like(out[1]))
    ref = sops.ssm_scan_ref if op == "ssm_scan" else rops.rwkv6_scan_ref
    saved = ref(*args, save_states=True)[2]
    if op == "ssm_scan":
        cost = sops.ssm_scan_bwd_cost(*args[:6], grads[0], saved, grads[1])
    else:
        r, k, v, w, u, _ = args
        cost = rops.rwkv6_scan_bwd_cost(r, k, v, w, grads[0], u, saved, grads[1])
    cm = _count(torch.autograd.grad, out, live, grads)
    assert cm.kernel_calls == {op + "_bwd": 1}
    assert (cm.flops, cm.bytes_min) == (cost.flops, cost.bytes)


def test_serving_fleet_op_counts_once_by_its_formula():
    """The fleet program's one kernel call counts its bytes (no products),
    none of the plain version's ops."""
    from repro_torch.kernels.serving_fleet import ops as fleet_ops
    from repro_torch.runtime import serving_torch as st
    from repro_torch.runtime.serving import Request, ServingFleetConfig

    cfg = ServingFleetConfig(n_replicas=2, max_transient=2, threshold=0.5,
                             provisioning_delay=3.0, tick_s=1.0)
    reqs = [Request(i, 3 * i, 2) for i in range(10)]
    pin = np.zeros(60, int)
    _, _, spec = st.run_workload(cfg, reqs, pin, 60, device="cpu")
    cm = _count(st.run_workload, cfg, reqs, pin, 60, device="cpu")
    assert cm.kernel_calls == {"serving_fleet": 1}
    assert cm.flops == 0 and cm.bytes_min == fleet_ops.fleet_bytes(spec, 1) > 0


# ------------------------------------------------------------ collectives


def _gloo_rank(rank, seq, batch):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    out = dryrun.trace_cell("deepseek-coder-33b", "train_4k", make_smoke_mesh((2, 4)),
                            layout="fsdp", smoke=True, seq_len=seq, global_batch=batch,
                            device="cpu")
    c = dict(out["collectives"])
    c.pop("top_ops")
    return {"flops": out["flops_per_device"], "bytes": out["bytes_per_device"],
            "bytes_min": out["bytes_min_per_device"], "collectives": c,
            "collective_counts": out["collective_counts"]}


def test_fsdp_step_on_8_gloo_ranks_moves_its_meta_count(tmp_path):
    """deepseek-coder-33b's smoke config under ``fsdp`` on a (2, 4) mesh:
    each gloo rank's all-gathers, reduce-scatters and all-reduces carry
    the bytes (and the FLOPs and bytes) the meta count of the same step
    under a fake 8-rank group gives."""
    from repro_torch.parallel.spawn import Ranks

    seq, batch = 32, 8
    meta = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "deepseek-coder-33b",
         "--shape", "train_4k", "--mesh", "single", "--smoke", "--mesh-shape", "2,4",
         "--layout", "fsdp", "--trace", "--seq", str(seq), "--batch", str(batch),
         "--force", "--out-dir", str(tmp_path / "meta")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))
    ranks = Ranks(_gloo_rank, 8, (seq, batch), store_dir=str(tmp_path), timeout_s=300)
    got = ranks.results(timeout=600)
    out, _ = meta.communicate(timeout=600)
    assert meta.returncode == 0, out[-4000:]
    cell = json.loads((tmp_path / "meta" / "single"
                       / "deepseek-coder-33b__train_4k.json").read_text())
    want = {"flops": cell["flops_per_device"], "bytes": cell["bytes_per_device"],
            "bytes_min": cell["bytes_min_per_device"],
            "collectives": {k: v for k, v in cell["collectives"].items() if k != "top_ops"},
            "collective_counts": cell["collective_counts"]}
    assert want["collectives"]["all-gather"] > 0 and want["collectives"]["reduce-scatter"] > 0
    for rank, g in enumerate(got):
        assert g == want, rank
