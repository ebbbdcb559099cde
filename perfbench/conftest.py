"""Fixtures of the benchmark's CPU tests: a tiny dense and a tiny MoE
configuration at the benchmark's layout, served by the program's plain
path on the CPU, and traffic sized to run in about a second. A tiny run
serves on past its window's close until every request it submitted has
finished (for at most ``DRAIN_S`` more seconds), so that a loaded host
still leaves the check finished requests to judge."""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {"name": "tiny-dense", "model": {
    "name": "tiny-dense", "family": "dense", "num_layers": 2, "d_model": 64,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "attn_pattern": ["local"], "window_size": 32, "mlp_type": "gelu",
    "norm_type": "layernorm", "norm_eps": 1e-5, "use_bias": True, "rope_theta": 10000.0,
    "tie_embeddings": True, "dtype": "bfloat16", "param_dtype": "bfloat16"}}
MOE = {"name": "tiny-moe", "model": {
    "name": "tiny-moe", "family": "moe", "num_layers": 2, "d_model": 64,
    "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 64, "vocab_size": 256,
    "attn_pattern": ["global"], "window_size": 0, "moe_period": 1, "num_experts": 4,
    "experts_per_token": 2, "capacity_factor": 1.25, "mlp_type": "swiglu",
    "norm_type": "rmsnorm", "norm_eps": 1e-5, "use_bias": False, "rope_theta": 10000.0,
    "tie_embeddings": False, "dtype": "bfloat16", "param_dtype": "bfloat16"}}
OPEN = {"loop": "open", "cycle_s": 0.5, "phases": [[0, 0.4, 0.75], [0.4, 0.5, 2.0]],
        "rate_rps": 30, "lead_in_s": 0.1, "prompt_tokens": [16, 60],
        "prompt_dist": "loguniform", "output_tokens": [3, 8], "output_dist": "uniform",
        "max_slots": 4, "max_len": 128, "kv_block_size": 16,
        "trace_slice_s": 0.2, "check_tokens": 40}
CLOSED = dict(OPEN, loop="closed", clients=4, think_s=0.0, requests=200, block=8,
              output_tokens=[4, 12])
LIMITS = {"logit_gap": 0.05, "routed_off_tie": 0, "keep_mismatch": 0}
DRAIN_S = 120.0


@pytest.fixture(scope="module")
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(few_threads):
    """run(config, traffic, trace=False, seed=...) -> (result, run) of one
    tiny cell on the CPU, its spec naming the cell in every per-layer
    metric."""
    import json

    from perfbench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = dict(spec, per_layer=[dict(m, workloads=["tiny"]) for m in spec["per_layer"]],
                end_to_end=[dict(m, workloads=["tiny"]) for m in spec["end_to_end"]])

    def run(config, traffic, trace=False, seed=2**31 + 12345, seconds=0.6):
        cell = {"name": "tiny", "config": config["name"], "traffic": "t", "chips": 1}
        limits = {k: v for k, v in LIMITS.items()
                  if config is MOE or k == "logit_gap"}
        result = harness.run_cell("tiny", seed, seconds, trace, device="cpu", spec=spec,
                                  inputs=(cell, config, traffic, limits), drain_s=DRAIN_S)
        return result, result.pop("_run")

    return run
