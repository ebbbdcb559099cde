"""Architecture registry of the port: ``get_config`` + reduced smoke configs.

A copy of ``repro.configs.registry``: the same ten ids in the same order,
each config a copy of the reference's module (dense GQA: deepseek-coder-33b,
starcoder2-3b, yi-34b, gemma2-2b; RWKV-6: rwkv6-3b; the Mamba/attention
hybrid with experts: jamba-1.5-large-398b; audio over frame embeddings:
musicgen-medium; mixture-of-experts: llama4-scout-17b-a16e, mixtral-8x22b;
a vision prefix before gemma text: paligemma-3b). ``smoke_config`` is the
reference's reduction verbatim, so a smoke config built here equals the
reference's field for field.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig, block_structure

_MODULES: Dict[str, str] = {
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family: same layer patterns / norm / MoE
    structure, tiny widths. Used by CPU parity tests."""
    c = get_config(arch_id)
    block, _, _ = block_structure(c)
    d_model = 128
    head_dim = 32
    num_heads = 4
    num_kv_heads = min(c.num_kv_heads, 2) if c.num_kv_heads < c.num_heads else num_heads
    if c.num_kv_heads == 1:
        num_kv_heads = 1
    return c.replace(
        num_layers=block * 2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=256,
        vocab_size=512,
        window_size=min(c.window_size, 32) if c.window_size else 0,
        num_experts=min(c.num_experts, 4) if c.num_experts else 0,
        experts_per_token=min(c.experts_per_token, 2) if c.num_experts else 0,
        rwkv_head_dim=32,  # -> 4 rwkv heads at d_model=128
        ssm_state_dim=8,
        ssm_dt_rank=8,
        prefix_len=8 if c.prefix_len else 0,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        num_microbatches=1,
        attn_chunk_q=16,
        attn_chunk_k=16,
        capacity_factor=2.0,
    )
