"""Model configuration: one dataclass parameterizes the whole zoo.

A model is a stack of ``num_layers`` residual layers. Layer *i*'s structure is
derived from cyclic patterns, so heterogeneous stacks (gemma2 local/global
alternation, jamba's 1:7 mamba:attn interleave with MoE every 2nd layer) are
expressed without per-layer config lists:

  mixer   = mixer_pattern[i % len(mixer_pattern)]      ("attn"|"mamba"|"rwkv")
  attn    = attn_pattern[i % len(attn_pattern)]        ("global"|"local")
  is_moe  = moe_period > 0 and i % moe_period == moe_period - 1

The reference package scans over *blocks* of size B = lcm of all pattern
periods; the port keeps the same block structure (so converted weights and
layer order line up) but runs the layers as a plain Python loop.

A copy of ``repro.models.config``: the port imports nothing from the JAX
package. ``use_pallas`` is kept so the two dataclasses agree field for field;
the port dispatches on the tensors' device instead (see
``repro_torch.models.attention.grouped_attention``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # per-layer structure ---------------------------------------------------
    mixer_pattern: Tuple[str, ...] = ("attn",)
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 0  # local-attention window (0 = unused)
    moe_period: int = 0  # 0 = dense MLP everywhere; k = MoE on layers i%k==k-1

    # attention -------------------------------------------------------------
    pos_type: str = "rope"  # rope|sinusoidal|none
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0  # 0 = off (gemma2 uses 50.0)
    final_softcap: float = 0.0  # 0 = off (gemma2 uses 30.0)

    # mlp / moe ---------------------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu|geglu|gelu
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False  # llama4-style always-on shared expert
    moe_impl: str = "auto"  # auto|dense|dispatch  (auto: dispatch, dense if tiny)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm (mamba-1) -----------------------------------------------------------
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 => d_model // 16

    # rwkv6 -------------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64
    rwkv_gate_lora_dim: int = 128

    # norms / embeddings ------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm|layernorm
    norm_plus_one: bool = False  # gemma (1 + w) convention
    post_norm: bool = False  # gemma2 sandwich (pre+post) norms
    use_bias: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma: inputs *= sqrt(d_model)
    embed_inputs: bool = True  # False: model consumes precomputed embeddings
    prefix_len: int = 0  # prefix-LM bidirectional prefix length (paligemma)
    norm_eps: float = 1e-6

    # numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"

    # training / distribution knobs (overridable per run) ----------------------
    remat: str = "full"  # none|full|dots
    num_microbatches: int = 1
    layout: str = "cp_fsdp"  # sharding layout (see repro.parallel.layouts)
    grad_acc_dtype: str = "float32"  # grad-accumulation buffer dtype
    opt_moments_dtype: str = "float32"  # AdamW moment storage (float32|int8)
    attn_chunk_q: int = 512  # query-chunk for chunked (flash-style) jnp attention
    attn_chunk_k: int = 1024  # key-chunk
    flash_vjp: bool = False  # recompute-backward chunked attention (no O(S^2) residuals)
    use_pallas: bool = False  # route hot ops through Pallas kernels (interpret on CPU)

    # derived ------------------------------------------------------------------
    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class LayerSpec:
    """Static structure of one layer position within a block."""

    mixer: str  # attn|mamba|rwkv
    attn_type: str  # global|local
    is_moe: bool
    layer_offset: int  # position within the block (0..B-1)


def _lcm(*vals: int) -> int:
    out = 1
    for v in vals:
        if v > 0:
            out = math.lcm(out, v)
    return out


def block_structure(cfg: ModelConfig) -> Tuple[int, int, Tuple[LayerSpec, ...]]:
    """(block_size, n_blocks, per-position LayerSpecs)."""
    has_attn = "attn" in cfg.mixer_pattern
    block = _lcm(
        len(cfg.mixer_pattern),
        len(cfg.attn_pattern) if has_attn else 1,
        cfg.moe_period if cfg.moe_period > 0 else 1,
    )
    if cfg.num_layers % block != 0:
        raise ValueError(
            f"{cfg.name}: num_layers={cfg.num_layers} not divisible by "
            f"block size {block} derived from layer patterns"
        )
    specs = []
    for j in range(block):
        specs.append(
            LayerSpec(
                mixer=cfg.mixer_pattern[j % len(cfg.mixer_pattern)],
                attn_type=cfg.attn_pattern[j % len(cfg.attn_pattern)],
                is_moe=cfg.moe_period > 0 and (j % cfg.moe_period == cfg.moe_period - 1),
                layer_offset=j,
            )
        )
    return block, cfg.num_layers // block, tuple(specs)
