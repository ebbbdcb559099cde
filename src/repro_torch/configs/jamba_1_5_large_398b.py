"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e
top-2 on every 2nd layer. 398B total / ~94B active. [arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Attention layers sit
at offset 4 of each 8-layer block (attn_layer_period=8, offset=4); MoE at odd
offsets (period=2, offset=1). No positional encoding (Mamba carries order).

At this scale the framework's distributed-optimization tricks are load-
bearing: FSDP weight storage + int8-quantized Adam moments are required to
fit a 256-chip v5e pod (see repro.optim and EXPERIMENTS.md §Dry-run).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    mixer_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe_period=2,
    num_experts=16,
    experts_per_token=2,
    pos_type="none",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="tp",
    remat="full",
    num_microbatches=8,
    grad_acc_dtype="bfloat16",  # 398B f32 grad buffers don't fit a v5e pod
    opt_moments_dtype="int8",  # 8-bit Adam moments (repro.optim)
)
