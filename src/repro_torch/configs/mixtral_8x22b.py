"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768. ~141B total.
8 experts on a 16-wide model axis => expert-tensor-parallel MoE (each device
holds a 1/16 d_ff slice of every expert — see repro.models.mlp). 48 heads
divide 16, so attention uses Megatron-style head TP.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_pattern=("local",),
    window_size=4096,
    moe_period=1,
    num_experts=8,
    experts_per_token=2,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="tp",
    remat="full",
    num_microbatches=8,
)
