"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, chunked
local attention (3 local : 1 global). [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified — implemented per the HF model card; deviations noted in DESIGN.md]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048.
~109B total / ~17B active.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_pattern=("local", "local", "local", "global"),
    window_size=8192,
    moe_period=1,
    num_experts=16,
    experts_per_token=1,
    shared_expert=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=500000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=4,
)
