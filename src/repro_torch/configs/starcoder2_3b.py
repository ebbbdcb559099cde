"""starcoder2-3b [dense] — GQA, RoPE, sliding-window 4096. [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. LayerNorm + biases,
non-gated GeLU MLP (4x), tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    attn_pattern=("local",),
    window_size=4096,
    mlp_type="gelu",
    norm_type="layernorm",
    norm_eps=1e-5,
    use_bias=True,
    rope_theta=100000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=2,
)
