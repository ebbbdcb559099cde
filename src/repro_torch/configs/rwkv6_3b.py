"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent decay linear
attention + squared-ReLU channel-mix. [arXiv:2404.05892; hf]

32L d_model=2560 (40 heads of 64) d_ff=8960 vocab=65536.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / rwkv_head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    mixer_pattern=("rwkv",),
    pos_type="none",
    norm_type="layernorm",
    norm_eps=1e-5,
    rwkv_head_dim=64,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="tp_ffn",
    remat="full",
    num_microbatches=2,
)
