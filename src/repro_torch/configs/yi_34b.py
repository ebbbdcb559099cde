"""yi-34b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=5000000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=4,
)
