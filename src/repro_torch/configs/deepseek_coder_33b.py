"""deepseek-coder-33b [dense] — llama-arch GQA. [arXiv:2401.14196; hf]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
56 heads / 8 kv-heads don't divide the 16-wide model axis, so the layout is
context-parallel attention + FSDP weight storage (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=100000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=4,
)
