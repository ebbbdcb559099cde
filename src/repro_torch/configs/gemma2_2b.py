"""gemma2-2b [dense] — local/global alternating attention, logit softcaps,
sandwich (pre+post) RMSNorm with (1+w) convention, GeGLU, head_dim 256,
256k vocabulary, tied + scaled embeddings. [arXiv:2408.00118; hf]

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_pattern=("local", "global"),
    window_size=4096,
    mlp_type="geglu",
    norm_type="rmsnorm",
    norm_plus_one=True,
    post_norm=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=4,
)
