"""paligemma-3b [vlm] — SigLIP frontend (STUB) + gemma-1 2b text backbone.
[arXiv:2407.07726; hf]

18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384 vocab=257216.
The SigLIP tower is a stub per the assignment: ``input_specs()`` supplies 256
precomputed patch embeddings (B,256,d) as a bidirectional prefix
(prefix-LM mask); text is causal.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="geglu",
    norm_type="rmsnorm",
    norm_plus_one=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    prefix_len=256,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=2,
)
