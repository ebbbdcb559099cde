"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]

48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048 (EnCodec codebook).
Backbone only per the assignment: the EnCodec/delay-pattern frontend is a
STUB — ``input_specs()`` provides precomputed frame embeddings (B,S,d) and
aligned next-frame labels (B,S).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    embed_inputs=False,  # frontend stub supplies embeddings
    pos_type="sinusoidal",
    mlp_type="gelu",
    norm_type="layernorm",
    norm_eps=1e-5,
    use_bias=True,
    tie_embeddings=False,
    dtype="bfloat16",
    param_dtype="bfloat16",
    layout="cp_fsdp",
    remat="full",
    num_microbatches=1,
)
