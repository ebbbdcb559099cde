"""Beyond-paper optimized run configurations (EXPERIMENTS.md §Perf).

The per-arch config files keep the paper-faithful baseline; these overrides
are the hillclimbed variants. Selected per (arch, step-kind) — e.g.:

    cfg = get_config("deepseek-coder-33b").replace(
        **OPTIMIZED["deepseek-coder-33b"]["train"])
    rules = layout_rules(mesh, cfg, "train", layout=cfg.layout)

Measured effects (single-pod, see §Perf):
  deepseek train_4k : 46.5 s -> 5.8 s step bound (roofline frac 0.10 -> 0.71)
  rwkv6    train_4k : 12-16x (tp_ffn replicated the recurrence across the
                      model axis; pure-FSDP removes it)
  mixtral decode_32k: 361 ms -> 10.5 ms per token (weight-stationary decode)
"""

OPTIMIZED = {
    "deepseek-coder-33b": {
        "train": dict(layout="fsdp", num_microbatches=1, flash_vjp=True),
        "decode": dict(layout="decode_ws"),
    },
    "yi-34b": {  # same shape/family as deepseek
        "train": dict(layout="fsdp", num_microbatches=1, flash_vjp=True),
        "decode": dict(layout="decode_ws"),
    },
    "rwkv6-3b": {
        "train": dict(layout="fsdp", num_microbatches=1),
    },
    "mixtral-8x22b": {
        "train": dict(num_microbatches=2, flash_vjp=True),
        "decode": dict(layout="decode_ws"),
    },
    "llama4-scout-17b-a16e": {
        "train": dict(num_microbatches=1, flash_vjp=True),
        "decode": dict(layout="decode_ws"),
    },
    "jamba-1.5-large-398b": {
        "train": dict(num_microbatches=2),
        "decode": dict(layout="decode_ws"),
    },
    "musicgen-medium": {
        "train": dict(layout="fsdp", num_microbatches=1, flash_vjp=True),
    },
    "gemma2-2b": {
        "train": dict(flash_vjp=True),
    },
    "starcoder2-3b": {
        "train": dict(flash_vjp=True),
    },
    "paligemma-3b": {
        "train": dict(flash_vjp=True),
    },
}
