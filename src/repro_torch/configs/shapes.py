"""Assigned input shapes. Every (arch x shape) pair is one dry-run cell.

train_*   lower ``train_step``; prefill_* lower ``prefill``;
decode_* / long_* lower ``decode_step`` (one token against a seq_len cache).

``long_500k`` requires a sub-quadratic sequence path: it RUNS for
ssm/hybrid/window-bounded-attention archs and is SKIPPED for pure
full-attention archs (see DESIGN.md §5 — the skip is part of the assignment).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}

# archs with a sub-quadratic long-context path (SSM / hybrid / sliding-window)
_LONG_OK = {
    "rwkv6-3b",  # ssm: O(1) state
    "jamba-1.5-large-398b",  # hybrid: mamba + 1:8 attention (seq-sharded KV)
    "mixtral-8x22b",  # SWA(4096): rolling window cache
    "starcoder2-3b",  # SWA(4096): rolling window cache
    "gemma2-2b",  # alternating local(4096)/global; globals use seq-sharded KV
}


def cell_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in _LONG_OK
    return True
