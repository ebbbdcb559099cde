"""Meta-tensor stand-ins and partition specs for every model input (twin of
``repro.launch.specs``).

``batch_struct`` returns tensors on the ``meta`` device (shape and dtype, no
storage) for the train / prefill / decode steps of any (arch, shape) cell,
the counterpart of the reference's ``jax.ShapeDtypeStruct``s. Modality
frontends are stubs as in the reference: audio supplies precomputed frame
embeddings, vlm supplies patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.layouts import divisible
from repro_torch.parallel.sharding import P, ShardingRules


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, kind: str, batch: int, seq_len: int) -> Dict[str, Any]:
    dt = torch_dtype(cfg.dtype)
    if kind in ("train", "prefill"):
        if cfg.family == "audio":
            out = {"embeds": _sds((batch, seq_len, cfg.d_model), dt)}
            if kind == "train":
                out["labels"] = _sds((batch, seq_len), torch.int32)
            return out
        if cfg.family == "vlm":
            P_ = cfg.prefix_len
            return {
                "prefix_embeds": _sds((batch, P_, cfg.d_model), dt),
                "tokens": _sds((batch, seq_len - P_), torch.int32),
            }
        return {"tokens": _sds((batch, seq_len), torch.int32)}
    # decode: one new token
    if cfg.family == "audio":
        return {"embeds": _sds((batch, 1, cfg.d_model), dt)}
    return {"tokens": _sds((batch, 1), torch.int32)}


def batch_partition(cfg: ModelConfig, kind: str, rules: ShardingRules) -> Dict[str, P]:
    b = rules.resolve("batch")
    s = rules.resolve("act_seq") if kind in ("train", "prefill") else None
    if kind in ("train", "prefill"):
        if cfg.family == "audio":
            out = {"embeds": P(b, s, None)}
            if kind == "train":
                out["labels"] = P(b, s)
            return out
        if cfg.family == "vlm":
            return {"prefix_embeds": P(b, None, None), "tokens": P(b, s)}
        return {"tokens": P(b, s)}
    if cfg.family == "audio":
        return {"embeds": P(b, None, None)}
    return {"tokens": P(b, None)}


def fix_divisibility(spec_tree, struct_tree, mesh):
    """Replace sharded dims that don't divide evenly with replication."""
    if isinstance(spec_tree, P):
        return divisible(spec_tree, tuple(struct_tree.shape), mesh)
    if isinstance(spec_tree, dict):
        return {k: fix_divisibility(v, struct_tree[k], mesh) for k, v in spec_tree.items()}
    return [fix_divisibility(s, t, mesh) for s, t in zip(spec_tree, struct_tree)]
