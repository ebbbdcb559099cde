"""Dense feed-forward layer (GeLU, GeGLU, SwiGLU, optional biases).

Twin of the dense half of ``repro.models.mlp``. Mixture-of-experts configs
are not ported yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init
from repro_torch.models.config import ModelConfig


def _gated(cfg: ModelConfig) -> bool:
    return cfg.mlp_type in ("swiglu", "geglu")


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    if _gated(cfg):
        p = {"w_gate": dense_init(gen, (d, ff), dtype, device),
             "w_up": dense_init(gen, (d, ff), dtype, device),
             "w_out": dense_init(gen, (ff, d), dtype, device)}
    else:
        p = {"w_in": dense_init(gen, (d, ff), dtype, device),
             "w_out": dense_init(gen, (ff, d), dtype, device)}
    if cfg.use_bias:
        p["b_in"] = torch.zeros(ff, dtype=dtype, device=device)
        p["b_out"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: mixture-of-experts MLPs are not ported yet")
    act = act_fn(cfg.mlp_type)
    if _gated(cfg):
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_in"]
        if cfg.use_bias:
            h = h + p["b_in"]
        h = act(h)
    y = h @ p["w_out"]
    if cfg.use_bias:
        y = y + p["b_out"]
    return y
