"""Convert the reference's parameters into the port's.

``params_from_jax(np_tree, cfg)`` takes the pytree of
``repro.models.decoder.DecoderLM.init`` with every leaf already turned into
a numpy array (``jax.tree.map(np.asarray, params)`` on the caller's side, so
this module imports no JAX). The reference stacks each block position's
weights under ``params["blocks"][j]`` with a leading ``n_blocks`` axis; the
port keeps one dict per layer, layer ``i * block_size + j`` being block
``i``'s position ``j``. Nested layer dicts (``attn``/``mlp``, RWKV's
``tm``/``cm``, an MoE layer's ``moe`` with its ``router`` (d, E),
``w_gate``/``w_up`` (E, d, ff), ``w_out`` (E, ff, d) and ``shared`` expert)
and ``ln0`` are carried as they are; every leaf keeps its dtype (RWKV's f32
``decay_base``/``bonus``/``ln_x`` and the f32 ``router`` in a bf16 model
too). A top-level entry the tree lacks stays absent: ``embed`` where the
model takes embeddings (musicgen), ``lm_head`` where it is tied
(paligemma).

``opt_state_from_jax(np_opt, cfg)`` carries the reference's AdamW state
(``AdamW.init``/``update``'s ``{"m", "v", ["ef"]}``) the same way: each
moment tree is laid out like the params, an int8 moment ``{"q", "s"}``
splits per layer like any leaf (a stacked ``(n_blocks, ..., 1)`` scale
becomes one ``(..., 1)`` scale per layer), and the ``ef`` residuals are f32
trees like the params.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, block_structure


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    device = resolve_device(device)
    block_size, n_blocks, _ = block_structure(cfg)
    out = {}
    for key in ("embed", "lm_head", "ln0", "final_norm"):
        if key in np_tree:
            out[key] = _map(np_tree[key], lambda a: _tensor(a, device))
    blocks = np_tree["blocks"]
    out["layers"] = [_map(blocks[j], lambda a, i=i: _tensor(np.asarray(a)[i], device))
                     for i in range(n_blocks) for j in range(block_size)]
    return out


def opt_state_from_jax(np_opt, cfg: ModelConfig, device=None):
    return {name: params_from_jax(tree, cfg, device=device)
            for name, tree in np_opt.items()}
