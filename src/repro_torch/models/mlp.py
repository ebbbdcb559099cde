"""Feed-forward layers: dense (GeLU, GeGLU, SwiGLU, optional biases) and
mixture-of-experts.

Twin of ``repro.models.mlp`` on one device. The MoE routes each token to its
top-k experts in f32 (``_route``), then runs one of the reference's two
single-device implementations, chosen by ``cfg.moe_impl``:

  * ``dense``    — every token through every expert, gate-weighted sum
                   (``_moe_dense``);
  * ``dispatch`` (and ``auto``) — GShard-style capacity dispatch
                   (``_moe_local``): the assignments are ranked per expert in
                   token-major order, the first C of each expert scatter into
                   an (E, C, d) buffer, three batched GEMMs run the experts,
                   and a gather weighted by the gates combines them. An
                   assignment past capacity is dropped (contributes zero).

Capacity ``C`` counts the tokens routed together. ``route_rows=True`` routes
each batch row as its own group, with its own capacity, exactly as the
reference's ``jax.vmap`` of a one-row step does (its dense batcher): the
groups dispatch into one (G, E, C, d) buffer and share one GEMM per expert
weight, so the expert weights are read once whatever the number of groups.
The reference's mesh paths (``_moe_smap``: EP and ETP inside ``shard_map``)
are mesh tooling and are not ported (ROADMAP Queue A, item 9).

Top-k keeps the lower expert index first on equal probabilities, as
``jax.lax.top_k`` does (``torch.topk`` does not promise an order on ties).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init
from repro_torch.models.config import ModelConfig

RECORD = None
"""Measurement hook, off while None. Set it to a list and every MoE call
appends ``(idx, probs, keep)``: its routing choices (G, T, k), its
probabilities (G, T, E) and, under capacity dispatch, which assignments
were kept (G, T*k; None for ``_moe_dense``). The tensors stay on the
device, so recording adds no host sync. A block's forward rerun by
activation checkpointing in the backward records nothing, so one training
forward records each MoE call once whatever ``cfg.remat``."""


def _record(entry):
    # the autograd engine runs a graph task only in the backward, where
    # torch.utils.checkpoint recomputes a block
    if RECORD is not None and torch._C._current_graph_task_id() == -1:
        RECORD.append(entry)


def _gated(cfg: ModelConfig) -> bool:
    return cfg.mlp_type in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# dense MLP


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


# ---------------------------------------------------------------------------
# MoE params


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    """The router is f32 whatever ``dtype`` is, as in the reference."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(gen, (d, E), torch.float32, device),
         "w_gate": dense_init(gen, (E, d, ff), dtype, device, in_axis=1),
         "w_up": dense_init(gen, (E, d, ff), dtype, device, in_axis=1),
         "w_out": dense_init(gen, (E, ff, d), dtype, device, in_axis=1)}
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, cfg, dtype, device)
    return p


# ---------------------------------------------------------------------------
# routing + dispatch helpers; tokens come in groups, (G, T, d)


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: largest first, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2, router, k: int):
    """Returns (gates (..., k), idx (..., k), probs (..., E)). f32 routing."""
    logits = x2.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(probs, idx, E: int):
    """Switch-style load-balancing loss E * sum_e f_e * P_e of each group:
    probs (G, T, E), idx (G, T, k) -> (G,)."""
    G = idx.shape[0]
    assign = F.one_hot(idx.reshape(G, -1), E).float()  # (G, T*k, E)
    f = assign.mean(1)
    pmean = probs.mean(1)
    return E * (f * pmean).sum(-1)


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    return max(1, int(math.ceil(T * k / E * cf)))


def _dispatch(x2, idx, E: int, C: int):
    """Scatter each group's tokens into its (E, C, d) buffer. x2 (G, T, d),
    idx (G, T, k). An expert's assignments are ranked in token-major order
    (token 0's first choice, then its second, ...); those past ``C`` are
    kept out (``keep`` False) and add a zero into slot C-1, as the
    reference's scatter-add does. Returns ((G, E, C, d), bookkeeping).

    On CUDA this ``index_add_`` and the backward of the ``x2[:, tok_ids]``
    gather add atomically, yet the results do not depend on their order:
    a buffer row gets one kept token plus zeros, and a token's gradient
    row at most k <= 2 values, each added into zeros (bitwise repeatable
    on the card: tests/test_torch_gpu.py)."""
    G, T, d = x2.shape
    k = idx.shape[-1]
    e_flat = idx.reshape(G, T * k)
    onehot = F.one_hot(e_flat, E)  # (G, T*k, E)
    prior = onehot.cumsum(1) - onehot
    pos_flat = prior.gather(2, e_flat[..., None])[..., 0]  # (G, T*k)
    keep = pos_flat < C
    slot = torch.clamp(pos_flat, max=C - 1)
    tok_ids = torch.arange(T, device=x2.device).repeat_interleave(k)
    xk = x2[:, tok_ids] * keep[..., None].to(x2.dtype)  # (G, T*k, d)
    groups = torch.arange(G, device=x2.device)[:, None]
    row = ((groups * E + e_flat) * C + slot).reshape(-1)  # into (G*E*C, d)
    disp = x2.new_zeros((G * E * C, d)).index_add_(0, row, xk.reshape(-1, d))
    return disp.reshape(G, E, C, d), (row, keep)


def _combine(expert_out, book, gates):
    """Gather each assignment's expert output, weight it by its gate (cast
    to the activation dtype first, 0 when dropped) and sum over the k
    choices. expert_out (G, E, C, d), gates (G, T, k) -> (G, T, d)."""
    row, keep = book
    G, T, k = gates.shape
    vals = expert_out.reshape(-1, expert_out.shape[-1])[row]  # (G*T*k, d)
    w = (keep.float() * gates.reshape(G, T * k)).to(vals.dtype).reshape(-1)
    vals = vals * w[:, None]
    return vals.reshape(G, T, k, -1).sum(2)


def _expert_ffn(disp, wg, wu, wo, cfg: ModelConfig):
    """(G, E, C, d) -> (G, E, C, d): one batched GEMM per expert weight over
    every group's rows (the reference's three ``einsum``s)."""
    G, E, C, d = disp.shape
    act = act_fn(cfg.mlp_type)
    xe = disp.transpose(0, 1).reshape(E, G * C, d)
    h = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    y = torch.bmm(act(h) * u, wo)
    return y.reshape(E, G, C, d).transpose(0, 1)


# ---------------------------------------------------------------------------
# implementations; x (G, T, d) -> (y (G, T, d), aux (G,))


def _moe_dense(p, x, cfg: ModelConfig):
    G, T, d = x.shape
    E = cfg.num_experts
    gates, idx, probs = _route(x, p["router"], cfg.experts_per_token)
    act = act_fn(cfg.mlp_type)
    x2 = x.reshape(G * T, d)
    outs = torch.stack([(act(x2 @ p["w_gate"][e]) * (x2 @ p["w_up"][e])) @ p["w_out"][e]
                        for e in range(E)])  # (E, G*T, d)
    gate_mat = torch.zeros((G * T, E), dtype=torch.float32, device=x.device)
    gate_mat.scatter_(1, idx.reshape(G * T, -1), gates.reshape(G * T, -1))
    y = torch.einsum("etd,te->td", outs.float(), gate_mat)
    _record((idx, probs, None))
    return y.reshape(G, T, d).to(x.dtype), _aux_loss(probs, idx, E)


def _moe_local(p, x, cfg: ModelConfig):
    G, T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    gates, idx, probs = _route(x, p["router"], k)
    C = _capacity(T, k, E, cfg.capacity_factor)
    disp, book = _dispatch(x, idx, E, C)
    _record((idx, probs, book[1]))
    out = _expert_ffn(disp, p["w_gate"], p["w_up"], p["w_out"], cfg)
    return _combine(out, book, gates), _aux_loss(probs, idx, E)


def apply_moe(p, x, cfg: ModelConfig, route_rows: bool = False):
    """x (B, S, d). Returns (y (B, S, d), aux): the B*S tokens route as one
    group, or with ``route_rows`` each row as a group of S tokens, and aux
    is then the mean of the rows' losses (the reference's vmap over rows,
    then a mean). ``cfg.moe_impl == "dense"`` runs every expert on every
    token; any other value (``auto``, ``dispatch``) dispatches under
    capacity, as the reference does without a mesh. The shared
    expert, where the config has one, is added to every token."""
    B, S, d = x.shape
    xg = x if route_rows else x.reshape(1, B * S, d)
    impl = _moe_dense if cfg.moe_impl == "dense" else _moe_local
    y, aux = impl(p, xg, cfg)
    y = y.reshape(B, S, d)
    if cfg.shared_expert:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y, aux.mean()
