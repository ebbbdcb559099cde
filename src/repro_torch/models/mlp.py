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
On a mesh (a sharding context and DTensor activations) ``apply_moe`` takes
``_moe_smap``, the twin of the reference's ``shard_map`` body, written over
local shards: expert parallelism (EP, when the experts divide the
``moe_tp`` axes) sends each rank's dispatch buffer to the experts' owners
and back with two ``all_to_all``s; expert-tensor parallelism (ETP) runs
every expert on each rank's ``ff`` shard and sums the partial outputs over
``moe_tp`` at the activation dtype. Capacity counts the rank's own tokens,
and the load-balancing loss multiplies the assignment and probability
vectors after averaging each over every rank.

Top-k keeps the lower expert index first on equal probabilities, as
``jax.lax.top_k`` does (``torch.topk`` does not promise an order on ties).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn, dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import P, is_dtensor, logical, sharding_ctx
from repro_torch.parallel.local import dense

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
        h = act(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    else:
        h = dense(x, p["w_in"])
        if cfg.use_bias:
            h = h + p["b_in"]
        h = act(h)
    h = logical(h, "batch", "act_seq_mlp", "act_ff")
    y = dense(h, p["w_out"])
    if cfg.use_bias:
        y = y + p["b_out"]
    return logical(y, "batch", "act_seq", None)


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
    logits = dense(x2.float(), router.float())
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


def _group(mesh, axes):
    """The process group of the mesh axes ``axes`` (one name or several,
    flattened in mesh order)."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    return mesh[tuple(axes)]._flatten().get_group()


def _pmean_all(v, mesh):
    """The mean of ``v`` over every rank of ``mesh``, differentiable."""
    from torch.distributed.tensor import DTensor, Partial

    return DTensor.from_local(v / mesh.size(), mesh, [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()


def _moe_smap(p, x, cfg: ModelConfig, mesh, rules):
    """EP / ETP dispatch over local shards (see the module docstring). x is
    a DTensor (B, S, d); returns (y laid out as the tokens were dispatched,
    aux, a replicated scalar)."""
    from torch.distributed._functional_collectives import (all_to_all_single,
                                                           all_to_all_single_autograd,
                                                           wait_tensor)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.parallel.layouts import axis_size, placements
    from repro_torch.parallel.local import partial_where_split

    E, k = cfg.num_experts, cfg.experts_per_token
    dp = rules.resolve("batch")
    tp = rules.resolve("moe_tp")
    seq = rules.resolve("act_seq")
    tp_size = axis_size(mesh, tp)
    use_ep = tp is not None and tp_size > 1 and E % tp_size == 0
    tp_axes = (tp,) if isinstance(tp, str) else tuple(tp or ())

    if use_ep:
        # tokens MUST be sharded across the expert axis: a replicated token
        # set makes every tp rank dispatch the same tokens and every expert
        # compute them tp_size x redundantly. If the layout leaves seq
        # unsharded, shard it over tp here.
        seq_ax = seq
        if seq_ax is None and x.shape[1] % tp_size == 0 and x.shape[1] > 1:
            seq_ax = tp
        x_spec = P(dp, seq_ax, None)
        w_specs = dict(router=P(None, None), w_gate=P(tp, None, None),
                       w_up=P(tp, None, None), w_out=P(tp, None, None))
    else:
        # ETP: each tp rank sees all tokens of its batch shard. If tp spans a
        # batch axis (weight-stationary decode: ff sharded over data x model)
        # the tokens must be fully replicated so the sum over tp is correct.
        if isinstance(dp, str):
            dp_eff = None if dp in tp_axes else dp
        elif dp is None:
            dp_eff = None
        else:
            dp_eff = tuple(a for a in dp if a not in tp_axes) or None
        x_spec = P(dp_eff, None, None)
        w_specs = dict(router=P(None, None), w_gate=P(None, None, tp),
                       w_up=P(None, None, tp), w_out=P(None, tp, None))

    xpl = placements(x_spec, mesh)
    names = ("router", "w_gate", "w_up", "w_out")
    wpl = [placements(w_specs[n], mesh) for n in names]
    xl = x.redistribute(mesh, xpl).to_local(
        grad_placements=partial_where_split(xpl, wpl))
    router, wg, wu, wo = (p[n].redistribute(mesh, pl).to_local(
        grad_placements=partial_where_split(pl, [xpl])) for n, pl in zip(names, wpl))

    Bl, Sl, d = xl.shape
    x2 = xl.reshape(1, Bl * Sl, d)
    T = Bl * Sl
    gates, idx, probs = _route(x2, router, k)
    C = _capacity(T, k, E, cfg.capacity_factor)
    disp, book = _dispatch(x2, idx, E, C)  # (1, E, C, d)
    _record((idx, probs, book[1]))
    if use_ep:
        # (E, C, d) -> tp chunks of E/tp experts: chunk j to rank j of tp;
        # rank i receives every rank's tokens for its own experts
        group = _group(mesh, tp)
        # under inference mode no autograd kernel may run (torch 2.11 then
        # finds no kernel for the autograd collective)
        a2a = all_to_all_single_autograd if torch.is_grad_enabled() else all_to_all_single
        send = disp.reshape(E, C, d)
        recv = wait_tensor(a2a(send, None, None, group))
        El = E // tp_size
        recv = recv.reshape(tp_size, El, C, d)  # (source rank, local expert, C, d)
        out = _expert_ffn(recv, wg, wu, wo, cfg)
        back = wait_tensor(a2a(out.reshape(E, C, d), None, None, group))
        y = _combine(back.reshape(1, E, C, d), book, gates)
        y = DTensor.from_local(y.reshape(Bl, Sl, d), mesh, xpl, run_check=False)
    else:
        out = _expert_ffn(disp, wg, wu, wo, cfg)  # partial over the ff shards
        y = _combine(out, book, gates).reshape(Bl, Sl, d).to(xl.dtype)
        ypl = [Partial() if names_ in tp_axes else pl
               for names_, pl in zip(mesh.mesh_dim_names, xpl)]
        y = DTensor.from_local(y, mesh, ypl, run_check=False).redistribute(mesh, xpl)
    # the aux loss needs the globally averaged f_e and P_e (a mean of
    # products over shards is not the global product): average first
    assign = F.one_hot(idx.reshape(-1), E).float().mean(0)
    f = _pmean_all(assign, mesh)
    pm = _pmean_all(probs.reshape(-1, E).mean(0), mesh)
    aux = DTensor.from_local(E * (f * pm).sum(), mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return y, aux


def apply_moe(p, x, cfg: ModelConfig, route_rows: bool = False):
    """x (B, S, d). Returns (y (B, S, d), aux): the B*S tokens route as one
    group, or with ``route_rows`` each row as a group of S tokens, and aux
    is then the mean of the rows' losses (the reference's vmap over rows,
    then a mean). ``cfg.moe_impl == "dense"`` runs every expert on every
    token; any other value (``auto``, ``dispatch``) dispatches under
    capacity, as the reference does without a mesh. The shared
    expert, where the config has one, is added to every token."""
    B, S, d = x.shape
    mesh, rules = sharding_ctx()
    if is_dtensor(x) and mesh is not None and rules is not None:
        if route_rows:
            raise NotImplementedError("route_rows (the dense batcher's step) "
                                      "runs without a mesh")
        if cfg.moe_impl == "dense":
            y, aux = _moe_dense_replicated(p, x, cfg)
        else:
            y, aux = _moe_smap(p, x, cfg, x.device_mesh, rules)
    else:
        xg = x if route_rows else x.reshape(1, B * S, d)
        impl = _moe_dense if cfg.moe_impl == "dense" else _moe_local
        y, aux = impl(p, xg, cfg)
        y, aux = y.reshape(B, S, d), aux.mean()
    if cfg.shared_expert:
        y = y + apply_mlp(p["shared"], x, cfg)
    return logical(y, "batch", "act_seq", None), aux


def _moe_dense_replicated(p, x, cfg: ModelConfig):
    """``moe_impl="dense"`` on a mesh: every rank runs every token through
    every expert, as the reference's dense path does under a mesh (XLA
    replicates what it needs)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel.local import local_call

    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    names = ("router", "w_gate", "w_up", "w_out")

    def dense(xl, *ws):
        y, aux = _moe_dense(dict(zip(names, ws)), xl.reshape(1, -1, xl.shape[-1]), cfg)
        return y.reshape(xl.shape), aux.mean()

    return local_call(dense, (x, *(p[n] for n in names)), (rep,) * 5, (rep, rep), mesh)
