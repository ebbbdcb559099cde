"""Train step factory (twin of ``repro.launch.steps.make_train_step``):
gradient accumulation over microbatches, then one AdamW update; and the
partition specs and meta-tensor tree of a whole train state
(``opt_state_specs``, ``train_state_specs``, ``train_state_struct``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.decoder import DecoderLM
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.local import mesh_ops
from repro_torch.parallel.sharding import P, is_dtensor
from repro_torch.tree import leaves, map_tree, unflatten


def make_train_step(model: DecoderLM, opt: AdamW,
                    num_microbatches: Optional[int] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    Every leaf of the global batch (numpy or tensor: ``tokens``, or the
    audio family's ``embeds`` and ``labels``, or the vlm family's
    ``prefix_embeds`` and ``tokens``) splits on its first axis into M
    microbatches of B/M rows, as the reference's ``jax.tree.map`` does, and
    each microbatch's dict goes whole to ``model.loss``; their gradients
    accumulate in ``cfg.grad_acc_dtype`` (the f32 router of an MoE layer
    too, beside bf16 leaves) and are divided by M, and the metrics
    (``loss``, ``ce`` and the MoE ``aux``) are averaged. Params and
    optimizer state are updated in place (see ``AdamW.update``); the
    returned state holds the same tensors.

    Memory: each leaf's gradient is added to its accumulation buffer by a
    hook as soon as autograd has produced it, and then dropped, so a
    microbatch's whole gradient never exists at once; AdamW receives the
    buffers and M and casts and divides leaf by leaf. The sums keep the
    reference's order: zeros, ``acc + g.astype(acc_dt)`` per microbatch,
    then ``.astype(f32) / M``. With M = 1 the buffer is the gradient
    itself, in the param dtype."""
    cfg = model.cfg
    M = num_microbatches or cfg.num_microbatches
    acc_dt = torch_dtype(cfg.grad_acc_dtype)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        flat = leaves(params)
        mbs = {}
        for name, leaf in batch.items():
            if not is_dtensor(leaf):
                leaf = torch.as_tensor(leaf).to(flat[0].device)
            if leaf.shape[0] % M:
                raise ValueError(f"batch[{name!r}]: {leaf.shape[0]} rows do not split "
                                 f"into {M} microbatches")
            mbs[name] = _microbatches(leaf, M)
        live = [p.detach().requires_grad_(True) for p in flat]
        tree = unflatten(params, live)
        if M == 1:
            grads = [None] * len(flat)
        else:
            grads = [torch.zeros_like(p, dtype=acc_dt) for p in flat]

        def accumulate(i):
            def hook(leaf):
                g = leaf.grad
                if is_dtensor(g):  # the gradient laid out as its param
                    g = g.redistribute(flat[i].device_mesh, flat[i].placements)
                if M == 1:
                    grads[i] = g
                else:
                    grads[i].add_(g.to(acc_dt))
                leaf.grad = None
            return hook

        handles = [t.register_post_accumulate_grad_hook(accumulate(i))
                   for i, t in enumerate(live)]
        sums = None
        try:
            for i in range(M):
                loss, metrics = model.loss(tree, {name: t[i] for name, t in mbs.items()})
                with mesh_ops(loss):  # the backward meets the forward's plain tensors
                    loss.backward()
                metrics = {k: v.detach() for k, v in metrics.items()}
                sums = metrics if sums is None else {k: sums[k] + v
                                                     for k, v in metrics.items()}
        finally:
            for h in handles:
                h.remove()
        del live, tree
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = sums if M == 1 else {k: v / M for k, v in sums.items()}
        metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        opt.update(unflatten(params, grads), state["opt"], params, state["step"],
                   num_microbatches=M)
        del grads
        return {"params": params, "opt": state["opt"],
                "step": state["step"] + 1}, metrics

    return train_step


def _microbatches(leaf, M: int):
    """``leaf`` split on its first axis into M microbatches of B/M rows, a
    (M, B/M, ...) tensor or, for a DTensor, a list of M DTensors laid out
    as the leaf where B/M rows still divide its mesh axes (else
    replicated there)."""
    if not is_dtensor(leaf):
        return leaf.reshape((M, leaf.shape[0] // M) + leaf.shape[1:])
    if M == 1:
        return [leaf]
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh, full = leaf.device_mesh, leaf.full_tensor()
    b = leaf.shape[0] // M
    pl = [p if getattr(p, "dim", None) != 0 or b % mesh.size(i) == 0 else Replicate()
          for i, p in enumerate(leaf.placements)]
    return [distribute_tensor(full[i * b:(i + 1) * b], mesh, pl, src_data_rank=None)
            for i in range(M)]


# ---------------------------------------------------------------------------
# sharding-spec assembly for a whole train state


def _spec_map(fn, spec_tree):
    if isinstance(spec_tree, P):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _spec_map(fn, v) for k, v in spec_tree.items()}
    return [_spec_map(fn, v) for v in spec_tree]


def opt_state_specs(param_spec_tree, opt: AdamW):
    """Mirror param partition specs onto AdamW moment state: an int8
    moment's scale (..., 1) replicates its last dim."""
    if opt.moments_dtype == "int8":
        def mom(ps):
            ts = tuple(ps)
            return {"q": ps, "s": P(*ts[:-1], None) if ts else P(None)}
    else:
        def mom(ps):
            return ps
    m = _spec_map(mom, param_spec_tree)
    out = {"m": m, "v": m}
    if opt.error_feedback:
        out["ef"] = param_spec_tree
    return out


def train_state_specs(param_spec_tree, opt: AdamW):
    return {
        "params": param_spec_tree,
        "opt": opt_state_specs(param_spec_tree, opt),
        "step": P(),
    }


def train_state_struct(model: DecoderLM, opt: AdamW):
    """The train state on the ``meta`` device, built by the constructor the
    live path uses (``opt.init_state``: int8 moments with their scales,
    error-feedback residuals); the step is an int32 scalar, as the
    reference's."""
    state = opt.init_state(model.init_shape())
    state["step"] = torch.empty((), dtype=torch.int32, device="meta")
    return state


def grad_acc_struct(model: DecoderLM, num_microbatches: Optional[int] = None):
    """The accumulation buffers ``make_train_step`` allocates for M > 1
    (one per param leaf, in ``cfg.grad_acc_dtype``), on ``meta``; an empty
    dict for M = 1, where the gradient itself is the buffer."""
    cfg = model.cfg
    if (num_microbatches or cfg.num_microbatches) == 1:
        return {}
    acc_dt = torch_dtype(cfg.grad_acc_dtype)
    return map_tree(lambda _, p: torch.empty(p.shape, dtype=acc_dt, device="meta"),
                    model.init_shape())
