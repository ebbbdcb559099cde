"""Train step factory (twin of ``repro.launch.steps.make_train_step``):
gradient accumulation over microbatches, then one AdamW update.

The reference's sharding-spec helpers (``opt_state_specs``,
``train_state_specs``) are mesh tooling and are not ported (ROADMAP
Queue A, item 11).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.decoder import DecoderLM
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, unflatten


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
            leaf = torch.as_tensor(leaf).to(flat[0].device)
            if leaf.shape[0] % M:
                raise ValueError(f"batch[{name!r}]: {leaf.shape[0]} rows do not split "
                                 f"into {M} microbatches")
            mbs[name] = leaf.reshape((M, leaf.shape[0] // M) + leaf.shape[1:])
        live = [p.detach().requires_grad_(True) for p in flat]
        tree = unflatten(params, live)
        if M == 1:
            grads = [None] * len(flat)
        else:
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in flat]

        def accumulate(i):
            def hook(leaf):
                if M == 1:
                    grads[i] = leaf.grad
                else:
                    grads[i].add_(leaf.grad.to(acc_dt))
                leaf.grad = None
            return hook

        handles = [t.register_post_accumulate_grad_hook(accumulate(i))
                   for i, t in enumerate(live)]
        sums = None
        try:
            for i in range(M):
                loss, metrics = model.loss(tree, {name: t[i] for name, t in mbs.items()})
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
        opt.update(unflatten(params, grads), state["opt"], params, state["step"],
                   num_microbatches=M)
        del grads
        return {"params": params, "opt": state["opt"],
                "step": state["step"] + 1}, metrics

    return train_step
