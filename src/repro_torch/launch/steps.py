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

    The global batch (``batch["tokens"]``, (B, S), numpy or tensor) splits
    into M microbatches of B/M rows; their gradients accumulate in
    ``cfg.grad_acc_dtype`` and are divided by M, and the metrics are
    averaged. Params and optimizer state are updated in place (see
    ``AdamW.update``); the returned state holds the same tensors."""
    cfg = model.cfg
    M = num_microbatches or cfg.num_microbatches
    acc_dt = torch_dtype(cfg.grad_acc_dtype)

    def grads_of(params, flat, tokens):
        live = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = model.loss(unflatten(params, live), {"tokens": tokens})
        grads = torch.autograd.grad(loss, live)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        flat = leaves(params)
        tokens = torch.as_tensor(batch["tokens"]).to(flat[0].device)
        if tokens.shape[0] % M:
            raise ValueError(f"global batch {tokens.shape[0]} does not split into "
                             f"{M} microbatches")
        if M == 1:
            metrics, grads = grads_of(params, flat, tokens)
            grads = [g.float() for g in grads]
        else:
            gacc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in flat]
            sums = None
            for mb in tokens.reshape((M, tokens.shape[0] // M) + tokens.shape[1:]):
                metrics, grads = grads_of(params, flat, mb)
                for a, g in zip(gacc, grads):
                    a.add_(g.to(acc_dt))
                del grads
                sums = metrics if sums is None else {k: sums[k] + v
                                                     for k, v in metrics.items()}
            grads = [a.float().div_(M) for a in gacc]
            del gacc
            metrics = {k: v / M for k, v in sums.items()}
        opt.update(unflatten(params, grads), state["opt"], params, state["step"])
        del grads
        return {"params": params, "opt": state["opt"],
                "step": state["step"] + 1}, metrics

    return train_step
