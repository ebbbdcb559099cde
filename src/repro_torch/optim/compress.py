"""Rowwise int8 quantization and error-feedback gradient compression (twin
of ``repro.optim.compress``).

scale = max|x| over the last dim / 127 (shape (..., 1) f32);
q = round(x / scale) clipped to +-127, int8. ``torch.round`` rounds half to
even, as ``jnp.round`` does; a truncating cast would not.
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree, unflatten


def quantize_int8(x, reduce_amax=None):
    """``reduce_amax``, where given, takes each row's local max in place and
    makes it the max over the row's shards (a last dim split over ranks)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce_amax is not None:
        reduce_amax(amax)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def error_feedback_compress(grads, residual):
    """Error-feedback int8 compression (1-bit-Adam style, 8-bit variant).

    Returns (decompressed grads, new residual), trees shaped like
    ``grads``: the decompressed grads are what a compressed all-reduce
    would deliver, and the quantization error is carried into the next
    step, so the compression is unbiased over time."""
    outs = []
    for g, r in zip(leaves(grads), leaves(residual)):
        gf = g.float() + r
        deq = dequantize_int8(*quantize_int8(gf))
        outs.append((deq, gf - deq))
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def init_residual(params):
    return map_tree(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
