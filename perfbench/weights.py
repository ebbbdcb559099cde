"""Seeded weights made on the device in a few large calls.

The layout (names, shapes, dtypes) is the program's parameter tree, read
from its ``meta`` init; the numbers are the benchmark's own: one buffer a
dtype, filled by a ``torch.Generator`` on the device in chunks, then each
leaf, a view of it, scaled in place to the size of the program's init
(products 1/sqrt(fan in), the embedding 1/sqrt(d)). Norm scales are drawn
around 1 and biases around 0, so that no term of the reference is
trivially equal to its neighbour's.

A Mamba mixer's own leaves are drawn in its published init's ranges, so
that the state carries weight from token to token: ``A_log`` about
log(1..d_state) a channel (S4D-real, N(0, 0.1) about it), ``D`` about 1,
``dt_bias`` the inverse softplus of a dt log-uniform in [1e-3, 1e-1] (the
uniform taken from the normal drawn, through its CDF), and the inner norms
``dt_norm``, ``b_norm``, ``c_norm`` as scales. No draw is added or moved:
a tree without these leaves gets the same numbers as before them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORM_SCALES = ("scale", "dt_norm", "b_norm", "c_norm")
DT_RANGE = (1e-3, 1e-1)  # Mamba's dt init, log-uniform

CHUNK = 1 << 28  # elements a generator call
ALIGN = 128  # elements: every leaf starts on a 256-byte boundary in bf16


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, made: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, made, path + (i,)) for i, v in enumerate(tree)]
    return made[path]


def make(shape_tree, seed: int, device) -> dict:
    """A tree shaped as ``shape_tree`` (meta tensors) with seeded values on
    ``device``."""
    leaves = _leaves(shape_tree)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    made: Dict[tuple, torch.Tensor] = {}
    for dtype in sorted({t.dtype for _, t in leaves}, key=str):
        group = [(p, t) for p, t in leaves if t.dtype == dtype]
        offsets, total = [], 0
        for _, t in group:
            offsets.append(total)
            total += -(-t.numel() // ALIGN) * ALIGN
        buf = torch.empty(total, dtype=dtype, device=device)
        for i in range(0, total, CHUNK):
            buf[i:i + CHUNK].normal_(generator=gen)
        for (path, t), off in zip(group, offsets):
            leaf = buf[off:off + t.numel()].view(t.shape)
            name = path[-1]
            if name in NORM_SCALES or name == "D":
                leaf.mul_(0.1).add_(1.0)
            elif name == "A_log":  # (d_inner, d_state)
                n = t.shape[-1]
                leaf.mul_(0.1).add_(torch.log(torch.arange(
                    1, n + 1, dtype=leaf.dtype, device=leaf.device)))
            elif name == "dt_bias":
                lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
                dt = torch.exp(lo + (hi - lo) * torch.special.ndtr(leaf.float()))
                leaf.copy_(torch.log(torch.expm1(dt)))
            elif t.dim() == 1:  # norm and projection biases
                leaf.mul_(0.02)
            elif name == "embed":
                leaf.mul_(t.shape[-1] ** -0.5)
            else:  # (fan_in, out) or (experts, fan_in, out)
                leaf.mul_(t.shape[-2] ** -0.5)
            made[path] = leaf
    return _rebuild(shape_tree, made)
