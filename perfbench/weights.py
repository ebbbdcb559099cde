"""Seeded weights made on the device in a few large calls.

The layout (names, shapes, dtypes) is the program's parameter tree, read
from its ``meta`` init; the numbers are the benchmark's own: one buffer a
dtype, filled by a ``torch.Generator`` on the device in chunks, then each
leaf, a view of it, scaled in place to the size of the program's init
(products 1/sqrt(fan in), the embedding 1/sqrt(d)). Norm scales are drawn
around 1 and biases around 0, so that no term of the reference is
trivially equal to its neighbour's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

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
            if name == "scale":
                leaf.mul_(0.1).add_(1.0)
            elif t.dim() == 1:  # norm and projection biases
                leaf.mul_(0.02)
            elif name == "embed":
                leaf.mul_(t.shape[-1] ** -0.5)
            else:  # (fan_in, out) or (experts, fan_in, out)
                leaf.mul_(t.shape[-2] ** -0.5)
            made[path] = leaf
    return _rebuild(shape_tree, made)
