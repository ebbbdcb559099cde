"""Logical-axis sharding: MaxText-style indirection between model code and
meshes (twin of ``repro.parallel.sharding``).

Model code annotates tensors with *logical* axis names ("batch", "act_seq",
"act_ff", "cache_len", ...). A ``ShardingRules`` table maps logical names to
mesh axes. Different *layouts* (cp_fsdp, tp, tp_ffn, fsdp, decode_ws) are
different rule tables, so the same model code runs under every parallelism
strategy, including none: without a context, and on a plain tensor, every
annotation is a no-op, so the meshless path is unchanged bit for bit.

Under a context an annotated tensor is a DTensor and ``logical`` is
``x.redistribute(mesh, placements)``, the placements coming from
``rules.spec(names)`` through ``parallel.layouts.placements`` (the
counterpart of ``jax.lax.with_sharding_constraint``).

``P`` stands in for ``jax.sharding.PartitionSpec``: a tuple with one entry
per tensor dimension, each ``None`` (replicated), a mesh-axis name, or a
tuple of names (the dimension sharded over several axes, major first).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


def _entry(e: MeshAxes) -> MeshAxes:
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """Partition spec: ``P("data", None)`` is ``("data", None)``. A one-axis
    tuple entry is stored as its name and an empty one as None, as JAX's
    ``PartitionSpec`` stores them."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to physical mesh axes (or None)."""

    rules: Mapping[str, MeshAxes] = field(default_factory=dict)

    def resolve(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.rules.get(name, None)

    def spec(self, names: Sequence[Optional[str]]) -> P:
        return P(*(self.resolve(n) for n in names))

    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(merged)


class _Ctx(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Optional[ShardingRules] = None


_CTX = _Ctx()


def set_sharding_ctx(mesh, rules: Optional[ShardingRules]) -> None:
    _CTX.mesh = mesh
    _CTX.rules = rules


def sharding_ctx():
    return _CTX.mesh, _CTX.rules


@contextlib.contextmanager
def use_sharding_ctx(mesh, rules: Optional[ShardingRules]):
    prev = sharding_ctx()
    set_sharding_ctx(mesh, rules)
    try:
        yield
    finally:
        set_sharding_ctx(*prev)


def is_dtensor(x: Any) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported, and
    # importing it costs seconds: a meshless process never pays it here
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def logical_placements(x: Any, *names: Optional[str], shape=None):
    """DTensor placements of ``x`` (of ``shape``, default its own) annotated
    with ``names`` (trailing dims replicated), or None outside any context.
    Dimensions that do not divide evenly stay replicated, as
    ``param_specs`` does."""
    from repro_torch.parallel.layouts import divisible, placements

    mesh, rules = sharding_ctx()
    if mesh is None or rules is None:
        return None
    shape = tuple(x.shape if shape is None else shape)
    padded = (list(names) + [None] * len(shape))[:len(shape)]
    return placements(divisible(rules.spec(padded), shape, mesh), mesh)


def split_last(x: Any, sizes: Tuple[int, ...], *names: Optional[str]) -> Any:
    """``x`` (..., prod(sizes)) reshaped to (..., *sizes). On a DTensor the
    flat dim first takes the layout ``names`` (one per dim of the result)
    give its leading split dim, so the split is even (the reference's
    XLA pads an uneven one; DTensor refuses it)."""
    shape = tuple(x.shape[:-1]) + tuple(sizes)
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        pl = logical_placements(x, *names, shape=shape)
        if pl is None:
            pl = (Replicate(),) * x.device_mesh.ndim
        if any(getattr(p, "dim", None) == len(shape) - 1 for p in pl):
            raise ValueError(f"split_last: {names} shard the last dim")
        # laid out again after the split: a no-op forward whose backward
        # brings the gradient to this layout before the reshape's backward
        return x.redistribute(x.device_mesh, pl).reshape(shape).redistribute(
            x.device_mesh, pl)
    return x.reshape(shape)


def logical(x: Any, *names: Optional[str]) -> Any:
    """Constrain an intermediate to its logical sharding: a no-op without a
    context and on a plain (non-DTensor) tensor.

    ``names`` has one entry per dim of ``x``; trailing dims may be omitted
    (treated as replicated)."""
    if not is_dtensor(x):
        return x
    pl = logical_placements(x, *names)
    if pl is None:
        return x
    return x.redistribute(x.device_mesh, pl)
