"""Local shards at the kernel call sites.

The CUDA kernels are bound through ``ctypes`` and read ``data_ptr()``; a
DTensor is a wrapper with no storage of its own, and no dispatch mode sees a
ctypes call. So every op that reaches a kernel runs on local shards:
``local_call`` redistributes each DTensor argument to the placements the op
needs, hands the op its local tensors (``to_local``), and wraps the op's
outputs back (``DTensor.from_local``), the counterpart of a ``shard_map``
region (and of ``torch.distributed.tensor.experimental.local_map``, with
the gradient placements of each input given explicitly).

An input that is replicated over a mesh dim on which the op's other inputs
are split, other than along the batch, receives a different gradient on
each rank of that dim: its ``grad_placements`` there are ``Partial()``, and
the sum over the dim happens when the gradient is redistributed.

``mesh_ops(x)`` is the context every model entry takes when ``x`` is a
DTensor or a sharding context is set: a plain tensor made inside the model
(positions, masks, zeros) or passed in whole then counts as replicated on
the mesh (``implicit_replication``). Otherwise it does nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

from repro_torch.parallel.sharding import is_dtensor, sharding_ctx


def mesh_ops(x=None):
    if not (is_dtensor(x) or sharding_ctx()[0] is not None):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, but
    nestable: leaving it restores the setting found on entry (the library's
    turns it off, which ends an enclosing one too)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def local_offset(shape, mesh, placements, dim: int) -> int:
    """Global index of this rank's first element along ``dim`` of a tensor
    of global ``shape`` laid out with ``placements``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return int(compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     tuple(placements))[1][dim])


def local_call(fn: Callable, args: Sequence, in_placements: Sequence,
               out_placements: Sequence, mesh, grad_placements: Optional[Sequence] = None):
    """``fn`` on the local shards of ``args``. ``in_placements[i]`` is the
    placements ``args[i]`` is redistributed to (None: the argument is passed
    as it is, e.g. a Python number); ``out_placements[j]`` those of ``fn``'s
    j-th output (None: returned as it is). Returns a tuple."""
    from torch.distributed.tensor import DTensor

    grad_placements = grad_placements or [None] * len(args)
    local = []
    for a, pl, gpl in zip(args, in_placements, grad_placements):
        if pl is None:
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [_replicate()] * mesh.ndim, run_check=False)
        a = a.redistribute(mesh, tuple(pl))
        local.append(a.to_local(grad_placements=tuple(gpl) if gpl is not None else None))
    outs = fn(*local)
    if not isinstance(outs, tuple):
        outs = (outs,)
    return tuple(o if pl is None else DTensor.from_local(o, mesh, tuple(pl), run_check=False)
                 for o, pl in zip(outs, out_placements))


def dense(x, w):
    """``x @ w`` for x (..., d) and a 2-D weight w (d, f). On a mesh the
    product runs on local shards (``local_call``) with placements decided
    here, mesh dim by mesh dim, as FSDP and Megatron lay a linear layer out:

      * x split on a leading dim: w whole there (gathered), the output split
        as x, w's gradient a partial sum;
      * x split on d: w split on its rows there (row parallel), the output a
        partial sum;
      * x whole and w stored split on its columns: w kept so (column
        parallel), the output split on f, x's gradient a partial sum;
      * otherwise w whole and the output whole.

    Every weight product of the models goes through it (attention, the MLP
    and the MoE router, Mamba, RWKV-6, the unembedding), so one rule lays
    them all out. DTensor's own matmul picks among such layouts by a cost
    that depends on the sizes, so a full-width step can get a partial
    gradient where its smoke-size twin gets a split one; torch 2.11 then
    fails to add it to a split one, and refuses to flatten a batch and a
    sequence that are both split."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (x if is_dtensor(x) else w).device_mesh
    rep = (Replicate(),) * mesh.ndim
    xst = tuple(x.placements) if is_dtensor(x) else rep
    wst = tuple(w.placements) if is_dtensor(w) else rep
    last = x.dim() - 1
    xpl, wpl, opl, xg, wg = [], [], [], [], []
    for xp, wp in zip(xst, wst):
        xd = getattr(xp, "dim", None)
        if xd is not None and xd < last:
            row = (xp, Replicate(), xp, xp, Partial())
        elif xd == last:
            row = (xp, Shard(0), Partial(), xp, Shard(0))
        elif getattr(wp, "dim", None) == 1:
            row = (Replicate(), Shard(1), Shard(last), Partial(), Shard(1))
        else:  # x whole (a partial x is reduced first)
            row = (Replicate(),) * 5
        for out, p in zip((xpl, wpl, opl, xg, wg), row):
            out.append(p)
    (y,) = local_call(lambda xl, wl: xl @ wl, (x, w), (xpl, wpl), (opl,), mesh,
                      grad_placements=(xg, wg))
    return y


def partial_where_split(pl_self, pl_others):
    """Gradient placements of an input laid out with ``pl_self``: Partial on
    every mesh dim where it is replicated and some other input is split."""
    from torch.distributed.tensor import Partial, Replicate

    out = []
    for i, p in enumerate(pl_self):
        split = any(o[i] != Replicate() for o in pl_others)
        out.append(Partial() if p == Replicate() and split else p)
    return tuple(out)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()
