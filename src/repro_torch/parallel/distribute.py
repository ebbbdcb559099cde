"""Lay a tree of full tensors out as DTensors, and back.

``distribute_tree`` cuts each leaf's local shard out of the full tensor that
every rank holds (``distribute_tensor(..., src_data_rank=None)``: no
communication, so a tree built from one seed on every rank, or on the
``meta`` device, lays out exactly). ``full_tree`` gathers every leaf back.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import is_dtensor


def distribute_tree(tree, shardings):
    """``tree``'s tensors as DTensors laid out by ``shardings``, a tree of
    ``layouts.NamedSharding`` (``layouts.to_shardings``); other leaves
    (ints) stay as they are. A tensor moves to the mesh's device type
    first."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, s) for v, s in zip(tree, shardings)]
    if not hasattr(tree, "shape"):
        return tree
    mesh = shardings.mesh
    t = tree.detach()
    if t.device.type not in ("meta", mesh.device_type):
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, list(shardings.placements), src_data_rank=None)


def full_tree(tree):
    """Every DTensor leaf gathered into a plain full tensor."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [full_tree(v) for v in tree]
    return tree.full_tensor() if is_dtensor(tree) else tree
