"""Meshes over any subset of the default group's ranks, each rank set's
process group made once.

``DeviceMesh(kind, ranks)`` makes new groups every time it is called. On
NCCL with a bound device it splits them from the default communicator and
names each by a hash of its ranks, so meshes with groups over the same
ranks (an elastic rescale from (2, 2) to 2 ranks and back) put more than
one group under one name: an elastic 4 -> 2 -> 4 run on four NCCL ranks
hung in the second collective of such a group. ``mesh_over`` makes each
rank set's group once per default group, with ``new_group`` (a fresh name,
connected when made, on every rank in the same order), and lays the mesh
over those groups with ``DeviceMesh.from_group``. A rank set that is the
whole world takes the default group, as ``DeviceMesh`` does. Every mesh
of the port is built here: ``launch.mesh``'s and the elastic trainer's.
"""

from __future__ import annotations

from typing import Sequence

import torch

_CACHE: dict = {"world": None, "groups": {}}


def _group(ranks: tuple):
    """The process group over ``ranks`` (``GroupMember.NON_GROUP_MEMBER``
    on a rank outside it). Collective over the default group the first time
    a rank set is asked for."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _get_default_group

    world = _get_default_group()
    if _CACHE["world"] is not world:
        _CACHE["world"], _CACHE["groups"] = world, {}
    groups = _CACHE["groups"]
    if ranks not in groups:
        if list(ranks) == list(range(dist.get_world_size())):
            groups[ranks] = world
        else:
            groups[ranks] = dist.new_group(list(ranks),
                                           device_id=getattr(world, "bound_device_id", None))
    return groups[ranks]


def mesh_over(kind: str, ranks: torch.Tensor, names: Sequence[str]):
    """A ``DeviceMesh`` of device type ``kind`` laid out as ``ranks`` (an
    integer tensor of global ranks, one dim per name in ``names``), or None
    on a rank that is not in ``ranks``. Every rank of the default group
    calls it with the same arguments."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    me = dist.get_rank()
    mine: list = []
    for dim in range(ranks.dim()):
        along = ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim])
        for row in along.tolist():
            g = _group(tuple(row))
            if me in row:
                mine.append(g)
    if len(mine) != ranks.dim():
        return None
    return DeviceMesh.from_group(mine, kind, mesh=ranks, mesh_dim_names=tuple(names))

