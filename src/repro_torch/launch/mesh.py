"""Production and smoke meshes (twin of ``repro.launch.mesh``). Importing
this module touches no process group; the functions are called only by
launchers and tests.

Single pod:  (16, 16)    = 256 ranks, axes ("data", "model").
Multi-pod:   (2, 16, 16) = 512 ranks, axes ("pod", "data", "model");
             the "pod" axis carries only data-parallel gradient reduction.

``make_production_mesh`` needs a default process group of 256 or 512 ranks:
the dry-run builds it under the ``"fake"`` process group of
``torch.testing._internal.distributed.fake_pg`` in a process of its own.
``make_smoke_mesh`` builds the small meshes of the tests (gloo ranks on the
CPU) and of the card (one NCCL rank). ``production_shape`` gives the
production meshes' names and sizes without any rank, which is all the
layout code reads (``repro_torch.parallel.layouts.MeshShape``).
"""

from __future__ import annotations

import math

from repro_torch.parallel.layouts import MeshShape


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_mesh(device_type: str, shape, axes):
    import torch.distributed as dist

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"need an initialised process group of >= {n} ranks "
                           f"for a {tuple(shape)} mesh")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"need {n} ranks, have {world}")
    import torch

    from repro_torch.parallel.groups import mesh_over

    return mesh_over(device_type, torch.arange(n).reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False):
    ms = production_shape(multi_pod=multi_pod)
    return _device_mesh("cpu", ms.sizes, ms.axis_names)


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cpu"):
    """Small mesh over the first ``prod(shape)`` ranks of the default
    group: gloo ranks on the CPU (``device_type="cpu"``), or NCCL ranks
    on the card (``"cuda"``)."""
    return _device_mesh(device_type, shape, axes)
