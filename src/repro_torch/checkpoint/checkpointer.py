"""Async, atomic checkpointing of a train state (twin of
``repro.checkpoint.checkpointer``).

  * atomic commit: writes go to ``<dir>/tmp.<step>`` and are published
    with one ``os.replace`` to ``<dir>/step_<k>``; a crash mid-write never
    corrupts the latest checkpoint;
  * async: the host copy is taken on the caller's thread (so a train step
    that updates the state in place cannot race the writer), the
    serialization runs on a writer thread, and its error surfaces on the
    next ``wait()`` (called before every save and restore);
  * rolling retention: the newest ``keep`` checkpoints stay;
  * restore into a template: the tree of the state to rebuild, whose
    leaves may be tensors on any device (or on ``meta``) or ints; the
    arrays land on ``device`` (default: each template leaf's own);
  * self-describing: leaves are keyed by their ``/``-joined tree path in
    one ``.npz``, with each leaf's dtype in ``meta.json``. numpy has no
    bfloat16, so a bf16 tensor is stored as its ``uint16`` bits;
  * meshes: a state of DTensors is saved as full tensors (every rank of
    the mesh gathers each leaf; the mesh's first rank writes), and
    ``restore(..., shardings=)`` lays each leaf out on the current mesh,
    whatever mesh wrote it. A blocking save and a restore on a mesh end
    and start with the mesh's ranks in step, so no rank reads a
    checkpoint before it is written.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import key, get, leaves_with_paths, unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int32": torch.int32, "int64": torch.int64}


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf, always a copy."""
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64), "int"
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"cannot checkpoint dtype {t.dtype}")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state, *, blocking: bool = False):
        self.wait()
        host, dtypes = {}, {}
        mesh = None
        for path, leaf in leaves_with_paths(state):
            if is_dtensor(leaf):
                mesh = leaf.device_mesh
                leaf = leaf.full_tensor()
            host[key(path)], dtypes[key(path)] = _to_host(leaf)
        meta = {"step": int(step), "keys": sorted(host), "dtypes": dtypes}
        if mesh is not None and not _writes(mesh):
            if blocking:
                _in_step(mesh)
            return

        def write():
            try:
                tmp = self.dir / f"tmp.{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz", **host)
                (tmp / "meta.json").write_text(json.dumps(meta))
                final = self.dir / f"step_{step:08d}"
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # noqa: BLE001 -- surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
            if mesh is not None:
                _in_step(mesh)
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None,
                shardings=None):
        """Returns (state shaped like ``template``, step). ``shardings``, a
        tree of ``parallel.layouts.NamedSharding`` over the state's tensor
        leaves (``to_shardings`` of ``train_state_specs``), lays each leaf
        out as a DTensor on its mesh."""
        self.wait()
        if shardings is not None:
            _in_step(_any_mesh(shardings))
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "meta.json").read_text())
        values = []
        with np.load(d / "arrays.npz") as arrays:
            for path, tmpl in leaves_with_paths(template):
                k = key(path)
                arr, name = arrays[k], meta["dtypes"][k]
                if name == "int":
                    values.append(int(arr))
                    continue
                if name == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
                    raise ValueError(f"{k}: checkpoint has {t.dtype}{tuple(t.shape)}, "
                                     f"template {tmpl.dtype}{tuple(tmpl.shape)}")
                if shardings is not None:
                    from repro_torch.parallel.distribute import distribute_tree

                    values.append(distribute_tree(t, get(shardings, path)))
                    continue
                target = tmpl.device if device is None else torch.device(device)
                if target.type == "meta":
                    raise ValueError(f"{k}: a meta template needs a device")
                values.append(t.to(target))
        return unflatten(template, values), step


def _writes(mesh) -> bool:
    """Whether this rank writes a mesh's checkpoints: the mesh's first."""
    import torch.distributed as dist

    return int(mesh.mesh.flatten()[0]) == dist.get_rank()


def _in_step(mesh) -> None:
    """Return on every rank of ``mesh`` only once all have arrived (an
    all-reduce over every mesh dim, read back on the host: on NCCL the
    all-reduce alone returns before the others arrive)."""
    from torch.distributed.tensor import DTensor, Partial

    z = torch.zeros(1, device=mesh.device_type)
    DTensor.from_local(z, mesh, [Partial()] * mesh.ndim, run_check=False).full_tensor().item()


def _any_mesh(shardings):
    for _, sh in leaves_with_paths(shardings):
        if hasattr(sh, "mesh"):
            return sh.mesh
    raise ValueError("shardings holds no NamedSharding")
