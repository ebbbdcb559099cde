"""Ranks of a process group started from one process: gloo ranks on the
host's CPU, the port's counterpart of the reference's forced host devices
(``--xla_force_host_platform_device_count``), or NCCL ranks, one a card.

``Ranks(fn, n, args)`` starts ``n`` processes (``spawn``), joins them in
one group through a ``FileStore`` (so concurrent groups never share a
port), calls ``fn(rank, *args)`` on each, on one torch thread a rank, and
collects what each returns; ``results()`` waits for all of them and raises
with a rank's traceback if one failed. A collective that waits longer than
``timeout_s`` fails, so a rank that died cannot hang the others. ``fn`` and
``args`` must pickle (``fn`` a module-level function). With
``backend="nccl"`` rank r runs on card r.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _rank_main(rank: int, n: int, store_path: str, fn, args, timeout_s: float, out,
               backend: str):
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)  # n ranks share the host's cores
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", rank)
            torch.cuda.set_device(kw["device_id"])
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
        # the outcome goes to the parent before the group is torn down: a
        # rank that failed while its peers wait in a collective would else
        # wait in ``destroy_process_group`` and never report
        try:
            out.put((rank, "ok", fn(rank, *args)))
        except BaseException:  # noqa: BLE001 -- reported to the parent
            out.put((rank, "error", traceback.format_exc()))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        out.put((rank, "error", traceback.format_exc()))


class Ranks:
    def __init__(self, fn: Callable, n: int, args: Sequence[Any] = (), *,
                 store_dir: Optional[str] = None, timeout_s: float = 600.0,
                 backend: str = "gloo"):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        store_dir = store_dir or tempfile.mkdtemp(prefix="ranks_")
        store = os.path.join(str(store_dir), "store")
        self.n = n
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, store, fn, tuple(args), timeout_s,
                                         self._out, backend))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self._results: Optional[List[Any]] = None

    def results(self, timeout: Optional[float] = None) -> List[Any]:
        """Every rank's return value, by rank."""
        if self._results is not None:
            return self._results
        got = {}
        try:
            while len(got) < self.n:
                rank, status, value = self._out.get(timeout=timeout)
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        except queue.Empty:
            raise TimeoutError(f"{self.n - len(got)} of {self.n} ranks did not "
                               f"finish in {timeout} s") from None
        finally:
            self.close()
        self._results = [got[r] for r in range(self.n)]
        return self._results

    def close(self):
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join()


def run_ranks(fn: Callable, n: int, args: Sequence[Any] = (), **kw) -> List[Any]:
    return Ranks(fn, n, args, **kw).results()
