"""Build the port's CUDA sources and load them with ``ctypes``.

Every ``src/repro_torch/csrc/*.cu`` is compiled on first use into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

All sources build in parallel, one ``nvcc`` each. A library is named by the
hash of its source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one is reused. ``ptxas -v`` (registers, shared
memory, spills) is kept beside each library in ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built with it at first use")


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all at once; returns
    ``{stem: library path}``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for src in sources():
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        pending.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in pending:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(text)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{text.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src.stem: library_path(src) for src in sources()}


def lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building all sources on the
    first call."""
    with _LOCK:
        if stem not in _LIBS:
            paths = build_all()
            handle = ctypes.CDLL(str(paths[stem]))
            handle.repro_error_string.argtypes = [ctypes.c_int]
            handle.repro_error_string.restype = ctypes.c_char_p
            _LIBS[stem] = handle
        return _LIBS[stem]


HEAD_DIMS = (32, 64, 128, 256)  # the kernels are instantiated for these
_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.int8": 2}


def dtype_code(t) -> int:
    """The C side's ``ReproDtype`` of a tensor (f32 0, bf16 1, int8 2)."""
    code = _DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"unsupported dtype {t.dtype}")
    return code


def rows_ok(t) -> bool:
    """Whether the kernels can read ``t``'s rows of ``hd`` elements with
    16-byte vector loads: unit last stride, every other stride a whole
    number of vectors, and a 16-byte aligned base."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % vec for s, n in zip(t.stride()[:-1], t.shape[:-1])
                        if n > 1))


def check_rows(t, name: str) -> None:
    if not rows_ok(t):
        raise ValueError(f"{name}: strides {t.stride()} / base not aligned to "
                         f"16-byte rows (need a unit last stride)")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans' input)."""
    return _sm_count(device.index if device.index is not None else 0)


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(handle: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs
    and ``torch.cuda.synchronize`` would not report it)."""
    if err != 0:
        text = handle.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
