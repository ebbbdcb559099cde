"""Device resolution for the port's entry points.

Entry points default to ``cuda``; asking for it on a machine without a card
raises instead of silently running on the CPU. Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """``ModelConfig`` dtype string -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]
