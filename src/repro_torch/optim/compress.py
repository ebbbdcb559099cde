"""Rowwise int8 quantization (twin of ``repro.optim.compress``).

scale = max|x| over the last dim / 127 (shape (..., 1) f32);
q = round(x / scale) clipped to +-127, int8. ``torch.round`` rounds half to
even, as ``jnp.round`` does; a truncating cast would not.
"""

from __future__ import annotations

import torch


def quantize_int8(x):
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale
