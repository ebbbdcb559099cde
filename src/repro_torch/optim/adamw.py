"""AdamW with f32 or int8-quantized moments (twin of
``repro.optim.adamw``).

``moments_dtype="int8"`` stores m and v rowwise-quantized (8-bit-Adam
style): 4 bytes of optimizer state per parameter instead of 8.

The update runs leaf by leaf, and a large leaf in slices of rows, and
writes params and moments in place, so it never holds an f32 copy of all
parameters, or of a whole large leaf, at once (rwkv6-3b has 3.1 B, one
jamba block 9.0 B).

Weight decay follows the reference's rule on the reference's layout. The
reference stacks every layer leaf over blocks (a leading ``n_blocks``
axis) and decays each leaf whose stacked array has ``ndim >= 2``; so every
per-layer leaf is decayed, 1-D norm scales, biases, ``maa_*`` and ``ln_x``
included, and only top-level 1-D leaves (``ln0``, ``final_norm``) are not.
The port keeps one dict per layer under ``params["layers"]``; a leaf there
counts one more dimension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.optim.compress import (dequantize_int8, error_feedback_compress,
                                        init_residual, quantize_int8)
from repro_torch.tree import get, leaves, leaves_with_paths, map_tree

TrainState = Dict[str, Any]  # {"params": ..., "opt": ..., "step": int}


def decays(path, p) -> bool:
    """The reference's rule, ``ndim >= 2`` of the stacked leaf."""
    stacked = p.ndim + (1 if path and path[0] == "layers" else 0)
    return stacked >= 2


@dataclass(frozen=True)
class AdamW:
    lr: Callable  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moments_dtype: str = "float32"  # float32|int8
    grad_clip: float = 1.0
    # error-feedback int8 gradient compression: grads are quantized before
    # the moment update and the quantization error is re-injected next step
    error_feedback: bool = False

    # ----------------------------------------------------------------- state

    def _moment_zero(self, _, p):
        if self.moments_dtype == "int8":
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "s": torch.zeros(p.shape[:-1] + (1,) if p.ndim else (1,),
                                     dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(self, params):
        opt = {"m": map_tree(self._moment_zero, params),
               "v": map_tree(self._moment_zero, params)}
        if self.error_feedback:
            opt["ef"] = init_residual(params)
        return opt

    def init_state(self, params) -> TrainState:
        return {"params": params, "opt": self.init(params), "step": 0}

    # ---------------------------------------------------------------- update

    def _load(self, mom):
        if self.moments_dtype == "int8":
            return dequantize_int8(mom["q"], mom["s"])
        return mom

    def _store(self, mom, val):
        if self.moments_dtype == "int8":
            q, s = quantize_int8(val)
            mom["q"].copy_(q)
            mom["s"].copy_(s)
        else:
            mom.copy_(val)

    @torch.no_grad()
    def update(self, grads, opt_state, params, step: int, *,
               num_microbatches: int = 1):
        """Returns (params, opt_state), both updated in place.

        ``grads`` may hold any float dtype (the train step hands over its
        accumulation buffers): each leaf is cast to f32 and divided by
        ``num_microbatches`` where it is read, as the reference's
        ``g.astype(f32) / M``, so no f32 copy of every gradient is made.
        A leaf is updated in slices of whole rows, so its f32 temporaries
        stay small (a row's int8 scale is the row's own); the result is the
        same as one pass over the leaf."""
        M = num_microbatches

        def as_f32(g):
            return g.float() / M if M > 1 else g.float()

        if self.error_feedback:
            grads, new_ef = error_feedback_compress(map_tree(lambda _, g: as_f32(g), grads),
                                                    opt_state["ef"])
            for r, nr in zip(leaves(opt_state["ef"]), leaves(new_ef)):
                r.copy_(nr)
            del new_ef
            M = 1
        f32 = np.float32
        count = f32(step) + f32(1)
        lr = self.lr(step)
        c1 = float(f32(1) - f32(self.b1) ** count)
        c2 = float(f32(1) - f32(self.b2) ** count)

        gl = leaves(grads)
        if self.grad_clip and self.grad_clip > 0:  # global-norm clip in f32
            gnorm = torch.sqrt(sum(torch.sum(torch.square(as_f32(g))) for g in gl))
            clip = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        else:
            clip = 1.0

        for (path, p), g in zip(leaves_with_paths(params), gl):
            m, v = get(opt_state["m"], path), get(opt_state["v"], path)
            wd = decays(path, p)
            for rows in _row_slices(p):
                self._update_rows(p[rows], as_f32(g[rows]) * clip, self._slice(m, rows),
                                  self._slice(v, rows), lr, c1, c2, wd)
        return params, opt_state

    def _slice(self, mom, rows):
        if self.moments_dtype == "int8":
            return {"q": mom["q"][rows], "s": mom["s"][rows]}
        return mom[rows]

    def _update_rows(self, p, gf, m, v, lr, c1, c2, wd: bool):
        mf = self.b1 * self._load(m) + (1 - self.b1) * gf
        vf = self.b2 * self._load(v) + (1 - self.b2) * torch.square(gf)
        del gf
        upd = (mf / c1) / (torch.sqrt(vf / c2) + self.eps)
        if wd:
            upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        self._store(m, mf)
        self._store(v, vf)


SLICE_ELEMENTS = 1 << 25  # f32 temporaries of 128 MB per slice


def _row_slices(p):
    """Slices of ``p``'s leading dimension, whole rows of the last dimension
    each, about ``SLICE_ELEMENTS`` elements apiece; a leaf of fewer than two
    dimensions is one slice."""
    if p.ndim < 2 or p.numel() <= SLICE_ELEMENTS:
        return [...]
    step = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]
