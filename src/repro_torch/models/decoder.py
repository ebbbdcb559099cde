"""Decoder LM for attention, RWKV-6 and Mamba/attention hybrid stacks (twin
of ``repro.models.decoder``).

The reference scans over parameter-stacked blocks; the port keeps the same
block structure (``block_structure``) but stores one params dict per layer
and runs the layers as a Python loop, in the reference's order (block i,
position j is layer ``i * block_size + j``).

Params: ``{"embed": (V, d), ["lm_head": (d, V)], ["ln0": {...}],
"final_norm": {...}, "layers": [...]}``; an attention layer is ``{"norm1",
"norm2", "attn", "mlp", ["norm1_post", "norm2_post"]}``, a Mamba layer
``{"norm1", "norm2", "mamba", "mlp"}``, an RWKV layer ``{"norm1", "norm2",
"tm", "cm"}`` (time-mix and channel-mix, no MLP), and a stack with RWKV
layers normalises its embeddings with ``ln0``. Params come
either from the reference's weights (``repro_torch.convert.params_from_jax``)
or from the port's own seeded ``init``.

Four modes share one layer body: ``train`` (``forward``/``loss``: the full
sequence, no caches, each block under ``torch.utils.checkpoint`` when
``cfg.remat == "full"``; attention layers through the differentiable flash
op, Mamba layers through the differentiable selective scan),
``prefill`` (returns per-layer caches), ``decode`` (dense cache, one token
per row, per-row positions) and ``decode_paged`` (paged pools + page
table). An RWKV layer's cache is its state ``{"shift_tm", "shift_cm",
"wkv"}``, a Mamba layer's ``{"conv", "ssm"}``; decode updates both in
place. Neither has a position, so a stack with either takes neither the
paged layout nor a bucketed (``true_len``) prefill, and raises there as the
reference does. MoE MLPs are not ported: a config with MoE layers
(``moe_period > 0``) raises at construction, so jamba-1.5-large-398b runs
as ``replace(moe_period=0, num_experts=0, experts_per_token=0)``, every MoE
FFN a dense SwiGLU of the published ``d_ff``, which is what the reference
builds for that config.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models import rwkv as R
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm, softcap)
from repro_torch.models.config import ModelConfig, block_structure


class DecoderLM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False):
        """``plain=True`` runs attention through the model-level plain
        PyTorch math and the WKV and selective scans through their plain
        versions, on any device (the yardstick for the kernel path)."""
        unported = sorted(set(cfg.mixer_pattern) - {"attn", "rwkv", "mamba"})
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: mixers {unported} are not ported; the port "
                f"serves attention, RWKV-6 and Mamba stacks")
        if cfg.dtype != cfg.param_dtype:
            raise ValueError(f"{cfg.name}: the port computes in the param dtype; "
                             f"dtype={cfg.dtype} != param_dtype={cfg.param_dtype}")
        self.cfg = cfg
        self.plain = plain
        self.block_size, self.n_blocks, self.specs = block_structure(cfg)
        if any(s.is_moe for s in self.specs):
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (moe_period={cfg.moe_period}, "
                f"num_experts={cfg.num_experts}) are not ported; build it with "
                f"moe_period=0, num_experts=0, experts_per_token=0")
        self.layer_specs = [self.specs[j] for _ in range(self.n_blocks)
                            for j in range(self.block_size)]

    @property
    def bucketed_prefill(self) -> bool:
        """Whether ``prefill`` takes a right-padded prompt with ``true_len``:
        pure-attention stacks without a bidirectional prefix (a prefix would
        let pad keys leak into real queries). Other stacks prefill at the
        prompt's exact length."""
        return (self.cfg.prefix_len == 0
                and all(s.mixer == "attn" for s in self.specs))

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------------ init

    def init(self, generator: torch.Generator, device=None, dtype=None):
        """The port's own seeded weights (same shapes and scales as the
        reference's init, not the same numbers). ``generator`` must live on
        ``device``; weights are drawn there directly. ``device="meta"``
        gives the tree's shapes and dtypes without storage."""
        cfg = self.cfg
        device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        dt = dtype or torch_dtype(cfg.param_dtype)
        params = {}
        if cfg.embed_inputs:
            params["embed"] = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                         dt, device)
        if not (cfg.tie_embeddings and cfg.embed_inputs):
            params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                           dt, device)
        if "rwkv" in cfg.mixer_pattern:
            params["ln0"] = init_norm(cfg, dt, device)
        params["final_norm"] = init_norm(cfg, dt, device)
        layers = []
        for spec in self.layer_specs:
            lp = {"norm1": init_norm(cfg, dt, device),
                  "norm2": init_norm(cfg, dt, device)}
            if spec.mixer == "rwkv":
                lp["tm"] = R.init_rwkv_tm(generator, cfg, dt, device)
                lp["cm"] = R.init_rwkv_cm(generator, cfg, dt, device)
            elif spec.mixer == "mamba":
                lp["mamba"] = M.init_mamba(generator, cfg, dt, device)
                lp["mlp"] = F.init_mlp(generator, cfg, dt, device)
            else:
                lp["attn"] = A.init_attention(generator, cfg, dt, device)
                lp["mlp"] = F.init_mlp(generator, cfg, dt, device)
            if cfg.post_norm:
                lp["norm1_post"] = init_norm(cfg, dt, device)
                lp["norm2_post"] = init_norm(cfg, dt, device)
            layers.append(lp)
        params["layers"] = layers
        return params

    # ----------------------------------------------------------------- layers

    def _apply_layer(self, lp, x, spec, *, mode, positions=None, cache=None,
                     pos=None, max_len=None, true_len=None, pages=None):
        cfg = self.cfg
        if spec.mixer != "attn" and (mode == "decode_paged" or true_len is not None):
            raise NotImplementedError(
                f"paged decode / bucketed (true_len) prefill support attention "
                f"layers only, got mixer={spec.mixer!r}; use the dense path")
        if spec.mixer == "rwkv":
            return self._apply_rwkv_layer(lp, x, mode=mode, cache=cache)
        h = apply_norm(lp["norm1"], x, cfg)
        if mode == "train":
            new_cache = None
            if spec.mixer == "mamba":
                y = M.mamba_train(lp["mamba"], h, cfg, plain=self.plain)
            else:
                positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
                y = A.attn_train(lp["attn"], h, cfg, spec, positions, plain=self.plain)
        elif spec.mixer == "mamba":
            if mode == "prefill":
                y, new_cache = M.mamba_prefill(lp["mamba"], h, cfg, plain=self.plain)
            else:
                y, new_cache = M.mamba_decode(lp["mamba"], h, cache, cfg,
                                              plain=self.plain)
        elif mode == "prefill":
            y, new_cache = A.attn_prefill(lp["attn"], h, cfg, spec, positions,
                                          max_len=max_len, true_len=true_len,
                                          plain=self.plain)
        elif mode == "decode_paged":
            y, new_cache = A.attn_decode_paged(lp["attn"], h, cache, cfg, spec,
                                               pos, pages, plain=self.plain)
        else:
            y, new_cache = A.attn_decode(lp["attn"], h, cache, cfg, spec, pos,
                                         plain=self.plain)
        if cfg.post_norm:
            y = apply_norm(lp["norm1_post"], y, cfg)
        x = x + y
        h = apply_norm(lp["norm2"], x, cfg)
        y = F.apply_mlp(lp["mlp"], h, cfg)
        if cfg.post_norm:
            y = apply_norm(lp["norm2_post"], y, cfg)
        return x + y, new_cache

    def _apply_rwkv_layer(self, lp, x, *, mode, cache):
        """Prefill returns a new state; decode updates ``cache`` in place
        (the wkv state through the scan's ``state_out``); train returns no
        state."""
        cfg = self.cfg
        decode = mode not in ("prefill", "train")
        h = apply_norm(lp["norm1"], x, cfg)
        if decode:
            y, sh_tm, wkv = R.rwkv_time_mix(
                lp["tm"], h, cfg, cache["shift_tm"], cache["wkv"],
                state_out=cache["wkv"], plain=self.plain)
        else:
            y, sh_tm, wkv = R.rwkv_time_mix(lp["tm"], h, cfg, plain=self.plain)
        if cfg.post_norm:
            y = apply_norm(lp["norm1_post"], y, cfg)
        x = x + y
        h = apply_norm(lp["norm2"], x, cfg)
        y, sh_cm = R.rwkv_channel_mix(lp["cm"], h, cfg,
                                      cache["shift_cm"] if decode else None)
        if cfg.post_norm:
            y = apply_norm(lp["norm2_post"], y, cfg)
        if mode == "train":
            return x + y, None
        if not decode:
            return x + y, {"shift_tm": sh_tm, "shift_cm": sh_cm, "wkv": wkv}
        cache["shift_tm"].copy_(sh_tm)
        cache["shift_cm"].copy_(sh_cm)
        return x + y, cache

    def _train_stack(self, params, x):
        """The train-mode stack, block by block (the reference scans over
        blocks and wraps each in ``jax.checkpoint`` under ``remat``)."""
        remat = self.cfg.remat
        if remat == "dots":
            raise NotImplementedError(
                "remat='dots' (save matmul outputs, recompute the rest) is not "
                "ported; use 'full' or 'none' (ROADMAP Queue A, training)")
        if remat not in ("full", "none"):
            raise ValueError(f"remat={remat!r}")
        bs = self.block_size
        for i in range(self.n_blocks):
            layers = list(zip(params["layers"][i * bs:(i + 1) * bs],
                              self.layer_specs[i * bs:(i + 1) * bs]))

            def block(x, layers=layers):
                for lp, spec in layers:
                    x, _ = self._apply_layer(lp, x, spec, mode="train")
                return x

            x = checkpoint(block, x, use_reentrant=False) if remat == "full" else block(x)
        return x

    def _stack(self, params, x, mode, caches=None, **kw):
        new_caches = []
        for i, (lp, spec) in enumerate(zip(params["layers"], self.layer_specs)):
            entry = None if caches is None else caches[i]
            x, nc = self._apply_layer(lp, x, spec, mode=mode, cache=entry, **kw)
            new_caches.append(nc)
        return x, new_caches

    # ------------------------------------------------------------- embeddings

    def _embed_in(self, params, tokens):
        cfg = self.cfg
        dt = self.dtype
        x = Fn.embedding(tokens.long(), params["embed"]).to(dt)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
        if "ln0" in params:
            x = apply_norm(params["ln0"], x, cfg)
        return x

    def _unembed(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg)
        if cfg.tie_embeddings and cfg.embed_inputs:
            logits = x @ params["embed"].to(x.dtype).T
        else:
            logits = x @ params["lm_head"].to(x.dtype)
        return softcap(logits, cfg.final_softcap)

    # cache ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device=None):
        """Dense per-layer caches: attention k/v (batch, L, KV, hd) and pos
        (batch, L); RWKV shift_tm/shift_cm (batch, d) and wkv (batch, H, hd,
        hd) f32; Mamba conv (batch, W-1, d_inner) and ssm (batch, d_inner, N)
        f32."""
        device = resolve_device(device)
        cfg, dt = self.cfg, self.dtype
        caches = []
        for spec in self.layer_specs:
            if spec.mixer == "rwkv":
                caches.append(R.init_rwkv_cache(cfg, batch, dt, device))
            elif spec.mixer == "mamba":
                caches.append(M.init_mamba_cache(cfg, batch, dt, device))
            else:
                caches.append(A.init_cache_entry(cfg, spec, batch, max_len, dt,
                                                 device))
        return caches

    def init_paged_cache(self, n_phys_blocks: int, block_size: int,
                         quant: Optional[str] = None, device=None):
        """Per-layer paged KV pools (block ids owned by
        ``repro_torch.runtime.paging.PageAllocator``). Attention-only
        stacks: RWKV and Mamba state is not positional and stays on the
        dense path."""
        for spec in self.layer_specs:
            if spec.mixer != "attn":
                raise NotImplementedError(
                    f"paged KV cache supports attention layers only, got "
                    f"mixer={spec.mixer!r} (use init_cache / the dense layout)")
        device = resolve_device(device)
        return [A.init_paged_entry(self.cfg, spec, n_phys_blocks, block_size,
                                   self.dtype, device, quant=quant)
                for spec in self.layer_specs]

    # ----------------------------------------------------------------- public

    def forward(self, params, tokens):
        """Full training/scoring forward. tokens: (B,S). Returns (logits
        (B,S,V), aux loss): aux is the MoE load-balancing loss, 0 here (no
        MoE layer is ported)."""
        x = self._train_stack(params, self._embed_in(params, tokens))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._unembed(params, x), aux

    def loss(self, params, batch):
        """Next-token cross-entropy in f32 over ``batch["tokens"]`` (B,S), the
        last position masked, plus ``router_aux_coef * aux``. Returns (loss,
        {"loss", "ce", "aux"}). Token batches only: the audio and vlm
        families are not ported."""
        cfg = self.cfg
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(f"{cfg.family} batches are not ported")
        tokens = batch["tokens"]
        logits, aux = self.forward(params, tokens)
        labels = torch.roll(tokens, -1, dims=1).long()
        S = tokens.shape[1]
        mask = (torch.arange(S, device=logits.device) < S - 1).float()
        mask = mask[None].expand(labels.shape)
        lp = torch.log_softmax(logits.float(), dim=-1)
        ce = -torch.gather(lp, -1, labels[..., None])[..., 0]
        ce = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill(self, params, *, tokens, max_len=None, true_len=None):
        """tokens: (B,S). Returns (last-token logits (B,V), caches).
        ``max_len`` sizes the caches for the decode that follows (default S).
        ``true_len`` marks a right-padded bucketed prompt: logits come from
        position ``true_len - 1`` and pad slots carry pos=-1."""
        x = self._embed_in(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
        x, caches = self._stack(params, x, "prefill", positions=positions,
                                max_len=max_len, true_len=true_len)
        last = x[:, -1:] if true_len is None else x[:, int(true_len) - 1:int(true_len)]
        return self._unembed(params, last)[:, 0], caches

    def decode_step(self, params, cache, *, tokens, pos):
        """One dense decode step. tokens: (B,1); pos: an int shared by the
        batch or a (B,) tensor of per-row positions. Caches update in place.
        Returns (logits (B,V), caches)."""
        x = self._embed_in(params, tokens)
        x, caches = self._stack(params, x, "decode", caches=cache, pos=pos)
        return self._unembed(params, x)[:, 0], caches

    def decode_step_paged(self, params, pools, *, tokens, pos_vec, pages):
        """One slot-batched decode step against paged pools. tokens: (B,1);
        pos_vec: (B,) per-slot positions; pages: (B,P) int32 page table.
        Pools update in place. Returns (logits (B,V), pools)."""
        x = self._embed_in(params, tokens)
        x, pools = self._stack(params, x, "decode_paged", caches=pools,
                               pos=pos_vec, pages=pages)
        return self._unembed(params, x)[:, 0], pools


def build_model(cfg: ModelConfig, *, plain: bool = False) -> DecoderLM:
    return DecoderLM(cfg, plain=plain)
