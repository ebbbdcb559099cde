"""Decoder LM for every stack of the registry: dense and MoE attention,
RWKV-6, Mamba/attention hybrids with experts, audio over frame embeddings
and a vision prefix before text (twin of ``repro.models.decoder``).

The reference scans over parameter-stacked blocks; the port keeps the same
block structure (``block_structure``) but stores one params dict per layer
and runs the layers as a Python loop, in the reference's order (block i,
position j is layer ``i * block_size + j``).

Params: ``{["embed": (V, d)], ["lm_head": (d, V)], ["ln0": {...}],
"final_norm": {...}, "layers": [...]}``; an attention layer is ``{"norm1",
"norm2", "attn", "mlp" | "moe", ["norm1_post", "norm2_post"]}``, a Mamba
layer ``{"norm1", "norm2", "mamba", "mlp" | "moe"}``, an RWKV layer
``{"norm1", "norm2", "tm", "cm"}`` (time-mix and channel-mix, no MLP). A
layer where ``spec.is_moe`` holds a ``moe`` dict (``router`` (d, E) in f32,
``w_gate``/``w_up`` (E, d, ff), ``w_out`` (E, ff, d), ``shared`` for a
shared expert) in place of ``mlp``. A stack with RWKV layers normalises its
embeddings with ``ln0``; a config with ``embed_inputs=False`` (musicgen)
has no ``embed`` and takes ``embeds``; ``lm_head`` is absent where the
embedding is tied. Params come either from the reference's weights
(``repro_torch.convert.params_from_jax``) or from the port's own seeded
``init``.

Inputs (``_embed_in``): ``tokens`` (B, S) through the embedding, or
``embeds`` (B, S, d) as they are; ``prefix_embeds`` (B, P, d) go in front
(paligemma's image patches, seen bidirectionally through
``cfg.prefix_len``); ``embed_scale`` multiplies after the concatenation,
then ``ln0``. ``pos_type="sinusoidal"`` (musicgen) adds no position term,
as in the reference, which never applies ``sinusoidal_pos``.

Four modes share one layer body: ``train`` (``forward``/``loss``: the full
sequence, no caches, each block under ``torch.utils.checkpoint`` when
``cfg.remat`` is ``"full"`` (keep only the block's input) or ``"dots"``
(keep every matmul's output, recompute the rest); attention layers
through the differentiable flash op, Mamba layers through the
differentiable selective scan; the MoE layers' load-balancing losses
summed into ``aux``),
``prefill`` (returns per-layer caches), ``decode`` (dense cache, one token
per row, per-row positions) and ``decode_paged`` (paged pools + page
table). An RWKV layer's cache is its state ``{"shift_tm", "shift_cm",
"wkv"}``, a Mamba layer's ``{"conv", "ssm"}``; decode updates both in
place. Neither has a position, so a stack with either takes neither the
paged layout nor a bucketed (``true_len``) prefill, and raises there as the
reference does. An MoE layer routes all the tokens of a call as one group
(capacity counts them all), or each batch row alone with
``decode_step(..., route_rows=True)``, the dense batcher's step (see
``repro_torch.models.mlp``).

``tracer`` (a :class:`repro_torch.obs.trace.Tracer`, None by default, the
batcher's) takes host-clock spans of the serving modes: ``model.prefill``
and ``model.decode_step`` (either layout) around the call, and inside each
``model.embed``, one ``model.layer`` a layer (``i``) holding its mixer
(``model.attn`` or ``model.mamba``; an RWKV layer none) and its FFN
(``model.mlp`` or ``model.moe``), and ``model.unembed``. The spans time
the host: nothing inside them waits for the device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models import rwkv as R
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm, softcap)
from repro_torch.models.config import ModelConfig, block_structure
from repro_torch.obs.trace import NO_SPAN
from repro_torch.parallel import is_dtensor, logical, sharding_ctx, use_sharding_ctx
from repro_torch.parallel.local import dense, local_call, mesh_ops, partial_where_split
from repro_torch.tree import leaves


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: the torch form of ``jax.checkpoint_policies.
    checkpoint_dots``: every matrix product's output is kept for the
    backward, everything else (elementwise ops, norms, the CUDA kernels
    launched through ctypes, which no dispatch mode sees) is recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class DecoderLM:
    def __init__(self, cfg: ModelConfig, *, plain: bool = False, tracer=None):
        """``plain=True`` runs attention through the model-level plain
        PyTorch math and the WKV and selective scans through their plain
        versions, on any device (the yardstick for the kernel path).
        ``tracer`` records the spans the module docstring lists."""
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
        self.tracer = tracer
        self.block_size, self.n_blocks, self.specs = block_structure(cfg)
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
            else:
                if spec.mixer == "mamba":
                    lp["mamba"] = M.init_mamba(generator, cfg, dt, device)
                else:
                    lp["attn"] = A.init_attention(generator, cfg, dt, device)
                if spec.is_moe:
                    lp["moe"] = F.init_moe(generator, cfg, dt, device)
                else:
                    lp["mlp"] = F.init_mlp(generator, cfg, dt, device)
            if cfg.post_norm:
                lp["norm1_post"] = init_norm(cfg, dt, device)
                lp["norm2_post"] = init_norm(cfg, dt, device)
            layers.append(lp)
        params["layers"] = layers
        return params

    def init_shape(self):
        """The params tree on the ``meta`` device (shapes and dtypes, no
        storage), built once and shared: treat it as read-only."""
        if getattr(self, "_shape_tree", None) is None:
            self._shape_tree = self.init(torch.Generator(), device="meta")
        return self._shape_tree

    def param_count(self) -> int:
        """Parameters of the whole tree, from a ``meta`` init."""
        return sum(t.numel() for t in leaves(self.init_shape()))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed share of the
        experts counts, ``experts_per_token / num_experts``)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.num_experts == 0:
            return total
        shapes = self.init_shape()
        expert_leaves = sum(lp["moe"][name].numel() for lp in shapes["layers"]
                            if "moe" in lp for name in ("w_gate", "w_up", "w_out"))
        active_frac = cfg.experts_per_token / cfg.num_experts
        return int(total - expert_leaves * (1.0 - active_frac))

    # ----------------------------------------------------------------- layers

    def _apply_layer(self, lp, x, spec, *, mode, positions=None, cache=None,
                     pos=None, max_len=None, true_len=None, pages=None,
                     route_rows=False, tracer=None):
        """Returns (x, new_cache, aux): aux is the layer's MoE
        load-balancing loss (an f32 scalar), None for a dense FFN."""
        cfg = self.cfg
        if spec.mixer != "attn" and (mode == "decode_paged" or true_len is not None):
            raise NotImplementedError(
                f"paged decode / bucketed (true_len) prefill support attention "
                f"layers only, got mixer={spec.mixer!r}; use the dense path")
        if spec.mixer == "rwkv":
            return self._apply_rwkv_layer(lp, x, mode=mode, cache=cache) + (None,)
        with (tracer.span("model.attn" if spec.mixer == "attn" else "model.mamba")
              if tracer is not None else NO_SPAN):
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
        with (tracer.span("model.moe" if spec.is_moe else "model.mlp")
              if tracer is not None else NO_SPAN):
            h = apply_norm(lp["norm2"], x, cfg)
            aux = None
            if spec.is_moe:
                y, aux = F.apply_moe(lp["moe"], h, cfg, route_rows=route_rows)
            else:
                y = F.apply_mlp(lp["mlp"], h, cfg)
            if cfg.post_norm:
                y = apply_norm(lp["norm2_post"], y, cfg)
            return x + y, new_cache, aux

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
        blocks and wraps each in ``jax.checkpoint`` under ``remat``).
        Returns (x, aux): aux sums the MoE layers' losses in f32, block by
        block as the reference's scan carry does."""
        remat = self.cfg.remat
        if remat not in ("full", "dots", "none"):
            raise ValueError(f"remat={remat!r}")
        kw = dict(use_reentrant=False)
        if remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
        bs = self.block_size
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ctx = sharding_ctx()  # a recompute may run on the autograd engine's thread
        for i in range(self.n_blocks):
            layers = list(zip(params["layers"][i * bs:(i + 1) * bs],
                              self.layer_specs[i * bs:(i + 1) * bs]))

            def block(x, layers=layers):
                with use_sharding_ctx(*ctx), mesh_ops(x):  # a recompute enters them too
                    aux_b = torch.zeros((), dtype=torch.float32, device=x.device)
                    for lp, spec in layers:
                        x, _, a = self._apply_layer(lp, x, spec, mode="train")
                        if a is not None:
                            aux_b = aux_b + a
                    return x, aux_b

            x, aux_b = block(x) if remat == "none" else checkpoint(block, x, **kw)
            aux = aux + aux_b
        return x, aux

    def _stack(self, params, x, mode, caches=None, **kw):
        """The serving modes' stack, one ``model.layer`` span a layer."""
        tracer = self.tracer
        new_caches = []
        for i, (lp, spec) in enumerate(zip(params["layers"], self.layer_specs)):
            entry = None if caches is None else caches[i]
            with (tracer.span("model.layer", i=i) if tracer is not None else NO_SPAN):
                x, nc, _ = self._apply_layer(lp, x, spec, mode=mode, cache=entry,
                                             tracer=tracer, **kw)
            new_caches.append(nc)
        return x, new_caches

    # ------------------------------------------------------------- embeddings

    def _embed_in(self, params, tokens=None, embeds=None, prefix_embeds=None):
        """tokens (B,S) through the embedding, or embeds (B,S,d) where the
        config takes no tokens; prefix_embeds (B,P,d) in front; then
        ``embed_scale`` and ``ln0``."""
        cfg = self.cfg
        dt = self.dtype
        if cfg.embed_inputs:
            x = _embed(tokens, params["embed"]).to(dt)
        else:
            x = embeds.to(dt)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dt), x], dim=1)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
        if "ln0" in params:
            x = apply_norm(params["ln0"], x, cfg)
        return logical(x, "batch", "act_seq", None)

    def _unembed(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_norm"], x, cfg)
        if cfg.tie_embeddings and cfg.embed_inputs:
            logits = dense(x, params["embed"].to(x.dtype).T)
        else:
            logits = dense(x, params["lm_head"].to(x.dtype))
        logits = softcap(logits, cfg.final_softcap)
        return logical(logits, "batch", "act_seq", "vocab")

    # cache ------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, device=None):
        """Dense per-layer caches: attention k/v (batch, L, KV, hd) and pos
        (batch, L); RWKV shift_tm/shift_cm (batch, d) and wkv (batch, H, hd,
        hd) f32; Mamba conv (batch, W-1, d_inner) and ssm (batch, d_inner, N)
        f32. ``device="meta"`` gives the tree without storage."""
        device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
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

    def cache_shape(self, batch: int, max_len: int):
        """The dense cache tree of a lockstep decode (every row at one
        position, as the reference's ``decode_step`` takes it) on the
        ``meta`` device: ``init_cache``'s tree, except that an attention
        layer's positions are one (L,) row shared by the batch, the
        reference's layout, which the dry run counts. ``init_cache``
        keeps a row per sequence, (B, L), so that slot-batched decode can
        run each row at its own position."""
        meta = torch.device("meta")
        cfg, dt = self.cfg, self.dtype
        caches = []
        for spec in self.layer_specs:
            if spec.mixer == "rwkv":
                caches.append(R.init_rwkv_cache(cfg, batch, dt, meta))
            elif spec.mixer == "mamba":
                caches.append(M.init_mamba_cache(cfg, batch, dt, meta))
            else:
                entry = A.init_cache_entry(cfg, spec, batch, max_len, dt, meta)
                entry["pos"] = entry["pos"][0]
                caches.append(entry)
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
        device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        return [A.init_paged_entry(self.cfg, spec, n_phys_blocks, block_size,
                                   self.dtype, device, quant=quant)
                for spec in self.layer_specs]

    # ----------------------------------------------------------------- public

    def forward(self, params, tokens=None, *, embeds=None, prefix_embeds=None):
        """Full training/scoring forward over tokens (B,S), or embeds
        (B,S,d), after prefix_embeds (B,P,d) if given. Returns (logits
        (B,P+S,V), aux): aux is the sum of the MoE layers' load-balancing
        losses, 0 without MoE layers."""
        with mesh_ops(_first(tokens, embeds)):
            x = self._embed_in(params, tokens, embeds, prefix_embeds)
            x, aux = self._train_stack(params, x)
            return self._unembed(params, x), aux

    def loss(self, params, batch):
        """Next-token cross-entropy in f32 plus ``router_aux_coef * aux``.
        Batch layout per family, as the reference's:

        lm:    {"tokens": (B,S)}, the last position masked;
        audio: {"embeds": (B,S,d), "labels": (B,S)} (labels pre-aligned);
        vlm:   {"prefix_embeds": (B,P,d), "tokens": (B,S_text)}, labels the
               text shifted by one, counted from position P-1 to the
               second last.

        Returns (loss, {"loss", "ce", "aux"})."""
        with mesh_ops(next(iter(batch.values()))):
            return self._loss(params, batch)

    def _loss(self, params, batch):
        """The forward takes the batch leaves as they are laid out (on a
        mesh each rank embeds its own rows); the labels are built from the
        whole tokens, since ``aten.roll`` has no DTensor strategy."""
        cfg = self.cfg
        if cfg.family == "audio":
            logits, aux = self.forward(params, embeds=batch["embeds"])
            labels = batch["labels"]
            if not is_dtensor(labels):
                labels = torch.as_tensor(labels).to(logits.device)
            labels = labels.long()
            mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
        elif cfg.family == "vlm":
            logits, aux = self.forward(params, batch["tokens"],
                                       prefix_embeds=batch["prefix_embeds"])
            tokens = _whole(batch["tokens"])
            P = batch["prefix_embeds"].shape[1]
            full = torch.cat([torch.zeros((tokens.shape[0], P), dtype=torch.int64,
                                          device=tokens.device), tokens.long()], dim=1)
            labels = torch.roll(full, -1, dims=1)
            S = full.shape[1]
            idx = torch.arange(S, device=tokens.device)
            mask = ((idx >= P - 1) & (idx < S - 1)).float()[None].expand(labels.shape)
        else:
            logits, aux = self.forward(params, batch["tokens"])
            tokens = _whole(batch["tokens"])
            labels = torch.roll(tokens, -1, dims=1).long()
            S = tokens.shape[1]
            mask = (torch.arange(S, device=tokens.device) < S - 1).float()
            mask = mask[None].expand(labels.shape)
        ce = _ce(logits, labels, mask)
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def prefill(self, params, *, tokens=None, embeds=None, prefix_embeds=None,
                max_len=None, true_len=None):
        """tokens (B,S) or embeds (B,S,d), after prefix_embeds (B,P,d) if
        given. Returns (last-token logits (B,V), caches). ``max_len`` sizes
        the caches for the decode that follows (default: the prefilled
        length, prefix included). ``true_len`` marks a right-padded
        bucketed prompt: logits come from position ``true_len - 1`` and pad
        slots carry pos=-1."""
        tracer = self.tracer
        with (tracer.span("model.prefill") if tracer is not None else NO_SPAN), \
                mesh_ops(_first(tokens, embeds)):
            with (tracer.span("model.embed") if tracer is not None else NO_SPAN):
                x = self._embed_in(params, tokens, embeds, prefix_embeds)
            positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
            x, caches = self._stack(params, x, "prefill", positions=positions,
                                    max_len=max_len, true_len=true_len)
            last = x[:, -1:] if true_len is None else x[:, int(true_len) - 1:int(true_len)]
            with (tracer.span("model.unembed") if tracer is not None else NO_SPAN):
                return self._unembed(params, last)[:, 0], caches

    def decode_step(self, params, cache, *, tokens=None, embeds=None, pos,
                    route_rows=False):
        """One dense decode step. tokens (B,1) or embeds (B,1,d); pos: an
        int shared by the batch or a (B,) tensor of per-row positions.
        Caches update in place. MoE layers route the B tokens as one group,
        or each row alone with ``route_rows`` (the reference's vmap of a
        one-row step, which its dense batcher runs). Returns (logits (B,V),
        caches)."""
        tracer = self.tracer
        with (tracer.span("model.decode_step") if tracer is not None else NO_SPAN), \
                mesh_ops(_first(tokens, embeds)):
            with (tracer.span("model.embed") if tracer is not None else NO_SPAN):
                x = self._embed_in(params, tokens, embeds)
            x, caches = self._stack(params, x, "decode", caches=cache, pos=pos,
                                    route_rows=route_rows)
            with (tracer.span("model.unembed") if tracer is not None else NO_SPAN):
                return self._unembed(params, x)[:, 0], caches

    def decode_step_paged(self, params, pools, *, tokens, pos_vec, pages):
        """One slot-batched decode step against paged pools. tokens: (B,1);
        pos_vec: (B,) per-slot positions; pages: (B,P) int32 page table.
        Pools update in place. Returns (logits (B,V), pools)."""
        tracer = self.tracer
        with (tracer.span("model.decode_step") if tracer is not None else NO_SPAN), \
                mesh_ops(tokens):
            with (tracer.span("model.embed") if tracer is not None else NO_SPAN):
                x = self._embed_in(params, tokens)
            x, pools = self._stack(params, x, "decode_paged", caches=pools,
                                   pos=pos_vec, pages=pages)
            with (tracer.span("model.unembed") if tracer is not None else NO_SPAN):
                return self._unembed(params, x)[:, 0], pools


def _ce_sums(logits, labels, mask):
    """(sum of masked per-token cross-entropies in f32, sum of the mask)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(lp, -1, labels[..., None])[..., 0]
    return (ce * mask).sum(), mask.sum()


def _ce(logits, labels, mask):
    """Masked mean cross-entropy. On a mesh each rank sums its own rows and
    positions (the vocab gathered), and the two sums are reduced over the
    ranks that split them."""
    if not is_dtensor(logits):
        num, den = _ce_sums(logits, labels, mask)
        return num / torch.clamp(den, min=1.0)
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.parallel import logical_placements
    from repro_torch.parallel.local import local_call

    mesh = logits.device_mesh
    lpl = logical_placements(logits, "batch", "act_seq", None)
    tpl = logical_placements(labels, "batch", "act_seq")
    sums = tuple(Partial() if p != Replicate() else Replicate() for p in lpl)
    num, den = local_call(_ce_sums, (logits, labels, mask), (lpl, tpl, tpl),
                          (sums, sums), mesh)
    rep = [Replicate()] * mesh.ndim
    return num.redistribute(mesh, rep) / torch.clamp(den.redistribute(mesh, rep), min=1.0)


def _whole(t):
    """A batch leaf as a plain tensor: a DTensor's whole value."""
    return t.full_tensor() if is_dtensor(t) else t


def _embed(tokens, table):
    """``Fn.embedding`` of ``tokens`` (B,S) into ``table`` (V,d). On a mesh
    each rank looks its own tokens up in the whole table, gathered on every
    rank (a lookup into a vocab-sharded table is a masked partial sum that
    DTensor cannot reduce when the tokens are split too), through
    ``local_call``: the output is laid out as the tokens, and the table's
    gradient is a partial sum over the ranks that split them, reduced where
    the table is laid out again, as ``parallel.local.dense`` lays out a
    linear layer rather than leave it to DTensor's strategies."""
    if not (is_dtensor(tokens) or is_dtensor(table)):
        return Fn.embedding(tokens.long(), table)
    from torch.distributed.tensor import Replicate

    mesh = (tokens if is_dtensor(tokens) else table).device_mesh
    rep = (Replicate(),) * mesh.ndim
    tpl = tuple(tokens.placements) if is_dtensor(tokens) else rep
    (x,) = local_call(lambda t, w: Fn.embedding(t.long(), w), (tokens, table),
                      (tpl, rep), (tpl,), mesh,
                      grad_placements=(None, partial_where_split(rep, [tpl])))
    return x


def _first(*xs):
    return next((x for x in xs if x is not None), None)


def build_model(cfg: ModelConfig, *, plain: bool = False) -> DecoderLM:
    return DecoderLM(cfg, plain=plain)
