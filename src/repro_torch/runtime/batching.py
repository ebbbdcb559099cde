"""Continuous-batching decode engine — the per-replica serving substrate
(twin of ``repro.runtime.batching``).

``max_slots`` concurrent sequences share one decode step over a slot-batched
KV cache; a finished sequence frees its slot at once and the next queued
request takes it on the following step, after a bucketed prefill (prompt
right-padded to a power-of-2 multiple of ``prompt_bucket``, clamped to
``max_len``; the true length selects the logits and masks the pad slots).

Two KV layouts (``kv_layout``):

  dense — every slot owns a padded ``max_len`` cache; the decode step runs
    all slots as one batch with an explicit slot dimension (the reference
    vmaps a single-sequence step over slots) and per-slot positions.
  paged — one shared pool of ``kv_block_size``-token blocks per layer plus a
    :class:`~repro_torch.runtime.paging.PageAllocator` page table; slot
    ``b``'s logical cache slot ``s`` lives at block ``table[b, s // bs]``,
    offset ``s % bs``. A request reserves ``ceil(min(plen + max_new,
    max_len) / bs)`` pages at admission (head-of-line FIFO gating, loud
    ``PagedCacheOOM`` at submit for a request that can never fit).
    ``kv_quant="int8"`` stores pooled K/V int8 with rowwise f32 scales.

Gathering a slot's pages reproduces its dense cache exactly, so both layouts
generate identical tokens (on the card too: the dense and paged decode
kernels share one device routine) for every stack without experts.

MoE layers route under a capacity that counts the tokens routed together,
and the two layouts group them as the reference does: the paged step
routes all ``max_slots`` rows as one group (free slots too, on their stale
tokens), the dense step each row alone (the reference vmaps a one-row
step; here ``decode_step(..., route_rows=True)``), and a bucketed prefill
routes its pad tokens after the prompt's. An expert that more rows pick
than its capacity drops an assignment in the paged step and never in the
dense one, so the two layouts may differ in tokens, in the reference as in
the port (ROADMAP Queue C); each request's first token, from the prefill,
is the same in both.

A stack that is not pure attention (RWKV-6, or jamba's Mamba/attention
hybrid) runs dense only (paged raises ``NotImplementedError``, as in the
reference) with one exact-length prefill per prompt length. Its slot row
holds the recurrent state (RWKV's ``shift_tm``, ``shift_cm``, ``wkv``;
Mamba's ``conv`` and ``ssm``) beside any attention layer's K/V, and
``kv_cache_bytes`` counts all of it. Free slots keep decoding on stale
tokens, which is harmless because admission overwrites every entry of the
row.

The port has no compiler cache to key; ``prefill_compiles`` counts distinct
prefill buckets (one entry of ``_prefills`` each), the quantity the
reference counts as ``batcher.prefill_compiles``.

``tracer`` (a :class:`repro_torch.obs.trace.Tracer`, None by default) takes
host-clock spans: ``batcher.submit`` (an instant: ``rid``, ``prompt_len``,
``max_new``), ``batcher.step`` (``step``; ``n_admitted`` and ``n_active``
at its end) around each ``step()``, and inside it ``batcher.admit``
(``rid``, ``bucket``, ``pages``) around each admission, with
``paging.scatter`` and ``batcher.first_token`` (the wait for the
prefill's argmax) inside, and ``batcher.sync`` (the wait for the decode
step's tokens). The model's own spans (``model.prefill``,
``model.decode_step``) come from the ``DecoderLM`` given the same tracer.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import cache_len_for
from repro_torch.obs.trace import NO_SPAN
from repro_torch.optim.compress import quantize_int8
from repro_torch.runtime.paging import (NULL_BLOCK, RESERVED_BLOCKS, TRASH_BLOCK,
                                        PageAllocator, PagedCacheOOM, pages_needed)


class SlotState:
    """Fixed-capacity decode-slot bookkeeping (copy of the reference's).

    Admit-on-free-slot semantics: a finished occupant frees its slot
    immediately and the lowest free slot takes the next admission.
    """

    __slots__ = ("max_slots", "_occupants")

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self._occupants: List[Optional[object]] = [None] * self.max_slots

    @property
    def n_active(self) -> int:
        return sum(o is not None for o in self._occupants)

    @property
    def n_free(self) -> int:
        return self.max_slots - self.n_active

    @property
    def occupancy(self) -> float:
        return self.n_active / self.max_slots

    def get(self, slot: int):
        return self._occupants[slot]

    def free_slot(self) -> Optional[int]:
        """Lowest free slot index, or None when full."""
        for i, o in enumerate(self._occupants):
            if o is None:
                return i
        return None

    def place(self, slot: int, item) -> None:
        if self._occupants[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        self._occupants[slot] = item

    def admit(self, item) -> int:
        slot = self.free_slot()
        if slot is None:
            raise RuntimeError("no free slot")
        self._occupants[slot] = item
        return slot

    def release(self, slot: int):
        item = self._occupants[slot]
        if item is None:
            raise RuntimeError(f"slot {slot} is already free")
        self._occupants[slot] = None
        return item

    def clear(self) -> None:
        self._occupants = [None] * self.max_slots

    def items(self) -> List[Tuple[int, object]]:
        """Snapshot of ``(slot, occupant)`` pairs — safe to admit/release
        while iterating."""
        return [(i, o) for i, o in enumerate(self._occupants) if o is not None]

    def occupants(self) -> List[object]:
        return [o for o in self._occupants if o is not None]


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    arrival: int = 0
    # engine-filled:
    start_step: Optional[int] = None
    finish_step: Optional[int] = None
    tokens: List[int] = field(default_factory=list)


class ContinuousBatcher:
    """Fixed-slot continuous-batching engine over a real decoder model.

    ``model`` is a :class:`repro_torch.models.DecoderLM` and ``params`` its
    weights on ``device`` (default ``cuda``). ``kv_blocks`` sets the paged
    pool's allocatable block budget (default: full dense capacity,
    ``max_slots * max_len / kv_block_size``). ``tracer`` records the
    spans the module docstring lists.
    """

    def __init__(self, model, params, *, max_slots: int = 4,
                 max_len: int = 128, prompt_bucket: int = 16,
                 kv_layout: str = "dense", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None, device=None, tracer=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        if kv_quant is not None and kv_layout != "paged":
            raise ValueError("kv_quant requires kv_layout='paged'")
        self.device = resolve_device(device)
        self.tracer = tracer
        self.model = model
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.bucket = prompt_bucket
        self.kv_layout = kv_layout
        self.kv_block_size = kv_block_size
        cfg = model.cfg
        # bucketed prefill where the model takes padded prompts; otherwise
        # one exact-length prefill per prompt length
        self._bucketed = model.bucketed_prefill

        self.pos = np.zeros(max_slots, np.int64)  # next absolute position
        self.remaining = np.zeros(max_slots, np.int64)
        self.slots = SlotState(max_slots)  # occupants: GenRequest
        self.last_tok = torch.zeros((max_slots, 1), dtype=torch.int64,
                                    device=self.device)
        self.queue: Deque[GenRequest] = deque()
        self.step_count = 0
        self._prefills: Dict[int, Callable] = {}
        self.prefill_compiles = 0

        if kv_layout == "paged":
            bs = kv_block_size
            if max_len % bs != 0:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of kv_block_size={bs}")
            for spec in model.specs:
                L = cache_len_for(cfg, spec, max_len)
                if L % bs != 0:
                    raise ValueError(
                        f"cache length {L} (attn_type={spec.attn_type!r}, "
                        f"window={cfg.window_size}) must be a multiple of "
                        f"kv_block_size={bs}")
            self.pages_per_slot = max_len // bs
            n_alloc = (max_slots * self.pages_per_slot if kv_blocks is None
                       else kv_blocks)
            self.allocator = PageAllocator(
                n_alloc + RESERVED_BLOCKS, bs, max_slots, self.pages_per_slot)
            self.pools = model.init_paged_cache(self.allocator.n_blocks, bs,
                                                quant=kv_quant,
                                                device=self.device)
        else:
            # one padded max_len cache per slot, the slot axis written out
            self.cache_slots = model.init_cache(max_slots, max_len,
                                                device=self.device)

    # ---------------------------------------------------------------- intake

    def _pages_for(self, req: GenRequest) -> int:
        return pages_needed(len(req.prompt), req.max_new, self.max_len,
                            self.kv_block_size)

    def submit(self, req: GenRequest):
        """Queue a request. Rejects loudly when the prompt cannot leave room
        for a generated token or — paged — when the request could never fit
        the block pool even when idle."""
        plen = len(req.prompt)
        if plen < 1 or plen > self.max_len - 1:
            raise ValueError(
                f"prompt length {plen} not in [1, max_len-1={self.max_len - 1}]")
        if self.kv_layout == "paged":
            need = self._pages_for(req)
            if not self.allocator.fits_ever(need):
                raise PagedCacheOOM(
                    f"request rid={req.rid} needs {need} pages; pool has "
                    f"{self.allocator.n_allocatable} total")
        self.queue.append(req)
        tracer = self.tracer
        if tracer is not None:
            tracer.instant("batcher.submit", time.perf_counter(), args={
                "rid": req.rid, "prompt_len": plen, "max_new": req.max_new})

    def _bucket_for(self, plen: int) -> int:
        b = self.bucket
        while b < plen:
            b *= 2
        return min(b, self.max_len)

    def _prefill_fn(self, bucket: int):
        if bucket not in self._prefills:
            self.prefill_compiles += 1
            # the closures hold the model, not the batcher: a cycle through
            # self would keep a dropped batcher's caches (and params) alive
            # until the cyclic collector runs
            model, max_len = self.model, self.max_len
            if self._bucketed:
                def prefill(params, toks, true_len):
                    return model.prefill(params, tokens=toks, max_len=max_len,
                                         true_len=true_len)
            else:
                def prefill(params, toks, true_len):
                    del true_len  # exact-length fallback
                    return model.prefill(params, tokens=toks, max_len=max_len)
            self._prefills[bucket] = prefill
        return self._prefills[bucket]

    def _admit(self, slot: int, req: GenRequest):
        plen = len(req.prompt)
        bucket = self._bucket_for(plen) if self._bucketed else plen
        paged = self.kv_layout == "paged"
        tracer = self.tracer
        with (tracer.span("batcher.admit", rid=req.rid, bucket=bucket,
                          pages=self._pages_for(req) if paged else 0)
              if tracer is not None else NO_SPAN):
            toks = np.zeros(bucket, np.int64)
            toks[:plen] = req.prompt
            logits, cache1 = self._prefill_fn(bucket)(
                self.params, torch.as_tensor(toks, device=self.device)[None], plen)
            if paged:
                with (tracer.span("paging.scatter") if tracer is not None else NO_SPAN):
                    self._scatter_paged(slot, req, cache1)
            else:
                # the whole slot row is overwritten, as the reference's .at[slot].set
                for entry, one in zip(self.cache_slots, cache1):
                    for name in entry:
                        entry[name][slot] = one[name][0]
            with (tracer.span("batcher.first_token") if tracer is not None else NO_SPAN):
                tok = int(torch.argmax(logits[0]))
            req.tokens.append(tok)
            req.start_step = self.step_count
            self.last_tok[slot, 0] = tok
            self.pos[slot] = plen
            self.remaining[slot] = req.max_new - 1
            self.slots.place(slot, req)

    def _scatter_paged(self, slot: int, req: GenRequest, cache1):
        """Reserve the slot's pages and write the prefill cache into the
        pools in place. Unreserved logical pages are redirected from the
        read-only NULL block to the TRASH sink so the shared zero tail is
        never written."""
        bs = self.kv_block_size
        row = self.allocator.reserve(slot, self._pages_for(req))
        write_row = row.copy()
        write_row[write_row == NULL_BLOCK] = TRASH_BLOCK
        for pool, entry in zip(self.pools, cache1):
            _, L, KV, hd = entry["k"].shape
            P = L // bs
            tbl = torch.as_tensor(write_row[:P], dtype=torch.int64,
                                  device=self.device)
            vk = entry["k"][0].reshape(P, bs, KV, hd)
            vv = entry["v"][0].reshape(P, bs, KV, hd)
            if "k_scale" in pool:
                qk, ks = quantize_int8(vk)
                qv, vs = quantize_int8(vv)
                pool["k"][tbl] = qk
                pool["v"][tbl] = qv
                pool["k_scale"][tbl] = ks
                pool["v_scale"][tbl] = vs
            else:
                pool["k"][tbl] = vk.to(pool["k"].dtype)
                pool["v"][tbl] = vv.to(pool["v"].dtype)
            pool["pos"][tbl] = entry["pos"][0].reshape(P, bs)

    # ------------------------------------------------------------------ step

    def _can_admit_head(self) -> bool:
        if self.kv_layout != "paged":
            return True
        # head-of-line: FIFO admission waits for pages, never reorders
        return self.allocator.can_reserve(self._pages_for(self.queue[0]))

    def step(self) -> int:
        """Admit queued requests into free slots, then decode one token for
        every active slot. Returns the number of active slots."""
        tracer = self.tracer
        with (tracer.span("batcher.step", step=self.step_count)
              if tracer is not None else NO_SPAN):
            n_admitted = 0
            while self.queue and self.slots.n_free and self._can_admit_head():
                self._admit(self.slots.free_slot(), self.queue.popleft())
                n_admitted += 1
            n_active = self.slots.n_active
            if n_active:
                self._decode(tracer)
            self.step_count += 1
            if tracer is not None:
                tracer.annotate(n_admitted=n_admitted, n_active=n_active)
        return n_active

    def _decode(self, tracer):
        pos_vec = torch.as_tensor(self.pos, device=self.device)
        if self.kv_layout == "paged":
            table = torch.as_tensor(self.allocator.table, device=self.device)
            logits, self.pools = self.model.decode_step_paged(
                self.params, self.pools, tokens=self.last_tok, pos_vec=pos_vec,
                pages=table)
        else:
            logits, self.cache_slots = self.model.decode_step(
                self.params, self.cache_slots, tokens=self.last_tok, pos=pos_vec,
                route_rows=True)
        next_tok = torch.argmax(logits, dim=-1)
        with (tracer.span("batcher.sync") if tracer is not None else NO_SPAN):
            toks = next_tok.cpu().numpy()
        for slot, req in self.slots.items():
            req.tokens.append(int(toks[slot]))
            self.pos[slot] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or self.pos[slot] >= self.max_len - 1:
                req.finish_step = self.step_count
                self.slots.release(slot)  # freed for next step
                if self.kv_layout == "paged":
                    self.allocator.free(slot)  # pages back to the pool
        self.last_tok = next_tok[:, None]

    def run(self, until_empty: bool = True, max_steps: int = 10_000):
        """Step until the queue and every slot have drained (or
        ``max_steps``); ``until_empty=False`` steps exactly ``max_steps``
        times, idle steps included."""
        while max_steps > 0 and (not until_empty
                                 or self.queue or self.slots.n_active):
            self.step()
            max_steps -= 1

    def kv_cache_bytes(self) -> int:
        """Resident KV-cache bytes of the current layout (pool tensors for
        paged, the stacked slot caches for dense, RWKV and Mamba state
        included)."""
        caches = self.pools if self.kv_layout == "paged" else self.cache_slots
        return sum(t.numel() * t.element_size()
                   for entry in caches for t in entry.values())
