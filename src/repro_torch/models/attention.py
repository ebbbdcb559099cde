"""Attention: GQA with RoPE, global or sliding-window masks, gemma2
soft-capping, prefix-LM, and KV caches (dense and paged).

Twin of ``repro.models.attention``: training, prefill and decode. The
reference chooses between its Pallas kernels and its jnp path with
``cfg.use_pallas``; the port dispatches on the tensors' device instead:
the kernel ops (``repro_torch.kernels.*.ops``) launch the hand-written CUDA
kernels on a CUDA tensor and run their plain PyTorch versions on a CPU
tensor. ``plain=True`` selects the model-level plain formulations
(``_direct_attention`` / ``_paged_attention_torch``, the reference's
``use_pallas=False`` path) on any device — the yardstick the kernel path is
held against on the card.

Layouts: activations (B, S, heads, hd); dense cache entry
``{"k": (B, L, KV, hd), "v": ..., "pos": (B, L) int32}`` — unlike the
reference, whose single-sequence cache carries one ``pos`` row, every
sequence of the batch carries its own positions, so a slot-batched dense
decode step can run every slot at its own position. Paged pool entry as the
reference: ``{"k": (n_phys, bs, KV, hd), "v", "pos": (n_phys, bs)}`` plus
f32 ``k_scale``/``v_scale`` (n_phys, bs, KV, 1) for int8 pools.

In-place updates: ``attn_decode`` writes the new token's K/V/pos into the
dense cache in place and ``attn_decode_paged`` into the pool in place (the
reference returns updated copies). Both still return the cache so call
sites read like the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import PLAIN_CALLS
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_vjp
from repro_torch.models.common import (NEG_INF, allow_mask, apply_rope,
                                       dense_init, mask_bias)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.optim.compress import dequantize_int8, quantize_int8
from repro_torch.parallel import is_dtensor, logical, logical_placements, split_last
from repro_torch.parallel.local import local_call, local_offset, partial_where_split


# ---------------------------------------------------------------------------
# params


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, (d, H * hd), dtype, device),
         "wk": dense_init(gen, (d, KV * hd), dtype, device),
         "wv": dense_init(gen, (d, KV * hd), dtype, device),
         "wo": dense_init(gen, (H * hd, d), dtype, device)}
    if cfg.use_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd),
                        ("bo", d)):
            p[name] = torch.zeros(n, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# plain attention math (grouped GQA form) — the reference's jnp path


def _softmax_attention(qg, k, v, ok, cap, scale):
    """qg: (B,Sq,KV,G,hd); k,v: (B,Sk,KV,hd); ok broadcastable to
    (B,KV,G,Sq,Sk). Returns (B,Sq,KV,G,hd)."""
    PLAIN_CALLS["model_attention"] += 1
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    if cap:
        logits = cap * torch.tanh(logits / cap)
    logits = logits.masked_fill(~ok, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _direct_attention(q, k, v, q_pos, k_pos, *, window, prefix_len, cap, scale):
    """q: (B,Sq,KV,G,hd); k,v: (B,Sk,KV,hd); positions 1-D, shared by the
    batch. Returns (B,Sq,KV,G,hd)."""
    ok = allow_mask(q_pos, k_pos, window=window, prefix_len=prefix_len)  # (Sq,Sk)
    return _softmax_attention(q, k, v, ok[None, None, None], cap, scale)


def _paged_attention_torch(qg, k, v, q_pos, k_pos, *, window, prefix_len, cap,
                           scale):
    """Batched-positions twin of ``_direct_attention`` (the reference's
    ``_paged_attention_jnp``): q_pos (B,Sq), k_pos (B,Sk), one mask row per
    sequence. Dense and paged plain decode both run through it."""
    ok = allow_mask(q_pos, k_pos, window=window, prefix_len=prefix_len)  # (B,Sq,Sk)
    return _softmax_attention(qg, k, v, ok[:, None, None], cap, scale)


def grouped_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, spec: LayerSpec,
                      plain: bool = False, train: bool = False, q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd). Positions are 1-D (shared by the
    batch; prefill and training self-attention over 0..S-1) or (B, S) per
    sequence (decode). Dispatch: ``plain`` -> the model-level plain math
    (differentiated by autograd in training); otherwise the kernel ops,
    which pick the CUDA kernel or its plain version by device. ``train``
    takes the flash op at every S, since its backward is the one the
    training path has; with ``cfg.flash_vjp`` it takes the op whose forward
    also returns the softmax statistics and whose backward recomputes
    chunk by chunk (``attn_chunk_q`` x ``attn_chunk_k``), the reference's
    ``_flash_jnp``.

    On DTensors (a mesh) the op runs on local shards (``_mesh_attention``);
    ``q_offset`` is then the global index of the local q chunk's first
    position, which the masks of prefill and training count from."""
    if is_dtensor(q):
        return _mesh_attention(q, k, v, q_pos, k_pos, cfg, spec, plain, train)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    window = cfg.window_size if spec.attn_type == "local" else 0
    if plain:
        kw = dict(window=window, prefix_len=cfg.prefix_len,
                  cap=cfg.attn_softcap, scale=hd**-0.5)
        qg = q.reshape(B, Sq, KV, G, hd)
        if q_pos.dim() == 1:
            return _direct_attention(qg, k, v, q_pos[q_offset:q_offset + Sq], k_pos,
                                     **kw).reshape(B, Sq, H, hd)
        return _paged_attention_torch(qg, k, v, q_pos, k_pos, **kw).reshape(B, Sq, H, hd)
    if Sq == 1 and not train:  # decode against a cache
        ok = allow_mask(q_pos, k_pos, window=window, prefix_len=cfg.prefix_len)
        bias = mask_bias(ok)[..., 0, :]  # (L,) or (B,L)
        o = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                             bias, softcap=cfg.attn_softcap)
        return o[:, None]
    if q_pos.dim() != 1 or q_offset + Sq > k.shape[1]:
        raise ValueError("prefill and training attention take self-attention "
                         "over positions 0..S-1")
    kw = dict(causal=True, window=window, softcap=cfg.attn_softcap,
              prefix_len=cfg.prefix_len, q_offset=q_offset)
    if train and cfg.flash_vjp:
        kw.update(chunk_q=min(cfg.attn_chunk_q, Sq), chunk_k=min(cfg.attn_chunk_k, Sq))
        op = flash_attention_vjp
    else:
        op = flash_attention
    o = op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    return o.transpose(1, 2).reshape(B, Sq, H, hd)


def _mesh_attention(q, k, v, q_pos, k_pos, cfg, spec, plain, train):
    """``grouped_attention`` on DTensors: each rank attends its local q
    (its batch rows, its sequence chunk under ``cp_fsdp``, its heads under
    ``tp``) against the whole key sequence of its rows, gathered where the
    layout shards it (a decode cache's ``cache_len``), and the key heads
    its q heads read. The output is laid out as q."""
    mesh = q.device_mesh
    qpl = logical_placements(q, "batch", "act_seq" if q.shape[1] > 1 else None,
                             "heads", None)
    kvpl = logical_placements(k, "batch", None, "kv_heads", None)
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    q_off = local_offset(q.shape, mesh, qpl, 1)
    h_off = local_offset(q.shape, mesh, qpl, 2)
    kv_off = local_offset(k.shape, mesh, kvpl, 2)
    decode = q_pos.dim() != 1
    if decode:
        pos_pl = logical_placements(k_pos, "batch", None)
        qp_pl = logical_placements(q_pos, "batch", None)
    else:
        pos_pl = qp_pl = None

    def attend(ql, kl, vl, qp, kp):
        Hl = ql.shape[2]
        k0 = h_off // G - kv_off
        k1 = (h_off + Hl - 1) // G + 1 - kv_off
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
        if k1 - k0 != 1 and not ((k1 - k0) * G == Hl and h_off % G == 0):
            raise ValueError(f"local heads {h_off}..{h_off + Hl} do not group over "
                             f"key heads {k0 + kv_off}..{k1 + kv_off}")
        return grouped_attention(ql, kl, vl, qp, kp, cfg, spec, plain, train,
                                 q_offset=0 if decode else q_off)

    kv_grad = partial_where_split(kvpl, [qpl])
    (o,) = local_call(attend, (q, k, v, q_pos, k_pos),
                      (qpl, kvpl, kvpl, qp_pl, pos_pl), (qpl,), mesh,
                      grad_placements=(None, kv_grad, kv_grad, None, None))
    return o


# ---------------------------------------------------------------------------
# qkv projection / output


def _project(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.use_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_last(q, (H, hd), "batch", "act_seq", "heads", None),
            split_last(k, (KV, hd), "batch", "act_kv_seq", "kv_heads", None),
            split_last(v, (KV, hd), "batch", "act_kv_seq", "kv_heads", None))


def _out(p, o, cfg: ModelConfig):
    B, S = o.shape[:2]
    y = o.reshape(B, S, -1) @ p["wo"]
    if cfg.use_bias:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# caches


def cache_len_for(cfg: ModelConfig, spec: LayerSpec, max_len: int) -> int:
    if spec.attn_type == "local" and cfg.window_size and cfg.window_size < max_len:
        return cfg.window_size
    return max_len


def init_cache_entry(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device):
    L = cache_len_for(cfg, spec, max_len)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
    }


def init_paged_entry(cfg: ModelConfig, spec: LayerSpec, n_phys_blocks: int,
                     block_size: int, dtype, device, quant: Optional[str] = None):
    """One layer's paged KV pool of ``n_phys_blocks`` blocks of
    ``block_size`` positions (``repro_torch.runtime.paging`` owns the block
    ids). Logical cache slot ``s`` of a sequence lives at physical block
    ``page_table[s // block_size]``, offset ``s % block_size``; ``pos`` is
    stored per (block, offset) so gathering a table row reproduces a dense
    cache entry. ``quant="int8"`` stores K/V int8 with rowwise f32 scales."""
    del spec  # every attention layer shares the pool shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    kv_dtype = torch.int8 if quant == "int8" else dtype
    shape = (n_phys_blocks, block_size, KV, hd)
    entry = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "pos": torch.full((n_phys_blocks, block_size), -1, dtype=torch.int32,
                          device=device),
    }
    if quant == "int8":
        sshape = (n_phys_blocks, block_size, KV, 1)
        entry["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        entry["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return entry


# ---------------------------------------------------------------------------
# layer entry points (x is already normed; residual handled by caller)


def attn_train(p, x, cfg: ModelConfig, spec: LayerSpec, positions,
               plain: bool = False):
    """The training forward of one layer: causal self-attention over
    ``positions`` (0..S-1), no cache. Returns y."""
    q, k, v = _project(p, x, cfg)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = _logical_qkv(q, k, v)
    o = grouped_attention(q, k, v, positions, positions, cfg, spec, plain, train=True)
    o = logical(o, "batch", "act_seq", "heads", None)
    return _out(p, o, cfg)


def _logical_qkv(q, k, v):
    return (logical(q, "batch", "act_seq", "heads", None),
            logical(k, "batch", "act_kv_seq", "kv_heads", None),
            logical(v, "batch", "act_kv_seq", "kv_heads", None))


def attn_prefill(p, x, cfg: ModelConfig, spec: LayerSpec, positions,
                 max_len=None, true_len=None, plain: bool = False):
    """Returns (y, cache_entry). The cache stores RoPE'd keys at absolute
    slots: global layers pad to ``max_len`` (empty slots carry pos=-1),
    local layers keep a rolling window (slot = pos % L).

    ``true_len`` marks a right-padded (bucketed) prompt whose tokens beyond
    ``true_len`` are padding: pad positions get pos=-1 and the rolling
    window is gathered so pad tokens never evict real keys. Requires
    ``cfg.prefix_len == 0`` (the batcher guards this)."""
    B, S, _ = x.shape
    max_len = max_len or S
    q, k, v = _project(p, x, cfg)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = _logical_qkv(q, k, v)
    o = grouped_attention(q, k, v, positions, positions, cfg, spec, plain)
    o = logical(o, "batch", "act_seq", "heads", None)
    y = _out(p, o, cfg)

    L = cache_len_for(cfg, spec, max_len)
    pos32 = positions.to(torch.int32)
    if true_len is not None:
        ck, cv, cpos = _padded_prefill_cache(k, v, pos32, L, int(true_len))
    elif L == S:
        ck, cv, cpos = k, v, pos32
    elif L > S:
        ck, cv, cpos = _pad_to(k, v, pos32, L)
    else:
        # rolling buffer invariant: slot = pos % L; roll so the last L keys
        # land on their slots.
        shift = (S - L) % L
        ck = torch.roll(k[:, S - L:], shift, dims=1)
        cv = torch.roll(v[:, S - L:], shift, dims=1)
        cpos = torch.roll(pos32[S - L:], shift, dims=0)
    cache = {"k": logical(ck.contiguous(), "batch", "cache_len", "kv_heads", None),
             "v": logical(cv.contiguous(), "batch", "cache_len", "kv_heads", None),
             "pos": cpos.expand(B, L).contiguous()}
    return y, cache


def _pad_to(k, v, pos32, L):
    B, S, KV, hd = k.shape
    ck = k.new_zeros((B, L, KV, hd))
    cv = v.new_zeros((B, L, KV, hd))
    ck[:, :S] = k
    cv[:, :S] = v
    cpos = torch.full((L,), -1, dtype=torch.int32, device=k.device)
    cpos[:S] = pos32
    return ck, cv, cpos


def _padded_prefill_cache(k, v, pos32, L, true_len: int):
    """Cache entry from a right-padded prefill of true length ``true_len``:
    what the exact-length prefill would have stored. For a rolling window
    (L < S) slot ``c`` holds the last real position ``p < true_len`` with
    ``p % L == c``, gathered from the padded sequence."""
    S = k.shape[1]
    if L >= S:
        idx = torch.arange(S, device=k.device)
        cpos = torch.where(idx < true_len, pos32, torch.full_like(pos32, -1))
        if L > S:
            return _pad_to(k, v, cpos, L)
        return k, v, cpos
    c = torch.arange(L, device=k.device)
    src = true_len - L + torch.remainder(c - true_len, L)  # last p<true_len, p%L==c
    valid = src >= 0
    safe = torch.clamp(src, 0, S - 1)
    ck = k.index_select(1, safe)
    cv = v.index_select(1, safe)
    cpos = torch.where(valid, src, torch.full_like(src, -1)).to(torch.int32)
    return ck, cv, cpos


def _pos_vector(pos, B, device):
    """Decode position(s) -> (B,) int64: a scalar is shared by the batch."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int64)
        return pos.expand(B) if pos.dim() == 0 else pos
    return torch.full((B,), int(pos), dtype=torch.int64, device=device)


def attn_decode(p, x, cache, cfg: ModelConfig, spec: LayerSpec, pos,
                plain: bool = False):
    """x: (B,1,d); pos: int / 0-d tensor shared by the batch, or (B,) per
    sequence. Writes the new K/V/pos into ``cache`` in place at slot
    ``pos % L`` of each row. Returns (y, cache)."""
    B = x.shape[0]
    q, k, v = _project(p, x, cfg)  # (B,1,H,hd), (B,1,KV,hd)
    pos_vec = _pos_vector(pos, B, x.device)
    qpos = pos_vec[:, None]  # (B,1)
    if cfg.pos_type == "rope":
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    L = cache["k"].shape[1]
    slot = torch.remainder(pos_vec, L)
    _write_slots(cache["k"], slot, k[:, 0])
    _write_slots(cache["v"], slot, v[:, 0])
    _write_slots(cache["pos"], slot, pos_vec)
    ck = logical(cache["k"], "batch", "cache_len", "kv_heads", None)
    cv = logical(cache["v"], "batch", "cache_len", "kv_heads", None)
    o = grouped_attention(q, ck, cv, qpos, cache["pos"], cfg, spec, plain)
    return _out(p, o, cfg), cache


def _replicated(x):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * x.device_mesh.ndim


def _write_slots(dst, slot, src):
    """``dst[b, slot[b]] = src[b]`` for every row b, in place. On a DTensor
    cache each rank writes the (row, slot) pairs its shard holds."""
    if is_dtensor(slot):
        slot = slot.full_tensor()
    if is_dtensor(src):
        src = src.full_tensor()
    rows = torch.arange(dst.shape[0], device=slot.device)
    if not is_dtensor(dst):
        dst[rows, slot] = src.to(dst.dtype)
        return
    local = dst.to_local()
    if local.device.type == "meta":  # a traced step: no values to write
        return
    b0 = local_offset(dst.shape, dst.device_mesh, dst.placements, 0)
    l0 = local_offset(dst.shape, dst.device_mesh, dst.placements, 1)
    mine = ((rows >= b0) & (rows < b0 + local.shape[0])
            & (slot >= l0) & (slot < l0 + local.shape[1]))
    local[rows[mine] - b0, slot[mine] - l0] = src[mine].to(local.dtype)


def attn_decode_paged(p, x, pool, cfg: ModelConfig, spec: LayerSpec, pos_vec,
                      pages, plain: bool = False):
    """Slot-batched decode step against this layer's paged KV pool.

    x: (B,1,d); pos_vec: (B,) per-slot absolute positions; pages: (B,
    P_global) int32 page-table rows (shared across layers; a local layer
    uses only its first ``window // block_size`` pages). The new K/V land
    at logical slot ``s = pos % L`` -> physical ``(pages[s // bs], s % bs)``,
    written into the pool in place; every slot writes unconditionally and
    the runtime points inactive slots at the TRASH block. Returns (y, pool).
    """
    if is_dtensor(x):  # on a mesh: every rank runs the whole batch
        rep = tuple(_replicated(x))
        flat, names = [], []
        for name, w in p.items():
            flat.append(w)
            names.append(name)

        def step(xl, *ws):
            y, _ = attn_decode_paged(dict(zip(names, ws)), xl, pool, cfg, spec,
                                     pos_vec, pages, plain)
            return y

        (y,) = local_call(step, (x, *flat), (rep,) * (1 + len(flat)), (rep,),
                          x.device_mesh)
        return y, pool
    B = x.shape[0]
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    bs = pool["k"].shape[1]
    max_len = pages.shape[1] * bs
    L = cache_len_for(cfg, spec, max_len)
    P = L // bs
    window = cfg.window_size if spec.attn_type == "local" else 0
    quantized = "k_scale" in pool

    q, k, v = _project(p, x, cfg)
    pos_vec = pos_vec.to(device=x.device, dtype=torch.int64)
    qpos = pos_vec[:, None]
    if cfg.pos_type == "rope":
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)

    s = torch.remainder(pos_vec, L)
    blk = pages.long().gather(1, (s // bs)[:, None])[:, 0]  # (B,)
    off = s % bs
    newk, newv = k[:, 0], v[:, 0]  # (B,KV,hd)
    if quantized:
        qk, ksc = quantize_int8(newk)
        qv, vsc = quantize_int8(newv)
        pool["k"][blk, off] = qk
        pool["v"][blk, off] = qv
        pool["k_scale"][blk, off] = ksc
        pool["v_scale"][blk, off] = vsc
    else:
        pool["k"][blk, off] = newk.to(pool["k"].dtype)
        pool["v"][blk, off] = newv.to(pool["v"].dtype)
    pool["pos"][blk, off] = pos_vec.to(torch.int32)

    tbl = pages[:, :P]
    cpos = pool["pos"][tbl.long()].reshape(B, L)
    if plain:
        idx = tbl.long()
        ck = pool["k"][idx].reshape(B, L, KV, hd)
        cv = pool["v"][idx].reshape(B, L, KV, hd)
        if quantized:
            ck = dequantize_int8(ck, pool["k_scale"][idx].reshape(B, L, KV, 1))
            cv = dequantize_int8(cv, pool["v_scale"][idx].reshape(B, L, KV, 1))
        o = _paged_attention_torch(
            q.reshape(B, 1, KV, H // KV, hd), ck, cv, qpos, cpos,
            window=window, prefix_len=cfg.prefix_len, cap=cfg.attn_softcap,
            scale=hd**-0.5).reshape(B, 1, H, hd).to(q.dtype)
    else:
        ok = allow_mask(qpos, cpos, window=window, prefix_len=cfg.prefix_len)
        bias = mask_bias(ok)[:, 0]  # (B,L)
        o = paged_decode_attention(
            q[:, 0], pool["k"], pool["v"], tbl.to(torch.int32), bias,
            k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
            softcap=cfg.attn_softcap)[:, None]
    return _out(p, o, cfg), pool
