"""Plain PyTorch reference of the served decoders: GQA attention with RoPE
(global or one sliding window), LayerNorm or RMSNorm, a GeLU MLP or a
mixture of experts routed under capacity. It imports nothing of the
program: it reads the configuration's sizes and the weights the benchmark
made, in the benchmark's layout.

``forward`` runs one request teacher-forced: its prompt, then the tokens
the program served fed back one by one, as a single causal sequence, and
returns f32 logits at every position that produced a served token. Each
step of it is what the program's prefill and paged decode compute for
that request:

* projections and expert products in bf16, as the configuration states;
  norms, RoPE, attention and the logits in f32;
* an MoE layer routes in f32 (softmax, top-k, the lower index first on
  ties, gates renormalised over the k chosen) and keeps an assignment while
  fewer than the capacity of its group came before it in token-major
  order. The program routes a prompt as one group (capacity from its
  padded bucket; padding comes after the prompt, so it never takes a
  prompt token's place) and each decode step's slots as one group. A
  decode token's group holds other requests, which a single request's
  forward cannot see: the caller passes, for each decode token, the
  assignments of the rows routed before it in its step (``prior``).

The reference routes by its own top k, and follows the program's choice
(``idx``) only where that choice is a near tie: where no expert it ranks
below another lies more than ``TIE_LOGIT`` above it in the reference's
router logits, so that rounding can have broken the tie either way. Each
token's ``route_gap`` is the widest such gap its choice crosses;
``routed_off_tie`` counts the tokens whose gap is ``TIE_LOGIT`` or more
(for the control, its own choices judged by the f32 router on its hidden
states), ``route_gap_max`` is the widest gap, and ``keep_mismatch``
counts the assignments the program kept or dropped against the capacity
rule applied to the choices routed.

``quant="fp8"`` is the control: every product takes its operands rounded
to float8 e4m3 under one scale a tensor (the projections, experts, router
and unembedding, and attention's q, k and v), the step from bf16 that
would tempt a change.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

F8_MAX = 448.0
# router logits closer than this are a near tie: the bf16 rounding of the
# hidden state moves the program's away from the reference's by less
# (widest gap a sound choice crossed on the H100: 0.079; the float8
# control's choices: 0.153 or more)
TIE_LOGIT = 0.11


def _fq(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = x.float().abs().amax().clamp_min(1e-12) / F8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Ref:
    def __init__(self, m: dict, params: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.m, self.p, self.quant = m, params, quant

    # ------------------------------------------------------------ products

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            x, w = _fq(x), _fq(w)
        return x @ w

    # ---------------------------------------------------------------- layers

    def norm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        eps = self.m["norm_eps"]
        if self.m["norm_type"] == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            y = (xf - mu) / torch.sqrt(var + eps) * p["scale"].float() + p["bias"].float()
        else:
            y = xf / torch.sqrt((xf * xf).mean(-1, keepdim=True) + eps) * p["scale"].float()
        return y.to(x.dtype)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """NeoX split-half rotary embedding: x (S, heads, hd), pos (S,)."""
        hd = x.shape[-1]
        half = hd // 2
        inv = self.m["rope_theta"] ** (-torch.arange(half, dtype=torch.float64,
                                                      device=x.device) / half)
        ang = (pos.double()[:, None] * inv)[:, None, :]
        cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
        a, b = x[..., :half].float(), x[..., half:].float()
        return torch.cat([a * cos - b * sin, a * sin + b * cos], -1).to(x.dtype)

    def attention(self, p: dict, h: torch.Tensor, q_block: int) -> torch.Tensor:
        m = self.m
        S = h.shape[0]
        H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q, k, v = self.mm(h, p["wq"]), self.mm(h, p["wk"]), self.mm(h, p["wv"])
        if m.get("use_bias"):
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        pos = torch.arange(S, device=h.device)
        q = self.rope(q.reshape(S, H, hd), pos).float()
        k = self.rope(k.reshape(S, KV, hd), pos).float()
        v = v.reshape(S, KV, hd).float()
        if self.quant is not None:  # attention's products in fp8 too, the cache with them
            q, k, v = _fq(q), _fq(k), _fq(v)
        window = m["window_size"] if tuple(m.get("attn_pattern", ("global",))) == ("local",) else 0
        G = H // KV
        out = torch.empty((S, H, hd), dtype=torch.float32, device=h.device)
        for s0 in range(0, S, q_block):
            s1 = min(S, s0 + q_block)
            k0 = max(0, s0 - window + 1) if window else 0
            qi = torch.arange(s0, s1, device=h.device)[:, None]
            ki = torch.arange(k0, s1, device=h.device)[None, :]
            ok = ki <= qi
            if window:
                ok &= (qi - ki) < window
            qg = q[s0:s1].reshape(s1 - s0, KV, G, hd)
            logits = torch.einsum("qkgh,skh->kgqs", qg, k[k0:s1]) * hd ** -0.5
            logits = logits.masked_fill(~ok, float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            o = torch.einsum("kgqs,skh->qkgh", probs, v[k0:s1])
            out[s0:s1] = o.reshape(s1 - s0, H, hd)
        o = self.mm(out.to(h.dtype).reshape(S, H * hd), p["wo"])
        return o + p["bo"] if m.get("use_bias") else o

    def mlp(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        if m["mlp_type"] == "gelu":
            u = self.mm(h, p["w_in"])
            if m.get("use_bias"):
                u = u + p["b_in"]
            y = self.mm(torch.nn.functional.gelu(u.float(), approximate="tanh").to(h.dtype),
                        p["w_out"])
            return y + p["b_out"] if m.get("use_bias") else y
        g = torch.nn.functional.silu(self.mm(h, p["w_gate"]).float())
        return self.mm((g * self.mm(h, p["w_up"]).float()).to(h.dtype), p["w_out"])

    def moe(self, p: dict, h: torch.Tensor, route: dict, stats: dict) -> torch.Tensor:
        """route: ``idx`` (S, k) the program's choices, ``keep`` (S, k) what
        it kept, ``prior`` (S, E) assignments routed before each token's
        group in token-major order, ``group`` (S,) group ids (tokens of one
        group contiguous), ``cap`` (S,) each token's group capacity."""
        m = self.m
        E, k = m["num_experts"], m["experts_per_token"]
        logits = h.float() @ p["router"].float()
        probs = torch.softmax(logits, -1)
        idx = route["idx"]
        if self.quant:  # the control routes by its own choices, made in fp8
            ctl = torch.softmax(self.mm(h.float(), p["router"].float()), -1)
            idx = torch.sort(ctl, dim=-1, descending=True, stable=True).indices[:, :k]
            probs = ctl
        gap = route_gap(logits, idx)
        off = gap >= TIE_LOGIT
        stats["routed_off_tie"] = stats.get("routed_off_tie", 0) + int(off.sum())
        stats["route_gap_max"] = max(stats.get("route_gap_max", 0.0), float(gap.max()))
        if not self.quant:
            best = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
            idx = torch.where(off[:, None], best, idx)
        # capacity: an assignment's rank in token-major order inside its group,
        # after the assignments routed before the group
        flat = torch.nn.functional.one_hot(idx.reshape(-1), E)
        before = flat.cumsum(0) - flat
        grp = route["group"].repeat_interleave(k)
        new_group = torch.ones_like(grp, dtype=torch.bool)
        new_group[1:] = grp[1:] != grp[:-1]
        gid = torch.cumsum(new_group.long(), 0) - 1
        rank = before - before[torch.nonzero(new_group)[:, 0]][gid]
        rank = rank + route["prior"].repeat_interleave(k, 0)
        rank = rank.gather(1, idx.reshape(-1, 1))[:, 0]
        keep = (rank < route["cap"].repeat_interleave(k)).reshape(-1, k)
        if not self.quant:
            stats["keep_mismatch"] = stats.get("keep_mismatch", 0) + int(
                (keep != route["keep"]).sum())
        gates = probs.gather(1, idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        w = gates * keep.float()
        y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for e in range(E):
            tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            x = h[tok]
            g = torch.nn.functional.silu(self.mm(x, p["w_gate"][e]).float())
            o = self.mm((g * self.mm(x, p["w_up"][e]).float()).to(h.dtype), p["w_out"][e])
            y.index_add_(0, tok, o.float() * w[tok, j][:, None])
        return y.to(h.dtype)

    # --------------------------------------------------------------- forward

    def forward(self, tokens: torch.Tensor, n_prompt: int,
                routes: Optional[List[dict]] = None, q_block: int = 1024) -> dict:
        """tokens (S,): the prompt then the served tokens but the last.
        Returns ``logits`` (S - n_prompt + 1, V) f32 at positions
        n_prompt - 1 .. S - 1, and the MoE numbers (``routed_off_tie``,
        ``route_gap_max``, ``keep_mismatch``) where the stack has experts."""
        m, p = self.m, self.p
        x = p["embed"][tokens]
        stats: dict = {}
        for i, lp in enumerate(p["layers"]):
            x = x + self.attention(lp["attn"], self.norm(lp["norm1"], x), q_block)
            h = self.norm(lp["norm2"], x)
            x = x + (self.moe(lp["moe"], h, routes[i], stats) if "moe" in lp
                     else self.mlp(lp["mlp"], h))
        h = self.norm(p["final_norm"], x[n_prompt - 1:]).float()
        w = p["embed"].T if m["tie_embeddings"] else p["lm_head"]
        stats["logits"] = self.mm(h, w.float())
        return stats


def route_gap(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S,) the widest gap by which an expert lies above one the choice
    ``idx`` (S, k) ranks before it, in ``logits`` (S, E): a later choice
    above an earlier one, or an expert left out above a chosen one."""
    chosen = logits.gather(1, idx)
    k = idx.shape[1]
    later = chosen[:, None, :] - chosen[:, :, None]  # [j, j']: l(c_j') - l(c_j)
    order = torch.triu(torch.ones(k, k, dtype=torch.bool, device=idx.device), 1)
    inner = later.masked_fill(~order, float("-inf")).amax((1, 2))
    left = logits.scatter(1, idx, float("-inf")).amax(1) - chosen.amin(1)
    return torch.maximum(inner, left).clamp_min(0.0)


def capacity(tokens: int, k: int, E: int, cf: float) -> int:
    """Capacity of a group of ``tokens`` routed together."""
    return max(1, int(math.ceil(tokens * k / E * cf)))
