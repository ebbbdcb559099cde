"""Plain PyTorch version of the serving-fleet simulator: the twin of the
reference's ``repro.runtime.serving_jax._simulate`` (XLA, no Pallas), over a
leading lane axis.

One lane is one fleet trajectory (one grid point and seed of a sweep cube);
lanes share the request stream and the pinning signal (``consts``) and
differ in their traced parameters and PRNG key. The tick is the
reference's, phase for phase, in the same dtypes (int32 state, f32
scores, bool masks) and the same order of float operations, so a lane
equals the reference's output bit for bit. The reference's vmapped form
is kept: each ``lax.cond`` is a host-side ``if`` over "any lane needs it"
with the work masked per lane where a lane's branch would not be the
identity, and the routing ``while_loop`` runs to the largest entry count
among the lanes. The routing and revocation draws are threefry blocks of
``(key, t, entry, sub-key)``, as ``jax.random`` draws them
(``repro_torch.runtime.threefry``).

``csrc/serving_fleet.cu`` computes the same function on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import PLAIN_CALLS
from repro_torch.runtime import threefry

INF = float("inf")
REVOKE_CHUNK = 256  # ticks of revocation draws made at once


def tick_keys(key, T: int):
    """Per-tick keys of each lane: ``tk = fold_in(key, t)``, the routing
    key ``fold_in(tk, 1)`` and the revocation key ``fold_in(tk, 3)``, each a
    pair of (L, T) word tensors."""
    k0, k1 = key
    ts = torch.arange(T, dtype=torch.int64, device=k0.device)
    tk = threefry.fold_in((k0[:, None], k1[:, None]), ts[None, :])
    return threefry.fold_in(tk, 1), threefry.fold_in(tk, 3)


def simulate_ref(spec, params, consts, key):
    """``spec``: a ``FleetSpec``; ``params``: the traced parameters, each a
    tensor with a leading lane axis L (``credit_rate``/``credit_burst``
    (L, n_tenants)); ``consts``: ``build_consts``' numpy arrays, shared by
    the lanes; ``key``: a pair of (L,) int64 word tensors. Returns the
    reference's output dict, each entry with a leading lane axis."""
    PLAIN_CALLS["serving_fleet"] += 1
    with torch.inference_mode():
        return _simulate(spec, params, consts, key)


def _simulate(spec, params, consts, key):
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    dev = key[0].device
    L = key[0].shape[0]
    R, S, Q = spec.n_replicas, spec.slot_cap, spec.queue_cap
    N, T, W = spec.n_requests, spec.horizon, spec.route_cap
    W2, RC = 2 * W, 2 * N
    n_ond, K_cap, NT, P = (spec.n_ondemand, spec.transient_cap,
                           spec.n_tenants, spec.pipe_len)
    LC, HC = spec.lifetime_cap, spec.hedge_cap
    rd = spec.probe_retries * spec.probe_d

    def const(name):
        return torch.as_tensor(np.asarray(consts[name]), dtype=i32, device=dev)

    arrival, gen, tenant_c = const("arrival"), const("gen"), const("tenant")
    arr_start = np.asarray(consts["arr_start"])
    arr_count = np.asarray(consts["arr_count"])
    pin_tgt = np.asarray(consts["pinned_target"])
    idx_r = torch.arange(R, device=dev)
    is_ond = idx_r < n_ond
    is_tr = ~is_ond
    home_tid = idx_r % NT
    lane = torch.arange(L, device=dev)

    thr = params["threshold"].to(dev, f32)
    k_max = params["max_transient"].to(dev, f32)
    m_slots = params["max_slots"].to(dev, i32)
    hf = params["hedge_factor"].to(dev, f32)
    rev_p = params["revoke_prob"].to(dev, f32)
    spot_mttf = params["spot_mttf"].to(dev, f32)
    cred_rate = params["credit_rate"].to(dev, f32).reshape(L, NT)
    cred_burst = params["credit_burst"].to(dev, f32).reshape(L, NT)
    m_slots_f = m_slots.to(f32)
    slot_open = torch.arange(S, device=dev)[None, :] < m_slots[:, None]  # (L,S)
    revoking = bool((rev_p > 0).any())  # u < rev_p is never true otherwise

    def take(arr, idx):
        """arr (L, X) gathered at idx (L, ...)."""
        return arr.gather(1, idx.reshape(L, -1).to(i64)).reshape(idx.shape)

    def cget(c, idx):
        """a shared const (X,) at idx (L, ...)."""
        return c[idx.to(i64)]

    def put(arr, idx, val, mask):
        """arr[l, idx] = val where mask (the reference's mode="drop"
        scatter with the dropped rows left out); idx/val/mask (L, ...)."""
        ln = lane.view((L,) + (1,) * (idx.dim() - 1)).expand_as(idx)
        if not isinstance(val, torch.Tensor):
            val = torch.full_like(idx, val, dtype=arr.dtype)
        arr[ln[mask], idx[mask].to(i64)] = val.expand_as(idx)[mask].to(arr.dtype)

    def q_window(q_rid, q_head, q_len, width):
        offs = torch.arange(width, device=dev)
        pos = (q_head[:, :, None] + offs) % Q
        return q_rid.gather(2, pos.to(i64)), offs < q_len[:, :, None]

    # ---- carry (serving_jax.py:760-785)
    online = is_ond.expand(L, R).clone()
    draining = torch.zeros(L, R, dtype=torch.bool, device=dev)
    online_at = torch.zeros(L, R, dtype=i32, device=dev)
    flushing = torch.zeros(L, R, dtype=torch.bool, device=dev)
    q_rid = torch.full((L, R, Q), -1, dtype=i32, device=dev)
    q_head = torch.zeros(L, R, dtype=i32, device=dev)
    q_len = torch.zeros(L, R, dtype=i32, device=dev)
    pend = torch.zeros(L, R, dtype=i32, device=dev)
    slot_rid = torch.full((L, R, S), -1, dtype=i32, device=dev)
    slot_rem = torch.zeros(L, R, S, dtype=i32, device=dev)
    start = torch.full((L, N), -1, dtype=i32, device=dev)
    finish = torch.full((L, N), -1, dtype=i32, device=dev)
    hedged = torch.zeros(L, N, dtype=torch.bool, device=dev)
    routed_at = arrival.expand(L, N).clone()
    pipe = torch.zeros(L, P, dtype=i32, device=dev)  # ring: pipe[k] = buf[(t+k)%P]
    ring = torch.full((L, RC), -1, dtype=i32, device=dev)
    rr_head = torch.zeros(L, dtype=i32, device=dev)
    rr_len = torch.zeros(L, dtype=i32, device=dev)
    want_prev = 0  # the pinning signal is shared by the lanes
    zl = torch.zeros(L, dtype=i32, device=dev)
    n_hedges, n_hcancel, n_revoke, n_rentals, n_over = (zl.clone() for _ in range(5))
    lt_buf = torch.zeros(L, LC, dtype=f32, device=dev)
    lt_count, lt_sum, n_throttle = zl.clone(), zl.clone(), zl.clone()
    credits = cred_burst.clone()

    route_key, revoke_key = tick_keys(key, T)
    rev_u = None
    flush_live = False    # some lane may hold a flushing replica
    drain_live = False    # some lane may hold a draining replica
    rows = []

    a_vec = torch.arange(K_cap + 1, dtype=f32, device=dev)
    ctrl_memo = {}

    def controller(want, n_act):
        """Phase 5's (add, rem): leading-true counts over a = 0..K, the
        reference's float comparisons. A pure function of the pinning
        target and three counts a lane, so it is memoised on them."""
        n_drain = (online & draining).sum(1, dtype=i32)
        n_pend_tr = pipe.sum(1, dtype=i32)
        memo_key = (want, tuple(torch.stack([n_act, n_drain, n_pend_tr]).flatten().tolist()))
        hit = ctrl_memo.get(memo_key)
        if hit is not None:
            return hit
        n_stable = n_ond + n_act
        long_busy = torch.tensor(float(want), dtype=f32, device=dev)
        proj = (n_stable + n_drain + n_pend_tr).to(f32)[:, None] + a_vec
        used = (n_act + n_pend_tr).to(f32)[:, None] + a_vec
        cond_a = ((long_busy > thr[:, None] * torch.clamp(proj, min=1.0))
                  & (used < k_max[:, None]))
        add = cond_a.to(i32).cumprod(1).sum(1, dtype=i32)
        cond_r = (((n_act.to(f32)[:, None] - a_vec) > 0)
                  & (long_busy < thr[:, None] * torch.clamp(
                      n_stable.to(f32)[:, None] - a_vec - 1.0, min=1.0)))
        rem = cond_r.to(i32).cumprod(1).sum(1, dtype=i32)
        rem = torch.where(add > 0, 0, rem)
        ctrl_memo[memo_key] = hit = (add, rem, bool((add > 0).any() or (rem > 0).any()))
        return hit

    def ring_push(rid, mask):
        nonlocal rr_len
        slot = (rr_head[:, None].to(i64) + rr_len[:, None]
                + mask.to(i64).cumsum(1) - 1) % RC
        put(ring, slot, rid, mask)
        rr_len = rr_len + mask.sum(1, dtype=i32)

    def push_entries(tgt, rid, mask, t):
        """serving_jax.py:270: same-target ranks give queue order; overflow
        past queue_cap is counted."""
        nonlocal q_len, pend, n_over
        order = torch.arange(tgt.shape[1], device=dev)
        same = ((tgt[:, None, :] == tgt[:, :, None])
                & mask[:, None, :] & mask[:, :, None])
        rank = (same & (order[None, :] < order[:, None])).sum(2)
        tgt_c = torch.where(mask, tgt, 0).to(i64)
        pos = q_len.gather(1, tgt_c) + rank
        ok = mask & (pos < Q)
        col = (q_head.gather(1, tgt_c) + pos) % Q
        ln = lane[:, None].expand_as(tgt_c)
        q_rid[ln[ok], tgt_c[ok], col[ok].to(i64)] = rid[ok].to(i32)
        q_len = q_len.scatter_add(1, tgt_c, ok.to(i32))
        g = torch.where(ok, cget(gen, torch.where(ok, rid, 0)), 0).to(i32)
        pend = pend.scatter_add(1, tgt_c, g)
        put(routed_at, rid, t, ok)
        n_over = n_over + (mask & ~ok).sum(1, dtype=i32)

    want_arr = np.minimum(pin_tgt[:T], n_ond)
    want_changes = np.flatnonzero(np.diff(want_arr) != 0) + 1
    arr_ticks = np.flatnonzero(arr_count[:T] > 0)
    pinned_by_want = {}
    rev_chunk = -1
    hedges_any = ring_live = False
    credits_live = bool(((cred_rate > 0) & (credits < cred_burst)).any())
    next_due = T  # first tick whose pipe entry is nonzero, as of the last full tick
    big = torch.iinfo(i32).max

    def revoke_draws(t):
        nonlocal rev_u, rev_chunk
        if t // REVOKE_CHUNK != rev_chunk:
            rev_chunk = t // REVOKE_CHUNK
            c = slice(rev_chunk * REVOKE_CHUNK, min((rev_chunk + 1) * REVOKE_CHUNK, T))
            rev_u = threefry.uniform((revoke_key[0][:, c], revoke_key[1][:, c]), R)
        return rev_u[:, t % REVOKE_CHUNK:]

    def quiet_span(t, pinned):
        """How many ticks from t on do nothing in any lane but decode every
        occupied slot one token and refill the credits (no arrival, pin
        change, flush, provisioning, reroute, controller action,
        revocation, hedge, admission, completion or drain), and the
        (act, occ) masks of the span; (0, None) when tick t does more.
        Such ticks are the reference's tick with every phase but the
        decode an identity, so they are stepped at once."""
        want = int(want_arr[t])
        if (want != want_prev or ring_live or next_due <= t or arr_count[t] > 0):
            return 0, None
        limit = min(int(want_changes[np.searchsorted(want_changes, t, "right")])
                    if np.searchsorted(want_changes, t, "right") < len(want_changes) else T,
                    int(arr_ticks[np.searchsorted(arr_ticks, t)])
                    if np.searchsorted(arr_ticks, t) < len(arr_ticks) else T,
                    next_due) - t
        if flush_live and bool((flushing & (pinned | ~online)).any()):
            return 0, None
        act_tr = online & is_tr & ~draining
        if controller(want, act_tr.sum(1, dtype=i32))[2]:
            return 0, None
        act = online & ~pinned
        occ = (slot_rid >= 0) & act[:, :, None]
        if hedges_any and bool((occ & (take(finish, torch.where(occ, slot_rid, 0)) >= 0)).any()):
            return 0, None
        free = ((slot_rid < 0) & slot_open[:, None, :]).sum(2)
        if bool((act & (q_len > 0) & (free > 0)).any()):
            return 0, None
        if drain_live and bool((act & draining & (q_len == 0) & ~occ.any(2)).any()):
            return 0, None
        limit = min(limit, int(torch.where(occ, slot_rem, big).amin()) - 1)
        if limit > 0 and revoking:
            u = revoke_draws(t)[:, :limit]
            hit = ((u < rev_p[:, None, None]) & act_tr[:, None, :]).any(2).any(0)
            limit = min(limit, u.shape[1], int(hit.to(i32).argmax()) if bool(hit.any())
                        else limit)
        if limit > 0 and n_ond > want and bool((act_tr & (pend > 0)).any()):
            # the earliest tick t' with (t' - routed_at) > hedge_factor x gen
            # in f32, over the hedge windows of the active transients
            hq_rid, hq_val = q_window(q_rid, q_head, q_len, spec.hedge_scan)
            h_val = torch.cat([hq_val, slot_rid >= 0], 2) & act_tr[:, :, None]
            h_rid = torch.where(h_val, torch.cat([hq_rid, slot_rid], 2), 0)
            cand = h_val & ~take(hedged, h_rid) & (take(finish, h_rid) < 0)
            x = hf[:, None, None] * cget(gen, h_rid).to(f32)
            first = take(routed_at, h_rid).to(torch.float64) + torch.floor(x.to(torch.float64)) + 1
            first = float(torch.where(cand & ~torch.isnan(first), first, INF).amin())
            limit = int(min(limit, max(first - t, 0.0)))
        return (limit, (act, occ)) if limit > 0 else (0, None)

    t = 0
    while t < T:
        want = int(want_arr[t])
        pinned = pinned_by_want.get(want)
        if pinned is None:
            pinned = pinned_by_want[want] = is_ond & (idx_r < want)
        k, masks = quiet_span(t, pinned)
        if k:
            act, occ = masks
            if credits_live:
                for _ in range(k):
                    credits = torch.minimum(credits + cred_rate, cred_burst)
                credits_live = bool(((cred_rate > 0) & (credits < cred_burst)).any())
            busy_r = occ.sum(2, dtype=i32)
            slot_rem = torch.where(occ, slot_rem - k, slot_rem)
            pend = pend - k * busy_r
            row = torch.cat([torch.stack([
                (online & is_tr).sum(1, dtype=i32), busy_r.sum(1, dtype=i32),
                act.sum(1, dtype=i32) * m_slots,
                torch.where(is_tr, busy_r, 0).sum(1, dtype=i32),
                (act & is_tr).sum(1, dtype=i32) * m_slots,
                torch.where(online, q_len, 0).sum(1, dtype=i32)], 1),
                torch.zeros(L, 10 + 2 * NT, dtype=i32, device=dev)], 1)
            rows.append(row[:, None, :].expand(L, k, row.shape[1]))
            t += k
            continue
        credits = torch.minimum(credits + cred_rate, cred_burst)
        n_thr_pre = n_throttle

        # ---- 1 · pinning (serving_jax.py:306)
        ev_disp_pin = zl
        if want > want_prev:
            a, b = want_prev, want
            sr = slot_rid[:, a:b]
            disp = sr >= 0
            d_rid = torch.where(disp, sr, 0)
            d_live = disp & (take(finish, d_rid) < 0)
            ev_disp_pin = d_live.sum((1, 2), dtype=i32)
            put(start, d_rid, -1, d_live & ~take(hedged, d_rid))
            ring_push(d_rid.reshape(L, -1), d_live.reshape(L, -1))
            pend[:, a:b] -= torch.where(disp, slot_rem[:, a:b], 0).sum(2, dtype=i32)
            slot_rid[:, a:b] = torch.where(disp, -1, sr)
            slot_rem[:, a:b] = torch.where(disp, 0, slot_rem[:, a:b])
            flushing[:, a:b] |= q_len[:, a:b] > 0
            flush_live = True

        # ---- 2 · flush displaced/revoked queues (serving_jax.py:327)
        if flush_live:
            fl = flushing & (pinned | ~online)
            on = fl.any(1)
            if bool(on.any()):
                f_rid, f_val = q_window(q_rid, q_head, q_len, spec.flush_cap)
                f_val = f_val & fl[:, :, None]
                f_pop = f_val.sum(2, dtype=i32)
                f_rid_c = torch.where(f_val, f_rid, 0)
                hg = take(hedged, f_rid_c)
                f_route = f_val & (take(finish, f_rid_c) < 0) & ~(is_tr[None, :, None] & hg)
                put(start, f_rid_c, -1, f_route & ~hg)
                ring_push(f_rid_c.reshape(L, -1), f_route.reshape(L, -1))
                pend = pend - torch.where(f_val, cget(gen, f_rid_c), 0).sum(2, dtype=i32)
                q_head = (q_head + f_pop) % Q
                q_len = q_len - f_pop
                flushing = torch.where(on[:, None], flushing & (q_len > 0), flushing)
            flush_live = bool(flushing.any())

        # ---- 3 · provisioning pipeline (serving_jax.py:357)
        h = t % P
        due = pipe[:, h].clone()
        n_on = zl
        if bool(due.any()):
            pipe[:, h] = 0
            avail = is_tr & ~online & (q_len == 0)
            pick = avail & (avail.to(i32).cumsum(1) <= due[:, None])
            n_on = pick.sum(1, dtype=i32)
            pipe[:, (t + 1) % P] += due - n_on
            online = online | pick
            draining = draining & ~pick
            online_at = torch.where(pick, t, online_at)
            n_rentals = n_rentals + n_on

        # ---- 4 · routing (serving_jax.py:370)
        act_tr = online & is_tr & ~draining
        n_act = act_tr.sum(1, dtype=i32)
        ev_reroute = zl
        n_arr = int(arr_count[t])
        if n_arr > 0 or bool((rr_len > 0).any()):
            # a lane with nothing to route runs no entry: its branch is the
            # identity, so no lane mask is needed here
            offs = torch.arange(W, device=dev)
            n_popped = torch.clamp(rr_len, max=W)
            rr_rid = ring.gather(1, ((rr_head[:, None] + offs) % RC).to(i64))
            rr_head = (rr_head + n_popped) % RC
            rr_len = rr_len - n_popped
            e_rid = torch.zeros(L, W2, dtype=i32, device=dev)
            e_rid[:, :W] = torch.where(offs < n_popped[:, None], rr_rid, 0)
            a_rid = torch.clamp(int(arr_start[t]) + offs[:n_arr], 0, N - 1).to(i32)
            e_rid.scatter_(1, (n_popped[:, None] + offs[:n_arr]).to(i64),
                           a_rid.expand(L, n_arr))
            n_e = n_popped + n_arr
            ar2 = torch.arange(W2, device=dev)
            e_val = (ar2 < n_e[:, None]) & (take(finish, e_rid) < 0)
            ev_reroute = ((ar2 < n_popped[:, None]) & e_val).sum(1, dtype=i32)
            # the k-th active transient row, in row order, at act_list[k]
            order = torch.argsort((~act_tr).to(i32), dim=1, stable=True)[:, :K_cap]
            act_list = torch.where(torch.arange(K_cap, device=dev) < n_act[:, None],
                                   order, 0)
            E = int(n_e.max())
            # draws of entry i: ek = fold_in(route_key, i); probes from
            # fold_in(ek, 0), fallbacks from fold_in(ek, 1)
            ek = threefry.fold_in((route_key[0][:, t, None], route_key[1][:, t, None]),
                                  torch.arange(E, device=dev)[None, :])
            sub = threefry.fold_in((ek[0][..., None], ek[1][..., None]),
                                   torch.tensor([0, 1], device=dev))
            which = torch.tensor([0] * rd + [1] * spec.probe_d, device=dev)
            ctr = torch.cat([torch.arange(rd, device=dev),
                             torch.arange(spec.probe_d, device=dev)])
            b0, b1 = threefry.threefry2x32(sub[0][..., which], sub[1][..., which], 0, ctr)
            u = threefry.bits_to_uniform(b0 ^ b1)                        # (L,E,rd+d)
            ci_all = torch.floor(u[..., :rd] * n_ond).to(i32).to(i64).reshape(
                L, E, spec.probe_retries, spec.probe_d)
            fb_all = torch.floor(u[..., rd:] * torch.clamp(n_act, min=1).to(f32)[:, None, None]
                                 ).to(i32)
            unpin = is_ond & ~pinned
            pin_ond = is_ond & pinned
            any_unpin = bool(unpin.any())
            pend_add = torch.zeros(L, R, dtype=i32, device=dev)
            chosen = torch.zeros(L, W2, dtype=i64, device=dev)
            for i in range(E):
                pend_now = (pend + pend_add).to(f32) / m_slots_f[:, None]
                ci = ci_all[:, i]
                c_ok = ~pinned[ci]
                round_ok = c_ok.any(2)
                has_round = round_ok.any(1)
                rd_cand = ci[lane, round_ok.to(i32).argmax(1)]
                rd_score = torch.where(~pinned[rd_cand], pend_now.gather(1, rd_cand), INF)
                probe_sid = rd_cand.gather(1, rd_score.argmin(1, keepdim=True))[:, 0]
                fci = act_list.gather(1, torch.clamp(fb_all[:, i], 0, K_cap - 1).to(i64))
                fb_score = pend_now.gather(1, fci)
                rid = e_rid[:, i].to(i64)
                g = gen[rid]
                if spec.spot_pricing:
                    dur = g.to(f32)[:, None]
                    fb_score = fb_score + dur * (fb_score + dur) / spot_mttf[:, None]
                fb_sid = fci.gather(1, fb_score.argmin(1, keepdim=True))[:, 0]
                if any_unpin:
                    ll_sid = torch.where(unpin, pend_now, INF).argmin(1)
                else:
                    ll_sid = torch.where(pin_ond, pend_now, INF).argmin(1)
                live = e_val[:, i]
                te = tenant_c[rid].to(i64)
                cost = g.to(f32)
                home = unpin[None, :] & (home_tid[None, :] == te[:, None])
                any_home = home.any(1)
                ll_home = torch.where(home, pend_now, INF).argmin(1)
                funded = credits.gather(1, te[:, None])[:, 0] >= cost
                throttled = live & ~funded & any_home
                normal = torch.where(has_round, probe_sid,
                                     torch.where(n_act > 0, fb_sid, ll_sid))
                sid = torch.where(throttled, ll_home, normal)
                credits = credits.scatter_add(
                    1, te[:, None], -torch.where(live & funded, cost, 0.0)[:, None])
                n_throttle = n_throttle + throttled.to(i32)
                pend_add = pend_add.scatter_add(
                    1, sid[:, None], torch.where(live, g, 0)[:, None])
                chosen[:, i] = sid
            push_entries(chosen, e_rid, e_val, t)

        # ---- 5 · §3.2 controller (serving_jax.py:499)
        add, rem, _ = controller(want, n_act)
        pipe[:, h] += add  # pipe[P-1] after this tick's shift
        load = q_len + (slot_rid >= 0).sum(2, dtype=i32)
        if bool((rem > 0).any()):
            drain_key = {0: load.to(f32), 1: online_at.to(f32),
                         2: -online_at.to(f32)}[spec.drain_code]
            score = torch.where(act_tr, drain_key, INF)
            drank = torch.argsort(torch.argsort(score, dim=1, stable=True), dim=1,
                                  stable=True)
            draining = draining | (act_tr & (drank < rem[:, None]))
            drain_live = True

        # ---- 6 · revocations (serving_jax.py:524)
        ev_revoke = ev_disp_rev = zl
        if revoking:
            u_t = revoke_draws(t)[:, 0]
            revoked = online & is_tr & ~draining & (u_t < rev_p[:, None])
            if bool(revoked.any()):
                ev_revoke = revoked.sum(1, dtype=i32)
                v = revoked[:, :, None] & (slot_rid >= 0)
                v_rid = torch.where(v, slot_rid, 0)
                v_route = v & (take(finish, v_rid) < 0) & ~take(hedged, v_rid)
                ev_disp_rev = v_route.sum((1, 2), dtype=i32)
                put(start, v_rid, -1, v_route)
                ring_push(v_rid.reshape(L, -1), v_route.reshape(L, -1))
                pend = pend - torch.where(v, slot_rem, 0).sum(2, dtype=i32)
                slot_rid = torch.where(v, -1, slot_rid)
                slot_rem = torch.where(v, 0, slot_rem)
                life = torch.where(revoked, t - online_at, 0)
                lt_idx = lt_count[:, None] + revoked.to(i32).cumsum(1) - 1
                put(lt_buf, lt_idx, life.to(f32), revoked & (lt_idx < LC))
                lt_sum = lt_sum + life.sum(1, dtype=i32)
                lt_count = lt_count + ev_revoke
                n_revoke = n_revoke + ev_revoke
                online = online & ~revoked
                flushing = flushing | (revoked & (q_len > 0))
                flush_live = True

        # ---- 7 · §3.3 hedging (serving_jax.py:571)
        act_tr = online & is_tr & ~draining
        reserve = is_ond & ~pinned
        n_res = n_ond - want
        n_hedges_pre = n_hedges
        if n_res > 0:
            on = (act_tr & (pend > 0)).any(1)
            if bool(on.any()):
                hq_rid, hq_val = q_window(q_rid, q_head, q_len, spec.hedge_scan)
                occ_s = slot_rid >= 0
                h_val = torch.cat([hq_val, occ_s], 2)
                h_rid = torch.where(h_val, torch.cat([hq_rid, slot_rid], 2), 0)
                elig = (h_val & (act_tr & on[:, None])[:, :, None]
                        & ~take(hedged, h_rid) & (take(finish, h_rid) < 0)
                        & ((t - take(routed_at, h_rid)).to(f32)
                           > hf[:, None, None] * cget(gen, h_rid).to(f32)))
                if bool(elig.any()):
                    e_flat = elig.reshape(L, -1)
                    h_cum = e_flat.to(i32).cumsum(1)
                    sel = e_flat & (h_cum <= HC)
                    hedge_rid = torch.zeros(L, HC, dtype=i32, device=dev)
                    put(hedge_rid, h_cum - 1, h_rid.reshape(L, -1), sel)
                    hedge_ok = (torch.arange(HC, device=dev)
                                < torch.clamp(sel.sum(1), max=HC)[:, None])
                    put(hedged, hedge_rid, True, hedge_ok)
                    n_hedges = n_hedges + hedge_ok.sum(1, dtype=i32)
                    res_order = torch.argsort(torch.where(reserve, load.to(f32), INF),
                                              dim=1, stable=True)
                    h_tgt = res_order[:, torch.arange(HC, device=dev) % max(n_res, 1)]
                    push_entries(h_tgt, hedge_rid, hedge_ok, t)

        # ---- 8 · advance every unpinned online replica (serving_jax.py:621)
        act = online & ~pinned
        occ = (slot_rid >= 0) & act[:, :, None]
        stale = occ & (take(finish, torch.where(occ, slot_rid, 0)) >= 0)
        if bool(stale.any()):
            n_hcancel = n_hcancel + stale.sum((1, 2), dtype=i32)
            pend = pend - torch.where(stale, slot_rem, 0).sum(2, dtype=i32)
            slot_rid = torch.where(stale, -1, slot_rid)
            slot_rem = torch.where(stale, 0, slot_rem)

        ev_admit = zl
        tn_admit = tn_wait = None
        if bool((act & (q_len > 0)).any()):
            # a lane with no queued active replica admits nothing: identity
            Pw = spec.admit_window
            w_rid, w_val = q_window(q_rid, q_head, q_len, Pw)
            w_val = w_val & act[:, :, None]
            w_rid = torch.where(w_val, w_rid, 0)
            alive = w_val & (take(finish, w_rid) < 0)
            free_mask = (slot_rid < 0) & slot_open[:, None, :] & act[:, :, None]
            free = free_mask.sum(2, dtype=i32)
            live_cum = alive.to(i32).cumsum(2)
            admit = alive & (live_cum <= free[:, :, None])
            stop = (alive & (live_cum == free[:, :, None])).to(i32).argmax(2)
            live_tot = live_cum[:, :, -1]
            n_valid = w_val.sum(2, dtype=i32)
            consumed = torch.where(free <= 0, 0,
                                   torch.where(live_tot >= free, stop + 1, n_valid)).to(i32)
            dead = (w_val & ~alive
                    & (torch.arange(Pw, device=dev) < consumed[:, :, None]))
            n_hcancel = n_hcancel + dead.sum((1, 2), dtype=i32)
            pend = pend - torch.where(dead, cget(gen, w_rid), 0).sum(2, dtype=i32)
            free_rank = free_mask.to(i32).cumsum(2)
            hit = (admit[:, :, None, :] & free_mask[:, :, :, None]
                   & (live_cum[:, :, None, :] == free_rank[:, :, :, None]))
            has = hit.any(3)
            ev_admit = has.sum((1, 2), dtype=i32)
            eidx = hit.to(i32).argmax(3)
            a_rid = w_rid.gather(2, eidx)
            slot_rid = torch.where(has, a_rid, slot_rid)
            slot_rem = torch.where(has, cget(gen, a_rid), slot_rem)
            a_safe = torch.where(has, a_rid, 0)
            sg = take(start, a_safe)
            put(start, a_rid, torch.where(sg < 0, t, sg), has)
            news = has & (sg < 0)
            te_a = torch.where(news, cget(tenant_c, a_safe), NT).reshape(L, -1).to(i64)
            tn_admit = torch.zeros(L, NT + 1, dtype=i32, device=dev).scatter_add(
                1, te_a, torch.ones_like(te_a, dtype=i32))[:, :NT]
            waits = torch.where(news, t - cget(arrival, a_safe), 0).reshape(L, -1)
            tn_wait = torch.zeros(L, NT + 1, dtype=i32, device=dev).scatter_add(
                1, te_a, waits.to(i32))[:, :NT]
            q_head = (q_head + consumed) % Q
            q_len = q_len - consumed
        if tn_admit is None:
            tn_admit = tn_wait = torch.zeros(L, NT, dtype=i32, device=dev)

        occ = (slot_rid >= 0) & act[:, :, None]
        busy_r = occ.sum(2, dtype=i32)
        slot_rem = torch.where(occ, slot_rem - 1, slot_rem)
        pend = pend - busy_r
        fin = occ & (slot_rem <= 0)
        ev_hedge_win = zl
        if bool(fin.any()):
            f_rid2 = torch.where(fin, slot_rid, 0)
            fg = take(finish, f_rid2)
            ev_hedge_win = (fin & (fg < 0) & take(hedged, f_rid2)).sum((1, 2), dtype=i32)
            put(finish, f_rid2, torch.where(fg < 0, t + 1, fg), fin)
            slot_rid = torch.where(fin, -1, slot_rid)
            slot_rem = torch.where(fin, 0, slot_rem)

        cap = act.sum(1, dtype=i32) * m_slots
        busy = busy_r.sum(1, dtype=i32)
        tr_cap = (act & is_tr).sum(1, dtype=i32) * m_slots
        tr_busy = torch.where(is_tr, busy_r, 0).sum(1, dtype=i32)

        n_done_drain = zl
        if drain_live:
            done_drain = (act & draining & (q_len == 0)
                          & ~(slot_rid >= 0).any(2))
            if bool(done_drain.any()):
                n_done_drain = done_drain.sum(1, dtype=i32)
                life = torch.where(done_drain, t - online_at, 0)
                lt_idx = lt_count[:, None] + done_drain.to(i32).cumsum(1) - 1
                put(lt_buf, lt_idx, life.to(f32), done_drain & (lt_idx < LC))
                lt_sum = lt_sum + life.sum(1, dtype=i32)
                lt_count = lt_count + n_done_drain
                online = online & ~done_drain
                draining = draining & ~done_drain
            drain_live = bool(draining.any())

        online_tr = (online & is_tr).sum(1, dtype=i32)
        qdepth = torch.where(online, q_len, 0).sum(1, dtype=i32)
        ev_counts = torch.stack([
            add,                          # RENT
            n_on,                         # PROVISION
            n_done_drain,                 # DRAIN
            ev_revoke,                    # REVOKE
            n_hedges - n_hedges_pre,      # HEDGE
            ev_hedge_win,                 # HEDGE_WIN
            ev_admit,                     # ADMIT
            ev_disp_pin + ev_disp_rev,    # DISPLACE
            ev_reroute,                   # REROUTE
            n_throttle - n_thr_pre,       # THROTTLE
        ], 1)
        rows.append(torch.cat([
            torch.stack([online_tr, busy, cap, tr_busy, tr_cap, qdepth], 1),
            ev_counts, tn_admit, tn_wait], 1)[:, None, :])
        want_prev = want
        # what the quiet-span test reads of this tick's end state
        nz = (pipe != 0).any(0).tolist()
        next_due = min((t + 1 + (i - t - 1) % P for i in range(P) if nz[i]), default=T)
        ring_live = bool((rr_len > 0).any())
        hedges_any = hedges_any or bool((n_hedges > 0).any())
        credits_live = bool(((cred_rate > 0) & (credits < cred_burst)).any())
        t += 1

    ys = torch.cat(rows, 1) if rows else torch.zeros(L, 0, 16 + 2 * NT, dtype=i32)
    return {
        "start": start, "finish": finish, "hedged": hedged,
        "active_transients": ys[:, :, 0], "busy": ys[:, :, 1], "cap": ys[:, :, 2],
        "tr_busy": ys[:, :, 3], "tr_cap": ys[:, :, 4],
        "event_counts": ys[:, :, 6:16], "queue_depth": ys[:, :, 5],
        "n_hedges": n_hedges, "n_hedge_cancelled": n_hcancel,
        "n_revocations": n_revoke, "n_rentals": n_rentals,
        "n_overflow": n_over, "lifetimes": lt_buf,
        "n_lifetimes": lt_count, "lifetime_sum": lt_sum,
        "final_online_transients": (online & is_tr).sum(1, dtype=i32),
        "final_tr_online": online & is_tr,
        "final_online_at": online_at,
        "tenant_admits": ys[:, :, 16:16 + NT], "tenant_wait_sums": ys[:, :, 16 + NT:],
        "n_throttled": n_throttle, "final_credits": credits,
    }
