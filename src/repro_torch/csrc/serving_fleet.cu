// The serving fleet's simulator: one fleet trajectory per thread block, the
// whole horizon in one launch.
//
// Replaces the reference's XLA program (it has no Pallas kernel)
//   src/repro/runtime/serving_jax.py:222 _simulate
// a lax.scan over decode ticks whose tick (:293-786) has five lax.cond
// phases and routes one request at a time in a lax.while_loop. Run eagerly
// on the card that is a few hundred tiny launches a tick; a CUDA graph would
// have to unroll the routing loop to its bound (2 x route_cap entries).
//
// What bounds it. Almost nothing of the fleet's state moves per tick: a tick
// reads and writes the hot per-replica state, ~10 KB at the paper's scale,
// and the queues only where requests are routed or admitted. The work is a
// chain of ticks, each of a dozen dependent phases with a block barrier
// between them, and the routing walks its entries one after another. So the
// kernel is bound by the latency of that chain (barriers, shared-memory
// round trips, one warp's serial routing), not by bytes or operations, and
// it is far from its roofline by construction; lanes (grid points x seeds)
// are independent blocks that fill the card's SMs side by side.
//
// Design. Block b runs lane b. The hot state (online/draining/flushing
// flags, online_at, queue heads and lengths, pending work, slot residents
// and their remaining tokens, the provisioning pipe, tenant credits) lives
// in shared memory for the whole run; the per-replica queues (R x Q), the
// reroute ring (2N) and the per-request arrays (start, finish, hedged,
// routed_at) live in global memory. Each tick runs the reference's phases
// 1-8 in order, separated by __syncthreads: the vectorised phases
// (flush-clearing, hedge eligibility, stale-slot cancellation, admission,
// decode, drain completion, the tick's sums) spread one replica row per
// thread; the order-dependent steps the reference writes as cumsum
// compactions or rank scatters (ring pushes, queue pushes, the drain and
// hedge-target picks, lifetimes) run in row order on one thread, where they
// are rare. Routing runs on one warp, entry by entry in order: its lanes
// draw the entry's probes and fallbacks in parallel (threefry, as
// jax.random draws them), and the least-loaded picks are shuffle argmins that
// keep the first index on ties, as jnp.argmin does. Where one request's
// start or finish may be stamped by two rows in a tick (a hedge pair), the
// rows read the old value in one step and write in the next, as the
// reference's gather-then-scatter does. Float steps use the _rn intrinsics,
// so no multiply-add is contracted and every score rounds as in the
// reference.

#include <math_constants.h>

#include "common.cuh"

struct FleetParams {
  // spec (serving_torch.FleetSpec)
  int L, R, S, Q, N, T, W, n_ond, K, NT, P, retries, d, FC, AW, HS, HC, LC;
  int drain_code, spot;
  // consts, shared by the lanes
  const int* arrival; const int* gen; const int* tenant;
  const int* arr_start; const int* arr_count; const int* pin;
  // traced parameters, per lane
  const float* thr; const float* k_max; const int* m_slots; const float* hf;
  const float* rev_p; const float* spot_mttf;
  const float* cred_rate; const float* cred_burst;  // (L, NT)
  const uint32_t* key;                              // (L, 2)
  // per-lane global state
  int* q_rid;       // (L, R, Q)
  int* ring;        // (L, 2N)
  int* routed_at;   // (L, N)
  // outputs
  int* start; int* finish; uint8_t* hedged;   // (L, N)
  int* series;      // (L, T, 16 + 2 NT)
  float* lifetimes; // (L, LC)
  int* counters;    // (L, N_COUNTERS)
  uint8_t* final_tr_online; int* final_online_at;  // (L, R)
  float* final_credits;                            // (L, NT)
};

namespace {

constexpr int FLEET_THREADS = 256;
#define F_INF CUDART_INF_F


// counters, in the wrapper's order
enum { C_HEDGES, C_HCANCEL, C_REVOKE, C_RENTALS, C_OVER, C_LT_COUNT, C_LT_SUM,
       C_THROTTLE, C_FINAL_TR, N_COUNTERS };

// per-tick sums and lane scalars kept in shared memory
enum {
  S_RR_HEAD, S_RR_LEN, S_WANT_PREV, S_HEDGES, S_HCANCEL, S_REVOKE, S_RENTALS,
  S_OVER, S_LT_COUNT, S_LT_SUM, S_THROTTLE,
  // per tick
  S_N_ACT, S_N_DRAIN, S_ADD, S_REM, S_N_ON, S_DRAIN_DONE, S_EV_REVOKE,
  S_EV_HWIN, S_EV_ADMIT, S_EV_DISP, S_EV_REROUTE, S_THR_PRE, S_HEDGE_PRE,
  S_N_REVOKED, S_FLAG, S_BUSY, S_TR_BUSY, S_CAP_ROWS, S_TR_CAP_ROWS,
  S_ONLINE_TR, S_QDEPTH, S_N_E, S_N_POPPED, S_TK0, S_TK1, N_SCALARS
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32, 20 rounds: jax.random's block function.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

struct Key { uint32_t a, b; };

__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
  uint32_t x0 = 0, x1 = data;
  threefry2x32(k.a, k.b, x0, x1);
  return {x0, x1};
}

// jax.random.uniform(k, shape)[i] in f32 (partitionable counters (0, i)).
__device__ __forceinline__ float uniform_at(Key k, uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry2x32(k.a, k.b, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3f800000u), 1.0f);
}

__device__ __forceinline__ int warp_sum_int(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

// (value, index) argmin over a warp keeping the first index on ties.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

struct Smem {
  int *online_at, *q_head, *q_len, *pend, *load, *pend_add, *rtmp;
  uint8_t *on, *dr, *fl;
  int *slot_rid, *slot_rem, *stmp, *stmp2;
  int *pipe, *tn_ad, *tn_wt, *act_list, *e_rid, *chosen, *hedge_rid, *h_tgt;
  int *draw_ci, *draw_fb, *sc;
  float* credits;
  uint8_t* e_val;
};

__host__ __device__ inline size_t align4(size_t x) { return (x + 3) & ~size_t(3); }

// Carve the dynamic shared memory; with base == nullptr it only sizes it.
__host__ __device__ inline size_t carve(const FleetParams& p, char* base, Smem* m) {
  size_t off = 0;
  auto ints = [&](int*& ptr, size_t n) {
    ptr = reinterpret_cast<int*>(base + off);
    off += 4 * n;
  };
  const size_t R = p.R, RS = size_t(p.R) * p.S, W2 = 2 * size_t(p.W);
  Smem tmp;
  Smem& s = m ? *m : tmp;
  ints(s.online_at, R); ints(s.q_head, R); ints(s.q_len, R); ints(s.pend, R);
  ints(s.load, R); ints(s.pend_add, R); ints(s.rtmp, R);
  ints(s.slot_rid, RS); ints(s.slot_rem, RS); ints(s.stmp, RS); ints(s.stmp2, RS);
  ints(s.pipe, p.P); ints(s.tn_ad, p.NT); ints(s.tn_wt, p.NT);
  ints(s.act_list, p.K); ints(s.e_rid, W2); ints(s.chosen, W2);
  ints(s.hedge_rid, p.HC); ints(s.h_tgt, p.HC);
  ints(s.draw_ci, 32); ints(s.draw_fb, 32); ints(s.sc, N_SCALARS);
  s.credits = reinterpret_cast<float*>(base + off);
  off += 4 * size_t(p.NT);
  s.on = reinterpret_cast<uint8_t*>(base + off); off += R;
  s.dr = reinterpret_cast<uint8_t*>(base + off); off += R;
  s.fl = reinterpret_cast<uint8_t*>(base + off); off += R;
  s.e_val = reinterpret_cast<uint8_t*>(base + off); off += W2;
  return align4(off);
}

__global__ void __launch_bounds__(FLEET_THREADS)
fleet_kernel(const FleetParams p) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem m;
  carve(p, smem_raw, &m);
  const int lane_id = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int wl = tid & 31;
  const int R = p.R, S = p.S, Q = p.Q, N = p.N, T = p.T, W = p.W, RC = 2 * p.N;
  const int n_ond = p.n_ond, K = p.K, NT = p.NT, P = p.P;
  const int rdraws = p.retries * p.d;
  int* q_rid = p.q_rid + size_t(lane_id) * R * Q;
  int* ring = p.ring + size_t(lane_id) * RC;
  int* routed_at = p.routed_at + size_t(lane_id) * N;
  int* start = p.start + size_t(lane_id) * N;
  int* finish = p.finish + size_t(lane_id) * N;
  uint8_t* hedged = p.hedged + size_t(lane_id) * N;
  const int n_cols = 16 + 2 * NT;
  int* series = p.series + size_t(lane_id) * T * n_cols;
  float* lt_buf = p.lifetimes + size_t(lane_id) * p.LC;
  const float thr = p.thr[lane_id], k_max = p.k_max[lane_id];
  const int m_slots = p.m_slots[lane_id];
  const float m_slots_f = static_cast<float>(m_slots);
  const float hf = p.hf[lane_id], rev_p = p.rev_p[lane_id];
  const float spot_mttf = p.spot_mttf[lane_id];
  const Key key = {p.key[2 * lane_id], p.key[2 * lane_id + 1]};
  int* sc = m.sc;

  // ---- carry (serving_jax.py:760)
  for (int r = tid; r < R; r += nth) {
    m.on[r] = r < n_ond; m.dr[r] = 0; m.fl[r] = 0;
    m.online_at[r] = 0; m.q_head[r] = 0; m.q_len[r] = 0; m.pend[r] = 0;
    m.rtmp[r] = 0;
  }
  for (int i = tid; i < R * S; i += nth) { m.slot_rid[i] = -1; m.slot_rem[i] = 0; }
  for (int i = tid; i < N; i += nth) {
    start[i] = -1; finish[i] = -1; hedged[i] = 0; routed_at[i] = p.arrival[i];
  }
  for (int i = tid; i < P; i += nth) m.pipe[i] = 0;
  for (int i = tid; i < NT; i += nth) m.credits[i] = p.cred_burst[lane_id * NT + i];
  for (int i = tid; i < N_SCALARS; i += nth) sc[i] = 0;
  __syncthreads();

  auto ring_push = [&](int rid) {  // one thread, in order
    ring[(sc[S_RR_HEAD] + sc[S_RR_LEN]) % RC] = rid;
    sc[S_RR_LEN] += 1;
  };
  // one thread, in order: queue push with overflow (serving_jax.py:270)
  auto push_entry = [&](int r, int rid, int t) {
    if (m.q_len[r] < Q) {
      q_rid[size_t(r) * Q + (m.q_head[r] + m.q_len[r]) % Q] = rid;
      m.q_len[r] += 1;
      m.pend[r] += p.gen[rid];
      routed_at[rid] = t;
    } else {
      sc[S_OVER] += 1;
    }
  };
  auto pend_now = [&](int r) {
    return __fdiv_rn(static_cast<float>(m.pend[r] + m.pend_add[r]), m_slots_f);
  };
  auto act_tr_row = [&](int r) { return r >= n_ond && m.on[r] && !m.dr[r]; };

  for (int t = 0; t < T; ++t) {
    const int want = min(p.pin[t], n_ond);
    __syncthreads();  // the last tick's scalars are written
    const int want_prev = sc[S_WANT_PREV];
    if (tid == 0) {
      for (int i = S_N_ACT; i < N_SCALARS; ++i) sc[i] = 0;
      for (int i = 0; i < NT; ++i) {
        m.credits[i] = fminf(__fadd_rn(m.credits[i], p.cred_rate[lane_id * NT + i]),
                             p.cred_burst[lane_id * NT + i]);
        m.tn_ad[i] = 0; m.tn_wt[i] = 0;
      }
      sc[S_THR_PRE] = sc[S_THROTTLE];
      sc[S_HEDGE_PRE] = sc[S_HEDGES];
      const Key tk = fold_in(key, static_cast<uint32_t>(t));
      sc[S_TK0] = static_cast<int>(tk.a);
      sc[S_TK1] = static_cast<int>(tk.b);
    }
    __syncthreads();
    const Key tk = {static_cast<uint32_t>(sc[S_TK0]), static_cast<uint32_t>(sc[S_TK1])};

    // ---- 1 · pinning: newly pinned rows displace their slot residents
    if (want > want_prev) {
      if (tid == 0) {
        for (int r = want_prev; r < want; ++r) {
          for (int s = 0; s < S; ++s) {
            const int rid = m.slot_rid[r * S + s];
            if (rid < 0) continue;
            if (finish[rid] < 0) {
              sc[S_EV_DISP] += 1;
              if (!hedged[rid]) start[rid] = -1;
              ring_push(rid);
            }
            m.pend[r] -= m.slot_rem[r * S + s];
            m.slot_rid[r * S + s] = -1;
            m.slot_rem[r * S + s] = 0;
          }
          if (m.q_len[r] > 0) m.fl[r] = 1;
        }
      }
      __syncthreads();
    }

    // ---- 2 · flush displaced/revoked queues into the reroute ring
    {
      int any = 0;
      for (int r = tid; r < R; r += nth)
        any |= m.fl[r] && ((r < want) || !m.on[r]);
      if (__syncthreads_or(any)) {
        if (tid == 0) {
          for (int r = 0; r < R; ++r) {
            if (!(m.fl[r] && ((r < want) || !m.on[r]))) continue;
            const int n = min(m.q_len[r], p.FC);
            for (int j = 0; j < n; ++j) {
              const int rid = q_rid[size_t(r) * Q + (m.q_head[r] + j) % Q];
              m.pend[r] -= p.gen[rid];
              if (finish[rid] < 0 && !(r >= n_ond && hedged[rid])) {
                if (!hedged[rid]) start[rid] = -1;
                ring_push(rid);
              }
            }
            m.q_head[r] = (m.q_head[r] + n) % Q;
            m.q_len[r] -= n;
          }
        }
        __syncthreads();
        for (int r = tid; r < R; r += nth)
          if (m.q_len[r] <= 0) m.fl[r] = 0;
        __syncthreads();
      }
    }

    // ---- 3 · provisioning pipeline (pipe[k] = pipe_buf[(t + k) % P])
    const int h = t % P;
    if (m.pipe[h] > 0) {
      __syncthreads();
      if (tid == 0) {
        const int due = m.pipe[h];
        m.pipe[h] = 0;
        int n_on = 0;
        for (int r = n_ond; r < R && n_on < due; ++r) {
          if (!m.on[r] && m.q_len[r] == 0) {
            m.on[r] = 1; m.dr[r] = 0; m.online_at[r] = t;
            ++n_on;
          }
        }
        m.pipe[(t + 1) % P] += due - n_on;
        sc[S_N_ON] = n_on;
        sc[S_RENTALS] += n_on;
      }
    }
    __syncthreads();

    // ---- 4 · routing: reroute-ring pops, then this tick's arrivals
    {
      int n_act = 0;
      for (int r = tid; r < R; r += nth) n_act += act_tr_row(r);
      n_act = warp_sum_int(n_act);
      if (wl == 0 && n_act) atomicAdd(&sc[S_N_ACT], n_act);
    }
    const int n_arr = p.arr_count[t];
    const bool route = sc[S_RR_LEN] > 0 || n_arr > 0;
    __syncthreads();
    const int n_act = sc[S_N_ACT];
    if (route) {
      if (tid == 0) {
        int k = 0;
        for (int r = n_ond; r < R; ++r)
          if (act_tr_row(r)) m.act_list[k++] = r;
        for (; k < K; ++k) m.act_list[k] = 0;
        const int n_popped = min(sc[S_RR_LEN], W);
        for (int i = 0; i < n_popped; ++i) m.e_rid[i] = ring[(sc[S_RR_HEAD] + i) % RC];
        sc[S_RR_HEAD] = (sc[S_RR_HEAD] + n_popped) % RC;
        sc[S_RR_LEN] -= n_popped;
        const int a0 = p.arr_start[t];
        for (int i = 0; i < n_arr; ++i) m.e_rid[n_popped + i] = min(max(a0 + i, 0), N - 1);
        const int n_e = n_popped + n_arr;
        int ev_rr = 0;
        for (int i = 0; i < n_e; ++i) {
          m.e_val[i] = finish[m.e_rid[i]] < 0;
          if (i < n_popped) ev_rr += m.e_val[i];
        }
        sc[S_EV_REROUTE] = ev_rr;
        sc[S_N_E] = n_e;
      }
      for (int r = tid; r < R; r += nth) m.pend_add[r] = 0;
      __syncthreads();
      if (tid < 32) {  // one warp walks the entries in order
        const int n_e = sc[S_N_E];
        const Key route_key = fold_in(tk, 1);
        const float n_act_f = static_cast<float>(max(n_act, 1));
        for (int i = 0; i < n_e; ++i) {
          if (!m.e_val[i]) continue;  // stale hedge loser: nothing changes
          const int rid = m.e_rid[i];
          const Key ek = fold_in(route_key, static_cast<uint32_t>(i));
          if (wl < rdraws) {
            const float u = uniform_at(fold_in(ek, 0), static_cast<uint32_t>(wl));
            m.draw_ci[wl] = static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(n_ond))));
          } else if (wl < rdraws + p.d) {
            const float u = uniform_at(fold_in(ek, 1), static_cast<uint32_t>(wl - rdraws));
            m.draw_fb[wl - rdraws] = static_cast<int>(floorf(__fmul_rn(u, n_act_f)));
          }
          __syncwarp();
          // probing: first round with an unpinned candidate wins
          int first = 0;
          bool has_round = false;
          for (int rr = 0; rr < p.retries && !has_round; ++rr) {
            for (int j = 0; j < p.d; ++j) {
              if (m.draw_ci[rr * p.d + j] >= want) { has_round = true; first = rr; }
            }
          }
          int probe_sid = m.draw_ci[first * p.d];
          float best = probe_sid >= want ? pend_now(probe_sid) : F_INF;
          for (int j = 1; j < p.d; ++j) {
            const int c = m.draw_ci[first * p.d + j];
            const float sc_j = c >= want ? pend_now(c) : F_INF;
            if (sc_j < best) { best = sc_j; probe_sid = c; }
          }
          // fallback: d draws over the active-transient pool
          const float dur = static_cast<float>(p.gen[rid]);
          int fb_sid = 0;
          float fb_best = F_INF;
          for (int j = 0; j < p.d; ++j) {
            const int c = m.act_list[min(max(m.draw_fb[j], 0), K - 1)];
            float s = pend_now(c);
            if (p.spot) s = __fadd_rn(s, __fdiv_rn(__fmul_rn(dur, __fadd_rn(s, dur)), spot_mttf));
            if (j == 0 || s < fb_best) { fb_best = s; fb_sid = c; }
          }
          const int te = p.tenant[rid];
          const bool funded = m.credits[te] >= dur;
          // least-loaded general replica (unpinned first), and the tenant's
          // home slice, as warp argmins; only when the choice needs them
          const bool need_ll = !has_round && n_act <= 0;
          int ll_sid = 0, ll_home = 0;
          bool any_home = false;
          if (need_ll) {
            const int lo = want < n_ond ? want : 0, hi = want < n_ond ? n_ond : want;
            float v = F_INF;
            int idx = 0x7fffffff;
            for (int r = lo + wl; r < hi; r += 32) {
              const float x = pend_now(r);
              if (x < v || idx == 0x7fffffff) { v = x; idx = r; }
            }
            warp_argmin(v, idx);
            ll_sid = idx == 0x7fffffff ? 0 : idx;
          }
          if (!funded) {
            float v = F_INF;
            int idx = 0x7fffffff;
            for (int r = want + wl; r < n_ond; r += 32) {
              if (r % NT != te) continue;
              const float x = pend_now(r);
              if (x < v || idx == 0x7fffffff) { v = x; idx = r; }
            }
            warp_argmin(v, idx);
            any_home = idx != 0x7fffffff;
            ll_home = any_home ? idx : 0;
          }
          const bool throttled = !funded && any_home;
          const int normal = has_round ? probe_sid : (n_act > 0 ? fb_sid : ll_sid);
          const int sid = throttled ? ll_home : normal;
          __syncwarp();
          if (wl == 0) {
            if (funded) m.credits[te] = __fadd_rn(m.credits[te], -dur);
            if (throttled) sc[S_THROTTLE] += 1;
            m.pend_add[sid] += p.gen[rid];
            m.chosen[i] = sid;
          }
          __syncwarp();
        }
      }
      __syncthreads();
      if (tid == 0) {
        const int n_e = sc[S_N_E];
        for (int i = 0; i < n_e; ++i)
          if (m.e_val[i]) push_entry(m.chosen[i], m.e_rid[i], t);
      }
    }
    __syncthreads();

    // ---- 5 · §3.2 controller: leading-true counts over a = 0..K
    {
      int n_drain = 0;
      for (int r = tid; r < R; r += nth) {
        n_drain += m.on[r] && m.dr[r];
        int occ = 0;
        for (int s = 0; s < S; ++s) occ += m.slot_rid[r * S + s] >= 0;
        m.load[r] = m.q_len[r] + occ;
      }
      n_drain = warp_sum_int(n_drain);
      if (wl == 0 && n_drain) atomicAdd(&sc[S_N_DRAIN], n_drain);
    }
    __syncthreads();
    if (tid == 0) {
      int n_pend_tr = 0;
      for (int i = 0; i < P; ++i) n_pend_tr += m.pipe[i];
      const int n_stable = n_ond + n_act;
      const float long_busy = static_cast<float>(want);
      const float base_p = static_cast<float>(n_stable + sc[S_N_DRAIN] + n_pend_tr);
      const float base_u = static_cast<float>(n_act + n_pend_tr);
      int add = 0;
      for (int a = 0; a <= K; ++a) {
        const float af = static_cast<float>(a);
        const float proj = __fadd_rn(base_p, af);
        const float used = __fadd_rn(base_u, af);
        if (!(long_busy > __fmul_rn(thr, fmaxf(proj, 1.0f)) && used < k_max)) break;
        ++add;
      }
      int rem = 0;
      if (add == 0) {
        const float act_f = static_cast<float>(n_act), stable_f = static_cast<float>(n_stable);
        for (int a = 0; a <= K; ++a) {
          const float af = static_cast<float>(a);
          const float lim = fmaxf(__fsub_rn(__fsub_rn(stable_f, af), 1.0f), 1.0f);
          if (!(__fsub_rn(act_f, af) > 0.0f && long_busy < __fmul_rn(thr, lim))) break;
          ++rem;
        }
      }
      m.pipe[h] += add;  // pipe[P - 1] after this tick's shift
      sc[S_ADD] = add;
      // drain the `rem` active transients first in (key, row) order
      for (int k = 0; k < rem; ++k) {
        int best_r = -1;
        float best = 0.0f;
        for (int r = n_ond; r < R; ++r) {
          if (!act_tr_row(r) || m.rtmp[r] == -7) continue;
          const float key_r = p.drain_code == 0 ? static_cast<float>(m.load[r])
                            : p.drain_code == 1 ? static_cast<float>(m.online_at[r])
                                                : -static_cast<float>(m.online_at[r]);
          if (best_r < 0 || key_r < best) { best = key_r; best_r = r; }
        }
        if (best_r < 0) break;
        m.rtmp[best_r] = -7;  // chosen this tick
      }
      if (rem > 0) {
        for (int r = n_ond; r < R; ++r) {
          if (m.rtmp[r] == -7) { m.dr[r] = 1; m.rtmp[r] = 0; }
        }
      }
    }
    __syncthreads();

    // ---- 6 · revocations: each active transient dies w.p. rev_p a tick
    if (rev_p > 0.0f) {
      const Key rk = fold_in(tk, 3);
      int n_rev = 0;
      for (int r = tid; r < R; r += nth) {
        int rv = 0;
        if (act_tr_row(r)) rv = uniform_at(rk, static_cast<uint32_t>(r)) < rev_p;
        m.rtmp[r] = rv;
        n_rev += rv;
      }
      n_rev = warp_sum_int(n_rev);
      if (wl == 0 && n_rev) atomicAdd(&sc[S_N_REVOKED], n_rev);
      __syncthreads();
      if (sc[S_N_REVOKED] > 0) {
        if (tid == 0) {
          int k = 0;
          for (int r = n_ond; r < R; ++r) {
            if (!m.rtmp[r]) continue;
            for (int s = 0; s < S; ++s) {
              const int rid = m.slot_rid[r * S + s];
              if (rid < 0) continue;
              if (finish[rid] < 0 && !hedged[rid]) {
                sc[S_EV_DISP] += 1;
                start[rid] = -1;
                ring_push(rid);
              }
              m.pend[r] -= m.slot_rem[r * S + s];
              m.slot_rid[r * S + s] = -1;
              m.slot_rem[r * S + s] = 0;
            }
            const int life = t - m.online_at[r];
            if (sc[S_LT_COUNT] + k < p.LC) lt_buf[sc[S_LT_COUNT] + k] = static_cast<float>(life);
            ++k;
            sc[S_LT_SUM] += life;
            m.on[r] = 0;
            if (m.q_len[r] > 0) m.fl[r] = 1;
            m.rtmp[r] = 0;
          }
          sc[S_LT_COUNT] += k;
          sc[S_REVOKE] += k;
          sc[S_EV_REVOKE] = k;
        }
      }
      __syncthreads();
    }

    // ---- 7 · §3.3 hedging onto the least-loaded reserve
    const int n_res = n_ond - want;
    if (n_res > 0) {
      int any = 0;
      for (int r = tid; r < R; r += nth) any |= act_tr_row(r) && m.pend[r] > 0;
      if (__syncthreads_or(any)) {
        const int width = p.HS + S;  // <= 32: one bit an entry
        int any_elig = 0;
        for (int r = tid; r < R; r += nth) {
          uint32_t mask = 0;
          if (act_tr_row(r)) {
            for (int j = 0; j < width; ++j) {
              int rid;
              if (j < p.HS) {
                if (j >= m.q_len[r]) continue;
                rid = q_rid[size_t(r) * Q + (m.q_head[r] + j) % Q];
              } else {
                rid = m.slot_rid[r * S + (j - p.HS)];
                if (rid < 0) continue;
              }
              if (hedged[rid] || finish[rid] >= 0) continue;
              if (static_cast<float>(t - routed_at[rid])
                  > __fmul_rn(hf, static_cast<float>(p.gen[rid])))
                mask |= 1u << j;
            }
          }
          m.rtmp[r] = static_cast<int>(mask);
          any_elig |= mask != 0;
        }
        if (__syncthreads_or(any_elig)) {
          if (tid == 0) {
            int n_sel = 0;
            for (int r = n_ond; r < R && n_sel < p.HC; ++r) {
              const uint32_t mask = static_cast<uint32_t>(m.rtmp[r]);
              for (int j = 0; j < width && n_sel < p.HC; ++j) {
                if (!(mask >> j & 1u)) continue;
                m.hedge_rid[n_sel++] = j < p.HS
                    ? q_rid[size_t(r) * Q + (m.q_head[r] + j) % Q]
                    : m.slot_rid[r * S + (j - p.HS)];
              }
            }
            for (int k = 0; k < n_sel; ++k) hedged[m.hedge_rid[k]] = 1;
            sc[S_HEDGES] += n_sel;
            // reserve rows in (load, row) order; the k-th hedge goes to
            // the (k mod n_res)-th of them
            const int n_pick = min(n_sel, n_res);
            for (int k = 0; k < n_pick; ++k) {
              int best_r = -1;
              for (int r = want; r < n_ond; ++r) {
                bool taken = false;
                for (int q = 0; q < k; ++q) taken |= m.h_tgt[q] == r;
                if (taken) continue;
                if (best_r < 0 || static_cast<float>(m.load[r])
                                      < static_cast<float>(m.load[best_r]))
                  best_r = r;
              }
              m.h_tgt[k] = best_r;
            }
            for (int k = 0; k < n_sel; ++k) push_entry(m.h_tgt[k % n_res], m.hedge_rid[k], t);
          }
        }
        __syncthreads();
        for (int r = tid; r < R; r += nth) m.rtmp[r] = 0;
        __syncthreads();
      }
    }

    // ---- 8 · advance every unpinned online replica one decode tick
    // 8a: cancel slots whose hedge pair already won; admit from the queue
    {
      int hc = 0;
      for (int r = tid; r < R; r += nth) {
        for (int s = 0; s < S; ++s) { m.stmp[r * S + s] = -1; m.stmp2[r * S + s] = 0; }
        if (!(m.on[r] && r >= want)) continue;
        for (int s = 0; s < S; ++s) {
          const int rid = m.slot_rid[r * S + s];
          if (rid >= 0 && finish[rid] >= 0) {
            ++hc;
            m.pend[r] -= m.slot_rem[r * S + s];
            m.slot_rid[r * S + s] = -1;
            m.slot_rem[r * S + s] = 0;
          }
        }
        if (m.q_len[r] <= 0) continue;
        int free = 0;
        for (int s = 0; s < S && s < m_slots; ++s) free += m.slot_rid[r * S + s] < 0;
        if (free <= 0) continue;
        const int n_valid = min(m.q_len[r], p.AW);
        int consumed = n_valid, k = 0, s = 0;
        for (int j = 0; j < n_valid; ++j) {
          const int rid = q_rid[size_t(r) * Q + (m.q_head[r] + j) % Q];
          if (finish[rid] >= 0) {  // dead: a hedge loser, dropped
            ++hc;
            m.pend[r] -= p.gen[rid];
            continue;
          }
          while (m.slot_rid[r * S + s] >= 0) ++s;  // the k-th free slot
          m.slot_rid[r * S + s] = rid;
          m.slot_rem[r * S + s] = p.gen[rid];
          m.stmp[r * S + s] = rid;
          m.stmp2[r * S + s] = start[rid];  // read before any row writes
          ++s;
          if (++k == free) { consumed = j + 1; break; }
        }
        m.q_head[r] = (m.q_head[r] + consumed) % Q;
        m.q_len[r] -= consumed;
      }
      hc = warp_sum_int(hc);
      if (wl == 0 && hc) atomicAdd(&sc[S_HCANCEL], hc);
    }
    __syncthreads();
    // 8b: stamp first starts; decode one token a slot
    {
      int n_adm = 0, busy = 0, tr_busy = 0, cap_rows = 0, tr_cap_rows = 0;
      for (int r = tid; r < R; r += nth) {
        if (!(m.on[r] && r >= want)) continue;
        ++cap_rows;
        tr_cap_rows += r >= n_ond;
        int busy_r = 0;
        for (int s = 0; s < S; ++s) {
          const int i = r * S + s;
          const int a_rid = m.stmp[i];
          if (a_rid >= 0) {
            ++n_adm;
            const int sg = m.stmp2[i];
            if (sg < 0) {
              start[a_rid] = t;
              const int te = p.tenant[a_rid];
              atomicAdd(&m.tn_ad[te], 1);
              atomicAdd(&m.tn_wt[te], t - p.arrival[a_rid]);
            }
          }
          m.stmp[i] = -1;
          const int rid = m.slot_rid[i];
          if (rid < 0) continue;
          ++busy_r;
          m.slot_rem[i] -= 1;
          if (m.slot_rem[i] <= 0) {
            m.stmp[i] = rid;
            m.stmp2[i] = finish[rid];  // read before any row writes
          }
        }
        m.pend[r] -= busy_r;
        busy += busy_r;
        if (r >= n_ond) tr_busy += busy_r;
      }
      n_adm = warp_sum_int(n_adm); busy = warp_sum_int(busy);
      tr_busy = warp_sum_int(tr_busy); cap_rows = warp_sum_int(cap_rows);
      tr_cap_rows = warp_sum_int(tr_cap_rows);
      if (wl == 0) {
        if (n_adm) atomicAdd(&sc[S_EV_ADMIT], n_adm);
        if (busy) atomicAdd(&sc[S_BUSY], busy);
        if (tr_busy) atomicAdd(&sc[S_TR_BUSY], tr_busy);
        if (cap_rows) atomicAdd(&sc[S_CAP_ROWS], cap_rows);
        if (tr_cap_rows) atomicAdd(&sc[S_TR_CAP_ROWS], tr_cap_rows);
      }
    }
    __syncthreads();
    // 8c: stamp finishes (first completion of a hedge pair wins)
    {
      int wins = 0, done = 0;
      for (int r = tid; r < R; r += nth) {
        if (!(m.on[r] && r >= want)) continue;
        bool occupied = false;
        for (int s = 0; s < S; ++s) {
          const int i = r * S + s;
          const int rid = m.stmp[i];
          if (rid >= 0) {
            if (m.stmp2[i] < 0) {
              wins += hedged[rid];
              finish[rid] = t + 1;
            }
            m.slot_rid[i] = -1;
            m.slot_rem[i] = 0;
          }
          occupied |= m.slot_rid[i] >= 0;
        }
        const int dd = m.dr[r] && m.q_len[r] == 0 && !occupied;
        m.rtmp[r] = dd;
        done += dd;
      }
      wins = warp_sum_int(wins);
      done = warp_sum_int(done);
      if (wl == 0) {
        if (wins) atomicAdd(&sc[S_EV_HWIN], wins);
        if (done) atomicAdd(&sc[S_DRAIN_DONE], done);
      }
    }
    __syncthreads();
    // 8d: drained replicas go offline, their lifetimes in row order
    if (sc[S_DRAIN_DONE] > 0) {
      if (tid == 0) {
        int k = 0;
        for (int r = 0; r < R; ++r) {
          if (!m.rtmp[r]) continue;
          const int life = t - m.online_at[r];
          if (sc[S_LT_COUNT] + k < p.LC) lt_buf[sc[S_LT_COUNT] + k] = static_cast<float>(life);
          ++k;
          sc[S_LT_SUM] += life;
          m.on[r] = 0;
          m.dr[r] = 0;
        }
        sc[S_LT_COUNT] += k;
      }
      __syncthreads();
    }
    {
      int online_tr = 0, qdepth = 0;
      for (int r = tid; r < R; r += nth) {
        m.rtmp[r] = 0;
        online_tr += r >= n_ond && m.on[r];
        if (m.on[r]) qdepth += m.q_len[r];
      }
      online_tr = warp_sum_int(online_tr);
      qdepth = warp_sum_int(qdepth);
      if (wl == 0) {
        if (online_tr) atomicAdd(&sc[S_ONLINE_TR], online_tr);
        if (qdepth) atomicAdd(&sc[S_QDEPTH], qdepth);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int* row = series + size_t(t) * n_cols;
      row[0] = sc[S_ONLINE_TR];
      row[1] = sc[S_BUSY];
      row[2] = sc[S_CAP_ROWS] * m_slots;
      row[3] = sc[S_TR_BUSY];
      row[4] = sc[S_TR_CAP_ROWS] * m_slots;
      row[5] = sc[S_QDEPTH];
      row[6] = sc[S_ADD];
      row[7] = sc[S_N_ON];
      row[8] = sc[S_DRAIN_DONE];
      row[9] = sc[S_EV_REVOKE];
      row[10] = sc[S_HEDGES] - sc[S_HEDGE_PRE];
      row[11] = sc[S_EV_HWIN];
      row[12] = sc[S_EV_ADMIT];
      row[13] = sc[S_EV_DISP];
      row[14] = sc[S_EV_REROUTE];
      row[15] = sc[S_THROTTLE] - sc[S_THR_PRE];
      for (int i = 0; i < NT; ++i) {
        row[16 + i] = m.tn_ad[i];
        row[16 + NT + i] = m.tn_wt[i];
      }
      sc[S_WANT_PREV] = want;
    }
  }
  __syncthreads();

  int* cnt = p.counters + size_t(lane_id) * N_COUNTERS;
  if (tid == 0) {
    cnt[C_HEDGES] = sc[S_HEDGES];
    cnt[C_HCANCEL] = sc[S_HCANCEL];
    cnt[C_REVOKE] = sc[S_REVOKE];
    cnt[C_RENTALS] = sc[S_RENTALS];
    cnt[C_OVER] = sc[S_OVER];
    cnt[C_LT_COUNT] = sc[S_LT_COUNT];
    cnt[C_LT_SUM] = sc[S_LT_SUM];
    cnt[C_THROTTLE] = sc[S_THROTTLE];
    int n_tr = 0;
    for (int r = n_ond; r < R; ++r) n_tr += m.on[r];
    cnt[C_FINAL_TR] = n_tr;
  }
  for (int r = tid; r < R; r += nth) {
    p.final_tr_online[size_t(lane_id) * R + r] = r >= n_ond && m.on[r];
    p.final_online_at[size_t(lane_id) * R + r] = m.online_at[r];
  }
  for (int i = tid; i < NT; i += nth) p.final_credits[lane_id * NT + i] = m.credits[i];
}

}  // namespace

extern "C" size_t serving_fleet_smem_bytes(const FleetParams* p) {
  return carve(*p, nullptr, nullptr);
}

extern "C" int serving_fleet_run(const FleetParams* p, void* stream) {
  if (p->L < 1 || p->R < 1 || p->S < 1 || p->T < 0 || p->P < 1 || p->NT < 1 || p->K < 1)
    return cudaErrorInvalidValue;
  if (p->HS + p->S > 32 || p->retries * p->d + p->d > 32 || p->d < 1)
    return cudaErrorInvalidValue;
  const size_t smem = carve(*p, nullptr, nullptr);
  cudaError_t err = set_smem(fleet_kernel, smem);
  if (err != cudaSuccess) return err;
  fleet_kernel<<<p->L, FLEET_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}
