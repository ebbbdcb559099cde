// One-token GQA decode attention against a KV cache, dense or paged:
// split-KV with a combine pass.
//
// Replaces two Pallas TPU kernels of the reference:
//   src/repro/kernels/decode_attention/kernel.py:paged_decode_attention_fwd (B1)
//   src/repro/kernels/decode_attention/kernel.py:decode_attention_fwd       (B3)
// with ONE device routine; the dense layout is the paged one with the
// identity table.
//
// Design.
// * Split. The grid is (B * KV * ceil(G/16), n_split). A CTA takes one
//   (sequence b, kv head), up to 16 of its G = H/KV query heads, and one
//   contiguous range of split_len logical key positions. The wrapper picks
//   (n_split, split_len) from (B, KV, L) and the SM count alone
//   (kernel.py:split_plan), never from the layout; every split holds at
//   least one key, so each split's running max is finite.
// * Loads. The CTA walks its range in chunks of CH = 64 keys through a
//   two-stage cp.async ring (one stage for f32 at hd = 256, where two do not
//   fit): each chunk is issued before the previous one is computed, in
//   16-byte copies with neighbouring lanes on neighbouring pieces of a row,
//   zero-filled past the range. K and V stay in their storage dtype in padded
//   shared rows, the chunk's bias and int8 scales beside them. The paged
//   layout resolves each key's row through the page table (the CTA reads its
//   own indices). Both layouts run the same arithmetic in the same order, so
//   a slot's paged result is bitwise its dense result.
// * Products. Each of the 4 warps owns 16 keys of every chunk and keeps its
//   own online softmax (m, l, acc) for the CTA's heads. bf16 q and cache:
//   QK^T and PV on tensor cores (mma.sync m16n8k16, heads padded to 16
//   rows, f32 accumulation), hd^-0.5 applied to the f32 scores, e^x on the
//   special-function unit, P rounded to bf16 in registers before PV. f32 q
//   or an int8 pool: f32 FMAs and expf (TF32 or bf16 inputs would miss
//   f32's 2e-5); int8 is dequantised with its f32 per-(block, slot, kv head)
//   scales as it leaves shared memory.
// * Combine. The 4 warps' states merge in shared memory in warp order and
//   the CTA writes one f32 partial (m, l, acc[hd]) per head; a second kernel
//   (decode_kernel_combine), launched by the same entry, merges each head's
//   n_split partials in split order and writes o. No float atomics: two
//   runs are bitwise equal.
// * Statistics. On request the combine also writes each row's softmax max m
//   and denominator l (B, H) f32, and o in f32: a decode over a cache whose
//   length is sharded across ranks merges the ranks' (o, m, l)
//   (models/attention.py, _mesh_attention), as the combine merges splits.
//
// Semantics kept from the reference kernels: q scaled by hd**-0.5; optional
// softcap; the mask is an additive f32 bias (finite NEG_INF, so a row whose
// every position is masked averages V); online softmax in f32; probabilities
// cast to V's dtype before the PV product (bf16 rounds there); the
// denominator floored at 1e-37.
//
// Bound on the H100: bytes. Every cached K/V byte is read once and used for
// G multiply-adds per element, far below the ~295 FLOP/byte ridge. The
// routine reads all L positions, masked or not, so it takes at least
// B*L*KV*hd*2*sizeof(kv) / 3.35 TB/s; the function needs only the keys
// its bias leaves visible, which is less wherever a slot is short or
// windowed (chip_smoke.py's bound counts those). The split puts at least
// two CTAs on every SM at the main path's shapes (three fit), each with a
// chunk of loads in flight while it computes the one before.
#include "common.cuh"

struct DecodeParams {
  const void* q;           // (B, H, hd)
  const void* k;           // dense (B, L, KV, hd) view; paged (n_phys, bs, KV, hd)
  const void* v;
  const float* k_scale;    // int8 pools: (n_phys, bs, KV, 1) f32, else null
  const float* v_scale;
  const int32_t* table;    // paged: (B, P) int32 page table; dense: null
  const float* bias;       // (B, L) f32 rows, row stride bias_sb (0 = shared)
  void* o;                 // (B, H, hd)
  float* part;             // (B, H, n_split, hd) f32 partial accumulators
  float* part_m;           // (B, H, n_split) running max of each split
  float* part_l;           // (B, H, n_split) denominator of each split
  int64_t q_sb, q_sh;
  int64_t o_sb, o_sh;
  int64_t k_sbase, k_stok, k_skv;  // dense: batch stride; paged: block stride
  int64_t v_sbase, v_stok, v_skv;
  int64_t s_sbase, s_stok, s_skv;  // scale strides (int8 only)
  int64_t bias_sb;
  int64_t table_sb;
  int32_t B, H, KV, L, hd, block_size;
  int32_t paged, n_split, split_len;
  float scale, softcap;
  int32_t q_dtype, kv_dtype;
  float* m;                // (B, H) f32 row max after softcap and bias, or null
  float* l;                // (B, H) f32 sum of exp(s - m); with m, o is f32
};

constexpr int CH = 64;          // keys per chunk
constexpr int NWARP = 4;        // each warp owns CH / NWARP = 16 keys of a chunk
constexpr int KW = CH / NWARP;  // the wrapper's split lengths are multiples of KW
constexpr int NTHREAD = 32 * NWARP;
constexpr int GT = 16;          // query heads per CTA (one m16 tile)
constexpr int SMEM_MAX = 227 * 1024;

template <typename TQ, typename TKV, int HD> struct DecodeTile {
  static constexpr bool MMA = sizeof(TQ) == 2 && sizeof(TKV) == 2;
  static constexpr int KROW = HD * sizeof(TKV) + 16;  // padded K/V row, bytes
  static constexpr int QROW = MMA ? HD * 2 + 16 : HD * 4 + 16;
  // K rows, V rows, then the chunk's f32 bias and (int8) K and V scales
  static constexpr int STAGE = 2 * CH * KROW + 3 * CH * 4;
  // q rows; each warp's (m, l) per head and its merge factor
  static constexpr size_t rest = static_cast<size_t>(GT) * QROW + 3 * NWARP * GT * sizeof(float);
  // two stages, so that three CTAs fit an SM at bf16 hd = 128 (measured
  // faster there than three stages at two CTAs); one where two do not fit
  // (f32 at hd = 256)
  static constexpr int STAGES = rest + 2 * STAGE <= SMEM_MAX ? 2 : 1;
  static constexpr size_t smem = rest + STAGES * STAGE;
  // the warps' accumulators reuse the ring once the loads are done
  static_assert(STAGES * STAGE >= NWARP * GT * HD * 4, "merge does not fit the ring");
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// c[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T> __device__ __forceinline__ float elem(const T* p) {
  return to_float(*p);
}
template <> __device__ __forceinline__ float elem<int8_t>(const int8_t* p) {
  return static_cast<float>(*p);
}

// Row offsets (elements) of logical key l of sequence b: through the page
// table, or the identity table of the dense layout.
struct RowOfs {
  int64_t k, v, s;
};
__device__ __forceinline__ RowOfs row_of(const DecodeParams& p, int b, int kv, int l) {
  int64_t base, tok;
  if (p.paged) {
    base = p.table[b * p.table_sb + l / p.block_size];
    tok = l % p.block_size;
  } else {
    base = b;
    tok = l;
  }
  return {base * p.k_sbase + tok * p.k_stok + kv * p.k_skv,
          base * p.v_sbase + tok * p.v_stok + kv * p.v_skv,
          base * p.s_sbase + tok * p.s_stok + kv * p.s_skv};
}

// Scale and softcap of N f32 scores, in a pass of its own so that the common
// case (no softcap) runs straight-line code.
template <int N>
__device__ __forceinline__ void scale_scores(const DecodeParams& p, float* s) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= p.scale;
  }
}


template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NTHREAD) decode_kernel(const DecodeParams p) {
  using Tile = DecodeTile<TQ, TKV, HD>;
  constexpr bool MMA = Tile::MMA;
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int KROW = Tile::KROW, QROW = Tile::QROW;
  constexpr int PIECES = HD * sizeof(TKV) / 16;  // 16-byte pieces of a row
  constexpr int STAGES = Tile::STAGES;

  const int G = p.H / p.KV;
  const int ngrp = (G + GT - 1) / GT;
  const int grp = blockIdx.x % ngrp;
  const int kv = (blockIdx.x / ngrp) % p.KV;
  const int b = blockIdx.x / (ngrp * p.KV);
  const int g0 = grp * GT;
  const int Gc = min(GT, G - g0);  // heads of this CTA
  const int split = blockIdx.y;
  const int lo = split * p.split_len;
  const int hi = min(p.L, lo + p.split_len);  // hi > lo: the plan keeps a key
  const int nchunk = (hi - lo + CH - 1) / CH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;                             // GT * QROW
  unsigned char* ring = q_s + GT * QROW;                 // STAGES * STAGE
  float* m_w = reinterpret_cast<float*>(ring + STAGES * Tile::STAGE);  // NWARP * GT
  float* l_w = m_w + NWARP * GT;                                       // NWARP * GT, then
                                                                       // the merge factors

  const TKV* kp = static_cast<const TKV*>(p.k);
  const TKV* vp = static_cast<const TKV*>(p.v);
  const float* bias_row = p.bias + b * p.bias_sb;

  // issue chunk c's K and V rows into stage c % STAGES; a key past the
  // range is zero-filled so that 0-probability rows multiply zeros
  auto issue = [&](int c) {
    if (c < nchunk) {
      unsigned char* st = ring + (c % STAGES) * Tile::STAGE;
      const int l0 = lo + c * CH;
      // neighbouring lanes copy neighbouring 16-byte pieces of one row
      for (int i = tid; i < CH * PIECES; i += NTHREAD) {
        const int t = i / PIECES, piece = i % PIECES;
        const bool ok = l0 + t < hi;
        const RowOfs r = row_of(p, b, kv, ok ? l0 + t : lo);
        cp_async16(st + t * KROW + 16 * piece,
                   reinterpret_cast<const unsigned char*>(kp + r.k) + 16 * piece, ok);
        cp_async16(st + (CH + t) * KROW + 16 * piece,
                   reinterpret_cast<const unsigned char*>(vp + r.v) + 16 * piece, ok);
      }
      if (tid < CH) {
        const int t = tid;
        const bool ok = l0 + t < hi;
        float* extra = reinterpret_cast<float*>(st + 2 * CH * KROW);
        cp_async4(extra + t, bias_row + (ok ? l0 + t : lo), ok);
        if constexpr (QUANT) {
          const RowOfs r = row_of(p, b, kv, ok ? l0 + t : lo);
          cp_async4(extra + CH + t, p.k_scale + r.s, ok);
          cp_async4(extra + 2 * CH + t, p.v_scale + r.s, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };
  // keep STAGES - 1 chunks in flight while one is computed (one stage:
  // load, compute, load)
  constexpr int AHEAD = STAGES > 1 ? STAGES - 1 : 1;
#pragma unroll
  for (int c = 0; c < AHEAD; ++c) issue(c);

  // q rows of this CTA's heads: bf16 for the tensor-core path, f32 for the
  // FMA path; rows past Gc are zero
  {
    const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + (kv * G + g0) * p.q_sh;
    for (int i = tid; i < GT * HD; i += NTHREAD) {
      const int g = i / HD, d = i % HD;
      const float x = g < Gc ? to_float(q[g * p.q_sh + d]) : 0.f;
      if constexpr (MMA) {
        reinterpret_cast<__nv_bfloat16*>(q_s + g * QROW)[d] = __float2bfloat16_rn(x);
      } else {
        reinterpret_cast<float*>(q_s + g * QROW)[d] = x;
      }
    }
  }

  const int kw0 = warp * KW;  // the warp's first key within a chunk
  // per-warp online-softmax state; the layout of acc and of (m, l) differs
  // by path, and both are written to shared memory in one layout at the end
  constexpr int NACC = MMA ? HD / 2 : GT * HD / 32;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  constexpr int NROW = MMA ? 2 : GT / 2;  // rows this lane tracks
  float m_r[NROW], l_r[NROW];
#pragma unroll
  for (int i = 0; i < NROW; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }

  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if constexpr (STAGES > 1) issue(c + AHEAD);  // into chunk c - 1's stage
    const unsigned char* k_s = ring + (c % STAGES) * Tile::STAGE;
    const unsigned char* v_s = k_s + CH * KROW;
    const float* bias_s = reinterpret_cast<const float*>(k_s + 2 * CH * KROW) + kw0;
    const int l0 = lo + c * CH + kw0;  // logical position of the warp's key 0

    if constexpr (MMA) {
      // S[16 heads x 16 keys] = Q K^T on tensor cores; lane holds rows
      // gq, gq + 8 and keys 8*nt + 2*tq + {0, 1}
      const int tq = lane % 4;
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, q_s + ((lane % 8) + ((lane / 8) % 2) * 8) * QROW
                       + (kk * 16 + (lane / 16) * 8) * 2);
        ldsm_x4(bk, k_s + (kw0 + (lane % 8) + (lane / 16) * 8) * KROW
                        + (kk * 16 + ((lane / 8) % 2) * 8) * 2);
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      }
      scale_scores<8>(p, &s[0][0]);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int l = l0 + 8 * nt + 2 * tq + (r % 2);
          s[nt][r] = l < hi ? s[nt][r] + bias_s[l - l0] : -INFINITY;
          mx[r / 2] = fmaxf(mx[r / 2], s[nt][r]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = m_new == -INFINITY ? 1.f : fast_exp2((m_r[i] - m_new) * REPRO_LOG2E);
        m_r[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m = m_r[r / 2];
          const float pr = m == -INFINITY ? 0.f : fast_exp2((s[nt][r] - m) * REPRO_LOG2E);
          psum[r / 2] += pr;
          s[nt][r] = pr;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + psum[i];
      // P as the A operand of PV: rounded to bf16 (V's dtype) in registers
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 16; ++dt) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_s + (kw0 + (lane % 8) + ((lane / 8) % 2) * 8) * KROW
                          + (dt * 16 + (lane / 16) * 8) * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* a4 = acc + 4 * (2 * dt + h);
          a4[0] *= alpha[0]; a4[1] *= alpha[0];
          a4[2] *= alpha[1]; a4[3] *= alpha[1];
          mma_bf16(a4, pa, bv[2 * h], bv[2 * h + 1]);
        }
      }
    } else {
      // f32 FMAs: lane (j = lane % 16, hh = lane / 16) scores key j for the
      // heads hh, hh + 2, ...; then owns output columns lane + 32 * jj
      const int j = lane % 16, hh = lane / 16;
      const int l = l0 + j;
      const bool present = l < hi;
      float sc[NROW];
#pragma unroll
      for (int i = 0; i < NROW; ++i) sc[i] = 0.f;
      float vsc = 0.f;  // V's scale of key j (0 for an absent key)
      if (present) {
        float ksc = 1.f;
        if constexpr (QUANT) {
          ksc = bias_s[CH + j];
          vsc = bias_s[2 * CH + j];
        }
        const TKV* kr = reinterpret_cast<const TKV*>(k_s + (kw0 + j) * KROW);
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          float kf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[e] = elem(kr + d + e) * ksc;
#pragma unroll
          for (int i = 0; i < NROW; ++i) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + (hh + 2 * i) * QROW + 4 * d);
            sc[i] = fmaf(qv.x, kf[0], fmaf(qv.y, kf[1], fmaf(qv.z, kf[2], fmaf(qv.w, kf[3], sc[i]))));
          }
        }
      }
      scale_scores<NROW>(p, sc);
      const float bj = present ? bias_s[j] : 0.f;
      float alpha[NROW];
#pragma unroll
      for (int i = 0; i < NROW; ++i) {
        const float x = present ? sc[i] + bj : -INFINITY;
        float mx = x;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_r[i], mx);
        alpha[i] = m_new == -INFINITY ? 1.f : expf(m_r[i] - m_new);
        m_r[i] = m_new;
        const float pr = m_new == -INFINITY ? 0.f : expf(x - m_new);
        float ps = pr;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l_r[i] = l_r[i] * alpha[i] + ps;
        sc[i] = pr;
      }
      // PV: column d = lane + 32 * jj of every head; p and alpha of head g
      // come from the lanes that own it by shuffle
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float a = __shfl_sync(0xffffffffu, alpha[g / 2], (g % 2) * 16);
#pragma unroll
        for (int jj = 0; jj < HD / 32; ++jj) acc[g * (HD / 32) + jj] *= a;
      }
#pragma unroll 1
      for (int t = 0; t < KW; ++t) {
        const float vs = QUANT ? __shfl_sync(0xffffffffu, vsc, t) : 1.f;
        const TKV* vr = reinterpret_cast<const TKV*>(v_s + (kw0 + t) * KROW);
        float vf[HD / 32];
#pragma unroll
        for (int jj = 0; jj < HD / 32; ++jj) vf[jj] = elem(vr + lane + 32 * jj) * vs;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float pg = __shfl_sync(0xffffffffu, sc[g / 2], (g % 2) * 16 + t);
#pragma unroll
          for (int jj = 0; jj < HD / 32; ++jj)
            acc[g * (HD / 32) + jj] = fmaf(pg, vf[jj], acc[g * (HD / 32) + jj]);
        }
      }
    }
    if constexpr (STAGES == 1) {
      __syncthreads();  // the stage is consumed before it is refilled
      issue(c + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- merge the 4 warps' states (warp order) into one partial per head
  float* acc_s = reinterpret_cast<float*>(ring);  // NWARP * GT * HD
  if constexpr (MMA) {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
      if (tq == 0) {
        m_w[warp * GT + gq + 8 * i] = m_r[i];
        l_w[warp * GT + gq + 8 * i] = l_r[i];
      }
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc_s[(warp * GT + gq + 8 * (r / 2)) * HD + 8 * nt + 2 * tq + (r % 2)] =
            acc[4 * nt + r];
  } else {
    const int j = lane % 16, hh = lane / 16;
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < NROW; ++i) {
        m_w[warp * GT + hh + 2 * i] = m_r[i];
        l_w[warp * GT + hh + 2 * i] = l_r[i];
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int jj = 0; jj < HD / 32; ++jj)
        acc_s[(warp * GT + g) * HD + lane + 32 * jj] = acc[g * (HD / 32) + jj];
  }
  __syncthreads();

  // per head: the split's max over the warps, each warp's factor, the
  // denominator; then every output column, the warps summed in order
  float* f_w = l_w + NWARP * GT;  // NWARP * GT
  const int64_t row0 = (static_cast<int64_t>(b) * p.H + kv * G + g0) * p.n_split + split;
  if (tid < Gc) {
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) m = fmaxf(m, m_w[w * GT + tid]);
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float f = expf(m_w[w * GT + tid] - m);  // a warp with no key: exp(-inf) = 0
      f_w[w * GT + tid] = f;
      l += l_w[w * GT + tid] * f;
    }
    const int64_t row = row0 + static_cast<int64_t>(tid) * p.n_split;
    p.part_m[row] = m;
    p.part_l[row] = l;
  }
  __syncthreads();
  for (int i = tid; i < Gc * HD; i += NTHREAD) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) o += acc_s[(w * GT + g) * HD + d] * f_w[w * GT + g];
    p.part[(row0 + static_cast<int64_t>(g) * p.n_split) * HD + d] = o;
  }
}

// Merge each head's n_split partials in split order and write o: the max
// over the splits, each split's weight exp(m_i - max) in shared memory, then
// one output column a thread. With statistics (p.m set) o is written in f32,
// so that a merge of several shards' results rounds to q's dtype once, and
// the row's merged max and denominator go to p.m and p.l; rounded to TQ, that
// o is the o of the launch without them.
template <typename TQ, int HD>
__global__ void __launch_bounds__(HD) decode_kernel_combine(const DecodeParams p) {
  extern __shared__ float w_s[];  // n_split weights, then n_split weighted denominators
  __shared__ float red[HD / 32];
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int d = threadIdx.x;
  const int n = p.n_split;
  const int64_t row0 = static_cast<int64_t>(bh) * n;
  float m = -INFINITY;
  for (int i = d; i < n; i += HD) m = fmaxf(m, p.part_m[row0 + i]);
  m = warp_max(m);
  if (d % 32 == 0) red[d / 32] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) m = fmaxf(m, red[w]);
  for (int i = d; i < n; i += HD) {
    const float f = expf(p.part_m[row0 + i] - m);
    w_s[i] = f;
    w_s[n + i] = p.part_l[row0 + i] * f;
  }
  __syncthreads();
  float o = 0.f, l = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    o += p.part[(row0 + i) * HD + d] * w_s[i];
    l += w_s[n + i];
  }
  const float res = o / fmaxf(l, 1e-37f);
  if (p.m != nullptr) {
    static_cast<float*>(p.o)[b * p.o_sb + h * p.o_sh + d] = res;
    if (d == 0) {
      p.m[bh] = m;
      p.l[bh] = l;
    }
  } else {
    static_cast<TQ*>(p.o)[b * p.o_sb + h * p.o_sh + d] = from_float<TQ>(res);
  }
}

template <typename TQ, typename TKV, int HD>
static cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const size_t smem = DecodeTile<TQ, TKV, HD>::smem;
  auto kernel = decode_kernel<TQ, TKV, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B * p.KV * ((G + GT - 1) / GT), p.n_split);
  kernel<<<grid, NTHREAD, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_kernel_combine<TQ, HD>
      <<<p.B * p.H, HD, 2 * p.n_split * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
static cudaError_t launch_hd(const DecodeParams& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch<TQ, TKV, 32>(p, stream);
    case 64: return launch<TQ, TKV, 64>(p, stream);
    case 128: return launch<TQ, TKV, 128>(p, stream);
    case 256: return launch<TQ, TKV, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int decode_attention_fwd(const DecodeParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n_split < 1 || p->split_len % KW || p->split_len < 1 ||
      static_cast<int64_t>(p->n_split - 1) * p->split_len >= p->L)
    return cudaErrorInvalidValue;  // a split without a key
  if (p->q_dtype == kF32 && p->kv_dtype == kF32) return launch_hd<float, float>(*p, s);
  if (p->q_dtype == kBF16 && p->kv_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(*p, s);
  if (p->q_dtype == kF32 && p->kv_dtype == kI8) return launch_hd<float, int8_t>(*p, s);
  if (p->q_dtype == kBF16 && p->kv_dtype == kI8) return launch_hd<__nv_bfloat16, int8_t>(*p, s);
  return cudaErrorInvalidValue;
}
