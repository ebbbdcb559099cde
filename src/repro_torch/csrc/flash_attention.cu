// Causal GQA flash-attention forward (prefill).
//
// Replaces the Pallas TPU kernel of the reference:
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd (B2)
// A CTA takes one q tile of one head h of one sequence b (query head h reads
// kv head h // G) and loops over the k tiles that the reference's
// block-level visibility test keeps (causal, sliding window, bidirectional
// prefix, q_offset; kernel.py:50-57). The ragged edge is masked in the
// kernel, so any Sq/Sk works (the reference kernel required both to tile).
//
// Semantics kept from the reference kernel: q scaled by hd**-0.5 (on the
// f32 scores); optional softcap; masked logits replaced (``where``) by the
// finite NEG_INF; f32 online softmax; probabilities cast to V's dtype before
// the PV product; denominator floored at 1e-37.
//
// Bound on the H100: operations. The work is 4*hd FLOPs per visible (q, k)
// pair per head against one read of q/k/v and one write of o, far above the
// ridge, so the least time is 4*B*H*hd*pairs / 989 TFLOP/s (bf16 tensor
// cores).
//
// bf16 (serving and training): flash_wgmma_kernel. Per CTA, one or two
// consumer warpgroups of 64 q rows each (two for hd <= 128, one for hd = 256,
// whose 64 x 256 f32 output tile takes 128 registers a thread) and one
// producer warpgroup. One producer thread loads the q tile once and keeps
// K and V tiles of 64 keys in flight through a four-stage shared-memory ring
// (three at hd = 256) with TMA; the tensor maps are built on the host from
// the views' strides, so the model's transposed (B,S,H,hd) projections load
// without a copy. Each stage has an mbarrier for K, one for V, and one on
// which every consumer warp releases it. With two consumer warpgroups the
// producer's gives up registers (setmaxnreg 40) so that each consumer thread
// holds 232. Tiles are stored in 64-wide hd panels (32 at hd = 32) with the
// 128-byte (64-byte) swizzle that wgmma reads.
// * S = Q K^T: one m64n64k16 wgmma per 16 of hd, Q and K K-major in shared
//   memory.
// * Scale, softcap and the masks apply to the f32 scores in registers, each
//   a pass of its own; the per-element mask runs only on tiles that cross a
//   causal, window, prefix or ragged boundary.
// * The online softmax stays in registers (a row lives on 4 threads); P is
//   rounded to bf16 in registers and O += P V runs on wgmma with P as the
//   register A operand and V MN-major through the descriptor's transpose
//   bit, one instruction per hd panel and 16 keys.
// * The loop is software-pipelined: tile j's S and tile j-1's PV are issued
//   together, and tile j's softmax runs while the tensor cores finish j-1's
//   PV. The first tile is peeled, so every wgmma and every wait sits on a
//   straight path and none is serialized.
// One head per CTA: the G heads of a kv group share its K/V tiles through L2.
//
// f32 (the parity checks and gradients): flash_kernel keeps the CUDA-core
// design, both products f32 FMAs from shared memory, since TF32 would miss
// f32's atol of 2e-5.
//
// Softmax statistics (training under cfg.flash_vjp): where p.m is set, both
// kernels also write each row's m (its largest logit after softcap and mask,
// natural-log domain) and l = sum exp(s - m), floored at 1e-37, as (B, H, Sq)
// f32 in the epilogue: the residuals of the chunked recompute backward
// (repro.models.attention._flash_jnp_bwd). A row that sees no k tile gets
// m = NEG_INF and l = 1e-37, the reference's values for a row that has
// seen nothing.
#include "common.cuh"

struct FlashParams {
  const void* q;  // (B, H, Sq, hd) view, unit last stride
  const void* k;  // (B, KV, Sk, hd) view
  const void* v;
  void* o;        // (B, H, Sq, hd) view
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int32_t B, H, KV, Sq, Sk, hd;
  int32_t causal, window, prefix_len, q_offset;
  float scale, softcap;
  int32_t dtype;
  float* m;  // (B, H, Sq) row statistics, or null
  float* l;
};

// ---------------------------------------------------------------------------
// f32: CUDA-core tiles

constexpr int BQ = 64;
constexpr int FTHREAD = 256;  // 16 x 16 threads; each owns 4 rows x (cols/16)

template <int HD> struct FlashTile {
  static constexpr int BK = HD > 128 ? 32 : 64;
  static constexpr int QSTR = HD + 1;
  static constexpr int KSTR = HD + 1;
  static constexpr int SSTR = BK + 1;
  static constexpr size_t smem_floats =
      BQ * QSTR + BK * KSTR + BK * HD + BQ * SSTR + 3 * BQ;
};

template <typename T, int HD>
__global__ void __launch_bounds__(FTHREAD) flash_kernel(const FlashParams p) {
  using Tile = FlashTile<HD>;
  constexpr int BK = Tile::BK;
  constexpr int QSTR = Tile::QSTR, KSTR = Tile::KSTR, SSTR = Tile::SSTR;
  constexpr int VEC = Vec<T>::N;
  constexpr int RI = BQ / 16;   // rows per thread
  constexpr int CJ = BK / 16;   // score columns per thread
  constexpr int DJ = HD / 16;   // output columns per thread

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                 // BQ * QSTR
  float* k_s = q_s + BQ * QSTR;      // BK * KSTR
  float* v_s = k_s + BK * KSTR;      // BK * HD
  float* s_s = v_s + BK * HD;        // BQ * SSTR
  float* m_s = s_s + BQ * SSTR;      // BQ
  float* l_s = m_s + BQ;             // BQ
  float* a_s = l_s + BQ;             // BQ

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  const int row0 = iq * BQ;
  for (int i = tid; i < BQ * HD / VEC; i += FTHREAD) {
    const int r = i / (HD / VEC);
    const int d0 = (i % (HD / VEC)) * VEC;
    float x[VEC];
    if (row0 + r < p.Sq) {
      Vec<T>::load(q + (row0 + r) * p.q_ss + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * QSTR + d0 + e] = x[e] * p.scale;
  }
  for (int r = tid; r < BQ; r += FTHREAD) {
    m_s[r] = REPRO_NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int q_lo = row0 + p.q_offset;
  const int q_hi = q_lo + BQ - 1;
  const int nk = (p.Sk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_lo = ik * BK;
    const int k_hi = k_lo + BK - 1;
    bool visible = true;
    if (p.causal) visible = q_hi >= k_lo;
    // block visible iff its closest (q, k) pair is inside the window
    if (p.window > 0) visible = visible && (q_lo - k_hi) < p.window;
    if (p.prefix_len > 0) visible = visible || k_lo < p.prefix_len;
    if (!visible) continue;  // uniform over the CTA

    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int i = tid; i < BK * HD / VEC; i += FTHREAD) {
      const int t = i / (HD / VEC);
      const int d0 = (i % (HD / VEC)) * VEC;
      float xk[VEC], xv[VEC];
      if (k_lo + t < p.Sk) {
        Vec<T>::load(k + (k_lo + t) * p.k_ss + d0, xk);
        Vec<T>::load(v + (k_lo + t) * p.v_ss + d0, xv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { xk[e] = 0.f; xv[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[t * KSTR + d0 + e] = xk[e];
        v_s[t * HD + d0 + e] = xv[e];
      }
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RI], kb[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = q_s[(ty + 16 * i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kb[j] = k_s[(tx + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qp = q_lo + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        const int kp = k_lo + c;
        float s = sc[i][j];
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        bool ok = true;
        if (p.causal) ok = kp <= qp;
        if (p.window > 0) ok = ok && (qp - kp) < p.window;
        if (p.prefix_len > 0) ok = ok || kp < p.prefix_len;
        if (kp >= p.Sk) {
          s = -INFINITY;  // absent key past the ragged edge: p = 0 exactly
        } else if (!ok) {
          s = REPRO_NEG_INF;
        }
        s_s[r * SSTR + c] = s;
      }
    }
    __syncthreads();

    // online softmax: each warp owns BQ/8 rows, lanes stride the columns
    for (int r = warp * (BQ / 8); r < (warp + 1) * (BQ / 8); ++r) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, s_s[r * SSTR + c]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float pr = expf(s_s[r * SSTR + c] - m_new);
        psum += pr;
        s_s[r * SSTR + c] = round_like<T>(pr);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pa[RI], vb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = s_s[(ty + 16 * i) * SSTR + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

  if (p.m) {
    const int64_t base = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int r = tid; r < BQ && row0 + r < p.Sq; r += FTHREAD) {
      p.m[base + row0 + r] = m_s[r];  // NEG_INF where no tile was seen
      p.l[base + row0 + r] = fmaxf(l_s[r], 1e-37f);
    }
  }
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      o[(row0 + r) * p.o_ss + tx + 16 * j] = from_float<T>(acc[i][j] / l);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma tiles fed by TMA


constexpr int WBK = 64;  // keys per K/V tile (128-key tiles spill at hd = 128)

template <int HD> struct WgTile {
  static constexpr int NWG = HD > 128 ? 1 : 2;  // consumer warpgroups, 64 q rows each
  static constexpr int BQ = 64 * NWG;
  static constexpr int NTHR = 128 * (NWG + 1);  // + the producer warpgroup
  static constexpr int PW = HD < 64 ? HD : 64;  // hd panel: one swizzle row of bf16
  static constexpr int NP = HD / PW;
  static constexpr int SWZ = PW * 2;            // bytes a panel row, the swizzle span
  static constexpr int LAYOUT = SWZ == 128 ? 1 : 2;  // descriptor layout: B128 / B64
  static constexpr int Q_PANEL = BQ * SWZ;
  static constexpr int KV_PANEL = WBK * SWZ;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K (or V) tile
  static constexpr int STAGES = HD > 128 ? 3 : 4;  // K/V ring depth
  static constexpr size_t smem =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + sizeof(uint64_t) * (1 + 3 * STAGES);
};


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions
template <int N> __device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128B, 2 = 64B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (static_cast<uint64_t>(layout) << 62);
}
// K-major panel (rows of SWZ bytes): 8-row groups SBO = 8 * SWZ apart; a
// 16-element step along K adds 32 bytes to the start address
template <class T> __device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return gmma_desc(addr, 16, 8 * T::SWZ, T::LAYOUT);
}
// MN-major V panel (rows = keys along K, SWZ bytes of hd along N): 8-key
// groups SBO = 8 * SWZ apart; LBO, the next panel along N, is not reached
// at N = PW
template <class T> __device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return gmma_desc(addr, T::KV_PANEL, 8 * T::SWZ, T::LAYOUT);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers, B MN-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x HD] += P[64 x BK] V[BK x HD]: P from registers, V MN-major from the
// stage at v_base; one wgmma per hd panel and 16 keys
template <class T>
__device__ __forceinline__ void pv_gemm(float (&o)[T::NP][T::PW / 2],
                                        const uint32_t (&pa)[WBK / 16][4], uint32_t v_base) {
#pragma unroll
  for (int pn = 0; pn < T::NP; ++pn)
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
      const uint64_t dv = mnmajor_desc<T>(v_base + pn * T::KV_PANEL + 16 * kk * T::SWZ);
      if constexpr (T::PW == 64) {
        wgmma_m64n64k16_rs(o[pn], pa[kk], dv);
      } else {
        wgmma_m64n32k16_rs(o[pn], pa[kk], dv);
      }
    }
}

// whether the reference keeps a k block for a q block (kernel.py:50-57)
__device__ __forceinline__ bool tile_visible(const FlashParams& p, int q_lo, int q_hi,
                                             int k_lo, int k_hi) {
  bool visible = true;
  if (p.causal) visible = q_hi >= k_lo;
  // block visible iff its closest (q, k) pair is inside the window
  if (p.window > 0) visible = visible && (q_lo - k_hi) < p.window;
  if (p.prefix_len > 0) visible = visible || k_lo < p.prefix_len;
  return visible;
}

// the first k tile at or after ik that the q tile sees, or nk
__device__ __forceinline__ int next_visible(const FlashParams& p, int q_lo, int q_hi, int ik,
                                            int nk) {
  while (ik < nk && !tile_visible(p, q_lo, q_hi, ik * WBK, ik * WBK + WBK - 1)) ++ik;
  return ik;
}

// S[64 x BK] = Q K^T for one consumer warpgroup: one wgmma per 16 of hd
template <class T>
__device__ __forceinline__ void s_gemm(float (&sc)[WBK / 2], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int pn = 0; pn < T::NP; ++pn)
#pragma unroll
    for (int kk = 0; kk < T::PW / 16; ++kk) {
      const uint64_t da = kmajor_desc<T>(q_base + pn * T::Q_PANEL + 32 * kk);
      const uint64_t db = kmajor_desc<T>(k_base + pn * T::KV_PANEL + 32 * kk);
      wgmma_m64n64k16_ss(sc, da, db, pn + kk);
    }
}

// One tile's scores to probabilities, in registers: scale and softcap, the
// mask where the tile crosses a boundary (each a pass of its own, so the
// common case runs straight-line code), then the online softmax (a row's
// scores lie on 4 threads). Returns each row's rescale factor in alpha.
template <class T>
__device__ __forceinline__ void tile_softmax(const FlashParams& p, float (&sc)[WBK / 2],
                                             float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
                                             int k_lo, int qw_lo, int r_in, int tq) {
  constexpr int N = WBK / 2;
  const int k_hi = k_lo + WBK - 1;
  const int qw_hi = qw_lo + 63;
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] = p.softcap * tanhf(sc[i] * p.scale / p.softcap);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= p.scale;
  }
  const bool whole = k_hi < p.Sk &&
                     (k_hi < p.prefix_len ||
                      ((!p.causal || k_hi <= qw_lo) && (p.window <= 0 || qw_hi - k_lo < p.window)));
  if (!whole) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kp = k_lo + 8 * (i / 4) + 2 * tq + (i % 2);
      const int qp = qw_lo + r_in + 8 * ((i % 4) / 2);
      bool ok = true;
      if (p.causal) ok = kp <= qp;
      if (p.window > 0) ok = ok && (qp - kp) < p.window;
      if (p.prefix_len > 0) ok = ok || kp < p.prefix_len;
      // an absent key past the ragged edge gets p = 0 exactly
      sc[i] = kp >= p.Sk ? -INFINITY : ok ? sc[i] : REPRO_NEG_INF;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);  // finite: the tile holds a key below Sk
    alpha[r] = fast_exp2((m_r[r] - m_new) * REPRO_LOG2E);  // the first tile: exp2(-inf) = 0
    m_r[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float pr = fast_exp2((sc[i] - m_r[(i % 4) / 2]) * REPRO_LOG2E);
    psum[(i % 4) / 2] += pr;
    sc[i] = pr;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
}

// P rounded to bf16 (V's dtype) as the A fragments of BK / 16 steps of 16
// keys, after O is rescaled by alpha
template <class T>
__device__ __forceinline__ void rescale_and_pack(float (&o)[T::NP][T::PW / 2],
                                                 uint32_t (&pa)[WBK / 16][4],
                                                 const float (&sc)[WBK / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int pn = 0; pn < T::NP; ++pn)
#pragma unroll
    for (int i = 0; i < T::PW / 2; ++i) o[pn][i] *= alpha[(i % 4) / 2];
#pragma unroll
  for (int kk = 0; kk < WBK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      pa[kk][e] = *reinterpret_cast<uint32_t*>(&v2);
    }
}

template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::NTHR, 1)
    flash_wgmma_kernel(const FlashParams p, const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv) {
  using T = WgTile<HD>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte aligned panels
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv_s = q_s + T::Q_BYTES;  // stage s: K tile, then V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + T::STAGES * 2 * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;  // K of stage s landed
  uint64_t* v_full = k_full + T::STAGES;
  uint64_t* empty = v_full + T::STAGES;  // every consumer warp is done with stage s

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int row0 = iq * T::BQ;
  const int q_lo = row0 + p.q_offset;
  const int q_hi = q_lo + T::BQ - 1;
  const int nk = (p.Sk + WBK - 1) / WBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * T::NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * T::NWG) {
    // ---- producer: one thread issues every TMA load; its warpgroup hands
    // registers to the consumers
    if constexpr (T::NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * T::NWG) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int pn = 0; pn < T::NP; ++pn)
        tma_load_4d(q_s + pn * T::Q_PANEL, &tmq, pn * T::PW, row0, h, b, q_full);
      int it = 0;
      for (int ik = next_visible(p, q_lo, q_hi, 0, nk); ik < nk;
           ik = next_visible(p, q_lo, q_hi, ik + 1, nk)) {
        const int s = it % T::STAGES;
        mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);  // the first round passes
        unsigned char* k_s = kv_s + s * 2 * T::KV_BYTES;
        mbar_expect_tx(&k_full[s], T::KV_BYTES);
        for (int pn = 0; pn < T::NP; ++pn)
          tma_load_4d(k_s + pn * T::KV_PANEL, &tmk, pn * T::PW, ik * WBK, kvh, b, &k_full[s]);
        mbar_expect_tx(&v_full[s], T::KV_BYTES);
        for (int pn = 0; pn < T::NP; ++pn)
          tma_load_4d(k_s + T::KV_BYTES + pn * T::KV_PANEL, &tmv, pn * T::PW, ik * WBK, kvh, b,
                      &v_full[s]);
        ++it;
      }
    }
  } else {
    // ---- consumers (232 registers a thread beside a producer at 40):
    // warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile; a thread
    // holds rows r_in and r_in + 8 of them, columns 8 j + 2 tq + {0, 1}
    if constexpr (T::NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int r_in = 16 * warp + lane / 4;
    const int tq = lane % 4;
    const int qw_lo = q_lo + 64 * wg;

    float o[T::NP][T::PW / 2];
#pragma unroll
    for (int pn = 0; pn < T::NP; ++pn)
#pragma unroll
      for (int i = 0; i < T::PW / 2; ++i) o[pn][i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(q_s) + 64 * wg * T::SWZ;

    // Software pipeline over the visible tiles: tile j's S = Q K^T and tile
    // j-1's O += P V are in flight together, and tile j's softmax runs on the
    // CUDA cores while the tensor cores finish j-1's PV. The first tile is
    // peeled, so that every wgmma and every wait sits on a straight path.
    mbar_wait(q_full, 0);
    int ik = next_visible(p, q_lo, q_hi, 0, nk);
    if (ik < nk) {
      uint32_t pa[WBK / 16][4];  // P of the previous tile: the A operand of its PV
      float sc[WBK / 2];
      float alpha[2];
      mbar_wait(&k_full[0], 0);
#pragma unroll
      for (int i = 0; i < WBK / 2; ++i) sc[i] = 0.f;
      reg_fence<WBK / 2>(sc);
      wgmma_fence();
      s_gemm<T>(sc, q_base, smem_u32(kv_s));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence<WBK / 2>(sc);
      tile_softmax<T>(p, sc, m_r, l_r, alpha, ik * WBK, qw_lo, r_in, tq);
      rescale_and_pack<T>(o, pa, sc, alpha);
      int prev = 0;
      uint32_t prev_parity = 0;
      for (int it = 1;; ++it) {
        ik = next_visible(p, q_lo, q_hi, ik + 1, nk);
        if (ik >= nk) break;
        const int s = it % T::STAGES;
        const uint32_t parity = (it / T::STAGES) & 1;
        mbar_wait(&k_full[s], parity);
        mbar_wait(&v_full[prev], prev_parity);
#pragma unroll
        for (int i = 0; i < WBK / 2; ++i) sc[i] = 0.f;
        reg_fence<WBK / 2>(sc);
#pragma unroll
        for (int pn = 0; pn < T::NP; ++pn) reg_fence<T::PW / 2>(o[pn]);
        wgmma_fence();
        s_gemm<T>(sc, q_base, smem_u32(kv_s + s * 2 * T::KV_BYTES));
        wgmma_commit();
        pv_gemm<T>(o, pa, smem_u32(kv_s + prev * 2 * T::KV_BYTES) + T::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();  // S is done; the previous PV may still run
        reg_fence<WBK / 2>(sc);
        tile_softmax<T>(p, sc, m_r, l_r, alpha, ik * WBK, qw_lo, r_in, tq);
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < T::NP; ++pn) reg_fence<T::PW / 2>(o[pn]);
        // the warp's wgmma reads of the previous stage are complete: release it
        if (lane == 0) mbar_arrive(&empty[prev]);
        rescale_and_pack<T>(o, pa, sc, alpha);
        prev = s;
        prev_parity = parity;
      }
      // the last tile's PV
      mbar_wait(&v_full[prev], prev_parity);
#pragma unroll
      for (int pn = 0; pn < T::NP; ++pn) reg_fence<T::PW / 2>(o[pn]);
      wgmma_fence();
      pv_gemm<T>(o, pa, smem_u32(kv_s + prev * 2 * T::KV_BYTES) + T::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int pn = 0; pn < T::NP; ++pn) reg_fence<T::PW / 2>(o[pn]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      const int row = row0 + 64 * wg + r_in + 8 * r;
      if (row >= p.Sq) continue;
      const float l = fmaxf(l_r[r], 1e-37f);
      if (p.m && tq == 0) {
        const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.Sq + row;
        p.m[at] = m_r[r] == -INFINITY ? REPRO_NEG_INF : m_r[r];  // no tile seen
        p.l[at] = l;
      }
#pragma unroll
      for (int pn = 0; pn < T::NP; ++pn)
#pragma unroll
        for (int j = 0; j < T::PW / 8; ++j) {
          const int col = pn * T::PW + 8 * j + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + col) =
              __floats2bfloat162_rn(o[pn][4 * j + 2 * r] / l, o[pn][4 * j + 2 * r + 1] / l);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// A 4-d tensor map (hd, S, heads, B) over a bf16 view with element strides
// (s_s, s_h, s_b); boxes of (pw, rows, 1, 1), swizzled as wgmma reads them,
// zero-filled past S.
static cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads,
                              int B, int64_t s_s, int64_t s_h, int64_t s_b, int rows, int pw) {
  const int64_t dims[4] = {hd, S, heads, B};
  const int64_t strides[3] = {s_s * 2, s_h * 2, s_b * 2};
  const int box[4] = {pw, rows, 1, 1};
  return tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides, box,
                       pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int HD>
static cudaError_t launch_wgmma(const FlashParams& p, cudaStream_t stream) {
  using T = WgTile<HD>;
  CUtensorMap tmq, tmk, tmv;
  cudaError_t err = tensor_map(&tmq, p.q, HD, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, T::BQ, T::PW);
  if (err == cudaSuccess)
    err = tensor_map(&tmk, p.k, HD, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, WBK, T::PW);
  if (err == cudaSuccess)
    err = tensor_map(&tmv, p.v, HD, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, WBK, T::PW);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wgmma_kernel<HD>;
  err = set_smem(kernel, T::smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + T::BQ - 1) / T::BQ, p.H, p.B);
  kernel<<<grid, T::NTHR, T::smem, stream>>>(p, tmq, tmk, tmv);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_f32(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = FlashTile<HD>::smem_floats * sizeof(float);
  auto kernel = flash_kernel<float, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, FTHREAD, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == kBF16) return launch_wgmma<HD>(p, stream);
  if (p.dtype == kF32) return launch_f32<HD>(p, stream);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_fwd(const FlashParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->hd) {
    case 32: return launch<32>(*p, s);
    case 64: return launch<64>(*p, s);
    case 128: return launch<128>(*p, s);
    case 256: return launch<256>(*p, s);
    default: return cudaErrorInvalidValue;
  }
}
