// Causal GQA flash-attention forward (prefill).
//
// Replaces the Pallas TPU kernel of the reference:
//   src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd (B2)
// One CTA per (q tile of BQ rows, head h, sequence b); query head h reads kv
// head h // G. The CTA loops over the k tiles that the reference's
// block-level visibility test keeps (causal, sliding window, bidirectional
// prefix, q_offset; kernel.py:50-57), staging K and V through shared memory
// and keeping the online-softmax state (m, l) in shared memory and the
// output accumulator in registers. The ragged edge is masked in the kernel,
// so any Sq/Sk works (the reference kernel required both to tile).
//
// Semantics kept from the reference kernel: q scaled by hd**-0.5 before the
// QK dot; optional softcap; masked logits replaced (``where``) by the finite
// NEG_INF; f32 online softmax; probabilities cast to V's dtype before the PV
// product; denominator floored at 1e-37.
//
// Bound on the H100: operations. The work is 4*hd FLOPs per visible (q, k)
// pair per head against one read of q/k/v and one write of o, far above the
// ridge, so the least time is 4*B*H*hd*pairs / 989 TFLOP/s (bf16 tensor
// cores). This simple design computes both products with f32 FMAs from
// shared memory (no tensor cores) on one CTA per SM, so it sits far above
// that bound. Left for later: wgmma tiles fed by TMA with a producer warp,
// keeping P in registers, and a persistent schedule over (b, h, q tile).
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
};

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

template <typename T, int HD>
static cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = FlashTile<HD>::smem_floats * sizeof(float);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, FTHREAD, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(const FlashParams& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_fwd(const FlashParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == kF32) return launch_hd<float>(*p, s);
  if (p->dtype == kBF16) return launch_hd<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
