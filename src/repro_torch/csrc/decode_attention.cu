// One-token GQA decode attention against a KV cache, dense or paged.
//
// Replaces two Pallas TPU kernels of the reference:
//   src/repro/kernels/decode_attention/kernel.py:paged_decode_attention_fwd (B1)
//   src/repro/kernels/decode_attention/kernel.py:decode_attention_fwd       (B3)
// with ONE device routine. A CTA takes one (sequence b, kv head) and all
// G = H/KV query heads of that kv head, and walks the cache in chunks of
// CH = 32 keys in logical order (one key per lane of a warp). The paged
// layout resolves each key's row through the page table (the block reads
// its own indices; no scalar prefetch), so a chunk spans 32 / bs pages (two
// at bs = 16) and the chunking does not depend on the page size; the dense
// layout is the same routine with the identity table.
// Because both layouts share the arithmetic and the chunk order, a slot's
// paged result is bitwise identical to its dense result.
//
// Semantics kept from the reference kernels: q is scaled by hd**-0.5 before
// the QK dot; optional softcap; the mask is an additive f32 bias (finite
// NEG_INF); online softmax with f32 (m, l, acc); probabilities cast to V's
// dtype before the PV product (bf16 rounds there); the denominator is
// floored at 1e-37. int8 pools are dequantised with their f32
// per-(block, slot, kv head) scales right after the load.
//
// Bound on the H100: bytes. Every cached K/V byte is read once and used for
// G FMAs per element, far below the ~295 FLOP/byte ridge, so the least time
// is B*L*KV*hd*2*sizeof(kv) / 3.35 TB/s. This simple design launches only
// B*KV CTAs (8 for starcoder2-3b at 4 slots) against 132 SMs and loads each
// chunk synchronously, so it is latency-bound far above that bound. Left for
// later: split the pages across CTAs with a combine pass (flash-decode),
// cp.async/TMA double buffering, and tensor-core QK/PV.
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
  int64_t q_sb, q_sh;
  int64_t o_sb, o_sh;
  int64_t k_sbase, k_stok, k_skv;  // dense: batch stride; paged: block stride
  int64_t v_sbase, v_stok, v_skv;
  int64_t s_sbase, s_stok, s_skv;  // scale strides (int8 only)
  int64_t bias_sb;
  int64_t table_sb;
  int32_t B, H, KV, L, hd, block_size;
  int32_t paged;
  float scale, softcap;
  int32_t q_dtype, kv_dtype;
};

constexpr int CH = 32;        // keys per online-softmax step (one per lane)
constexpr int NWARP = 4;
constexpr int NTHREAD = 32 * NWARP;

template <int HD>
__host__ __device__ constexpr size_t decode_smem_floats(int G) {
  return static_cast<size_t>(G) * HD * 2   // q (scaled), acc
         + CH * (HD + 1)                   // K chunk, padded rows
         + CH * HD                         // V chunk
         + static_cast<size_t>(G) * (CH + 3);  // p, m, l, alpha
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NTHREAD) decode_kernel(const DecodeParams p) {
  constexpr int VEC = Vec<TKV>::N;
  constexpr int QVEC = Vec<TQ>::N;
  constexpr int KSTR = HD + 1;
  constexpr bool QUANT = sizeof(TKV) == 1;
  const int G = p.H / p.KV;
  const int b = blockIdx.x / p.KV;
  const int kv = blockIdx.x % p.KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                 // G * HD
  float* acc = q_s + G * HD;         // G * HD
  float* k_s = acc + G * HD;         // CH * KSTR
  float* v_s = k_s + CH * KSTR;      // CH * HD
  float* p_s = v_s + CH * HD;        // G * CH
  float* m_s = p_s + G * CH;         // G
  float* l_s = m_s + G;              // G
  float* a_s = l_s + G;              // G
  __shared__ int64_t rowk[CH], rowv[CH], rows[CH];

  const TQ* q = static_cast<const TQ*>(p.q);
  const TKV* kp = static_cast<const TKV*>(p.k);
  const TKV* vp = static_cast<const TKV*>(p.v);

  for (int i = tid; i < G * HD / QVEC; i += NTHREAD) {
    const int g = i / (HD / QVEC);
    const int d0 = (i % (HD / QVEC)) * QVEC;
    float x[QVEC];
    Vec<TQ>::load(q + b * p.q_sb + (kv * G + g) * p.q_sh + d0, x);
#pragma unroll
    for (int e = 0; e < QVEC; ++e) {
      q_s[g * HD + d0 + e] = x[e] * p.scale;
      acc[g * HD + d0 + e] = 0.f;
    }
  }
  for (int g = tid; g < G; g += NTHREAD) {
    m_s[g] = REPRO_NEG_INF;
    l_s[g] = 0.f;
  }

  const float* bias_row = p.bias + b * p.bias_sb;
  for (int l0 = 0; l0 < p.L; l0 += CH) {
    const int nvalid = min(CH, p.L - l0);
    __syncthreads();  // previous chunk fully consumed
    if (tid < nvalid) {
      const int l = l0 + tid;
      int64_t base, tok;
      if (p.paged) {
        base = p.table[b * p.table_sb + l / p.block_size];
        tok = l % p.block_size;
      } else {
        base = b;
        tok = l;
      }
      rowk[tid] = base * p.k_sbase + tok * p.k_stok + kv * p.k_skv;
      rowv[tid] = base * p.v_sbase + tok * p.v_stok + kv * p.v_skv;
      rows[tid] = base * p.s_sbase + tok * p.s_stok + kv * p.s_skv;
    }
    __syncthreads();
    for (int i = tid; i < CH * HD / VEC; i += NTHREAD) {
      const int t = i / (HD / VEC);
      const int d0 = (i % (HD / VEC)) * VEC;
      float xk[VEC], xv[VEC];
      if (t < nvalid) {
        Vec<TKV>::load(kp + rowk[t] + d0, xk);
        Vec<TKV>::load(vp + rowv[t] + d0, xv);
        if (QUANT) {
          const float ks = p.k_scale[rows[t]];
          const float vs = p.v_scale[rows[t]];
#pragma unroll
          for (int e = 0; e < VEC; ++e) { xk[e] *= ks; xv[e] *= vs; }
        }
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

    // Each warp owns query heads g = warp, warp + NWARP, ...: scores with
    // one key per lane, then the online-softmax update and the PV product
    // for its own rows (no cross-warp traffic until the next chunk).
    for (int g = warp; g < G; g += NWARP) {
      float s = -INFINITY;  // absent key (ragged dense tail): p = 0 exactly
      if (lane < nvalid) {
        const float* qr = q_s + g * HD;
        const float* kr = k_s + lane * KSTR;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
        s = dot + bias_row[l0 + lane];
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = expf(s - m_new);
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(pr);
      p_s[g * CH + lane] = round_like<TKV>(pr);
      __syncwarp();
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        const int d = lane + 32 * j;
        float pv = 0.f;
        for (int t = 0; t < nvalid; ++t) pv = fmaf(p_s[g * CH + t], v_s[t * HD + d], pv);
        acc[g * HD + d] = acc[g * HD + d] * alpha + pv;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  TQ* o = static_cast<TQ*>(p.o);
  for (int i = tid; i < G * HD; i += NTHREAD) {
    const int g = i / HD;
    const int d = i % HD;
    const float l = fmaxf(l_s[g], 1e-37f);
    o[b * p.o_sb + (kv * G + g) * p.o_sh + d] = from_float<TQ>(acc[i] / l);
  }
}

template <typename TQ, typename TKV, int HD>
static cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  const int G = p.H / p.KV;
  const size_t smem = decode_smem_floats<HD>(G) * sizeof(float);
  auto kernel = decode_kernel<TQ, TKV, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.B * p.KV, NTHREAD, smem, stream>>>(p);
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
  if (p->q_dtype == kF32 && p->kv_dtype == kF32) return launch_hd<float, float>(*p, s);
  if (p->q_dtype == kBF16 && p->kv_dtype == kBF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(*p, s);
  if (p->q_dtype == kF32 && p->kv_dtype == kI8) return launch_hd<float, int8_t>(*p, s);
  if (p->q_dtype == kBF16 && p->kv_dtype == kI8) return launch_hd<__nv_bfloat16, int8_t>(*p, s);
  return cudaErrorInvalidValue;
}
