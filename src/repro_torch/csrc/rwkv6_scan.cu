// RWKV-6 WKV recurrence (forward), per (sequence b, head h):
//
//   y_t[v] = sum_k r_t[k] * (S[k,v] + u[k] * k_t[k] * v_t[v])
//   S[k,v] <- w_t[k] * S[k,v] + k_t[k] * v_t[v]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py:61 rwkv6_scan_fwd (B5)
// whose grid walks time chunks in order and keeps the (hd, hd) f32 state in
// VMEM scratch. Here the sequential grid axis becomes a loop inside the CTA,
// and the state never leaves registers.
//
// Design. Each value column of S evolves alone, so a CTA takes one (b, h)
// and `cols` value columns (grid (hd / cols, H, B); the wrapper passes 16:
// 160 CTAs for a B=1, H=40 prefill on 132 SMs; no combine pass; tests pass
// other splits to check that the result does not change). Its 8 * COLS threads split the state as
// thread (g, c) = (tid % 8, tid / 8) holding rows k = g, g + 8, g + 16, ...
// of column c, hd / 8 floats in registers. A step costs each thread hd / 8
// fused updates; the column's y is the sum of the 8 partials of its thread
// group, reduced by a fixed warp-shuffle tree (xor 1, 2, 4), so the result
// does not depend on COLS. Time steps are staged through shared memory in
// chunks of CH = 64 (r, k, w rows and the CTA's slice of v, widened to f32;
// y staged likewise and written back once per chunk), so global loads stay
// off the per-step dependency chain. A ragged last chunk (any S >= 1) is
// masked by the loop bound.
//
// Inputs are read through their strides (unit last stride), so the model's
// (B, S, H, hd) projections are passed as (B, H, S, hd) views without a
// copy, and y is written through its strides into the wrapper's (B, S, H,
// hd) buffer. r, k, v are f32 or bf16 (widened on load); w, u, s0, y, sT are
// f32; s0 and sT are contiguous (B, H, hd, hd). sT may alias s0 (decode
// updates the slot cache in place): each CTA reads and writes only its own
// columns of its own (b, h), reading them all before its first write.
//
// Bound on the H100: at a prefill (B=1, H=40, S=4500, hd=64) the least work
// is 5 flops per state element per step (r.S is one FMA; w*S + k*v is a
// multiply and an FMA) plus 5 per key row for the bonus, which factors as
// (r . (u*k)) v: 40 * 4500 * (5 * 4096 + 5 * 64) = 3.74 GFLOP, 0.056 ms at
// the 67 TFLOP/s f32 FMA rate (operations), above the 161 MB of r, k, v
// (bf16), w, y (f32) at 3.35 TB/s (0.048 ms). This kernel does 7 flops per
// element, folding the bonus into each element's FMA chain. There is no
// tensor-core form: the per-channel, data-dependent decay w_t stops the
// chunk from being written as a matrix product without pairwise exp
// rescaling (the TPU kernel's docstring says the same). A decode step
// (S=1, B=4) moves the 5.24 MB of state in and out: bytes, 0.0016 ms. This
// simple kernel is latency-bound far above that: one chunk is loaded, then
// consumed, with no overlap of the two, and each step is a short chain of
// shared-memory loads, FMAs and shuffles.
#include "common.cuh"

struct Rwkv6Params {
  const void* r;        // (B, H, S, hd) views, unit last stride
  const void* k;
  const void* v;
  const float* w;
  const float* u;       // (H, hd), row stride u_sh
  const float* s0;      // (B, H, hd, hd) contiguous
  float* y;             // (B, H, S, hd) view
  float* sT;            // (B, H, hd, hd) contiguous; may equal s0
  int64_t r_sb, r_sh, r_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int64_t y_sb, y_sh, y_ss;
  int64_t u_sh;
  int32_t B, H, S, hd;
  int32_t cols;         // value columns per CTA (checked by the wrapper)
  int32_t dtype;        // of r, k, v: kF32 or kBF16
};

constexpr int CH = 64;     // time steps staged per chunk
constexpr int KG = 8;      // threads splitting the key rows of one column
constexpr int MAX_THREADS = KG * 64;

template <int HD>
__host__ __device__ constexpr size_t rwkv_smem_floats(int cols) {
  return 3 * CH * HD                          // r, k, w rows
         + 2 * CH * static_cast<size_t>(cols);  // v slice, y slice
}

// Stage rows [t0, t0 + n) of one (b, h) of a (B, H, S, hd) view into
// dst[t * HD + d] as f32, with 16-byte vector loads.
template <typename T, int HD>
__device__ void stage_rows(float* dst, const T* src, int64_t ss, int t0, int n) {
  constexpr int VEC = Vec<T>::N;
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < n * PER_ROW; i += blockDim.x) {
    const int t = i / PER_ROW;
    const int d0 = (i % PER_ROW) * VEC;
    float x[VEC];
    Vec<T>::load(src + (t0 + t) * ss + d0, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[t * HD + d0 + e] = x[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(MAX_THREADS) rwkv6_kernel(const Rwkv6Params p) {
  constexpr int KR = HD / KG;  // key rows per thread
  const int cols = p.cols;
  const int c0 = blockIdx.x * cols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid % KG;      // key rows g, g + KG, ...
  const int c = tid / KG;      // local value column

  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + CH * HD;
  float* w_s = k_s + CH * HD;
  float* v_s = w_s + CH * HD;   // CH * cols
  float* y_s = v_s + CH * cols; // CH * cols

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + c0;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  float* y = p.y + b * p.y_sb + h * p.y_sh + c0;
  const int64_t state = (static_cast<int64_t>(b) * p.H + h) * HD * HD + c0 + c;

  float s[KR], uk[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int kk = g + KG * i;
    s[i] = p.s0[state + kk * HD];
    uk[i] = p.u[h * p.u_sh + kk];
  }

  for (int t0 = 0; t0 < p.S; t0 += CH) {
    const int n = min(CH, p.S - t0);
    stage_rows<T, HD>(r_s, r, p.r_ss, t0, n);
    stage_rows<T, HD>(k_s, k, p.k_ss, t0, n);
    stage_rows<float, HD>(w_s, w, p.w_ss, t0, n);
    for (int i = tid; i < n * cols; i += blockDim.x) {
      const int t = i / cols;
      v_s[i] = to_float(v[(t0 + t) * p.v_ss + i % cols]);
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vt = v_s[t * cols + c];
      const float* rt = r_s + t * HD;
      const float* kt = k_s + t * HD;
      const float* wt = w_s + t * HD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kk = g + KG * i;
        const float kv = kt[kk] * vt;
        part = fmaf(rt[kk], fmaf(uk[i], kv, s[i]), part);
        s[i] = fmaf(wt[kk], s[i], kv);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if (g == 0) y_s[t * cols + c] = part;
    }
    __syncthreads();

    for (int i = tid; i < n * cols; i += blockDim.x) {
      const int t = i / cols;
      y[(t0 + t) * p.y_ss + i % cols] = y_s[i];
    }
  }

#pragma unroll
  for (int i = 0; i < KR; ++i) p.sT[state + (g + KG * i) * HD] = s[i];
}

template <typename T, int HD>
static cudaError_t launch(const Rwkv6Params& p, cudaStream_t stream) {
  const size_t smem = rwkv_smem_floats<HD>(p.cols) * sizeof(float);
  auto kernel = rwkv6_kernel<T, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(HD / p.cols, p.H, p.B);
  kernel<<<grid, KG * p.cols, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(const Rwkv6Params& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int rwkv6_scan_fwd(const Rwkv6Params* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->S < 1) return cudaErrorInvalidValue;
  if (p->dtype == kF32) return launch_hd<float>(*p, s);
  if (p->dtype == kBF16) return launch_hd<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
