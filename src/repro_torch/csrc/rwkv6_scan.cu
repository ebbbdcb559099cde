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
// Bound on the H100: at a prefill (B=1, H=40, S=4500, hd=64) the least work
// is 5 flops per state element per step (r.S is one FMA; w*S + k*v is a
// multiply and an FMA) plus 5 per key row for the bonus, which factors as
// (r . (u*k)) v: 40 * 4500 * (5 * 4096 + 5 * 64) = 3.74 GFLOP, 0.056 ms at
// the 67 TFLOP/s f32 FMA rate (operations), above the 161 MB of r, k, v
// (bf16), w, y (f32) at 3.35 TB/s (0.048 ms). There is no tensor-core form:
// the per-channel, data-dependent decay w_t stops a chunk from being written
// as a matrix product without pairwise exp rescaling (the TPU kernel's
// docstring says the same). A decode step (S=1, B=4) moves the 5.24 MB of
// state in and out: bytes, 0.0016 ms. With save_states (training, B=2,
// S=2048) the 8-step checkpoints it writes, 335 MB, bind: 0.10 ms.
//
// Design. Each value column of S evolves alone, so a CTA owns whole value
// columns: one (b, h) and `cols` columns with all hd key rows (grid
// (hd / cols, H, B)). y needs no pass across CTAs; the in-place decode state
// (sT aliasing s0) is safe, since each CTA reads all of its own columns
// before it writes any; and the sum over k has one fixed order, so y, sT
// and the checkpoints do not depend on the split (`cols` is the wrapper's
// plan from the shapes and the SM count; tests force other splits and
// compare bits). Thread (g, c) = (tid % KG, tid / KG) holds key rows
// KR g .. KR g + KR - 1 of local column c in registers: KR = 4 (KG = 16 at
// hd = 64), so a B=1, H=40 prefill runs 320 CTAs of 4 warps, about 9.7
// warps per SM, twice the 8-row split of the first version; a launch of
// one chunk (a decode step) takes KR = 8, half the threads. What the
// design does about the latency that bound the first version (one chunk
// loaded, then consumed, each step a serial chain):
//  - Time runs in chunks of CH = 16 steps through a two-stage ring in
//    shared memory, filled by TMA (one tensor map per input, boxes of CH
//    rows, zeros past S) in the inputs' own types: chunk c + 1 lands while
//    chunk c is consumed, an mbarrier per stage says when, and one CTA
//    barrier per chunk hands the ring over. r, k, v stay bf16 there and are
//    widened at use (a thread's four key rows are one 8-byte load): a
//    widening pass through f32 buffers measured slower, its shared-memory
//    traffic outweighing the conversions.
//  - The step loop of a full chunk is unrolled at compile time (a ragged
//    last chunk runs a masked copy), a step's row partials form two
//    independent chains, and nothing is stored inside it: only the state
//    update w*S + k*v is carried from step to step. y's partials of the 16
//    steps are summed over the KG threads of a column once per chunk, each
//    round handing half of them to the partner lane (15 shuffles for 16
//    sums, not 64), and each lane writes its steps' y.
//  - s0 arrives, and sT leaves, as one TMA box of the CTA's columns through
//    a shared-memory slab, not as one scattered word per key row. With
//    save_states, a chunk's checkpoints go from registers to a
//    double-buffered slab after its steps and are written out, in 16-byte
//    stores along value columns, after the next barrier.
// Measured on the H100 (PERF.md): the prefill 0.41 ms, save_states 0.50 ms,
// a decode step 0.0051 ms of device time, from 1.59, 0.99 and 0.0071.
//
// f32 inputs (the parity and gradient checks' path) carry the state and
// every sum in f64 and round only what they store (AccOf below): the
// full-depth f32 gradient of rwkv6-3b amplifies any rounding in depth, so
// far that the plain f32 path with only its sums reordered lies 12-15x
// farther from a path with an f64 scan than the plain path itself on one
// leaf (PERF.md); in f64 the kernel path stays within 4e-5 of that path.
// bf16 inputs (the model's path) keep f32.
//
// Inputs are read through their strides (unit last stride, 16-byte aligned
// rows and base, which TMA needs: the wrapper checks), so the model's
// (B, S, H, hd) projections are passed as (B, H, S, hd) views without a
// copy, and y is written through its strides into the wrapper's
// (B, S, H, hd) buffer. r, k, v are f32 or bf16;
// w, u, s0, y, sT are f32; s0 and sT are contiguous (B, H, hd, hd). Training
// passes a non-null s_starts (B, H, ceil(S / CK), hd, hd): the state before
// steps 0, CK, 2 CK, ..., the checkpoints B7 below rewinds from (the TPU
// kernel's save_states, at the port's own interval CK).
#include "common.cuh"

#include <cooperative_groups.h>

namespace cgrp = cooperative_groups;

struct Rwkv6Params {
  const void* r;        // (B, H, S, hd) views, unit last stride
  const void* k;
  const void* v;
  const float* w;
  const float* u;       // (H, hd), row stride u_sh
  const float* s0;      // (B, H, hd, hd) contiguous
  float* y;             // (B, H, S, hd) view
  float* sT;            // (B, H, hd, hd) contiguous; may equal s0
  float* s_starts;      // (B, H, nc, hd, hd) contiguous, or null (serving)
  int64_t r_sb, r_sh, r_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int64_t y_sb, y_sh, y_ss;
  int64_t u_sh;
  int32_t B, H, S, hd;
  int32_t cols;         // value columns per CTA (the wrapper's plan)
  int32_t dtype;        // of r, k, v: kF32 or kBF16
};

constexpr int CH = 16;     // time steps per chunk of the forward's ring
constexpr int RING = 2;    // chunks in the forward's ring: loads run RING - 1 chunks ahead
constexpr int CK = 8;      // steps between saved states (kernel/ref.py CHECKPOINT)
constexpr int KR_SCAN = 4;  // key rows a forward thread holds over many chunks
constexpr int KR_STEP = 8;  // ... and in a launch of one chunk (a decode step), hd = 64
constexpr int SLAB_PAD = 4;  // floats after each column of a checkpoint slab
constexpr int FWD_MAX_THREADS = 512;

// N consecutive elements (N a multiple of 4, aligned to N of them), widened
// to f32 (bf16 -> f32 is exact: the high half of the word).
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p, float (&x)[N]) {
  uint32_t wd[N / 2];
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      wd[4 * q] = v.x; wd[4 * q + 1] = v.y; wd[4 * q + 2] = v.z; wd[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[q];
      wd[2 * q] = v.x; wd[2 * q + 1] = v.y;
    }
  }
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    x[2 * q] = __uint_as_float(wd[q] << 16);
    x[2 * q + 1] = __uint_as_float(wd[q] & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                                  x[4 * q + 3]);
}

// The checkpoint slab: a CTA's `cols` value columns of one row-major (hd,
// hd) state, in shared memory as sm[c * (HD + SLAB_PAD) + k], so a forward
// thread's key rows are whole 16-byte words. slab_out writes it to global
// memory with 16-byte stores along the value columns.
template <int HD>
__device__ void slab_out(float* dst, const float* sm, int cols) {
  const int nq = cols / 4;          // a power of two
  const int shift = __ffs(nq) - 1;
  for (int e = threadIdx.x; e < HD * nq; e += blockDim.x) {
    const int k = e >> shift;
    const int q = e & (nq - 1);
    const float* s = sm + 4 * q * (HD + SLAB_PAD) + k;
    *reinterpret_cast<float4*>(dst + k * HD + 4 * q) =
        make_float4(s[0], s[HD + SLAB_PAD], s[2 * (HD + SLAB_PAD)], s[3 * (HD + SLAB_PAD)]);
  }
}

// The type the scans carry their recurrences and sums in: f64 for f32
// inputs, f32 for bf16 inputs (see the note at the head of this file).
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<float> { using type = double; };
__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

// Shared memory of the forward, in bytes from the base (each piece 128-byte
// aligned): RING ring stages, each w (f32) then r, k, v as stored; the state
// slab [HD][cols] that s0 arrives in and sT leaves from; with SAVE two
// buffers of CH / CK checkpoint slabs [cols][HD + SLAB_PAD]; an mbarrier per
// stage.
template <typename T, int HD, bool SAVE>
struct FwdSmem {
  static constexpr size_t STAGE = static_cast<size_t>(CH) * HD * (sizeof(float) + 3 * sizeof(T));
  static __host__ __device__ size_t slab(int cols) { return static_cast<size_t>(cols) * HD * 4; }
  static __host__ __device__ size_t ckslab(int cols) {
    return static_cast<size_t>(cols) * (HD + SLAB_PAD) * 4;
  }
  static __host__ __device__ size_t slab_at() { return RING * STAGE; }
  static __host__ __device__ size_t ck_at(int cols) { return slab_at() + slab(cols); }
  static __host__ __device__ size_t bar_at(int cols) {
    return ck_at(cols) + (SAVE ? 2 * (CH / CK) * ckslab(cols) : 0);
  }
  static __host__ __device__ size_t bytes(int cols) {
    return bar_at(cols) + RING * sizeof(uint64_t);
  }
};

// SAVE: write the chunk-start states (training); the serving instance has
// no such branch in its step loop. Tensor maps: r, k, v, w as (hd, S, H, B)
// with boxes of (hd, CH); the states s0 and sT as (hd, hd, H, B) with boxes
// of the CTA's (cols, hd).
template <typename T, int HD, bool SAVE, int KR>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
rwkv6_kernel(const Rwkv6Params p, const __grid_constant__ CUtensorMap tm_r,
             const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_s0,
             const __grid_constant__ CUtensorMap tm_sT) {
  using Sm = FwdSmem<T, HD, SAVE>;
  using A = typename AccOf<T>::type;
  constexpr int KG = HD / KR;  // threads per value column
  constexpr int YL = CH / KG;  // steps of y each lane writes per chunk
  static_assert(CH % KG == 0 && CH % CK == 0, "chunk");
  const int cols = p.cols;
  const int c0 = blockIdx.x * cols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid % KG;      // key rows KR * g .. KR * g + KR - 1
  const int c = tid / KG;      // local value column
  const int ckslab = cols * (HD + SLAB_PAD);

  extern __shared__ __align__(128) unsigned char rwkv_smem[];
  float* slab = reinterpret_cast<float*>(rwkv_smem + Sm::slab_at());  // [HD][cols]
  float* ck = reinterpret_cast<float*>(rwkv_smem + Sm::ck_at(cols));   // SAVE: [2][CH / CK]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rwkv_smem + Sm::bar_at(cols));
  auto raw = [&](int st) { return rwkv_smem + st * Sm::STAGE; };  // w, r, k, v

  float* y = p.y + b * p.y_sb + h * p.y_sh + c0 + c;
  const int nchunk = (p.S + CH - 1) / CH;
  float* starts = SAVE ? p.s_starts + (static_cast<int64_t>(b) * p.H + h) * ((p.S + CK - 1) / CK)
                             * HD * HD + c0
                       : nullptr;

  // chunk ch's rows into its ring stage: w, r, k, v, one TMA load each
  // by thread 0 (rows past S read as zeros; the stage's barrier, armed
  // beforehand, counts the whole boxes)
  auto load = [&](int ch) {
    if (tid != 0) return;
    unsigned char* dst = raw(ch % RING);
    uint64_t* bc = &bar[ch % RING];
    tma_load_4d(dst, &tm_w, 0, ch * CH, h, b, bc);
    dst += CH * HD * sizeof(float);
    tma_load_4d(dst, &tm_r, 0, ch * CH, h, b, bc);
    tma_load_4d(dst + CH * HD * sizeof(T), &tm_k, 0, ch * CH, h, b, bc);
    tma_load_4d(dst + 2 * CH * HD * sizeof(T), &tm_v, 0, ch * CH, h, b, bc);
  };
  auto land = [&](int ch) { mbar_wait(&bar[ch % RING], (ch / RING) & 1); };
  // write out checkpoint q that chunk ch left in its slab buffer
  auto flush = [&](int ch, int q) {
    if (q * CK < p.S - ch * CH)
      slab_out<HD>(starts + static_cast<int64_t>(ch * CH / CK + q) * HD * HD,
                   ck + ((ch & 1) * (CH / CK) + q) * ckslab, cols);
  };

  if (tid == 0) {
    prefetch_tensormap(&tm_r);
    prefetch_tensormap(&tm_k);
    prefetch_tensormap(&tm_v);
    prefetch_tensormap(&tm_w);
    prefetch_tensormap(&tm_s0);
    prefetch_tensormap(&tm_sT);
    for (int x = 0; x < RING; ++x) mbar_init(&bar[x], 1);
    fence_mbarrier_init();
    mbar_expect_tx(&bar[0], static_cast<uint32_t>(Sm::STAGE + Sm::slab(cols)));
    for (int x = 1; x < RING && x < nchunk; ++x)
      mbar_expect_tx(&bar[x], static_cast<uint32_t>(Sm::STAGE));
  }
  __syncthreads();
  if (tid == 0) tma_load_4d(slab, &tm_s0, c0, 0, h, b, &bar[0]);  // s0, with chunk 0
  for (int x = 0; x < RING && x < nchunk; ++x) load(x);
  A s[KR], uk[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) uk[i] = p.u[h * p.u_sh + KR * g + i];
  land(0);
#pragma unroll
  for (int i = 0; i < KR; ++i) s[i] = slab[(KR * g + i) * cols + c];

  for (int ch = 0; ch < nchunk; ++ch) {
    const int t0 = ch * CH;
    const int n = min(CH, p.S - t0);
    // every thread has seen chunk ch land, so its barrier can be armed for
    // chunk ch + RING, whose loads the barrier at the end of this chunk orders
    if (tid == 0 && ch + RING < nchunk)
      mbar_expect_tx(&bar[ch % RING], static_cast<uint32_t>(Sm::STAGE));
    const float* ws = reinterpret_cast<const float*>(raw(ch % RING)) + KR * g;
    const T* rs = reinterpret_cast<const T*>(raw(ch % RING) + CH * HD * sizeof(float)) + KR * g;
    const T* ks = rs + CH * HD;
    const T* vs = rs - KR * g + 2 * CH * HD + c0 + c;

    A yp[CH];                // the thread's partial of y at each step of the chunk
    float cks[CH / CK][KR];  // SAVE: the chunk's checkpoints, written after its steps
    auto step = [&](int t) {
      float rr[KR], kk[KR], ww[KR];
      load_rows(rs + t * HD, rr);
      load_rows(ks + t * HD, kk);
      load_rows(ws + t * HD, ww);
      const float vt = to_float(vs[t * HD]);
      if (SAVE && t % CK == 0) {
#pragma unroll
        for (int i = 0; i < KR; ++i) cks[t / CK][i] = static_cast<float>(s[i]);
      }
      A part[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const A kv = A(kk[i]) * A(vt);
        part[i & 1] = fma_acc(A(rr[i]), fma_acc(uk[i], kv, s[i]), part[i & 1]);
        s[i] = fma_acc(A(ww[i]), s[i], kv);
      }
      yp[t] = part[0] + part[1];
    };
    if (n == CH) {
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        step(t);
        // the previous chunk's checkpoints leave between this chunk's steps,
        // so their stores spread over the chunk
        if (SAVE && ch > 0 && t % CK == CK / 2) flush(ch - 1, t / CK);
      }
    } else {
      if (SAVE && ch > 0) {
#pragma unroll
        for (int q = 0; q < CH / CK; ++q) flush(ch - 1, q);
      }
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        if (t < n) step(t);
        else yp[t] = 0.f;
      }
    }
    if (SAVE) {
      float* dst = ck + (ch & 1) * (CH / CK) * ckslab + c * (HD + SLAB_PAD) + KR * g;
#pragma unroll
      for (int q = 0; q < CH / CK; ++q)
        if (q * CK < n) store_rows(dst + q * ckslab, cks[q]);
    }
    lane_sum<KG / 2, 1, CH>(yp, g);  // lane g: steps YL g .. YL g + YL - 1
#pragma unroll
    for (int m = 0; m < YL; ++m)
      if (YL * g + m < n) y[(t0 + YL * g + m) * p.y_ss] = static_cast<float>(yp[m]);
    if (ch + 1 < nchunk) land(ch + 1);
    __syncthreads();  // chunk ch is consumed, chunk ch + 1 is ready
    if (ch + RING < nchunk) load(ch + RING);
  }
  if (SAVE) {
#pragma unroll
    for (int q = 0; q < CH / CK; ++q) flush(nchunk - 1, q);  // after the last barrier
  }

  // sT leaves through the slab: each thread its own words, one TMA store
#pragma unroll
  for (int i = 0; i < KR; ++i) slab[(KR * g + i) * cols + c] = static_cast<float>(s[i]);
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_4d(&tm_sT, slab, c0, 0, h, b);
    tma_store_drain();
  }
}

template <typename T, int HD, bool SAVE, int KR>
static cudaError_t launch_fwd(const Rwkv6Params& p, cudaStream_t stream) {
  const CUtensorMapDataType ty =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int eb = static_cast<int>(sizeof(T));
  const int64_t rows[4] = {HD, p.S, p.H, p.B};
  const int rbox[4] = {HD, CH, 1, 1};
  const int64_t sd[4] = {HD, HD, p.H, p.B};
  const int64_t ss[3] = {HD * 4, HD * HD * 4, static_cast<int64_t>(p.H) * HD * HD * 4};
  const int sbox[4] = {p.cols, HD, 1, 1};
  CUtensorMap tr, tk, tv, tw, ts0, tsT;
  const int64_t str[3] = {p.r_ss * eb, p.r_sh * eb, p.r_sb * eb};
  const int64_t stk[3] = {p.k_ss * eb, p.k_sh * eb, p.k_sb * eb};
  const int64_t stv[3] = {p.v_ss * eb, p.v_sh * eb, p.v_sb * eb};
  const int64_t stw[3] = {p.w_ss * 4, p.w_sh * 4, p.w_sb * 4};
  cudaError_t err = tensor_map_4d(&tr, ty, eb, p.r, rows, str, rbox);
  if (err == cudaSuccess) err = tensor_map_4d(&tk, ty, eb, p.k, rows, stk, rbox);
  if (err == cudaSuccess) err = tensor_map_4d(&tv, ty, eb, p.v, rows, stv, rbox);
  if (err == cudaSuccess)
    err = tensor_map_4d(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.w, rows, stw, rbox);
  if (err == cudaSuccess)
    err = tensor_map_4d(&ts0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.s0, sd, ss, sbox);
  if (err == cudaSuccess)
    err = tensor_map_4d(&tsT, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.sT, sd, ss, sbox);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<T, HD, SAVE>::bytes(p.cols);
  auto kernel = rwkv6_kernel<T, HD, SAVE, KR>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(HD / p.cols, p.H, p.B), (HD / KR) * p.cols, smem, stream>>>(p, tr, tk, tv, tw,
                                                                            ts0, tsT);
  return cudaGetLastError();
}

// A launch of one chunk (a decode step) holds 8 key rows a thread at hd =
// 64: half the threads a CTA, which measured faster there (PERF.md); the sum
// over k then has another fixed order, the same for every split.
template <typename T, int HD, bool SAVE>
static cudaError_t launch_fwd_kr(const Rwkv6Params& p, cudaStream_t stream) {
  if constexpr (HD == 64) {
    if (p.S <= CH) return launch_fwd<T, HD, SAVE, KR_STEP>(p, stream);
  }
  return launch_fwd<T, HD, SAVE, KR_SCAN>(p, stream);
}

template <typename T, int HD>
static cudaError_t launch_fwd_save(const Rwkv6Params& p, cudaStream_t stream) {
  if (p.cols < 4 || p.cols % 4 || HD % p.cols || (HD / KR_SCAN) * p.cols > FWD_MAX_THREADS)
    return cudaErrorInvalidValue;
  return p.s_starts != nullptr ? launch_fwd_kr<T, HD, true>(p, stream)
                               : launch_fwd_kr<T, HD, false>(p, stream);
}

template <typename T>
static cudaError_t launch_hd(const Rwkv6Params& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch_fwd_save<T, 32>(p, stream);
    case 64: return launch_fwd_save<T, 64>(p, stream);
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

// ---------------------------------------------------------------------------
// RWKV-6 WKV backward (B7), per (sequence b, head h), with G = dL/dS_t:
//
//   dr_t[i] = sum_j S_{t-1}[i,j] dy_t[j] + u[i] k_t[i] (dy_t . v_t)
//   dk_t[i] = sum_j G[i,j] v_t[j]       + u[i] r_t[i] (dy_t . v_t)
//   dv_t[j] = sum_i G[i,j] k_t[i]       + (r_t . (u * k_t)) dy_t[j]
//   dw_t[i] = sum_j G[i,j] S_{t-1}[i,j],   du[i] += r_t[i] k_t[i] (dy_t . v_t)
//   G[i,j] <- w_t[i] G[i,j] + r_t[i] dy_t[j]        (G starts at dsT, ends ds0)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6_scan/kernel.py:166 rwkv6_scan_bwd (_bwd_kernel :104)
// whose grid walks 64-step chunks in reverse; per chunk it rewinds the
// states from the chunk's checkpoint into a VMEM history (64 x hd x hd f32,
// 1 MiB at hd = 64) and then runs the reverse recurrence.
//
// Bound on the H100: per state element and step the function needs 14
// flops (replay: a multiply and an FMA; dr, dk, dw, dv: one FMA each;
// the G update: a multiply and an FMA), plus about 15 per row for the
// bonus and du terms. At the training microbatch (B=2, H=40, S=2048,
// hd=64) that is 9.55 GFLOP, 0.143 ms at the 67 TFLOP/s f32 rate, above
// the 297 MB its bytes need at 3.35 TB/s, 0.089 ms (r, k, v, dr, dk, dv
// in bf16, w, dy, dw in f32, and the checkpoints and du partials at the
// TPU kernel's 64-step chunk): operations bind. The 8-step checkpoints
// are this design's cost, not the function's: 298 MB more, 0.089 ms, read
// here and written by the forward.
//
// Design. The replay of S and the recurrence of G are elementwise in (i, j);
// only the outputs reduce: dr, dk, dw over value columns j, dv over key rows
// i. So each (b, h) is split by value columns over a thread-block cluster of
// NC = BWD_NC = 4 CTAs (grid (NC, H, B), launched with a cluster dimension).
// Rank q owns columns [q hd / NC, (q + 1) hd / NC) with all hd key rows, so
// dv's sum over rows stays inside the CTA. Thread (i, cg) = (tid / TPR,
// tid % TPR) holds row i and JM = 8 consecutive columns of S and G. At the
// training shape that is 320 CTAs of 128 threads (the first version ran 80
// CTAs of 512 on 132 SMs, one to an SM), three to an SM. The cluster size is
// fixed: a cluster of 2 (twice the history a thread, half the CTAs) and one
// of 8 both measured slower at the training shape.
//
// The history does not fit in full: one step of a 64 x 64 f32 history is 16
// KB. So the forward saves the state every CK = 8 steps (the reference's
// chunk is a parameter; this port's interval is its own), and per chunk,
// last first (a ragged last chunk, any S >= 1, first, masked by its length),
// each thread rewinds its own 8 columns CK steps from the checkpoint into
// registers (the whole 8-step history of its words, 64 values: split 4
// ways it fits where the first version's 128 KB shared-memory history did not),
// then walks the chunk's steps backwards, loading each step's operands one
// step ahead:
//  - dr, dk, dw: each thread's partial over its 8 columns, a fixed shuffle
//    tree over the TPR threads of the row, then one partial per rank in a
//    double-buffered shared buffer. Once per chunk every rank reads the
//    cluster's partials of its CK / NC steps through distributed shared
//    memory, adds them in rank order, adds the bonus and writes the rows. No
//    partial goes to HBM and no float atomic is used, so a run is bitwise
//    repeatable.
//  - dv: each step's products G k_i are summed over the warp's rows by
//    shuffles that hand half of the values on each round; the warps'
//    partials meet in shared memory and are added in warp order.
//  - The scalars dy.v and r.(u*k) come from the full staged rows, in the
//    same order on every rank, a chunk ahead of their use; each rank writes
//    du's chunk partials for its own hd / NC rows.
// A chunk's rows of r, k, v (as stored, widened at use), w and dy arrive by
// TMA into a three-chunk ring, two chunks ahead (one tensor map each, one of
// two mbarriers), and its checkpoint slice by loads into registers a chunk
// ahead. Two CTA barriers and one split cluster barrier (arrive after the
// walk, wait before the cross-rank sums, whose loads are issued before the
// local work that follows) per chunk.
// Measured on the H100 (PERF.md): 0.97 ms at the training microbatch, from
// 2.39. What is left is latency: one CTA alone on an SM takes 0.67 ms for
// that sequence (both device times), a chunk's short phases (rewind, walk, the barriers' skew,
// scalars, dv, du, the cross-rank sums) each waiting on the last, and the
// 2.4 CTAs an SM holds at this shape hide little of it.
//
// As in the forward, f32 inputs carry G, the replayed states and every sum
// in f64, and bf16 inputs in f32.
//
// Inputs are read through their strides (unit last stride, 16-byte aligned
// rows and base, for TMA), so the model's (B, S, H, hd) projections come as
// (B, H, S, hd) views; dr, dk, dv, dw are written through their strides
// into (B, S, H, hd) storage. r, k, v, dr, dk, dv are f32 or bf16 (widened
// on load, rounded on store); w, dy, u, s_starts, dsT, dw, du (per chunk,
// (B, H, nc, hd)) and ds0 are f32.

struct Rwkv6BwdParams {
  const void* r;        // (B, H, S, hd) views, unit last stride
  const void* k;
  const void* v;
  const float* w;
  const float* dy;
  const float* u;       // (H, hd), row stride u_sh
  const float* s_starts;  // (B, H, nc, hd, hd) contiguous
  const float* dsT;     // (B, H, hd, hd) contiguous
  void* dr;             // (B, H, S, hd) views, dtype of r
  void* dk;
  void* dv;
  float* dw;
  float* du;            // (B, H, nc, hd) contiguous, per-chunk partials
  float* ds0;           // (B, H, hd, hd) contiguous
  int64_t r_sb, r_sh, r_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t w_sb, w_sh, w_ss;
  int64_t dy_sb, dy_sh, dy_ss;
  int64_t dr_sb, dr_sh, dr_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int64_t dw_sb, dw_sh, dw_ss;
  int64_t u_sh;
  int32_t B, H, S, hd;
  int32_t dtype;        // of r, k, v, dr, dk, dv: kF32 or kBF16
};

constexpr int BWD_NC = 4;  // CTAs per (b, h), one thread-block cluster
constexpr int BWD_JM = 8;  // value columns a backward thread holds

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

template <int HD>
struct BwdShape {
  static constexpr int CPC = HD / BWD_NC;   // value columns per CTA
  static constexpr int TPR = CPC / BWD_JM;  // threads per key row
  static constexpr int NT = HD * TPR;       // threads per CTA
  static constexpr int NW = NT / 32;
  static constexpr int SPR = CK / BWD_NC;   // steps of dr, dk, dw each rank writes
  static_assert(TPR >= 1 && CPC <= 32 && NT % 32 == 0 && CK % BWD_NC == 0, "unsupported split");
};

// Shared memory of the backward, in bytes: three stages of a chunk's rows
// (one in use, the next landed, the one after arriving), each w and dy
// (f32) then r, k, v as stored; two partial buffers of dr, dk, dw; the
// warps' dv partials; two buffers of step scalars; u; two mbarriers.
template <typename T, int HD>
struct BwdSmem {
  using Sh = BwdShape<HD>;
  static constexpr size_t STAGE = CK * HD * (2 * sizeof(float) + 3 * sizeof(T));
  static constexpr size_t PART_AT = 3 * STAGE;
  static constexpr size_t FLOATS = 2 * 3 * CK * HD + CK * Sh::NW * Sh::CPC + 2 * 2 * CK + HD;
  static constexpr size_t BAR_AT = PART_AT + FLOATS * sizeof(float);
  static constexpr size_t BYTES = BAR_AT + 2 * sizeof(uint64_t);
  static constexpr uint32_t TX = STAGE;  // a chunk's boxes
};

template <typename T>
__device__ __forceinline__ void store_as(void* base, int64_t off, float x) {
  static_cast<T*>(base)[off] = from_float<T>(x);
}

// Split cluster barrier: arrive releases this thread's shared-memory writes
// to the cluster, wait acquires every other thread's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(BwdShape<HD>::NT, sizeof(T) == 2 ? 3 : 1)
rwkv6_bwd_kernel(const Rwkv6BwdParams p, const __grid_constant__ CUtensorMap tm_r,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_dy) {
  using Sh = BwdShape<HD>;
  using A = typename AccOf<T>::type;
  constexpr int NC = BWD_NC;
  constexpr int JM = BWD_JM;
  constexpr int CPC = Sh::CPC;
  constexpr int TPR = Sh::TPR;
  constexpr int NT = Sh::NT;
  constexpr int NW = Sh::NW;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i = tid / TPR;              // key row
  const int c0 = q * CPC;               // this rank's first value column
  const int jl = (tid % TPR) * JM;      // the thread's first column within the rank's
  const int lane = tid % 32;
  const int warp = tid / 32;

  using Sm = BwdSmem<T, HD>;
  extern __shared__ __align__(128) unsigned char rwkv_smem[];
  // chunk c's stage: w, dy [CK][HD] in f32, then r, k, v [CK][HD] as stored
  auto wst = [&](int c) { return reinterpret_cast<float*>(rwkv_smem + (c % 3) * Sm::STAGE); };
  auto rkv = [&](int c) {
    return reinterpret_cast<T*>(rwkv_smem + (c % 3) * Sm::STAGE + 2 * CK * HD * sizeof(float));
  };
  float* part = reinterpret_cast<float*>(rwkv_smem + Sm::PART_AT);  // [2][CK][3][HD]
  float* dvp = part + 2 * 3 * CK * HD;  // [CK][NW][CPC]: dv partials of each warp's rows
  float* scal = dvp + CK * NW * CPC;    // [2][CK][2]: dy.v, r.(u*k) of a chunk's steps
  float* u_s = scal + 2 * 2 * CK;       // [HD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(rwkv_smem + Sm::BAR_AT);  // [2]
  auto scl = [&](int c) { return scal + (c & 1) * 2 * CK; };

  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const int64_t dr_o = b * p.dr_sb + h * p.dr_sh;
  const int64_t dk_o = b * p.dk_sb + h * p.dk_sh;
  const int64_t dv_o = b * p.dv_sb + h * p.dv_sh + c0;
  float* dw = p.dw + b * p.dw_sb + h * p.dw_sh;
  const int nch = (p.S + CK - 1) / CK;
  const int64_t own = static_cast<int64_t>(i) * HD + c0 + jl;  // the thread's words of a state
  const float* starts = p.s_starts + bh * nch * HD * HD + own;

  // (thread 0) arm chunk c's barrier and load its rows into its stage, one
  // TMA each. Rows past S read as zeros; the barrier counts whole boxes.
  auto load = [&](int c) {
    uint64_t* bc = &bar[c & 1];
    mbar_expect_tx(bc, Sm::TX);
    tma_load_4d(wst(c), &tm_w, 0, c * CK, h, b, bc);
    tma_load_4d(wst(c) + CK * HD, &tm_dy, 0, c * CK, h, b, bc);
    tma_load_4d(rkv(c), &tm_r, 0, c * CK, h, b, bc);
    tma_load_4d(rkv(c) + CK * HD, &tm_k, 0, c * CK, h, b, bc);
    tma_load_4d(rkv(c) + 2 * CK * HD, &tm_v, 0, c * CK, h, b, bc);
  };
  // chunk c's loads are the ((nch - 1 - c) / 2)-th on their barrier
  auto landed = [&](int c) { mbar_wait(&bar[c & 1], ((nch - 1 - c) >> 1) & 1); };
  // chunk c's per-step scalars from its landed rows: each warp its steps,
  // lane partials, then the trees of all of them interleaved (a fixed order)
  auto scalars = [&](int c) {
    constexpr int QN = (CK + NW - 1) / NW;
    const int n = min(CK, p.S - c * CK);
    const T* rr = rkv(c);
    const float* dys = wst(c) + CK * HD;
    A sc[2 * QN];
#pragma unroll
    for (int x = 0; x < QN; ++x) {
      const int t = warp + NW * x;
      A dyv = 0, ruk = 0;
      if (t < n) {
#pragma unroll
        for (int y = 0; y < HD / 32; ++y) {
          const int d = lane + 32 * y;
          dyv = fma_acc(A(dys[t * HD + d]), A(to_float(rr[(2 * CK + t) * HD + d])), dyv);
          ruk = fma_acc(A(to_float(rr[t * HD + d])),
                        A(u_s[d]) * A(to_float(rr[(CK + t) * HD + d])), ruk);
        }
      }
      sc[2 * x] = dyv;
      sc[2 * x + 1] = ruk;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int x = 0; x < 2 * QN; ++x) sc[x] += __shfl_xor_sync(0xffffffffu, sc[x], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < QN; ++x) {
        if (warp + NW * x < n) {
          scl(c)[2 * (warp + NW * x)] = static_cast<float>(sc[2 * x]);
          scl(c)[2 * (warp + NW * x) + 1] = static_cast<float>(sc[2 * x + 1]);
        }
      }
    }
  };

  for (int d = tid; d < HD; d += NT) u_s[d] = p.u[h * p.u_sh + d];
  A G[JM];
  float Sn[JM];
  {
    float g0[JM];
    load_rows(p.dsT + bh * HD * HD + own, g0);
#pragma unroll
    for (int m = 0; m < JM; ++m) G[m] = g0[m];
  }
  load_rows(starts + static_cast<int64_t>(nch - 1) * HD * HD, Sn);
  if (tid == 0) {
    prefetch_tensormap(&tm_r);
    prefetch_tensormap(&tm_k);
    prefetch_tensormap(&tm_v);
    prefetch_tensormap(&tm_w);
    prefetch_tensormap(&tm_dy);
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    load(nch - 1);
    if (nch > 1) load(nch - 2);
  }
  landed(nch - 1);
  scalars(nch - 1);

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * CK;
    const int n = min(CK, p.S - t0);
    __syncthreads();  // chunk c's scalars are complete; dv partials are free
    A hist[CK][JM];  // hist[t] = S_{t0 + t - 1}: the thread's own words, in registers
#pragma unroll
    for (int m = 0; m < JM; ++m) hist[0][m] = Sn[m];
    if (c > 0) load_rows(starts + static_cast<int64_t>(c - 1) * HD * HD, Sn);
    const T* rs = rkv(c);  // r, k, v as stored, widened at use
    const T* ks = rs + CK * HD;
    const T* vs = rs + 2 * CK * HD;
    const float* ws = wst(c);
    const float* dys = ws + CK * HD;
    const float* sc = scl(c);

    // rewind the chunk from its checkpoint
#pragma unroll
    for (int t = 0; t + 1 < CK; ++t) {
      if (t + 1 < n) {
        const A wt = ws[t * HD + i];
        const A kt = to_float(ks[t * HD + i]);
        float vj[JM];
        load_rows(vs + t * HD + c0 + jl, vj);
#pragma unroll
        for (int m = 0; m < JM; ++m) hist[t + 1][m] = fma_acc(wt, hist[t][m], kt * A(vj[m]));
      }
    }

    // reverse walk over the chunk's steps. A full chunk loads step t - 1's
    // operands before step t's stores, so the loads never wait behind them.
    struct Wlk { float r, k, w, dy[JM], v[JM]; };
    auto wlk_load = [&](int t, Wlk& o) {
      o.r = to_float(rs[t * HD + i]);
      o.k = to_float(ks[t * HD + i]);
      o.w = ws[t * HD + i];
      load_rows(dys + t * HD + c0 + jl, o.dy);
      load_rows(vs + t * HD + c0 + jl, o.v);
    };
    float* pp = part + (c & 1) * CK * 3 * HD;
    auto wlk_step = [&](int t, const Wlk& o) {
      A pr = 0, pk = 0, pw = 0, pv[JM];
#pragma unroll
      for (int m = 0; m < JM; ++m) {
        const A gm = G[m];
        const A sm = hist[t][m];
        const A dym = o.dy[m];
        pr = fma_acc(sm, dym, pr);
        pk = fma_acc(gm, A(o.v[m]), pk);
        pw = fma_acc(gm, sm, pw);
        pv[m] = gm * A(o.k);
        G[m] = fma_acc(A(o.w), gm, A(o.r) * dym);
      }
#pragma unroll
      for (int x = 1; x < TPR; x <<= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, x);
        pk += __shfl_xor_sync(0xffffffffu, pk, x);
        pw += __shfl_xor_sync(0xffffffffu, pw, x);
      }
      if (tid % TPR == 0) {
        pp[(3 * t) * HD + i] = static_cast<float>(pr);
        pp[(3 * t + 1) * HD + i] = static_cast<float>(pk);
        pp[(3 * t + 2) * HD + i] = static_cast<float>(pw);
      }
      // dv: the sum of G k_i over the warp's rows (lane bits 16 .. TPR); the
      // halving rounds take the top log2(JM) bits, which then name the
      // lane's column, and the lanes whose remaining row bits are 0 write it
      lane_sum<16, TPR, JM>(pv, lane);
      constexpr int HB = 5 - ilog2(JM);  // lowest halving bit
      if ((lane & ((1 << HB) - 1) & ~(TPR - 1)) == 0)
        dvp[(t * NW + warp) * CPC + jl + (lane >> HB)] = static_cast<float>(pv[0]);
    };
    if (n == CK) {
      Wlk wo[2];
      wlk_load(CK - 1, wo[(CK - 1) & 1]);
#pragma unroll
      for (int t = CK - 1; t >= 0; --t) {
        if (t > 0) wlk_load(t - 1, wo[(t - 1) & 1]);
        wlk_step(t, wo[t & 1]);
      }
    } else {
#pragma unroll
      for (int t = CK - 1; t >= 0; --t) {
        if (t < n) {
          Wlk o;
          wlk_load(t, o);
          wlk_step(t, o);
        }
      }
    }
    cluster_arrive();   // this rank's partials of chunk c are written
    if (c > 0) landed(c - 1);
    __syncthreads();    // dv partials are visible; chunk c - 1 has landed; chunk c + 1's
                        // stage is free for chunk c - 2
    if (tid == 0 && c > 1) load(c - 2);
    cluster_wait();     // every rank's partials of chunk c are visible
    // the ranks' partials of this rank's steps, fetched now and added after
    // the local work below, which hides their latency
    constexpr int OPT = (Sh::SPR * HD + NT - 1) / NT;
    float rem[OPT][NC][3];  // stored partials
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int e = tid + o * NT;
      const int t = q * Sh::SPR + e / HD;
      if (e < Sh::SPR * HD && t < n) {
#pragma unroll
        for (int rk = 0; rk < NC; ++rk) {
          const float* rp = cluster.map_shared_rank(pp, rk) + 3 * t * HD + e % HD;
          rem[o][rk][0] = rp[0];
          rem[o][rk][1] = rp[HD];
          rem[o][rk][2] = rp[2 * HD];
        }
      }
    }
    if (c > 0) scalars(c - 1);

    // dv over this rank's columns: the warps' partials in warp order
    for (int e = tid; e < n * CPC; e += NT) {
      const int t = e / CPC;
      const int j = e % CPC;
      A sum = dvp[t * NW * CPC + j];
#pragma unroll
      for (int x = 1; x < NW; ++x) sum += dvp[(t * NW + x) * CPC + j];
      store_as<T>(p.dv, dv_o + (t0 + t) * p.dv_ss + j,
                  static_cast<float>(fma_acc(A(sc[2 * t + 1]), A(dys[t * HD + c0 + j]), sum)));
    }
    // du's chunk partials, each row by one rank: rank q's rows, one (row,
    // step) product a thread, summed over the steps by a fixed tree
    constexpr int DR = HD / NC;
    static_assert(DR * CK % 32 == 0, "whole warps");
    for (int e = tid; e < DR * CK; e += NT) {
      const int ii = q * DR + e / CK;
      const int t = e % CK;
      A x = t < n ? A(to_float(rs[t * HD + ii])) * A(to_float(ks[t * HD + ii])) * A(sc[2 * t])
                  : A(0);
#pragma unroll
      for (int o = 1; o < CK; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (t == 0) p.du[(bh * nch + c) * HD + ii] = static_cast<float>(x);
    }
    // dr, dk, dw of this rank's steps: the ranks' partials in rank order
#pragma unroll
    for (int o = 0; o < OPT; ++o) {
      const int e = tid + o * NT;
      const int t = q * Sh::SPR + e / HD;
      const int ii = e % HD;
      if (e < Sh::SPR * HD && t < n) {
        A sr = 0, sk = 0, sw = 0;
#pragma unroll
        for (int rk = 0; rk < NC; ++rk) {
          sr += rem[o][rk][0];
          sk += rem[o][rk][1];
          sw += rem[o][rk][2];
        }
        const A dyv = sc[2 * t];
        const A u_i = u_s[ii];
        const int64_t ts = t0 + t;
        store_as<T>(p.dr, dr_o + ts * p.dr_ss + ii,
                    static_cast<float>(fma_acc(u_i * A(to_float(ks[t * HD + ii])), dyv, sr)));
        store_as<T>(p.dk, dk_o + ts * p.dk_ss + ii,
                    static_cast<float>(fma_acc(u_i * A(to_float(rs[t * HD + ii])), dyv, sk)));
        dw[ts * p.dw_ss + ii] = static_cast<float>(sw);
      }
    }
  }

  {
    float g0[JM];
#pragma unroll
    for (int m = 0; m < JM; ++m) g0[m] = static_cast<float>(G[m]);
    store_rows(p.ds0 + bh * HD * HD + own, g0);
  }
  cluster_arrive();  // no CTA leaves while a peer may still read its partials
  cluster_wait();
}

template <typename T, int HD>
static cudaError_t launch_bwd(const Rwkv6BwdParams& p, cudaStream_t stream) {
  const CUtensorMapDataType ty =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int eb = static_cast<int>(sizeof(T));
  const int64_t rows[4] = {HD, p.S, p.H, p.B};
  const int box[4] = {HD, CK, 1, 1};
  const int64_t str[3] = {p.r_ss * eb, p.r_sh * eb, p.r_sb * eb};
  const int64_t stk[3] = {p.k_ss * eb, p.k_sh * eb, p.k_sb * eb};
  const int64_t stv[3] = {p.v_ss * eb, p.v_sh * eb, p.v_sb * eb};
  const int64_t stw[3] = {p.w_ss * 4, p.w_sh * 4, p.w_sb * 4};
  const int64_t sty[3] = {p.dy_ss * 4, p.dy_sh * 4, p.dy_sb * 4};
  CUtensorMap tr, tk, tv, tw, ty4;
  cudaError_t err = tensor_map_4d(&tr, ty, eb, p.r, rows, str, box);
  if (err == cudaSuccess) err = tensor_map_4d(&tk, ty, eb, p.k, rows, stk, box);
  if (err == cudaSuccess) err = tensor_map_4d(&tv, ty, eb, p.v, rows, stv, box);
  if (err == cudaSuccess)
    err = tensor_map_4d(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.w, rows, stw, box);
  if (err == cudaSuccess)
    err = tensor_map_4d(&ty4, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.dy, rows, sty, box);
  if (err != cudaSuccess) return err;
  const size_t smem = BwdSmem<T, HD>::BYTES;
  auto kernel = rwkv6_bwd_kernel<T, HD>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BWD_NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BWD_NC, p.H, p.B);
  cfg.blockDim = dim3(BwdShape<HD>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, tr, tk, tv, tw, ty4);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_bwd_hd(const Rwkv6BwdParams& p, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch_bwd<T, 32>(p, stream);
    case 64: return launch_bwd<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int rwkv6_scan_bwd(const Rwkv6BwdParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->S < 1) return cudaErrorInvalidValue;
  if (p->dtype == kF32) return launch_bwd_hd<float>(*p, s);
  if (p->dtype == kBF16) return launch_bwd_hd<__nv_bfloat16>(*p, s);
  return cudaErrorInvalidValue;
}
