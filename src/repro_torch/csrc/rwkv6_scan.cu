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
// Training passes a non-null s_starts (B, H, ceil(S / CK), hd, hd): the
// state before steps 0, CK, 2 CK, ..., the checkpoints B7 below rewinds
// from (the TPU kernel's save_states, at the port's own interval CK).
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
  float* s_starts;      // (B, H, nc, hd, hd) contiguous, or null (serving)
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
constexpr int CK = 8;      // steps between saved states (kernel/ref.py CHECKPOINT)
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

// SAVE: write the chunk-start states (training); the serving instance has
// no such branch in its step loop.
template <typename T, int HD, bool SAVE>
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
  float* starts = SAVE ? p.s_starts + (static_cast<int64_t>(b) * p.H + h)
                               * ((p.S + CK - 1) / CK) * HD * HD + c0 + c
                        : nullptr;

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
      if (SAVE && (t0 + t) % CK == 0) {
        float* dst = starts + static_cast<int64_t>((t0 + t) / CK) * HD * HD;
#pragma unroll
        for (int i = 0; i < KR; ++i) dst[(g + KG * i) * HD] = s[i];
      }
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
  auto kernel = p.s_starts != nullptr ? rwkv6_kernel<T, HD, true>
                                      : rwkv6_kernel<T, HD, false>;
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
// Design. One CTA per (b, h) holds the whole state, so the sums over value
// columns (dr, dk, dw) and over key rows (dv) need no pass across CTAs and
// no float atomics: the result does not depend on the launch shape. Its
// 8 * HD threads split the state as thread (i, cg) = (tid / 8, tid % 8)
// holding row i, columns cg, cg + 8, ... (HD / 8 elements of S and of G in
// registers). Sums over columns: the thread's partial, then a fixed
// shuffle tree over the 8 lanes of the row (xor 1, 2, 4). Sums over rows
// (dv): a fixed tree over the warp's 4 rows (xor 8, 16), then the warps'
// partials summed in warp order from shared memory.
//
// The history does not fit: a Hopper CTA has 227 KB of shared memory, one
// step of a 64 x 64 f32 history is 16 KB. So the checkpoint interval is
// short: the forward saves the state every CK = 8 steps (the reference's
// chunk is a parameter; this port's interval is its own), and the
// backward rewinds CK steps into a 128 KB history in shared memory, each
// thread reading back only its own elements (no barrier between replay and
// reverse walk; laid out [step][element][thread], conflict-free). The
// checkpoints cost the forward S / 8 states of hd * hd f32 per (b, h), read
// once here: a full-width microbatch (B=2, H=40, S=2048) moves 335 MB of
// them. The chunks run from the last to the first, a ragged last chunk
// (any S >= 1) first, masked by its length.
//
// Inputs are read through their strides (unit last stride), so the model's
// (B, S, H, hd) projections come as (B, H, S, hd) views; dr, dk, dv, dw are
// written through their strides into (B, S, H, hd) storage. r, k, v, dr,
// dk, dv are f32 or bf16 (widened on load, rounded on store); w, dy, u,
// s_starts, dsT, dw, du (per chunk, (B, H, nc, hd)) and ds0 are f32.
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
// here and written by the forward. This simple kernel is far above it: 80 CTAs on 132 SMs, each a sequential chain of
// S steps, every step a few shared-memory loads, ~8 FMAs a thread and
// five shuffle rounds, and every chunk of 8 steps a global load of its
// checkpoint and inputs that nothing overlaps.

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

constexpr int BWD_CG = 8;  // lanes splitting the value columns of one row

template <int HD>
__host__ __device__ constexpr int bwd_threads() { return BWD_CG * HD; }

template <int HD>
__host__ __device__ constexpr size_t bwd_smem_floats() {
  return static_cast<size_t>(CK) * HD * HD           // history
         + 5 * CK * HD                                // r, k, v, w, dy rows
         + 2 * CK                                     // dy.v, r.(u*k) per step
         + 3 * CK * HD                                // dr, dk, dw rows
         + static_cast<size_t>(CK) * (bwd_threads<HD>() / 32) * HD;  // dv per warp
}

template <typename T>
__device__ __forceinline__ void store_as(void* base, int64_t off, float x) {
  static_cast<T*>(base)[off] = from_float<T>(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_CG * 64) rwkv6_bwd_kernel(const Rwkv6BwdParams p) {
  constexpr int JM = HD / BWD_CG;          // columns per thread
  constexpr int NT = bwd_threads<HD>();
  constexpr int NW = NT / 32;
  static_assert(NW >= CK, "one warp per step computes the step's scalars");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = tid % BWD_CG;
  const int i = tid / BWD_CG;              // key row
  const int lane = tid % 32;
  const int warp = tid / 32;

  extern __shared__ float smem[];
  float* hist = smem;                      // [CK][JM][NT]
  float* r_s = hist + CK * HD * HD;
  float* k_s = r_s + CK * HD;
  float* v_s = k_s + CK * HD;
  float* w_s = v_s + CK * HD;
  float* dy_s = w_s + CK * HD;
  float* scal = dy_s + CK * HD;            // [CK][2]
  float* dr_s = scal + 2 * CK;
  float* dk_s = dr_s + CK * HD;
  float* dw_s = dk_s + CK * HD;
  float* dvp = dw_s + CK * HD;             // [CK][NW][HD]

  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const float* dy = p.dy + b * p.dy_sb + h * p.dy_sh;
  const int64_t dr_o = b * p.dr_sb + h * p.dr_sh;
  const int64_t dk_o = b * p.dk_sb + h * p.dk_sh;
  const int64_t dv_o = b * p.dv_sb + h * p.dv_sh;
  float* dw = p.dw + b * p.dw_sb + h * p.dw_sh;
  const int nc = (p.S + CK - 1) / CK;
  const float* starts = p.s_starts + bh * nc * HD * HD;
  const float u_i = p.u[h * p.u_sh + i];

  float G[JM], Sv[JM], pv[JM];
#pragma unroll
  for (int m = 0; m < JM; ++m) G[m] = p.dsT[bh * HD * HD + i * HD + cg + BWD_CG * m];

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CK;
    const int n = min(CK, p.S - t0);
    stage_rows<T, HD>(r_s, r, p.r_ss, t0, n);
    stage_rows<T, HD>(k_s, k, p.k_ss, t0, n);
    stage_rows<T, HD>(v_s, v, p.v_ss, t0, n);
    stage_rows<float, HD>(w_s, w, p.w_ss, t0, n);
    stage_rows<float, HD>(dy_s, dy, p.dy_ss, t0, n);
#pragma unroll
    for (int m = 0; m < JM; ++m)
      Sv[m] = starts[static_cast<int64_t>(c) * HD * HD + i * HD + cg + BWD_CG * m];
    __syncthreads();

    if (warp < n) {  // per-step scalars, fixed order: lane partials, then a tree
      const int t = warp;
      float dyv = 0.f, ruk = 0.f;
      for (int d = lane; d < HD; d += 32) {
        dyv = fmaf(dy_s[t * HD + d], v_s[t * HD + d], dyv);
        ruk = fmaf(r_s[t * HD + d], p.u[h * p.u_sh + d] * k_s[t * HD + d], ruk);
      }
      dyv = warp_sum(dyv);
      ruk = warp_sum(ruk);
      if (lane == 0) {
        scal[2 * t] = dyv;
        scal[2 * t + 1] = ruk;
      }
    }
    // rewind: hist[t] = S_{t0 + t - 1}, each thread its own elements
#pragma unroll
    for (int t = 0; t < CK; ++t) {
      if (t < n) {
        const float wt = w_s[t * HD + i];
        const float kt = k_s[t * HD + i];
#pragma unroll
        for (int m = 0; m < JM; ++m) {
          hist[(t * JM + m) * NT + tid] = Sv[m];
          Sv[m] = fmaf(wt, Sv[m], kt * v_s[t * HD + cg + BWD_CG * m]);
        }
      }
    }
    __syncthreads();  // scal

    float du_c = 0.f;
#pragma unroll
    for (int t = CK - 1; t >= 0; --t) {
      if (t < n) {
        const float rt = r_s[t * HD + i];
        const float kt = k_s[t * HD + i];
        const float wt = w_s[t * HD + i];
        const float dyv = scal[2 * t];
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int m = 0; m < JM; ++m) {
          const int j = cg + BWD_CG * m;
          const float s = hist[(t * JM + m) * NT + tid];
          const float g = G[m];
          const float dyj = dy_s[t * HD + j];
          pr = fmaf(s, dyj, pr);
          pk = fmaf(g, v_s[t * HD + j], pk);
          pw = fmaf(g, s, pw);
          pv[m] = g * kt;
          G[m] = fmaf(wt, g, rt * dyj);
        }
#pragma unroll
        for (int o = 1; o < BWD_CG; o <<= 1) {
          pr += __shfl_xor_sync(0xffffffffu, pr, o);
          pk += __shfl_xor_sync(0xffffffffu, pk, o);
          pw += __shfl_xor_sync(0xffffffffu, pw, o);
        }
        if (cg == 0) {
          dr_s[t * HD + i] = fmaf(u_i * kt, dyv, pr);
          dk_s[t * HD + i] = fmaf(u_i * rt, dyv, pk);
          dw_s[t * HD + i] = pw;
          du_c = fmaf(rt * kt, dyv, du_c);
        }
#pragma unroll
        for (int m = 0; m < JM; ++m) {
          pv[m] += __shfl_xor_sync(0xffffffffu, pv[m], 8);
          pv[m] += __shfl_xor_sync(0xffffffffu, pv[m], 16);
          if (lane < BWD_CG) dvp[(t * NW + warp) * HD + cg + BWD_CG * m] = pv[m];
        }
      }
    }
    if (cg == 0) p.du[(bh * nc + c) * HD + i] = du_c;
    __syncthreads();  // dr_s, dk_s, dw_s, dvp

    for (int e = tid; e < n * HD; e += NT) {
      const int t = e / HD;
      const int d = e % HD;
      float dvsum = 0.f;
      for (int q = 0; q < NW; ++q) dvsum += dvp[(t * NW + q) * HD + d];
      const int64_t ts = t0 + t;
      store_as<T>(p.dr, dr_o + ts * p.dr_ss + d, dr_s[e]);
      store_as<T>(p.dk, dk_o + ts * p.dk_ss + d, dk_s[e]);
      store_as<T>(p.dv, dv_o + ts * p.dv_ss + d, fmaf(scal[2 * t + 1], dy_s[e], dvsum));
      dw[ts * p.dw_ss + d] = dw_s[e];
    }
    __syncthreads();  // staging is reused by the next chunk
  }

#pragma unroll
  for (int m = 0; m < JM; ++m) p.ds0[bh * HD * HD + i * HD + cg + BWD_CG * m] = G[m];
}

template <typename T, int HD>
static cudaError_t launch_bwd(const Rwkv6BwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<HD>() * sizeof(float);
  auto kernel = rwkv6_bwd_kernel<T, HD>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, p.B), bwd_threads<HD>(), smem, stream>>>(p);
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
