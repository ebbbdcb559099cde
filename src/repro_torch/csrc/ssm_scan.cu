// Mamba-1 selective scan (forward), per (sequence b, channel d, state n):
//
//   h[n] <- exp(dt_t * A[d,n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t   = sum_n h[n] * C_t[n] + D[d] * x_t
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py:62 ssm_scan_fwd (B4, body _kernel :29)
// whose grid (B, Di / 512, n_chunks) walks 64-step time chunks in order and
// keeps a (512, N) f32 state block in VMEM scratch between them. Here the
// sequential grid axis becomes a loop inside the CTA and the state never
// leaves registers.
//
// Design. Channels are independent and B_t, C_t are shared by every channel
// of a row, so one thread owns one (b, d): its N state values and its row of
// A sit in registers (N is a template parameter, 8 or 16). A CTA takes 128
// consecutive channels of one sequence (grid (ceil(Di / 128), B): 128 CTAs
// at a B=1, Di=16384 prefill, fewer than the card's 132 SMs). Time runs in
// chunks of CH = 16 steps. The CTA stages a chunk's B and C rows (2 CH N
// floats) in shared memory, double-buffered, and each thread holds the
// chunk's x and dt values of its channel in registers; the next chunk's
// loads are issued before the current chunk's steps, so they overlap them,
// and one barrier per chunk publishes the next B/C buffer. x, dt and y are
// read and written one step at a time across the CTA's threads: consecutive
// threads, consecutive channels, coalesced. The sum over n runs in a fixed
// order (n = 0, 1, ...), and the exponential is the accurate expf, so a run
// is bitwise repeatable and does not depend on the launch shape. A ragged
// last chunk (any S >= 1) is masked by its length; a thread past Di computes
// on zeros and writes nothing.
//
// All tensors are f32 and contiguous: x, dt, y (B, S, Di); Bc, Cc (B, S, N);
// A (Di, N); D (Di,); h0, hT (B, Di, N), read and written as float4 (16-byte
// aligned bases, checked by the wrapper). hT may alias h0 (decode updates the
// slot cache in place): each thread reads its own state row before it writes
// it, and no other thread touches that row.
//
// Bound on the H100: at a prefill (B=1, S=4500, Di=16384, N=16) the function
// reads x and dt and writes y (3 x 294.9 MB) and reads B, C, A, D, h0 and
// writes hT (~4 MB): 888.5 MB at 3.35 TB/s, 0.265 ms. Its operations, 7 per
// (d, n, t) (dt*A, exp, da*h, dtx*B and their sum, h*C and the running sum)
// and 3 per (d, t) (dt*x, D*x and its add), are 8.48 GFLOP, 0.127 ms at the
// 67 TFLOP/s f32 rate, counting exp as one: bytes bind. A decode
// step (B=4, S=1) moves the 8.4 MB of state in and out and reads A: bytes,
// ~3 us. This simple kernel is latency-bound above both: 4 warps per SM,
// each step a chain of N exponentials and FMAs per thread.
#include "common.cuh"

struct SsmParams {
  const float* x;       // (B, S, Di) contiguous
  const float* dt;      // (B, S, Di) contiguous
  const float* A;       // (Di, N) contiguous
  const float* Bc;      // (B, S, N) contiguous
  const float* Cc;      // (B, S, N) contiguous
  const float* D;       // (Di,)
  const float* h0;      // (B, Di, N) contiguous
  float* y;             // (B, S, Di) contiguous
  float* hT;            // (B, Di, N) contiguous; may equal h0
  int32_t B, S, Di, N;
};

constexpr int SSM_THREADS = 128;  // channels per CTA
constexpr int SSM_CH = 16;        // time steps per chunk

// One chunk's inputs as a thread holds them: its channel's x and dt for
// every step, and its share of the B and C values it stages for the CTA.
template <int N>
struct Chunk {
  static constexpr int PER = SSM_CH * N / SSM_THREADS;
  static_assert(PER * SSM_THREADS == SSM_CH * N, "a chunk's B/C rows split evenly");
  float x[SSM_CH], dt[SSM_CH], b[PER], c[PER];
};

template <int N>
__device__ __forceinline__ void load_chunk(Chunk<N>& k, const SsmParams& p, int b,
                                           int d, int t0) {
  const int n = min(SSM_CH, p.S - t0);
  const bool live = d < p.Di;
  const int64_t row = static_cast<int64_t>(b) * p.S + t0;
#pragma unroll
  for (int t = 0; t < SSM_CH; ++t) {
    const bool ok = live && t < n;
    const int64_t off = (row + t) * p.Di + d;
    k.x[t] = ok ? p.x[off] : 0.f;
    k.dt[t] = ok ? p.dt[off] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < Chunk<N>::PER; ++i) {
    const int e = threadIdx.x + i * SSM_THREADS;  // step e / N, state e % N
    const bool ok = e < n * N;
    k.b[i] = ok ? p.Bc[row * N + e] : 0.f;
    k.c[i] = ok ? p.Cc[row * N + e] : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void stage_bc(float* bs, float* cs, const Chunk<N>& k) {
#pragma unroll
  for (int i = 0; i < Chunk<N>::PER; ++i) {
    bs[threadIdx.x + i * SSM_THREADS] = k.b[i];
    cs[threadIdx.x + i * SSM_THREADS] = k.c[i];
  }
}

template <int N>
__global__ void __launch_bounds__(SSM_THREADS) ssm_scan_kernel(const SsmParams p) {
  static_assert(N % 4 == 0, "state rows move as float4");
  __shared__ __align__(16) float bc_s[2][2][SSM_CH * N];  // [buffer][B, C][t * N + n]
  const int d = blockIdx.x * SSM_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = d < p.Di;
  const int64_t hoff = (static_cast<int64_t>(b) * p.Di + d) * N;

  float h[N], a[N];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hv = live ? reinterpret_cast<const float4*>(p.h0 + hoff)[q] : z;
    const float4 av = live ? reinterpret_cast<const float4*>(p.A + static_cast<int64_t>(d) * N)[q] : z;
    h[4 * q] = hv.x; h[4 * q + 1] = hv.y; h[4 * q + 2] = hv.z; h[4 * q + 3] = hv.w;
    a[4 * q] = av.x; a[4 * q + 1] = av.y; a[4 * q + 2] = av.z; a[4 * q + 3] = av.w;
  }
  const float dd = live ? p.D[d] : 0.f;

  Chunk<N> cur, nxt;
  load_chunk<N>(cur, p, b, d, 0);
  stage_bc<N>(bc_s[0][0], bc_s[0][1], cur);
  __syncthreads();
  int buf = 0;
  for (int t0 = 0; t0 < p.S; t0 += SSM_CH) {
    const int n = min(SSM_CH, p.S - t0);
    const bool more = t0 + SSM_CH < p.S;  // uniform over the CTA
    if (more) load_chunk<N>(nxt, p, b, d, t0 + SSM_CH);
    const float* bs = bc_s[buf][0];
    const float* cs = bc_s[buf][1];
    float* y = p.y + (static_cast<int64_t>(b) * p.S + t0) * p.Di + d;
#pragma unroll
    for (int t = 0; t < SSM_CH; ++t) {
      if (t < n) {
        const float dtt = cur.dt[t];
        const float dtx = dtt * cur.x[t];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float da = expf(dtt * a[j]);
          h[j] = fmaf(da, h[j], dtx * bs[t * N + j]);
          acc = fmaf(h[j], cs[t * N + j], acc);
        }
        if (live) y[static_cast<int64_t>(t) * p.Di] = fmaf(dd, cur.x[t], acc);
      }
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      buf ^= 1;
      stage_bc<N>(bc_s[buf][0], bc_s[buf][1], nxt);
      cur = nxt;
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p.hT + hoff)[q] =
          make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <int N>
static cudaError_t launch(const SsmParams& p, cudaStream_t stream) {
  const dim3 grid((p.Di + SSM_THREADS - 1) / SSM_THREADS, p.B);
  ssm_scan_kernel<N><<<grid, SSM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int ssm_scan_fwd(const SsmParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->S < 1 || p->B < 1 || p->Di < 1) return cudaErrorInvalidValue;
  switch (p->N) {
    case 8: return launch<8>(*p, s);
    case 16: return launch<16>(*p, s);
    default: return cudaErrorInvalidValue;
  }
}
