// Mamba-1 selective scan, forward (B4) and backward (B6), per (sequence b,
// channel d, state n):
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
// threads, consecutive channels, coalesced. The sum over n for y runs in a
// fixed order: four partial sums (n mod 4, each in order of n) added
// pairwise, a shorter dependency chain than one running sum and about half
// its rounding error, which an 8-layer stack amplifies into its f32
// gradients; the exponential is the accurate expf, so a run
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
// (d, n, t) (dt*A, exp, da*h, dtx*B and their sum, h*C and its sum)
// and 3 per (d, t) (dt*x, D*x and its add), are 8.48 GFLOP, 0.127 ms at the
// 67 TFLOP/s f32 rate, counting exp as one: bytes bind. A decode
// step (B=4, S=1) moves the 8.4 MB of state in and out and reads A: bytes,
// ~3 us. This simple kernel is latency-bound above both: 4 warps per SM,
// each step a chain of N exponentials and FMAs per thread.
//
// Training passes a non-null h_starts (B, nc, Di, N), nc = ceil(S / CK): the
// state before steps 0, CK, 2 CK, ..., the checkpoints B6 below replays from
// (the TPU kernel's save_states, at the port's own interval CK). Saving is a
// template parameter, so the serving instance has no such branch in its
// step loop (a runtime branch spilled and slowed the RWKV-6 forward).
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
  float* h_starts;      // (B, nc, Di, N) contiguous, or null (serving)
  int32_t B, S, Di, N;
};

constexpr int SSM_THREADS = 128;  // channels per CTA (kernel.py CHANNELS_PER_CTA)
constexpr int SSM_CH = 16;        // time steps per chunk
constexpr int SSM_CK = 8;         // steps between saved states (ref.py CHECKPOINT)
static_assert(SSM_CH % SSM_CK == 0, "checkpoints fall on chunk steps");

// A thread's row of N floats, moved as float4 (16-byte aligned, N % 4 == 0);
// a thread past Di reads zeros.
template <int N>
__device__ __forceinline__ void load_row(float (&r)[N], const float* src, bool live) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = live ? reinterpret_cast<const float4*>(src)[q]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

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

// SAVE: write the chunk-start states (training).
template <int N, bool SAVE>
__global__ void __launch_bounds__(SSM_THREADS) ssm_scan_kernel(const SsmParams p) {
  static_assert(N % 4 == 0, "state rows move as float4");
  __shared__ __align__(16) float bc_s[2][2][SSM_CH * N];  // [buffer][B, C][t * N + n]
  const int d = blockIdx.x * SSM_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  const bool live = d < p.Di;
  const int64_t hoff = (static_cast<int64_t>(b) * p.Di + d) * N;
  const int nc = (p.S + SSM_CK - 1) / SSM_CK;

  float h[N], a[N];
  load_row<N>(h, p.h0 + hoff, live);
  load_row<N>(a, p.A + static_cast<int64_t>(d) * N, live);
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
        if (SAVE && t % SSM_CK == 0 && live)
          store_row<N>(p.h_starts + ((static_cast<int64_t>(b) * nc + (t0 + t) / SSM_CK)
                                     * p.Di + d) * N, h);
        const float dtt = cur.dt[t];
        const float dtx = dtt * cur.x[t];
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // y's partial sums over n = j mod 4
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float da = expf(dtt * a[j]);
          h[j] = fmaf(da, h[j], dtx * bs[t * N + j]);
          acc[j % 4] = fmaf(h[j], cs[t * N + j], acc[j % 4]);
        }
        if (live)
          y[static_cast<int64_t>(t) * p.Di] =
              fmaf(dd, cur.x[t], (acc[0] + acc[1]) + (acc[2] + acc[3]));
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

  if (live) store_row<N>(p.hT + hoff, h);
}

template <int N>
static cudaError_t launch(const SsmParams& p, cudaStream_t stream) {
  const dim3 grid((p.Di + SSM_THREADS - 1) / SSM_THREADS, p.B);
  if (p.h_starts != nullptr)
    ssm_scan_kernel<N, true><<<grid, SSM_THREADS, 0, stream>>>(p);
  else
    ssm_scan_kernel<N, false><<<grid, SSM_THREADS, 0, stream>>>(p);
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

// ---------------------------------------------------------------------------
// Backward (B6), per (b, d), in reverse over time with g = dL/dh_t:
//
//   g += dy_t C_t;   gh = g * h_{t-1} * exp(dt_t A)
//   ddt_t = sum_n gh A + x_t sum_n g B_t;   dx_t = dt_t sum_n g B_t + D dy_t
//   dB_t += sum_d g dt_t x_t;   dC_t += sum_d dy_t h_t
//   dA += gh dt_t;   dD += dy_t x_t;   then g <- exp(dt_t A) g
//
// and dh0 is g at t = 0. Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py:180 ssm_scan_bwd (B6, body _bwd_kernel :114)
// whose grid (B, Di / 512, n_chunks) walks 64-step chunks last first, replays
// each chunk's h from its checkpoint into a (64, 512, N) f32 VMEM history
// (2 MB) and writes dB/dC as per-channel-block partials.
//
// Design. The forward's mapping: one thread owns (b, d) and keeps its N
// values of g, its row of A and its dA sums in registers; 128 channels a
// CTA, grid (ceil(Di / 128), B). Time runs in reverse segments of CK = 8
// steps, the forward's checkpoint interval: each segment (1) stages its B
// and C rows in shared memory and its x, dt, dy values in registers,
// (2) replays h forward from the segment's checkpoint into a shared-memory
// history of the CK states h_{t-1}, laid out [step][n][thread] so a warp's
// accesses hit 32 banks, and (3) walks the history back. The history costs
// 128 * N * 4 bytes a step: 64 KB at CK = 8, N = 16 (dynamic shared memory);
// CK = 16 would take 128 KB and one CTA per SM, and the TPU's 64 steps
// 512 KB. The price of the short interval is the checkpoints: at the
// training microbatch (B=1, S=1024, Di=16384, N=16) B4 writes and B6 reads
// 134.2 MB of them where the TPU's 64-step chunk needs 16.8 MB (0.035 ms
// more at the memory rate, each way). The replay repeats B4's arithmetic
// in B4's order (expf(dt * A), fmaf(da, h, dt x * B)), so the replayed
// states equal the forward's bitwise. dB_t and dC_t are sums over channels,
// so across CTAs: each step, a warp reduces its 2N values by recursive
// halving (2N - 1 shuffles; lane l ends with one value's warp total), the 4
// warps' totals are summed in shared memory in a fixed order after the
// segment, and each CTA writes partials (B, ceil(Di / 128), S, N) that the
// wrapper sums in a fixed order, as the reference sums its per-block
// partials. dA and dD are summed over t in registers and written per
// sequence (B, Di, N) and (B, Di), summed over b by the wrapper. No float
// atomics: two runs are bitwise equal. A ragged last segment (any S >= 1)
// is masked by its length; a thread past Di computes on zeros and writes
// nothing. Nothing is written in place: dh0 is its own tensor.
//
// Bound on the H100 at the training microbatch (B=1, S=1024, Di=16384,
// N=16): bytes, reading x, dt and dy (201.3 MB), writing dx and ddt
// (134.2 MB), the checkpoints at the TPU kernel's 64-step chunk (16.8 MB),
// A, dhT, dA, dh0 (4.2 MB), B, C, dB, dC, D, dD (0.4 MB): 356.9 MB, 0.1065 ms
// at 3.35 TB/s. Operations, 25 per (d, n, t): the replay 5 (dt*A, exp,
// dt x * B and its FMA), the backward 20 (dt*A, exp and h_t again, the g
// FMA, gh, two FMAs for the sums over n, the dA FMA, the two dB/dC terms,
// the g decay and the two sums over channels); ~9 per (d, t): 6.86 GFLOP,
// 0.1024 ms at the 67 TFLOP/s f32 rate, counting exp as one. The two are
// within 4%: bytes bind. Like B4, this simple kernel runs 4 warps per SM at
// B=1 and is latency-bound well above both.

struct SsmBwdParams {
  const float* x;         // (B, S, Di) contiguous
  const float* dt;        // (B, S, Di) contiguous
  const float* A;         // (Di, N) contiguous
  const float* Bc;        // (B, S, N) contiguous
  const float* Cc;        // (B, S, N) contiguous
  const float* D;         // (Di,)
  const float* dy;        // (B, S, Di) contiguous
  const float* h_starts;  // (B, nc, Di, N) contiguous, B4's checkpoints
  const float* dhT;       // (B, Di, N) contiguous
  float* dx;              // (B, S, Di)
  float* ddt;             // (B, S, Di)
  float* dA;              // (B, Di, N) per-sequence sums
  float* dD;              // (B, Di) per-sequence sums
  float* dBp;             // (B, ceil(Di / 128), S, N) per-CTA partials
  float* dCp;             // (B, ceil(Di / 128), S, N)
  float* dh0;             // (B, Di, N)
  int32_t B, S, Di, N;
};

constexpr int SSM_WARPS = SSM_THREADS / 32;

template <int N>
__host__ __device__ constexpr size_t bwd_smem_floats() {
  return static_cast<size_t>(SSM_CK) * N * SSM_THREADS  // history [step][n][thread]
         + 2 * SSM_CK * N                                // B, C rows [step][n]
         + SSM_WARPS * SSM_CK * 2 * N;                   // warp totals [warp][step][2N]
}

template <int N>
__global__ void __launch_bounds__(SSM_THREADS) ssm_scan_bwd_kernel(const SsmBwdParams p) {
  static_assert(N % 4 == 0, "state rows move as float4");
  constexpr int V = 2 * N;                     // dB and dC terms of a step
  static_assert(V == 16 || V == 32, "a warp reduces 16 or 32 values");
  constexpr int SHIFT = V == 32 ? 0 : 1;       // lane l holds value l >> SHIFT
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;
  float* bs = hist + SSM_CK * N * SSM_THREADS;
  float* cs = bs + SSM_CK * N;
  float* red = cs + SSM_CK * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int d = blk * SSM_THREADS + tid;
  const bool live = d < p.Di;
  const int nc = (p.S + SSM_CK - 1) / SSM_CK;
  const int64_t hoff = (static_cast<int64_t>(b) * p.Di + d) * N;
  const int64_t part = (static_cast<int64_t>(b) * gridDim.x + blk) * p.S;

  float a[N], g[N], dA[N];
  load_row<N>(a, p.A + static_cast<int64_t>(d) * N, live);
  load_row<N>(g, p.dhT + hoff, live);
#pragma unroll
  for (int j = 0; j < N; ++j) dA[j] = 0.f;
  const float dd = live ? p.D[d] : 0.f;
  float dD = 0.f;

  for (int seg = nc - 1; seg >= 0; --seg) {
    const int t0 = seg * SSM_CK;
    const int n = min(SSM_CK, p.S - t0);     // uniform over the CTA
    const int64_t row = static_cast<int64_t>(b) * p.S + t0;
    float xs[SSM_CK], dts[SSM_CK], dys[SSM_CK];
#pragma unroll
    for (int i = 0; i < SSM_CK; ++i) {
      const bool ok = live && i < n;
      const int64_t off = (row + i) * p.Di + d;
      xs[i] = ok ? p.x[off] : 0.f;
      dts[i] = ok ? p.dt[off] : 0.f;
      dys[i] = ok ? p.dy[off] : 0.f;
    }
    for (int e = tid; e < SSM_CK * N; e += SSM_THREADS) {
      const bool ok = e < n * N;
      bs[e] = ok ? p.Bc[row * N + e] : 0.f;
      cs[e] = ok ? p.Cc[row * N + e] : 0.f;
    }
    __syncthreads();

    // (2) replay h_{t-1} of the segment's steps from the checkpoint
    float h[N];
    load_row<N>(h, p.h_starts + ((static_cast<int64_t>(b) * nc + seg) * p.Di + d) * N,
                live);
#pragma unroll
    for (int i = 0; i < SSM_CK; ++i) {
      if (i < n) {
#pragma unroll
        for (int j = 0; j < N; ++j) hist[(i * N + j) * SSM_THREADS + tid] = h[j];
        if (i + 1 < n) {
          const float dtt = dts[i];
          const float dtx = dtt * xs[i];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float da = expf(dtt * a[j]);
            h[j] = fmaf(da, h[j], dtx * bs[i * N + j]);
          }
        }
      }
    }

    // (3) walk the segment back
#pragma unroll
    for (int i = SSM_CK - 1; i >= 0; --i) {
      if (i < n) {
        const float dtt = dts[i], xt = xs[i], dyt = dys[i];
        const float dtx = dtt * xt;
        float v[V];
        float sgb = 0.f, sgha = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float bj = bs[i * N + j];
          const float hp = hist[(i * N + j) * SSM_THREADS + tid];
          const float da = expf(dtt * a[j]);
          const float ht = fmaf(da, hp, dtx * bj);
          const float gj = fmaf(dyt, cs[i * N + j], g[j]);
          const float gh = gj * hp * da;
          sgb = fmaf(gj, bj, sgb);
          sgha = fmaf(gh, a[j], sgha);
          dA[j] = fmaf(gh, dtt, dA[j]);
          v[j] = gj * dtx;
          v[N + j] = dyt * ht;
          g[j] = da * gj;
        }
        lane_sum<16, 1, V>(v, lane);  // lane l: value l >> SHIFT, summed
        if ((lane & ((1 << SHIFT) - 1)) == 0)
          red[(warp * SSM_CK + i) * V + (lane >> SHIFT)] = v[0];
        if (live) {
          const int64_t off = (row + i) * p.Di + d;
          p.ddt[off] = fmaf(xt, sgb, sgha);
          p.dx[off] = fmaf(dtt, sgb, dd * dyt);
        }
        dD = fmaf(dyt, xt, dD);
      }
    }
    __syncthreads();

    // the warps' totals, summed in a fixed order: one (step, value) a thread
    for (int e = tid; e < n * V; e += SSM_THREADS) {
      const int i = e / V, k = e % V;
      float s = red[i * V + k];
#pragma unroll
      for (int w = 1; w < SSM_WARPS; ++w) s += red[(w * SSM_CK + i) * V + k];
      float* dst = k < N ? p.dBp : p.dCp;
      dst[(part + t0 + i) * N + k % N] = s;
    }
    // the next segment stages B/C, last read before the barrier above, and
    // writes red only after its own barrier, once every thread is done here
  }

  if (live) {
    store_row<N>(p.dh0 + hoff, g);
    store_row<N>(p.dA + hoff, dA);
    p.dD[static_cast<int64_t>(b) * p.Di + d] = dD;
  }
}

template <int N>
static cudaError_t launch_bwd(const SsmBwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<N>() * sizeof(float);
  auto kernel = ssm_scan_bwd_kernel<N>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Di + SSM_THREADS - 1) / SSM_THREADS, p.B);
  kernel<<<grid, SSM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int ssm_scan_bwd(const SsmBwdParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->S < 1 || p->B < 1 || p->Di < 1) return cudaErrorInvalidValue;
  switch (p->N) {
    case 8: return launch_bwd<8>(*p, s);
    case 16: return launch_bwd<16>(*p, s);
    default: return cudaErrorInvalidValue;
  }
}
