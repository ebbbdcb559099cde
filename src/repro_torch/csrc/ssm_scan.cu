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
// Lane mapping (both kernels). Channels are independent and B_t, C_t are
// shared by every channel of a row. SSM_LANES = 4 consecutive lanes own one
// (b, d): lane q holds the states n = 4k + q (k < N / 4; 4 states at N = 16,
// 2 at N = 8) and their A[d, n] in registers. A sum over n is the lane's
// running sum over its own states in order of k, then a sum over the four
// lanes: lanes q ^ 1 first, then q ^ 2, (s0 + s1) + (s2 + s3), the same bits
// whichever lane holds it, since float addition commutes. That is four
// partial sums by n mod 4 added pairwise: a shorter dependency chain than
// one running sum and about half its rounding error, which an 8-layer
// stack amplifies into its f32 gradients.
//
// B4 design. A CTA takes SSM_FWD_CHANNELS = 32 consecutive channels of one
// sequence, 128 threads (grid (ceil(Di / 32), B): 512 CTAs, 16 warps an SM
// at a B=1, Di=16384 prefill; one thread per channel would give 128 CTAs
// of 4 warps, too few to hide each step's exponential chain). Time runs in
// chunks of CH = 16 steps through a ring of 3 stages in shared memory,
// filled by cp.async two chunks ahead of use: a chunk's x and dt for the
// CTA's channels ([t][channel], one coalesced 128-byte row a step, read by
// a channel's four lanes) and its B and C rows, laid out [t][q][k] =
// B_t[4k + q] so that a lane reads its states' values as one float4. One
// CTA barrier per chunk hands the ring over. The step loop stores nothing
// and shuffles nothing: a lane keeps its partial of y for each of the
// chunk's steps, and one reduce-scatter over the four lanes per chunk (12
// shuffles for 16 sums, in the order above) leaves each lane the y of four
// steps to write. h0 and A arrive, and hT leaves, through shared memory in
// 16-byte pieces, whole channel rows at a time. A launch of at most 4 steps
// (a decode step) runs an instance with 4-step chunks, whose CTAs copy and
// hold a quarter of the ring. The exponential is the accurate expf, so a
// run is bitwise repeatable and does not depend on the launch shape. A
// ragged last chunk (any S >= 1) is masked by its length; a channel past
// Di computes on zeros and writes nothing.
//
// All tensors are f32 and contiguous: x, dt, y (B, S, Di); Bc, Cc (B, S, N);
// A (Di, N); D (Di,); h0, hT (B, Di, N), their rows 16-byte aligned (the
// wrapper checks). hT may alias h0 (decode updates the slot cache in
// place): a CTA reads all of its channels' states before it writes any,
// and no other CTA touches them.
//
// Bound on the H100: at a prefill (B=1, S=4500, Di=16384, N=16) the function
// reads x and dt and writes y (3 x 294.9 MB) and reads B, C, A, D, h0 and
// writes hT (~4 MB): 888.5 MB at 3.35 TB/s, 0.265 ms. Its operations, 7 per
// (d, n, t) (dt*A, exp, da*h, dtx*B and their sum, h*C and its sum)
// and 3 per (d, t) (dt*x, D*x and its add), are 8.48 GFLOP, 0.127 ms at the
// 67 TFLOP/s f32 rate, counting exp as one: bytes bind. What the card can
// issue sets a higher floor. The accurate expf is one MUFU.EX2 (16 a clock
// per SM: 1.18e9 of them, 0.28 ms at 132 SMs and 1.98 GHz) among 7 more
// instructions of range reduction and scaling, so a lane's step is about
// 55 warp instructions (per state dt*A, the expf, dtx*B, the h FMA and the
// y FMA; then its 4 shared-memory loads and a share of the chunk's sums and
// copies): 0.48 ms of issue at four schedulers an SM and 1.98 GHz, which no
// change of layout can lower while expf keeps its bits. A decode step (B=4,
// S=1) moves the 8.4 MB of state in and out and reads A: bytes, ~3 us.
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

constexpr int SSM_LANES = 4;          // lanes per channel (kernel.py LANES_PER_CHANNEL)
constexpr int SSM_FWD_CHANNELS = 32;  // channels per forward CTA
constexpr int SSM_FWD_THREADS = SSM_LANES * SSM_FWD_CHANNELS;
constexpr int SSM_CH = 16;            // time steps per chunk of the forward's ring
constexpr int SSM_STEP_CH = 4;        // ... in a launch of at most that many steps (decode)
constexpr int SSM_RING = 3;           // chunks in the ring: loads run two chunks ahead
constexpr int SSM_CK = 8;             // steps between saved states (ref.py CHECKPOINT)
static_assert(SSM_CH % SSM_CK == 0, "checkpoints fall on chunk steps");

// A lane's NL = N / 4 values of one row laid out [q][k], read as one vector.
template <int NL>
__device__ __forceinline__ void lds_lane(float (&v)[NL], const float* p) {
  static_assert(NL == 2 || NL == 4, "N is 8 or 16");
  if constexpr (NL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

// Sum L values over a channel's four lanes and scatter the sums: lanes
// q ^ 1 first, then q ^ 2, each round handing half of the values to the
// partner (3 L / 4 shuffles for L sums). Every sum is (s0 + s1) + (s2 + s3)
// in the lanes' order, the same bits whichever lane holds it, since float
// addition commutes. On return lane q holds, in v[0 .. L / 4), the sums of
// values first(q) .. first(q) + L / 4 - 1, first(q) = L / 2 (q & 1) +
// L / 4 (q >> 1).
template <int L>
__device__ __forceinline__ void lane_scatter_sum(float (&v)[L], int q) {
  const bool hi1 = (q & 1) != 0;
#pragma unroll
  for (int m = 0; m < L / 2; ++m) {
    const float send = hi1 ? v[m] : v[m + L / 2];
    const float keep = hi1 ? v[m + L / 2] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
  const bool hi2 = (q & 2) != 0;
#pragma unroll
  for (int m = 0; m < L / 4; ++m) {
    const float send = hi2 ? v[m] : v[m + L / 4];
    const float keep = hi2 ? v[m + L / 4] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
}
template <int L>
__device__ __forceinline__ int scatter_first(int q) {
  return L / 2 * (q & 1) + L / 4 * (q >> 1);
}

// Copy rows 0 .. rows - 1 (of at most T) from `row` on of B and C (B, S, N)
// into [t][q][k] layout (B_t[4k + q] at t * N + q * N / 4 + k). Rows past
// `rows` are not written: the steps that would read them are masked.
template <int N, int T, int THREADS>
__device__ __forceinline__ void copy_bc(float* bs, float* cs, const float* Bc,
                                        const float* Cc, int64_t row, int rows) {
  static_assert(THREADS % N == 0, "a thread copies one state's column");
  constexpr int STEP = THREADS / N;  // rows apart of a thread's copies
  const int n = threadIdx.x % N, i0 = threadIdx.x / N;
  const int slot = i0 * N + (n % SSM_LANES) * (N / SSM_LANES) + n / SSM_LANES;
  const int64_t off = (row + i0) * N + n;
#pragma unroll
  for (int j = 0; j < (T + STEP - 1) / STEP; ++j) {
    if (i0 + j * STEP < rows) {
      cp_async4(bs + slot + j * STEP * N, Bc + off + j * STEP * N, true);
      cp_async4(cs + slot + j * STEP * N, Cc + off + j * STEP * N, true);
    }
  }
}

// Copy rows 0 .. rows - 1 (of at most T) from `row` on, channels d0 ..
// d0 + C - 1, of K inputs (B, S, Di) into [t][channel] arrays, zeros past
// Di; a thread copies one channel's rows i0, i0 + STEP, ... of each input,
// at one offset.
template <int T, int C, int THREADS, int K>
__device__ __forceinline__ void copy_rows(float* const (&dst)[K], const float* const (&src)[K],
                                          int64_t row, int rows, int d0, int Di) {
  static_assert(THREADS % C == 0, "a thread copies one channel's column");
  constexpr int STEP = THREADS / C;  // rows apart of a thread's copies
  const int c = threadIdx.x % C, i0 = threadIdx.x / C;
  const bool ok = d0 + c < Di;
  const int64_t off = ok ? (row + i0) * Di + d0 + c : 0;
  const int64_t next = ok ? static_cast<int64_t>(STEP) * Di : 0;
#pragma unroll
  for (int j = 0; j < (T + STEP - 1) / STEP; ++j) {
    if (i0 + j * STEP < rows) {
#pragma unroll
      for (int a = 0; a < K; ++a)
        cp_async4(dst[a] + (i0 + j * STEP) * C + c, src[a] + off + j * next, ok);
    }
  }
}

// The CTA's C channel rows of N floats of a (.., Di, N) state in shared
// memory, SLAB_ROW<N> floats apart (a padded row: a warp's lanes (c, q)
// reading state 4k + q hit 32 banks), copied in and out 16 bytes a thread.
template <int N>
constexpr int SLAB_ROW = N + 4;
template <int N, int C, int THREADS>
__device__ __forceinline__ void slab_in(float* slab, const float* src, int d0, int Di) {
  constexpr int Q = N / 4;
  for (int e = threadIdx.x; e < C * Q; e += THREADS) {
    const int c = e / Q, j = e % Q;
    const bool ok = d0 + c < Di;
    cp_async16(slab + c * SLAB_ROW<N> + 4 * j, src + (ok ? (d0 + c) * N + 4 * j : 0), ok);
  }
}
template <int N, int C, int THREADS>
__device__ __forceinline__ void slab_out(float* dst, const float* slab, int d0, int Di) {
  constexpr int Q = N / 4;
  for (int e = threadIdx.x; e < C * Q; e += THREADS) {
    const int c = e / Q, j = e % Q;
    if (d0 + c < Di)
      *reinterpret_cast<float4*>(dst + (d0 + c) * N + 4 * j) =
          *reinterpret_cast<const float4*>(slab + c * SLAB_ROW<N> + 4 * j);
  }
}

// One chunk of CH steps of the forward's ring.
template <int N, int CH>
struct FwdStage {
  float x[CH][SSM_FWD_CHANNELS];
  float dt[CH][SSM_FWD_CHANNELS];
  float b[CH][N];  // [t][q][k]
  float c[CH][N];
};

// SAVE: write the chunk-start states (training). CH: steps per chunk,
// SSM_CH, or SSM_STEP_CH in a launch of that many steps or fewer (a decode
// step), whose CTAs copy and hold less (9.7 KB of shared memory, at most 64
// registers a thread, 8 CTAs an SM), since a decode step's 2048 CTAs (B=4,
// Di=16384) each run one step.
template <int N, bool SAVE, int CH>
__global__ void __launch_bounds__(SSM_FWD_THREADS, CH == SSM_CH ? 1 : 8)
ssm_scan_kernel(const SsmParams p) {
  static_assert(!SAVE || CH % SSM_CK == 0, "checkpoints fall on chunk steps");
  constexpr int NL = N / SSM_LANES;
  constexpr int C = SSM_FWD_CHANNELS;
  __shared__ __align__(16) FwdStage<N, CH> ring[SSM_RING];
  __shared__ __align__(16) float hs[C * SLAB_ROW<N>];  // h0 in, hT out
  __shared__ __align__(16) float as[C * SLAB_ROW<N>];  // A
  const int tid = threadIdx.x;
  const int q = tid % SSM_LANES;
  const int c = tid / SSM_LANES;
  const int d0 = blockIdx.x * C;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.Di;
  const int nc = (p.S + SSM_CK - 1) / SSM_CK;
  const int nch = (p.S + CH - 1) / CH;
  const int64_t state = static_cast<int64_t>(b) * p.Di * N;  // this sequence's (Di, N)

  auto load = [&](int ch) {
    FwdStage<N, CH>& st = ring[ch % SSM_RING];
    const int t0 = ch * CH;
    const int64_t row = static_cast<int64_t>(b) * p.S + t0;
    const int rows = min(CH, p.S - t0);
    float* const dst[2] = {&st.x[0][0], &st.dt[0][0]};
    const float* const src[2] = {p.x, p.dt};
    copy_rows<CH, C, SSM_FWD_THREADS>(dst, src, row, rows, d0, p.Di);
    copy_bc<N, CH, SSM_FWD_THREADS>(&st.b[0][0], &st.c[0][0], p.Bc, p.Cc, row, rows);
  };
  slab_in<N, C, SSM_FWD_THREADS>(hs, p.h0 + state, d0, p.Di);
  slab_in<N, C, SSM_FWD_THREADS>(as, p.A, d0, p.Di);
  load(0);
  cp_async_commit();
  if (nch > 1) load(1);
  cp_async_commit();
  const float dd = live ? p.D[d] : 0.f;

  float h[NL], a[NL];
  for (int ch = 0; ch < nch; ++ch) {
    // chunk ch has landed for every thread, and every thread is done with
    // chunk ch - 1, whose stage the load below refills
    cp_async_wait<1>();
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        h[k] = hs[c * SLAB_ROW<N> + SSM_LANES * k + q];
        a[k] = as[c * SLAB_ROW<N> + SSM_LANES * k + q];
      }
    }
    if (ch + 2 < nch) load(ch + 2);
    cp_async_commit();
    const FwdStage<N, CH>& st = ring[ch % SSM_RING];
    const int t0 = ch * CH;
    const int n = min(CH, p.S - t0);  // uniform over the CTA
    float yp[CH];  // y's partial over the lane's states at each step, in order of n
    auto step = [&](int t) {
      if (SAVE && t % SSM_CK == 0 && live) {
        float* hsave = p.h_starts + ((static_cast<int64_t>(b) * nc + (t0 + t) / SSM_CK)
                                     * p.Di + d) * N + q;
#pragma unroll
        for (int k = 0; k < NL; ++k) hsave[SSM_LANES * k] = h[k];
      }
      const float dtt = st.dt[t][c];
      const float dtx = dtt * st.x[t][c];
      float bb[NL], cc[NL];
      lds_lane<NL>(bb, &st.b[t][q * NL]);
      lds_lane<NL>(cc, &st.c[t][q * NL]);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const float da = expf(dtt * a[k]);
        h[k] = fmaf(da, h[k], dtx * bb[k]);
        acc = fmaf(h[k], cc[k], acc);
      }
      yp[t] = acc;
    };
    if (n == CH) {
#pragma unroll
      for (int t = 0; t < CH; ++t) step(t);
    } else {
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        if (t < n) step(t);
        else yp[t] = 0.f;
      }
    }
    // y of the chunk's steps: lane q writes steps first .. first + 3
    lane_scatter_sum<CH>(yp, q);
    const int first = scatter_first<CH>(q);
    float* y = p.y + (static_cast<int64_t>(b) * p.S + t0) * p.Di + d;
#pragma unroll
    for (int m = 0; m < CH / SSM_LANES; ++m) {
      const int t = first + m;
      if (live && t < n) y[static_cast<int64_t>(t) * p.Di] = fmaf(dd, st.x[t][c], yp[m]);
    }
  }

  // hT out through the slab: each lane overwrites only what it read
#pragma unroll
  for (int k = 0; k < NL; ++k) hs[c * SLAB_ROW<N> + SSM_LANES * k + q] = h[k];
  __syncthreads();
  slab_out<N, C, SSM_FWD_THREADS>(p.hT + state, hs, d0, p.Di);
}

template <int N>
static cudaError_t launch(const SsmParams& p, cudaStream_t stream) {
  const dim3 grid((p.Di + SSM_FWD_CHANNELS - 1) / SSM_FWD_CHANNELS, p.B);
  if (p.h_starts != nullptr)
    ssm_scan_kernel<N, true, SSM_CH><<<grid, SSM_FWD_THREADS, 0, stream>>>(p);
  else if (p.S <= SSM_STEP_CH)
    ssm_scan_kernel<N, false, SSM_STEP_CH><<<grid, SSM_FWD_THREADS, 0, stream>>>(p);
  else
    ssm_scan_kernel<N, false, SSM_CH><<<grid, SSM_FWD_THREADS, 0, stream>>>(p);
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
// Design. The forward's lane mapping: lane q of a channel keeps g, A and
// the dA sums of its states n = 4k + q in registers. A CTA takes
// SSM_BWD_CHANNELS = 128 channels, 512 threads, grid (ceil(Di / 128), B):
// one CTA of 16 warps an SM at B=1. Time runs in reverse segments of CK = 8
// steps, the forward's checkpoint interval. A segment's x, dt, dy
// ([t][channel]) and B, C rows ([t][q][k], as in the forward) arrive by
// cp.async in one of two shared-memory buffers while the segment after it
// in time is still being walked, and its checkpoint into registers. Each
// segment (1) replays h forward from its checkpoint into a register history
// of the CK states h_{t-1} (8 x 4 floats a lane at N = 16), repeating B4's
// arithmetic in B4's order, so the replayed states equal the forward's
// bitwise, and keeps the decays exp(dt_t A) in shared memory, one float4 a
// lane and step (64 KB; kept in registers beside the history they spilled
// at the 128 registers a thread that 16 warps an SM allow); (2) walks the
// history back without a second exponential. A full segment runs an
// unrolled path with no step guards. The sums over n (g B and gh A, for dx
// and ddt) are a lane's partials kept for the segment's 8 steps and summed
// over the four lanes once per segment, as B4's y. dB_t and dC_t are sums
// over channels, so across CTAs: each step, the lanes of a warp with the
// same q reduce their 2 N / 4 values by recursive halving over lane bits 4,
// 3, 2 (7 shuffles at N = 16; lane l ends with one value's total over the
// warp's 8 channels), the 16 warps' totals go to shared memory (double
// buffered by segment) and are summed there in a fixed order at the start
// of the next segment, and each CTA writes partials (B, ceil(Di / 128), S,
// N) that the wrapper sums in a fixed order, as the reference sums its
// per-block partials. 128 channels a CTA keep those partials at 16.8 MB at
// the training microbatch (32 would write 67 MB). dA and dD are summed over
// t in registers and written per sequence (B, Di, N) and (B, Di), summed
// over b by the wrapper. No float atomics: two runs are bitwise equal. A
// ragged last segment (any S >= 1) is masked by its length; a channel past
// Di computes on zeros and writes nothing. Nothing is written in place: dh0
// is its own tensor.
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
// within 4%: bytes bind. What the card can issue sets a higher floor: the
// replay's ~12 instructions per state (one expf), the walk's ~11 per state
// and the halving's 28, the loads and a share of the segment's copies and
// sums, about 190 warp instructions a lane and step: 0.38 ms of issue at
// 1.98 GHz, three times the bytes' bound.

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

constexpr int SSM_BWD_CHANNELS = 128;  // channels per backward CTA (kernel.py CHANNELS_PER_CTA)
constexpr int SSM_BWD_THREADS = SSM_LANES * SSM_BWD_CHANNELS;
constexpr int SSM_BWD_WARPS = SSM_BWD_THREADS / 32;

// One segment's inputs. The backward's shared memory holds two of them,
// then the warps' dB/dC totals of two segments, [segment % 2][warp][step][2N],
// then the replay's decays, [step][thread][k].
template <int N>
struct BwdStage {
  float x[SSM_CK][SSM_BWD_CHANNELS];
  float dt[SSM_CK][SSM_BWD_CHANNELS];
  float dy[SSM_CK][SSM_BWD_CHANNELS];
  float b[SSM_CK][N];  // [t][q][k]
  float c[SSM_CK][N];
};

template <int N>
__host__ __device__ constexpr size_t bwd_red_floats() {
  return static_cast<size_t>(2) * SSM_BWD_WARPS * SSM_CK * 2 * N;
}
template <int N>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return 2 * sizeof(BwdStage<N>) + sizeof(float) * (bwd_red_floats<N>()
                                                    + SSM_CK * SSM_BWD_THREADS * N / SSM_LANES);
}

template <int NL>
__device__ __forceinline__ void sts_lane(float* p, const float (&v)[NL]) {
  if constexpr (NL == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int N>
__global__ void __launch_bounds__(SSM_BWD_THREADS, 1) ssm_scan_bwd_kernel(const SsmBwdParams p) {
  constexpr int NL = N / SSM_LANES;
  constexpr int V = 2 * NL;  // a lane's dB and dC terms of a step
  constexpr int RED = SSM_BWD_WARPS * SSM_CK * 2 * N;  // floats of one segment's totals
  // after halving over lane bits 4, 3, 2, lane l holds term (l >> 2) >> DUP
  // of its q; at N = 8 lanes l and l ^ 4 hold the same one
  constexpr int DUP = V == 8 ? 0 : 1;
  constexpr int C = SSM_BWD_CHANNELS;
  static_assert(V == 4 || V == 8, "N is 8 or 16");
  extern __shared__ __align__(16) unsigned char ssm_smem[];
  BwdStage<N>* in = reinterpret_cast<BwdStage<N>*>(ssm_smem);
  float* red = reinterpret_cast<float*>(ssm_smem + 2 * sizeof(BwdStage<N>));
  float* decay = red + bwd_red_floats<N>();

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q = tid % SSM_LANES;
  const int c = tid / SSM_LANES;
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int d0 = blk * SSM_BWD_CHANNELS;
  const int d = d0 + c;
  const bool live = d < p.Di;
  const int nc = (p.S + SSM_CK - 1) / SSM_CK;
  const int64_t hoff = (static_cast<int64_t>(b) * p.Di + d) * N + q;  // + 4k: state 4k + q
  const int64_t part = (static_cast<int64_t>(b) * gridDim.x + blk) * p.S;

  auto load = [&](int seg) {
    BwdStage<N>& st = in[seg & 1];
    const int t0 = seg * SSM_CK;
    const int64_t row = static_cast<int64_t>(b) * p.S + t0;
    const int rows = min(SSM_CK, p.S - t0);
    float* const dst[3] = {&st.x[0][0], &st.dt[0][0], &st.dy[0][0]};
    const float* const src[3] = {p.x, p.dt, p.dy};
    copy_rows<SSM_CK, C, SSM_BWD_THREADS>(dst, src, row, rows, d0, p.Di);
    copy_bc<N, SSM_CK, SSM_BWD_THREADS>(&st.b[0][0], &st.c[0][0], p.Bc, p.Cc, row, rows);
  };
  // the checkpoint of segment seg, the state before its first step
  auto checkpoint = [&](float (&h)[NL], int seg) {
    const float* hs = p.h_starts + ((static_cast<int64_t>(b) * nc + seg) * p.Di + d) * N + q;
#pragma unroll
    for (int k = 0; k < NL; ++k) h[k] = live ? hs[SSM_LANES * k] : 0.f;
  };
  // segment seg's dB/dC: the 16 warps' totals summed in a fixed order
  auto flush = [&](int seg) {
    const int t0 = seg * SSM_CK;
    const int rows = min(SSM_CK, p.S - t0);
    const float* r = red + (seg & 1) * RED;
    for (int e = tid; e < rows * 2 * N; e += SSM_BWD_THREADS) {
      float s = r[e];
#pragma unroll
      for (int w = 1; w < SSM_BWD_WARPS; ++w) s += r[w * SSM_CK * 2 * N + e];
      const int i = e / (2 * N), k = e % (2 * N);
      float* dst = k < N ? p.dBp : p.dCp;
      dst[(part + t0 + i) * N + k % N] = s;
    }
  };

  load(nc - 1);
  cp_async_commit();
  float a[NL], g[NL], dA[NL], hc[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    a[k] = live ? p.A[static_cast<int64_t>(d) * N + SSM_LANES * k + q] : 0.f;
    g[k] = live ? p.dhT[hoff + SSM_LANES * k] : 0.f;
    dA[k] = 0.f;
  }
  checkpoint(hc, nc - 1);
  const float dd = live ? p.D[d] : 0.f;
  float dD = 0.f;

  for (int seg = nc - 1; seg >= 0; --seg) {
    // segment seg has landed for every thread; every thread is done with
    // segment seg + 1, whose buffer the load below refills, and has written
    // its dB/dC totals
    cp_async_wait<0>();
    __syncthreads();
    if (seg > 0) load(seg - 1);
    cp_async_commit();
    if (seg + 1 < nc) flush(seg + 1);
    float hn[NL];  // the next segment's checkpoint, in flight during this one
    checkpoint(hn, max(seg - 1, 0));

    const BwdStage<N>& st = in[seg & 1];
    const int t0 = seg * SSM_CK;
    const int n = min(SSM_CK, p.S - t0);  // uniform over the CTA
    float* rw = red + (seg & 1) * RED + warp * SSM_CK * 2 * N;
    float* da_t = decay + tid * NL;  // + i * SSM_BWD_THREADS * NL: step i's decays

    // (1) replay h_{t-1}, and keep exp(dt_t A), of the segment's steps;
    // (2) walk the segment back. The sums over n of g B and gh A of each
    // step are the lane's partials here, summed over the lanes after it.
    float hist[SSM_CK][NL];
    float sn[2 * SSM_CK];  // [2 i] sum of g B, [2 i + 1] sum of gh A, step i
    auto replay = [&](int i) {
      const float dtt = st.dt[i][c];
      const float dtx = dtt * st.x[i][c];
      float bb[NL], da[NL];
      lds_lane<NL>(bb, &st.b[i][q * NL]);
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        hist[i][k] = hc[k];
        da[k] = expf(dtt * a[k]);
        hc[k] = fmaf(da[k], hc[k], dtx * bb[k]);
      }
      sts_lane<NL>(da_t + i * SSM_BWD_THREADS * NL, da);
    };
    auto walk = [&](int i) {
      const float dtt = st.dt[i][c], dyt = st.dy[i][c];
      const float dtx = dtt * st.x[i][c];
      float bb[NL], cc[NL], da[NL], v[V];
      lds_lane<NL>(bb, &st.b[i][q * NL]);
      lds_lane<NL>(cc, &st.c[i][q * NL]);
      lds_lane<NL>(da, da_t + i * SSM_BWD_THREADS * NL);
      sn[2 * i] = sn[2 * i + 1] = 0.f;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const float hp = hist[i][k];
        const float ht = fmaf(da[k], hp, dtx * bb[k]);
        const float gj = fmaf(dyt, cc[k], g[k]);
        const float gh = gj * hp * da[k];
        sn[2 * i] = fmaf(gj, bb[k], sn[2 * i]);
        sn[2 * i + 1] = fmaf(gh, a[k], sn[2 * i + 1]);
        dA[k] = fmaf(gh, dtt, dA[k]);
        v[k] = gj * dtx;
        v[NL + k] = dyt * ht;
        g[k] = da[k] * gj;
      }
      lane_sum<16, 4, V>(v, lane);  // lane l: term (l >> 2) >> DUP of its q, summed
      const int m = (lane >> 2) >> DUP;
      if (((lane >> 2) & DUP) == 0)  // state 4 (m % NL) + q, B's term below NL, C's above
        rw[i * 2 * N + (m < NL ? 0 : N) + SSM_LANES * (m % NL) + q] = v[0];
      dD = fmaf(dyt, st.x[i][c], dD);
    };
    if (n == SSM_CK) {
#pragma unroll
      for (int i = 0; i < SSM_CK; ++i) replay(i);
#pragma unroll
      for (int i = SSM_CK - 1; i >= 0; --i) walk(i);
    } else {
#pragma unroll
      for (int i = 0; i < SSM_CK; ++i)
        if (i < n) replay(i);
#pragma unroll
      for (int i = SSM_CK - 1; i >= 0; --i) {
        if (i < n) walk(i);
        else sn[2 * i] = sn[2 * i + 1] = 0.f;
      }
    }
    // dx and ddt: lane q writes steps first and first + 1
    lane_scatter_sum<2 * SSM_CK>(sn, q);
    const int first = scatter_first<2 * SSM_CK>(q) / 2;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = first + j;
      if (live && i < n) {
        const int64_t off = (static_cast<int64_t>(b) * p.S + t0 + i) * p.Di + d;
        const float sgb = sn[2 * j], sgha = sn[2 * j + 1];
        p.ddt[off] = fmaf(st.x[i][c], sgb, sgha);
        p.dx[off] = fmaf(st.dt[i][c], sgb, dd * st.dy[i][c]);
      }
    }
#pragma unroll
    for (int k = 0; k < NL; ++k) hc[k] = hn[k];
  }
  __syncthreads();
  flush(0);

  if (live) {
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      p.dh0[hoff + SSM_LANES * k] = g[k];
      p.dA[hoff + SSM_LANES * k] = dA[k];
    }
    if (q == 0) p.dD[static_cast<int64_t>(b) * p.Di + d] = dD;
  }
}

template <int N>
static cudaError_t launch_bwd(const SsmBwdParams& p, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<N>();
  auto kernel = ssm_scan_bwd_kernel<N>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Di + SSM_BWD_CHANNELS - 1) / SSM_BWD_CHANNELS, p.B);
  kernel<<<grid, SSM_BWD_THREADS, smem, stream>>>(p);
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
