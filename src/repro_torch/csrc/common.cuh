// Shared helpers of the port's hand-written Hopper kernels.
//
// Each kernel library is built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: a plain C entry per kernel takes a pointer to a
// parameter struct (mirrored field for field by a ctypes.Structure) and the
// CUDA stream, launches, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Same finite mask value as the reference (repro.models.common.NEG_INF): a
// row whose every position is masked stays finite instead of turning NaN.
#define REPRO_NEG_INF (-2.3819763e38f)

enum ReproDtype : int32_t { kF32 = 0, kBF16 = 1, kI8 = 2 };

// 16-byte vector load of VEC consecutive elements of T, widened to f32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[4 * i + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xff));
      }
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a probability to the dtype of V before the PV product, as the
// reference does (``p.astype(v.dtype)``): bf16 rounds, f32 and int8 pools
// (dequantised to f32) keep it.
template <typename TV> __device__ __forceinline__ float round_like(float x) { return x; }
template <> __device__ __forceinline__ float round_like<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

#define REPRO_LOG2E 1.4426950408889634f

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0): the
// bf16 attention paths' softmax, as exp2((s - m) * log2 e)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum per-lane values over the lanes that differ in lane bits O, O / 2, ...,
// LO (powers of two). While more than one value is live, each round hands
// half of them to the partner lane and keeps the other half, so L values
// cost L - 1 shuffles over log2(L) bits, not L log2(L); after that, plain
// butterflies. Values v[0 .. LIVE) are live on entry; on return a lane holds
// the sums of v[m'], m' = the index its halving bits select. Each sum's
// order is fixed by the lane bits alone.
template <int O, int LO, int LIVE, int V, typename F>
__device__ __forceinline__ void lane_sum(F (&v)[V], int lane) {
  if constexpr (O >= LO) {
    if constexpr (LIVE > 1) {
      constexpr int HALF = LIVE / 2;
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int m = 0; m < HALF; ++m) {
        const F send = hi ? v[m] : v[m + HALF];
        const F keep = hi ? v[m + HALF] : v[m];
        v[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      lane_sum<O / 2, LO, HALF, V, F>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      lane_sum<O / 2, LO, 1, V, F>(v, lane);
    }
  }
}

// Each library exports the CUDA error text so the wrapper can report it.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Raise the dynamic shared-memory cap of a kernel when it needs more than the
// default 48 KB; returns the CUDA error so the entry can report it.
template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// cp.async (decode attention, the Mamba scans): global -> shared copies
// that bypass registers; `pred` false writes zeros and reads nothing. A
// thread's copies complete in commit groups: cp_async_wait<K> returns when
// at most K of its groups are still in flight.

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and TMA (flash attention, the RWKV-6 scans)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of parity ``parity``. A
// wait that outlasts ~2^35 cycles (many seconds) is a fault of the kernel:
// trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if ((n & 1023) == 1023) {
      const long long now = clock64();
      if (start == 0) {
        start = now;
      } else if (now - start > (1ll << 35)) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to a following TMA store.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}
// Wait until this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A 4-d tensor map over a strided view: dims innermost first, `strides` in
// bytes for dims 1 .. 3, boxes `box`, zero fill past the ends, no swizzle
// unless asked. A dim of size 1 is never stepped over, so its stride is
// replaced by the extent of the dims inside it (TMA wants strides of whole
// 16 bytes). The wrappers have checked TMA's rules for the rest: a 16-byte
// aligned base and strides of whole 16 bytes.
static cudaError_t tensor_map_4d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                                 const void* ptr, const int64_t (&dims)[4],
                                 const int64_t (&strides)[3], const int (&box)[4],
                                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[4], s[3];
  cuuint32_t bx[4], unit[4];
  int64_t span = static_cast<int64_t>(elem_bytes) * dims[0];
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i > 0) {
      s[i - 1] = static_cast<cuuint64_t>(dims[i] == 1 ? span : strides[i - 1]);
      span = static_cast<int64_t>(s[i - 1]) * dims[i];
    }
  }
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), d, s, bx, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
