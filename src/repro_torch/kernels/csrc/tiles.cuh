// Device helpers of the tile kernels, shared by fused/csrc/fused_dwn.cu
// (K1, K2, the float fused K6), lut_eval/csrc/lut_eval.cu (the LUT
// layers, K4 and K8), thermometer/csrc/thermometer.cu (the packed
// encode, K3) and popcount/csrc/popcount.cu (the packed classify, K5):
// asynchronous staging into shared memory, the reads of a LUT's
// one-bit-per-entry table, L2 evict-last loads and the 16-byte rounding
// of the shared-memory
// layouts (align16, mirrored by kernels/_launch.py).  The build hashes
// this directory into every library that includes it (kernels/_build.py),
// so an edit rebuilds all four.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// v rounded up to a multiple of 16: where each part of a shared-memory
// layout starts.
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy from global to shared memory: 16 bytes (both
// addresses 16-byte aligned) or 4 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Asynchronous copy of `bytes` (a multiple of 4) from global to shared
// memory by the whole block: 16 bytes a thread where both sides allow it.
__device__ void stage(void* dst, const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) &
       15) == 0) {
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(d + 16 * i, s + 16 * i);
    d += 16 * n16;
    s += 16 * n16;
    bytes -= 16 * n16;
  }
  for (int i = threadIdx.x; i < (bytes >> 2); i += blockDim.x)
    cp_async4(d + 4 * i, s + 4 * i);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One read of the model: from shared memory when the launch staged it
// there, else from global memory through the read-only cache.  Either way
// every lane of a warp reads the same address (a broadcast), except a
// table word of a LUT wider than 5 inputs, which depends on the sample.
template <bool kStaged, typename V>
__device__ __forceinline__ V model_ld(const V* p) {
  if constexpr (kStaged)
    return *p;
  else
    return __ldg(p);
}

// Loads of a model that stays in L2 while rows and outputs stream past
// it (K6's and K8's tables, K8's wires): an evict-last policy.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float ld_evict_last(const float* p,
                                               uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_evict_last(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;\n"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

// Entry `addr` of one LUT's table (tw words at t), any fan-in.
template <bool kStaged>
__device__ __forceinline__ uint32_t table_bit(const uint32_t* t, int n,
                                              uint32_t addr) {
  if (n <= 5) return (model_ld<kStaged>(t) >> addr) & 1u;
  return (model_ld<kStaged>(t + (addr >> 5)) >> (addr & 31u)) & 1u;
}

// Entry `addr` (< 64) of a fan-in-6 table held as two words.
__device__ __forceinline__ uint32_t table6(uint32_t lo, uint32_t hi,
                                           uint32_t addr) {
  return ((addr & 32u) ? hi : lo) >> (addr & 31u) & 1u;
}

}  // namespace
