// Packed LUT-layer evaluation for Hopper (sm_90a): packed bits -> one
// layer of LUTs -> packed output bits.
//
// Replaces the Pallas TPU kernel
//   lut_eval_packed <- src/repro/kernels/lut_eval/kernel.py
//                      (_lut_eval_packed_kernel)
//
// Wire k of LUT l reads bit bit_off[l, k] of input word word_idx[l, k] and
// is bit k of the LUT's address (weight 2^k); the LUT's output is entry
// `addr` of its truth table, packed LSB-first into output word l >> 5.
// m is a multiple of 32 (the op pads with all-zero tables, whose output
// bits are 0, so the pad bits of the last real word stay 0).
//
// What bounds it on an H100.  Per sample it reads W_in words and writes
// m/32, and does m*n single-bit selects and m table reads; at lg width
// (W_in=100, m=2400, n=6) and B=4096 that is 3.0 MB against 69 M
// operations, so it is bound by operations: the random bit gathers and
// the table reads.  The design keeps both on chip:
//   * one warp owns one sample; its input row sits in the warp's own slice
//     of shared memory, so every gather is a shared-memory read;
//   * truth tables are stored one bit per entry (lg-2400: 18.75 KiB
//     instead of 600 KiB as int32) and read through the read-only path, so
//     they and the wire indices stay resident in L1/L2;
//   * lane i evaluates LUT 32*w + i and __ballot_sync packs output word w
//     in the repo's LSB-first order; lane j keeps word w0 + j of each run
//     of 32, so the warp stores 32 words as one 128-byte transaction.
//
// Interface: a plain C function (loaded with ctypes) that launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one sample each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) lut_eval_packed_kernel(
    const uint32_t* __restrict__ words, int B, int W_in,
    const int* __restrict__ widx, const int* __restrict__ boff,
    const uint32_t* __restrict__ tab, int m, int n, int tw,
    uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (row >= B) return;  // the whole warp leaves
  uint32_t* in = smem + (size_t)warp * W_in;
  for (int w = lane; w < W_in; w += 32) in[w] = __ldg(words + row * W_in + w);
  __syncwarp();
  const int W_out = m >> 5;
  uint32_t* o = out + row * W_out;
  for (int w0 = 0; w0 < W_out; w0 += 32) {
    const int nw = min(32, W_out - w0);
    uint32_t mine = 0;
    for (int j = 0; j < nw; ++j) {
      const int lut = (w0 + j) * 32 + lane;
      const int* wi = widx + (size_t)lut * n;
      const int* bo = boff + (size_t)lut * n;
      uint32_t addr = 0;
      for (int k = 0; k < n; ++k)
        addr |= ((in[__ldg(wi + k)] >> __ldg(bo + k)) & 1u) << k;
      const uint32_t t = __ldg(tab + (size_t)lut * tw + (addr >> 5));
      const uint32_t word = __ballot_sync(kFull, (t >> (addr & 31u)) & 1u);
      if (lane == j) mine = word;
    }
    if (lane < nw) o[w0 + lane] = mine;
  }
}

}  // namespace

extern "C" int lut_eval_packed_launch(const void* words, int B, int W_in,
                                      const void* widx, const void* boff,
                                      const void* tab, int m, int n, int tw,
                                      void* out, void* stream) {
  if (B <= 0 || W_in <= 0 || m <= 0 || m % 32 != 0 || n <= 0 || n > 31 ||
      tw != ((1 << n) + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kThreads / 32) * W_in * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_eval_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  lut_eval_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, W_in, (const int*)widx, (const int*)boff,
      (const uint32_t*)tab, m, n, tw, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* lut_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
