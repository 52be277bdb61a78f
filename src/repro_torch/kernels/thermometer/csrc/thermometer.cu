// Thermometer encode for Hopper (sm_90a): features -> bits, as float32
// {0,1} (thermometer_encode_kernel) or packed into words
// (thermometer_encode_packed_kernel).
//
// Replaces the Pallas TPU kernels
//   thermometer_encode        <- src/repro/kernels/thermometer/kernel.py
//                                (_thermometer_kernel)
//   thermometer_encode_packed <- src/repro/kernels/thermometer/kernel.py
//                                (_thermometer_packed_kernel)
//
// Bit i = f*T + t of a sample's flat bit vector is x[b, f] > th[f, t]
// (strict: PEN grids put many x exactly on a threshold; NaN compares
// false).  The compares stay IEEE: no fast-math and no flush-to-zero, so a
// denormal x against a 0.0 threshold reads 1.
//
// thermometer_encode_kernel writes bit i of row b as out[b*F*T + i]
// (1.0f or 0.0f; T is not padded, the reference pads it to 128 lanes).
// What bounds it on an H100: per sample F floats in and F*T floats out;
// at lg width (F=16, T=200) and B=4096 that is 52.7 MB, 52.4 MB of it the
// output, against 13 M compares, so it is bound by bytes, nearly all of
// them stores.  The design makes every store coalesced: a block owns a
// chunk of kChunk consecutive elements of one row, and thread k writes
// elements k, k + kThreads, ..., so each warp stores 128 contiguous bytes
// per step; the row's features and the thresholds are read through the
// read-only path and stay in L1/L2.
//
// thermometer_encode_packed_kernel packs bit i into word i >> 5 at
// position i & 31, LSB-first.  When F*T is not a multiple of 32 the last
// word's pad bits are 0 (the reference falls back to its jnp oracle there;
// this kernel takes the ragged word).
// What bounds it on an H100.  Per sample it reads F floats and writes
// ceil(F*T/32) words after F*T compares; at lg width and B=4096 that is
// 1.9 MB, 1.6 MB of it the packed output, against 13 M compares, so it is
// bound by bytes.  The design therefore makes the stores coalesced:
//   * one warp owns 32 consecutive output words of one sample; for word j
//     lane i compares bit 32*j + i and __ballot_sync packs the 32 compares
//     in the repo's LSB-first order (lane i is bit i), and lane j keeps the
//     word, so the warp stores its 32 words as one 128-byte transaction;
//   * the thresholds (12.5 KiB at lg width) are read lane-consecutive
//     through the read-only path and stay in L1/L2 for every sample;
//   * the feature of bit i is x[i / T]: one integer division per compare,
//     a known cost that a later PR can remove.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, each one 32-word chunk of a row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4 * kThreads;  // float elements one block writes

__global__ void __launch_bounds__(kThreads) thermometer_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ th, int F, int T,
    int chunks, float* __restrict__ out) {
  const long long row = blockIdx.x / chunks;
  const int FT = F * T;
  const int j0 = (int)(blockIdx.x % chunks) * kChunk;
  const int j1 = min(FT, j0 + kChunk);
  const float* xr = x + row * F;
  float* o = out + row * FT;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
    o[j] = __ldg(xr + j / T) > __ldg(th + j) ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads) thermometer_encode_packed_kernel(
    const float* __restrict__ x, const float* __restrict__ th, int B, int F,
    int T, int W, int chunks, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (gw >= (long long)B * chunks) return;  // the whole warp leaves
  const long long row = gw / chunks;
  const int w0 = (int)(gw % chunks) * 32;
  const int nw = min(32, W - w0);
  const int FT = F * T;
  const float* xr = x + row * F;
  uint32_t mine = 0;
  for (int j = 0; j < nw; ++j) {
    const int i = (w0 + j) * 32 + lane;
    const bool bit = i < FT && __ldg(xr + i / T) > __ldg(th + i);
    const uint32_t word = __ballot_sync(kFull, bit);
    if (lane == j) mine = word;
  }
  if (lane < nw) out[row * W + w0 + lane] = mine;
}

}  // namespace

extern "C" int thermometer_encode_launch(const void* x, const void* th,
                                         int B, int F, int T, void* out,
                                         void* stream) {
  if (B <= 0 || F <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int chunks = (F * T + kChunk - 1) / kChunk;
  const long long grid = (long long)B * chunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  thermometer_encode_kernel<<<(unsigned)grid, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, F, T, chunks, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int thermometer_encode_packed_launch(const void* x, const void* th,
                                                int B, int F, int T,
                                                void* out, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int W = (F * T + 31) / 32;
  const int chunks = (W + 31) / 32;
  const long long warps = (long long)B * chunks;
  const long long grid = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  thermometer_encode_packed_kernel<<<(unsigned)grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, B, F, T, W, chunks, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* thermometer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
