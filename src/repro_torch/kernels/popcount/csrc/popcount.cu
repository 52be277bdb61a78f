// Popcount and first-argmax classify for Hopper (sm_90a): LUT-layer
// outputs -> per-class counts -> predicted class, from float32 bits
// (popcount_classify_kernel) or from packed words
// (popcount_classify_packed_kernel).
//
// Replaces the Pallas TPU kernels
//   popcount_classify        <- src/repro/kernels/popcount/kernel.py
//                               (_popcount_kernel)
//   popcount_classify_packed <- src/repro/kernels/popcount/kernel.py
//                               (_popcount_packed_kernel)
//
// Both write counts[b, c] as float32 and idx[b], the first class with the
// largest count (strict '>' in ascending class order, so ties go to the
// lower class).
//
// popcount_classify_kernel: counts[b, c] is the sum of bits[b, c*g + j]
// over j < g = m / C (contiguous class groups), exact for {0,1} bits below
// 2^24 in any order.  What bounds it on an H100: per sample m floats in,
// C+1 values out; at lg width (m=2400, C=5) and B=4096 that is 39.4 MB
// against 9.8 M adds, so it is bound by bytes.  One warp owns one sample;
// lane i reads elements i, i+32, ... of each class group, so every load of
// the warp is one 128-byte line, and the group's sum is reduced with a
// butterfly of warp shuffles.
//
// popcount_classify_packed_kernel: counts[b, c] is the number of set bits
// of words[b, :] under class_masks[c, :] (class groups need not align
// with word boundaries; pad bits are 0 and count nothing), exact below
// 2^24.  What bounds it on an H100.  Per sample it reads W words and
// writes C+1 values after C*W popcounts; at lg width (W=75, C=5) and
// B=4096 that is 1.3 MB against 1.5 M popcounts, so it is bound by bytes.
// The design:
//   * one warp owns one sample; lane i reads words i, i+32, ..., so the
//     row is read coalesced, and re-read per class from L1;
//   * the masks (C*W words) are read through the read-only path and stay
//     resident in L1/L2;
//   * each class's count is __popc(word & mask) summed over the lanes with
//     a butterfly of warp shuffles, so every lane holds it; lane 0 keeps
//     the running first argmax and writes the results.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one sample each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) popcount_classify_kernel(
    const float* __restrict__ bits, int B, int m, int C,
    float* __restrict__ counts, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves
  const int g = m / C;
  const float* br = bits + row * m;
  float best = 0.0f;
  int best_c = 0;
  for (int c = 0; c < C; ++c) {
    const float* grp = br + (size_t)c * g;
    float s = 0.0f;
#pragma unroll 4
    for (int j = lane; j < g; j += 32) s += __ldg(grp + j);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) counts[row * C + c] = s;
    if (c == 0 || s > best) {  // strict: ties keep the lower class
      best = s;
      best_c = c;
    }
  }
  if (lane == 0) idx[row] = best_c;
}

__global__ void __launch_bounds__(kThreads) popcount_classify_packed_kernel(
    const uint32_t* __restrict__ words, int B, int W,
    const uint32_t* __restrict__ masks, int C, float* __restrict__ counts,
    int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves
  const uint32_t* wr = words + row * W;
  int best = -1, best_c = 0;
  for (int c = 0; c < C; ++c) {
    const uint32_t* mc = masks + (size_t)c * W;
    int s = 0;
    for (int w = lane; w < W; w += 32)
      s += __popc(__ldg(wr + w) & __ldg(mc + w));
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) counts[row * C + c] = (float)s;
    if (s > best) {  // strict: ties keep the lower class
      best = s;
      best_c = c;
    }
  }
  if (lane == 0) idx[row] = best_c;
}

}  // namespace

extern "C" int popcount_classify_launch(const void* bits, int B, int m,
                                        int C, void* counts, void* idx,
                                        void* stream) {
  if (B <= 0 || C <= 0 || m < 0 || m % C != 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  popcount_classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bits, B, m, C, (float*)counts, (int*)idx);
  return (int)cudaGetLastError();
}

extern "C" int popcount_classify_packed_launch(const void* words, int B,
                                               int W, const void* masks,
                                               int C, void* counts, void* idx,
                                               void* stream) {
  if (B <= 0 || W < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  popcount_classify_packed_kernel<<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, W, (const uint32_t*)masks, C,
      (float*)counts, (int*)idx);
  return (int)cudaGetLastError();
}

extern "C" const char* popcount_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
