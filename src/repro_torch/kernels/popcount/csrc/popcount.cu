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
// with word boundaries, the masks may be any bit patterns; pad bits are 0
// and count nothing), exact below 2^24.  What bounds it on an H100.  Per
// sample it reads W words and writes C+1 values; at lg width (W=75, C=5)
// and B=4096 that is 1.33 MB, 0.397 us at 3.35 TB/s, so it is bound by
// bytes: its C*W = 375 popcounts a sample, 1.5 M at 16 a clock an SM, are
// 0.367 us (contiguous class groups need only 79 of them: at most two
// masks are non-zero in a word).  Both are below a launch's fixed cost
// (about 1 us in a CUDA graph), so what the design cuts is the chain of
// dependent steps one block runs.  The first design (one warp a sample,
// each class a pass over the row and a 5-step shuffle butterfly) ran at
// 10x that bound.  The design:
//   * lanes over samples: a block owns a tile of 32 consecutive samples,
//     whose 32*W words are one contiguous span, staged with cp.async
//     (16 bytes a copy where W is odd) into rows of odd pitch (W | 1
//     words), so that lane l reads word w of its own row at bank
//     (l*pitch + w) mod 32, conflict-free;
//   * the class masks (C*W words, 1.5 KB at lg) are staged once per
//     block beside the tile, so that every mask read is a broadcast;
//   * the block's warps split the row's words; a warp first finds the
//     classes whose masks are non-zero somewhere in its words (one
//     __reduce_or_sync, so the whole warp agrees and skips the others
//     without divergence: 1 or 2 of 5 classes at lg), then for each live
//     class sums __popc(word & mask) over its words, 16 words a lane in
//     registers at a time, no test per word;
//   * each warp adds its per-class sums into the tile's [C][32] integer
//     counts with shared-memory atomics (integer adds: exact in any
//     order), one barrier, then the counts go out as float32 and warp 0
//     takes the first argmax;
//   * rows too wide for a block's shared memory, or more than 32 classes
//     (a warp's live classes are one 32-bit set), take
//     popcount_classify_packed_rows_kernel, the first design, kept.
// Measured on the card (PERF.md, scripts/k5_ab.py): a test per word and
// class diverges and costs more than the popcounts it saves, and the
// popcounts of classes whose masks are 0 cost more than a warp's one test.
// The path is planned on the host (kernel.py: plan_popcount_classify_packed)
// from W and C alone; the C entry checks that the plan's shared memory is
// this layout's.

// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tiles.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps, one sample each
constexpr int kTileRows = 32;     // samples of a packed tile, a lane each
constexpr int kMaxTileWarps = 8;  // warps of a packed tile's block
constexpr int kMaxClasses = 32;   // a warp's live classes: one 32-bit set
constexpr int kChunk = 16;        // words a lane holds in registers at once
constexpr int kMaxSmem = 232448;  // dynamic shared memory of a block

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

// The first packed design, kept for rows too wide for a tile and for more
// than kMaxClasses classes: one warp owns one sample; lane i reads words
// i, i+32, ... of the row (coalesced) and of each class's mask, and each
// class's count is summed over the lanes with a butterfly of shuffles.
__global__ void __launch_bounds__(kThreads)
    popcount_classify_packed_rows_kernel(const uint32_t* __restrict__ words,
                                         int B, int W,
                                         const uint32_t* __restrict__ masks,
                                         int C, float* __restrict__ counts,
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

struct PopcountTiles {
  const uint32_t* words;  // (B, W)
  const uint32_t* masks;  // (C, W)
  float* counts;          // (B, C)
  int* idx;               // (B,)
  int B, W, C;
  int pitch;  // W | 1: words of a staged row
  int ws;     // words a warp walks
};

// Shared-memory byte offsets of popcount_classify_packed_kernel's parts:
// the class masks ([C][W] words, then kChunk words that a warp's last
// chunk may read past them), the tile's counts ([C][kTileRows] ints) and
// the tile ([kTileRows][pitch] words); off[3] is the total.
__host__ __device__ void popcount_tiles_layout(int W, int C, size_t off[4]) {
  off[0] = 0;
  off[1] = align16(((size_t)C * W + kChunk) * 4);
  off[2] = off[1] + (size_t)C * kTileRows * 4;
  off[3] = off[2] + (size_t)kTileRows * (W | 1) * 4;
}

__global__ void __launch_bounds__(kMaxTileWarps * 32)
    popcount_classify_packed_kernel(const __grid_constant__ PopcountTiles p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C, W = p.W;
  size_t off[4];
  popcount_tiles_layout(W, C, off);
  uint32_t* ms = reinterpret_cast<uint32_t*>(sm + off[0]);
  int* cnt = reinterpret_cast<int*>(sm + off[1]);
  uint32_t* rows = reinterpret_cast<uint32_t*>(sm + off[2]);
  const long long row0 = (long long)blockIdx.x * kTileRows;
  const int nr = (int)min((long long)kTileRows, p.B - row0);

  // the masks and the tile's rows (one contiguous span of nr*W words)
  stage(ms, p.masks, C * W * 4);
  const uint32_t* src = p.words + row0 * W;
  if (p.pitch == W && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    stage(rows, src, nr * W * 4);
  } else {
    for (int g = tid; g < nr * W; g += blockDim.x) {
      const int r = g / W;
      cp_async4(rows + r * p.pitch + g - r * W, src + g);
    }
  }
  cp_async_commit();
  for (int i = tid; i < C * kTileRows; i += blockDim.x) cnt[i] = 0;
  cp_async_wait_all();
  __syncthreads();

  // this warp's words [w0, w0 + n) of the lane's row; the classes whose
  // masks are 0 over all of them, a set the whole warp agrees on, are
  // skipped without divergence
  const int w0 = warp * p.ws, n = max(0, min(p.ws, W - w0));
  unsigned bits = 0;
  for (int j = lane; j < n; j += 32)
    for (int c = 0; c < C; ++c)
      bits |= (ms[c * W + w0 + j] != 0u ? 1u : 0u) << c;
  const unsigned live = __reduce_or_sync(kFull, bits);
  const uint32_t* row = rows + lane * p.pitch + w0;
  for (int c = 0; c < C; ++c) {
    if (!((live >> c) & 1u)) continue;
    const uint32_t* mc = ms + c * W + w0;
    int s = 0;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      uint32_t x[kChunk];  // words past n are 0 and count nothing
#pragma unroll
      for (int j = 0; j < kChunk; ++j) x[j] = c0 + j < n ? row[c0 + j] : 0u;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s += __popc(x[j] & mc[c0 + j]);
    }
    atomicAdd(cnt + c * kTileRows + lane, s);  // integers: exact, any order
  }
  __syncthreads();

  // counts out as float32, class-major over the tile; the first argmax
  for (int t = tid; t < C * kTileRows; t += blockDim.x) {
    const int c = t >> 5, r = t & 31;
    if (r < nr) p.counts[(row0 + r) * C + c] = (float)cnt[t];
  }
  if (warp == 0 && lane < nr) {
    int best = -1, best_c = 0;
    for (int c = 0; c < C; ++c) {
      const int v = cnt[c * kTileRows + lane];
      if (v > best) {  // strict: ties keep the lower class
        best = v;
        best_c = c;
      }
    }
    p.idx[row0 + lane] = best_c;
  }
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

// K5 on tiles of 32 samples, a block each, of `warps` warps; smem: the
// plan's dynamic shared memory in bytes (kernel.py:
// plan_popcount_classify_packed), which must be this layout's.
extern "C" int popcount_classify_packed_launch(const void* words, int B,
                                               int W, const void* masks,
                                               int C, void* counts, void* idx,
                                               int warps, int smem,
                                               void* stream) {
  if (B <= 0 || W < 0 || C <= 0 || C > kMaxClasses || warps < 1 ||
      warps > kMaxTileWarps)
    return (int)cudaErrorInvalidValue;
  size_t off[4];
  popcount_tiles_layout(W, C, off);
  if (off[3] != (size_t)smem || off[3] > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  PopcountTiles p = {};
  p.words = static_cast<const uint32_t*>(words);
  p.masks = static_cast<const uint32_t*>(masks);
  p.counts = static_cast<float*>(counts);
  p.idx = static_cast<int*>(idx);
  p.B = B;
  p.W = W;
  p.C = C;
  p.pitch = W | 1;
  p.ws = (W + warps - 1) / warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        popcount_classify_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  popcount_classify_packed_kernel<<<(B + kTileRows - 1) / kTileRows,
                                    warps * 32, smem,
                                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The rows kernel: the first design, for any W and C.
extern "C" int popcount_classify_packed_rows_launch(const void* words, int B,
                                                    int W, const void* masks,
                                                    int C, void* counts,
                                                    void* idx, void* stream) {
  if (B <= 0 || W < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  popcount_classify_packed_rows_kernel<<<grid, kThreads, 0,
                                         (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, W, (const uint32_t*)masks, C,
      (float*)counts, (int*)idx);
  return (int)cudaGetLastError();
}

extern "C" const char* popcount_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
