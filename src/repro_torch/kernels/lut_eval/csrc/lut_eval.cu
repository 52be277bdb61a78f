// LUT-layer evaluation for Hopper (sm_90a): one layer of LUTs on float32
// bits (lut_eval_kernel) or on packed bits (lut_eval_packed_kernel).
//
// Replaces the Pallas TPU kernels
//   lut_eval        <- src/repro/kernels/lut_eval/kernel.py (_lut_eval_kernel)
//   lut_eval_packed <- src/repro/kernels/lut_eval/kernel.py
//                      (_lut_eval_packed_kernel)
//
// lut_eval_kernel.  With s_i = bits[b, mapping[l, i]] (i < n), LUT l of
// row b outputs the multilinear function of its inputs,
//   out[b, l] = sum_a table[l, a] * prod_i (s_i if bit i of a else 1 - s_i),
// which is table[l, addr] for bits in {0,1} (and finite tables) and
// interpolates for bits in (0, 1).  The reference selects the wires with a
// dense one-hot matrix product on the MXU; every column of that matrix
// holds a single 1, so the product equals the gather done here, exactly.
// The table is evaluated as a tree of 2^n - 1 lerps, input 0 first:
// lo + s_i * (hi - lo), one subtraction and one FMA.  For s_i = 0 that is
// lo, for s_i = 1 it is lo + (hi - lo), which is hi for {0,1} tables and
// within an ulp of hi for float tables; the plain version rounds the same
// way, as s_i * (hi - lo) is exact for s_i in {0,1}.  The tree streams
// over the corners a = 0, 1, ... like a binary counter, keeping one
// pending value per level, so a LUT needs n registers, not 2^n.
// What bounds it on an H100: per row it reads C floats and writes m; at
// lg width (C=3200, m=2400, n=6) and B=4096 that is 92.4 MB (bits 52.4 MB,
// output 39.3 MB, tables 0.6 MB) against 1.3 G operations, so it is bound
// by bytes.  The design:
//   * a block owns kRows rows and stages them in shared memory (8 x 12.8
//     KB at lg width), so the random wire gathers are shared-memory reads
//     and the bits are read from device memory once;
//   * thread t of the block evaluates LUT l = t, t + kThreads, ... for all
//     of the block's rows at once, so each table entry is loaded once per
//     block and used kRows times;
//   * tables arrive corner-major, (2^n, m), so lanes (consecutive LUTs)
//     read one 128-byte line per corner, and write one per row.
// The tables (614 KB) are read once per block from L2: 512 blocks at
// B=4096 move 314 MB from L2, a known cost a later PR can cut.
//
// lut_eval_packed_kernel.  Wire k of LUT l reads bit bit_off[l, k] of
// input word word_idx[l, k] and is bit k of the LUT's address (weight
// 2^k); the LUT's output is entry `addr` of its truth table, packed
// LSB-first into output word l >> 5.  m is a multiple of 32 (the op pads
// with all-zero tables, whose output bits are 0, so the pad bits of the
// last real word stay 0).
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
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // packed: 8 warps, one sample each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;       // float: rows one block stages and evaluates
constexpr int kMaxFanIn = 8;   // float: 2^8 corners at most

// rows_per_block: <= kRows, fewer when kRows rows of C floats would not
// fit in shared memory; the last block may hold fewer still.
// Two blocks per SM (at most 128 registers a thread): the fastest at lg
// width of the row counts and register limits tried (PERF.md, PR 13).
template <int N>
__global__ void __launch_bounds__(kThreads, 2) lut_eval_kernel(
    const float* __restrict__ bits, int B, int C,
    const int* __restrict__ mapping, const float* __restrict__ tab_t, int m,
    int rows_per_block, float* __restrict__ out) {
  extern __shared__ float rows_s[];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, B - r0);
  const float* src = bits + r0 * C;
  for (int i = threadIdx.x; i < rows * C; i += kThreads)
    rows_s[i] = __ldg(src + i);
  __syncthreads();
  for (int l = threadIdx.x; l < m; l += kThreads) {
    int wire[N];
#pragma unroll
    for (int k = 0; k < N; ++k) wire[k] = __ldg(mapping + (size_t)l * N + k);
    float s[kRows][N], pend[kRows][N], res[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        s[r][k] = r < rows ? rows_s[r * C + wire[k]] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < (1 << N); ++a) {
      const float t = __ldg(tab_t + (size_t)a * m + l);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = t;
        bool held = false;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (held) continue;
          if ((a >> k) & 1) {  // v is the hi side of level k: fold
            v = fmaf(s[r][k], v - pend[r][k], pend[r][k]);
          } else {             // v is the lo side: wait for its pair
            pend[r][k] = v;
            held = true;
          }
        }
        if (!held) res[r] = v;  // a == 2^N - 1: the whole tree folded
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) out[(r0 + r) * m + l] = res[r];
  }
}

template <int N>
cudaError_t launch_lut_eval(const float* bits, int B, int C,
                            const int* mapping, const float* tab_t, int m,
                            int rows_per_block, float* out,
                            cudaStream_t stream) {
  const size_t smem = (size_t)rows_per_block * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_eval_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + rows_per_block - 1) / rows_per_block;
  lut_eval_kernel<N><<<grid, kThreads, smem, stream>>>(
      bits, B, C, mapping, tab_t, m, rows_per_block, out);
  return cudaGetLastError();
}

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

// rows: rows per block, 1..kRows, with rows * C floats of shared memory.
extern "C" int lut_eval_launch(const void* bits, int B, int C,
                               const void* mapping, const void* tab_t, int m,
                               int n, int rows, void* out, void* stream) {
  if (B <= 0 || C <= 0 || m <= 0 || n < 1 || n > kMaxFanIn || rows < 1 ||
      rows > kRows)
    return (int)cudaErrorInvalidValue;
  const float* b = (const float*)bits;
  const int* mp = (const int*)mapping;
  const float* t = (const float*)tab_t;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 1: return (int)launch_lut_eval<1>(b, B, C, mp, t, m, rows, o, st);
    case 2: return (int)launch_lut_eval<2>(b, B, C, mp, t, m, rows, o, st);
    case 3: return (int)launch_lut_eval<3>(b, B, C, mp, t, m, rows, o, st);
    case 4: return (int)launch_lut_eval<4>(b, B, C, mp, t, m, rows, o, st);
    case 5: return (int)launch_lut_eval<5>(b, B, C, mp, t, m, rows, o, st);
    case 6: return (int)launch_lut_eval<6>(b, B, C, mp, t, m, rows, o, st);
    case 7: return (int)launch_lut_eval<7>(b, B, C, mp, t, m, rows, o, st);
    default: return (int)launch_lut_eval<8>(b, B, C, mp, t, m, rows, o, st);
  }
}

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
