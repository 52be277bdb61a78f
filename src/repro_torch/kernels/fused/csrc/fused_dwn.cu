// Fused DWN inference kernels for Hopper (sm_90a): features -> thermometer
// bits -> LUT layer(s) -> group popcount -> first argmax, one launch.
//
// Replaces the three fused Pallas TPU kernels:
//   * fused_dwn_kernel             <- src/repro/kernels/fused/kernel.py
//                                     fused_dwn (_fused_kernel)
//   * fused_dwn_packed_kernel      <- src/repro/kernels/fused/kernel.py
//                                     fused_dwn_packed (_fused_packed_kernel)
//   * fused_dwn_batch_major_kernel <- src/repro/kernels/fused/kernel.py
//                                     fused_dwn_batch_major (_fused_bm_kernel)
//
// fused_dwn_kernel, the float datapath: one layer of m LUTs with float32
// tables (m, 2^n).  Its bits come from its own compares, so they are
// exactly 0 or 1, and the reference's multilinear corner product then
// equals the table entry they address, for finite tables: this kernel
// reads tables[l, addr] and compares only the m*n wired bits (wire i =
// f*T + t is x[f] > th[f, t]), never all F*T.  LUT l counts for class
// l / g, g = m / C; LUTs from g*C on count for no class (the reference's
// one-hot class map has a zero row for them).  What bounds it on an H100:
// it moves 1.05 MB at lg width (x, thresholds, wires, f32 tables, counts)
// against 59 M wired compares, 9.8 M table reads and 9.8 M class adds at
// B=4096, so it is bound by operations.  The f32 tables (614 KB at lg
// width) do not fit a block's shared memory, so the block walks the LUTs
// in tiles of block_m, as the reference's sequential m axis does: each
// tile's tables (copied 16 bytes a thread) and wires (feature index and
// threshold, wire-major) are staged in shared memory and used by all
// block_b rows of the block.  Lanes take consecutive LUTs and keep their
// wires in registers across the warp's rows; each lane adds its LUTs'
// outputs to its own sum per (row, class) in shared memory, and after the
// last tile the 32 lane sums of a class are added with a butterfly of
// shuffles: a fixed order, so the sums are deterministic.  LUTs that count
// for no class are not evaluated.  The first argmax follows.
//
// What bounds the packed kernels on an H100.  Per sample the work is F*T
// float compares (packed) or m0*n compares (batch-major), m*n single-bit
// selects per layer, one table read per LUT and C*W popcounts; the bytes
// that must move are only x (B*F floats), the model (mapping, bit-packed
// tables, thresholds) and the (B, C) counts.  At lg-2400 and B=4096 that
// is about 0.5 MB against some 80 M integer/compare operations, so the
// kernels are bound by operations (instruction issue and the latency of
// the gathers), not by device memory.  The design keeps every bit out of
// device memory:
//   * one warp owns one sample at a time; its packed bit vectors live in a
//     per-warp slice of shared memory (two ping-pong buffers);
//   * lane i of the warp evaluates LUT 32*w+i, and __ballot_sync packs the
//     32 output bits into word w in the repo's LSB-first convention (lane i
//     is bit i) with no shifting or reduction;
//   * truth tables are stored one bit per entry (lg-2400: 2400 x 64 bits =
//     18.75 KiB instead of 600 KiB as int32), so the whole model stays
//     resident in L1/L2 and is read through the read-only path (__ldg);
//   * class counts are __popc(word & mask) summed over words with a warp
//     shuffle reduction, and lane 0 scans classes in ascending order with a
//     strict '>' so ties go to the lower class.
// Rows past B are never touched (the grid bounds-checks rows), LUTs past m
// are zero-table pad LUTs whose bits stay 0, and the pad bits of a ragged
// last thermometer word (F*T % 32 != 0) are 0.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;      // == ref.MAX_LAYERS
constexpr int kMaxFanIn = 8;       // == kernel.FUSED_DWN_MAX_FAN_IN
constexpr int kThreads = 256;      // 8 warps, one sample per warp at a time
constexpr unsigned kFull = 0xffffffffu;

// Word-addressed LUT layers, flat: layer L's wires are widx/boff
// [wire_off, wire_off + m*n), its tables tab[tab_off, tab_off + m*tab_words).
struct LayerStack {
  int num_layers;
  int m[kMaxLayers];          // LUTs, a multiple of 32
  int n[kMaxLayers];          // fan-in
  int wire_off[kMaxLayers];
  int tab_off[kMaxLayers];
  int tab_words[kMaxLayers];  // ceil(2^n / 32)
};

__device__ __forceinline__ uint32_t lut_bit(const uint32_t* __restrict__ tab,
                                            int tab_words, int lut,
                                            uint32_t addr) {
  const uint32_t w = __ldg(tab + (size_t)lut * tab_words + (addr >> 5));
  return (w >> (addr & 31u)) & 1u;
}

// Runs every layer of `st` on the packed words in `cur`; returns the buffer
// holding the last layer's output words.
__device__ const uint32_t* run_layers(const LayerStack& st,
                                      const int* __restrict__ widx,
                                      const int* __restrict__ boff,
                                      const uint32_t* __restrict__ tab,
                                      uint32_t* cur, uint32_t* nxt,
                                      int lane) {
  for (int L = 0; L < st.num_layers; ++L) {
    const int n = st.n[L];
    const int tw = st.tab_words[L];
    const int words_out = st.m[L] >> 5;
    const int* wi = widx + st.wire_off[L];
    const int* bo = boff + st.wire_off[L];
    const uint32_t* tb = tab + st.tab_off[L];
    for (int ow = 0; ow < words_out; ++ow) {
      const int lut = ow * 32 + lane;
      uint32_t addr = 0;
      for (int k = 0; k < n; ++k) {
        const int w = __ldg(wi + lut * n + k);
        const int b = __ldg(bo + lut * n + k);
        addr |= ((cur[w] >> b) & 1u) << k;
      }
      const uint32_t word = __ballot_sync(kFull, lut_bit(tb, tw, lut, addr));
      if (lane == 0) nxt[ow] = word;
    }
    __syncwarp();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Masked popcount per class + first argmax; lane 0 writes the results.
__device__ void classify(const uint32_t* words,
                         const uint32_t* __restrict__ masks, int C, int W,
                         float* __restrict__ counts, int* __restrict__ idx,
                         int lane) {
  int best = -1, best_c = 0;
  for (int c = 0; c < C; ++c) {
    int s = 0;
    for (int w = lane; w < W; w += 32)
      s += __popc(words[w] & __ldg(masks + (size_t)c * W + w));
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) counts[c] = (float)s;
    if (s > best) {  // strict: ties keep the lower class
      best = s;
      best_c = c;
    }
  }
  if (lane == 0) *idx = best_c;
}

__global__ void __launch_bounds__(kThreads) fused_dwn_packed_kernel(
    const float* __restrict__ x, const float* __restrict__ th, int B, int F,
    int T, LayerStack st, const int* __restrict__ widx,
    const int* __restrict__ boff, const uint32_t* __restrict__ tab,
    const uint32_t* __restrict__ masks, int C, int W_last,
    float* __restrict__ counts, int* __restrict__ idx, int block_b,
    int buf_words) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int stride = F + 2 * buf_words;
  float* xrow = reinterpret_cast<float*>(smem + warp * stride);
  uint32_t* buf_a = smem + warp * stride + F;
  uint32_t* buf_b = buf_a + buf_words;
  const int FT = F * T;
  const int W0 = (FT + 31) >> 5;
  const long long start = (long long)blockIdx.x * block_b;
  const long long end = min((long long)B, start + block_b);
  for (long long s = start + warp; s < end; s += nwarps) {
    for (int f = lane; f < F; f += 32) xrow[f] = __ldg(x + s * F + f);
    __syncwarp();
    // encode: logical bit i = f*T + t is x[f] > th[f, t] = th_flat[i]
    for (int w = 0; w < W0; ++w) {
      const int i = w * 32 + lane;
      const uint32_t bit = (i < FT) && (xrow[i / T] > __ldg(th + i));
      const uint32_t word = __ballot_sync(kFull, bit);
      if (lane == 0) buf_a[w] = word;
    }
    __syncwarp();
    const uint32_t* out = run_layers(st, widx, boff, tab, buf_a, buf_b, lane);
    classify(out, masks, C, W_last, counts + s * C, idx + s, lane);
    __syncwarp();  // the next sample reuses this warp's buffers
  }
}

__global__ void __launch_bounds__(kThreads) fused_dwn_batch_major_kernel(
    const float* __restrict__ x, int B, int F,
    const int* __restrict__ wire_f, const float* __restrict__ wire_th,
    const uint32_t* __restrict__ tab0, int m0, int n0, int tw0,
    LayerStack st, const int* __restrict__ widx,
    const int* __restrict__ boff, const uint32_t* __restrict__ tab,
    const uint32_t* __restrict__ masks, int C, int W_last,
    float* __restrict__ counts, int* __restrict__ idx, int block_b,
    int buf_words) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int stride = F + 2 * buf_words;
  float* xrow = reinterpret_cast<float*>(smem + warp * stride);
  uint32_t* buf_a = smem + warp * stride + F;
  uint32_t* buf_b = buf_a + buf_words;
  const long long start = (long long)blockIdx.x * block_b;
  const long long end = min((long long)B, start + block_b);
  for (long long s = start + warp; s < end; s += nwarps) {
    for (int f = lane; f < F; f += 32) xrow[f] = __ldg(x + s * F + f);
    __syncwarp();
    // direct-wire first layer: only the m0*n wired bits are compared
    for (int ow = 0; ow < (m0 >> 5); ++ow) {
      const int lut = ow * 32 + lane;
      uint32_t addr = 0;
      for (int k = 0; k < n0; ++k) {
        const int f = __ldg(wire_f + lut * n0 + k);
        addr |= (uint32_t)(xrow[f] > __ldg(wire_th + lut * n0 + k)) << k;
      }
      const uint32_t word = __ballot_sync(kFull, lut_bit(tab0, tw0, lut, addr));
      if (lane == 0) buf_a[ow] = word;
    }
    __syncwarp();
    const uint32_t* out = run_layers(st, widx, boff, tab, buf_a, buf_b, lane);
    classify(out, masks, C, W_last, counts + s * C, idx + s, lane);
    __syncwarp();
  }
}

// Shared memory of fused_dwn_kernel, in floats: one tile's tables
// (block_m x 2^n, first, so that it is 16-byte aligned for the vector
// copy), its wires (feature index and threshold, n x block_m each, wire-
// major), then the block's rows of x (block_b x F) and the class sums of
// each lane (block_b x C x 32).
__host__ __device__ size_t fused_dwn_smem_floats(int F, int C, int n,
                                                 int block_b, int block_m) {
  return (size_t)block_m * ((1 << n) + 2 * n) +
         (size_t)block_b * (F + 32 * C);
}

// vec4: tables may be copied as float4 (2^n % 4 == 0, 16-byte aligned).
__global__ void __launch_bounds__(kThreads) fused_dwn_kernel(
    const float* __restrict__ x, const float* __restrict__ th, int B, int F,
    int T, const int* __restrict__ mapping, const float* __restrict__ tables,
    int m, int n, int C, int g, float* __restrict__ counts,
    int* __restrict__ idx, int block_b, int block_m, bool vec4) {
  extern __shared__ float4 smem4[];
  const int A = 1 << n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long r0 = (long long)blockIdx.x * block_b;
  const int rows = (int)min((long long)block_b, B - r0);
  float* tab_s = reinterpret_cast<float*>(smem4);  // block_m x A
  int* wf_s = reinterpret_cast<int*>(tab_s + (size_t)block_m * A);
  float* wt_s = reinterpret_cast<float*>(wf_s + n * block_m);
  float* x_s = wt_s + n * block_m;                 // block_b x F
  float* part_s = x_s + block_b * F;               // block_b x C x 32
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x)
    x_s[i] = __ldg(x + r0 * F + i);
  for (int i = threadIdx.x; i < rows * C * 32; i += blockDim.x)
    part_s[i] = 0.0f;
  // LUTs at and past `counted` count for no class and are not evaluated
  const int counted = g * C;
  for (int t0 = 0; t0 < counted; t0 += block_m) {
    const int tile = min(block_m, counted - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < tile * n; i += blockDim.x) {
      const int wire = __ldg(mapping + (size_t)t0 * n + i);
      const int j = i / n, k = i - j * n;
      wf_s[k * block_m + j] = wire / T;
      wt_s[k * block_m + j] = __ldg(th + wire);
    }
    if (vec4) {
      const float4* src =
          reinterpret_cast<const float4*>(tables + (size_t)t0 * A);
      for (int i = threadIdx.x; i < tile * A / 4; i += blockDim.x)
        smem4[i] = __ldg(src + i);
    } else {
      for (int i = threadIdx.x; i < tile * A; i += blockDim.x)
        tab_s[i] = __ldg(tables + (size_t)t0 * A + i);
    }
    __syncthreads();
    // lane i takes LUTs t0 + i, t0 + i + 32, ... for each of the warp's
    // rows, keeping a LUT's wires in registers, and adds each output to its
    // own sum of the LUT's class
    for (int j = lane; j < tile; j += 32) {
      int wf[kMaxFanIn];
      float wt[kMaxFanIn];
#pragma unroll
      for (int k = 0; k < kMaxFanIn; ++k) {
        wf[k] = k < n ? wf_s[k * block_m + j] : 0;
        wt[k] = k < n ? wt_s[k * block_m + j] : 0.0f;
      }
      const float* tl = tab_s + (size_t)j * A;
      float* pl = part_s + (t0 + j) / g * 32 + lane;
      for (int r = warp; r < rows; r += nwarps) {
        const float* xr = x_s + r * F;
        uint32_t addr = 0;
#pragma unroll
        for (int k = 0; k < kMaxFanIn; ++k)
          if (k < n) addr |= (uint32_t)(xr[wf[k]] > wt[k]) << k;
        pl[r * C * 32] += tl[addr];
      }
    }
  }
  __syncthreads();
  // each class count is the butterfly sum of the lanes' sums
  for (int r = warp; r < rows; r += nwarps) {
    int best_c = 0;
    float best = 0.0f;
    for (int c = 0; c < C; ++c) {
      float s = part_s[(r * C + c) * 32 + lane];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) counts[(r0 + r) * C + c] = s;
      if (c == 0 || s > best) {  // strict: ties keep the lower class
        best = s;
        best_c = c;
      }
    }
    if (lane == 0) idx[r0 + r] = best_c;
  }
}

// meta: num_layers rows of (m, n, wire_off, tab_off, tab_words).
cudaError_t fill_stack(LayerStack* st, const int* meta, int num_layers) {
  if (num_layers < 0 || num_layers > kMaxLayers) return cudaErrorInvalidValue;
  st->num_layers = num_layers;
  for (int L = 0; L < kMaxLayers; ++L) {
    const bool live = L < num_layers;
    st->m[L] = live ? meta[5 * L + 0] : 0;
    st->n[L] = live ? meta[5 * L + 1] : 0;
    st->wire_off[L] = live ? meta[5 * L + 2] : 0;
    st->tab_off[L] = live ? meta[5 * L + 3] : 0;
    st->tab_words[L] = live ? meta[5 * L + 4] : 0;
  }
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

size_t smem_bytes(int F, int buf_words) {
  return (size_t)(kThreads / 32) * (F + 2 * buf_words) * sizeof(uint32_t);
}

}  // namespace

extern "C" int fused_dwn_launch(const void* x, const void* th, int B, int F,
                                int T, const void* mapping,
                                const void* tables, int m, int n, int C,
                                void* counts, void* idx, int block_b,
                                int block_m, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || m <= 0 || n < 1 || n > kMaxFanIn ||
      C <= 0 ||
      block_b <= 0 || block_m <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * fused_dwn_smem_floats(F, C, n, block_b, block_m);
  const cudaError_t err = prepare_smem(fused_dwn_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = n >= 2 && (uintptr_t)tables % 16 == 0;
  const int grid = (B + block_b - 1) / block_b;
  fused_dwn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, B, F, T, (const int*)mapping,
      (const float*)tables, m, n, C, m / C, (float*)counts, (int*)idx,
      block_b, block_m, vec4);
  return (int)cudaGetLastError();
}

extern "C" int fused_dwn_packed_launch(
    const void* x, const void* th, int B, int F, int T, const int* meta,
    int num_layers, const void* widx, const void* boff, const void* tab,
    const void* masks, int C, int W_last, void* counts, void* idx,
    int block_b, int buf_words, void* stream) {
  LayerStack st;
  cudaError_t err = fill_stack(&st, meta, num_layers);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || block_b <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, buf_words);
  err = prepare_smem(fused_dwn_packed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + block_b - 1) / block_b;
  fused_dwn_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, B, F, T, st, (const int*)widx,
      (const int*)boff, (const uint32_t*)tab, (const uint32_t*)masks, C,
      W_last, (float*)counts, (int*)idx, block_b, buf_words);
  return (int)cudaGetLastError();
}

extern "C" int fused_dwn_batch_major_launch(
    const void* x, int B, int F, const void* wire_f, const void* wire_th,
    const void* tab0, int m0, int n0, int tw0, const int* meta,
    int num_layers, const void* widx, const void* boff, const void* tab,
    const void* masks, int C, int W_last, void* counts, void* idx,
    int block_b, int buf_words, void* stream) {
  LayerStack st;
  cudaError_t err = fill_stack(&st, meta, num_layers);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || block_b <= 0 || m0 % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, buf_words);
  err = prepare_smem(fused_dwn_batch_major_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + block_b - 1) / block_b;
  fused_dwn_batch_major_kernel<<<grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const float*)x, B, F, (const int*)wire_f, (const float*)wire_th,
      (const uint32_t*)tab0, m0, n0, tw0, st, (const int*)widx,
      (const int*)boff, (const uint32_t*)tab, (const uint32_t*)masks, C,
      W_last, (float*)counts, (int*)idx, block_b, buf_words);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_dwn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
