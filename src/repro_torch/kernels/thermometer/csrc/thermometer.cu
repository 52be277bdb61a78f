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
// 1.9 MB against 13 M compares: 0.0008 ms by the compares at the issue
// rate, so a launch's few microseconds are its real floor.  The first
// design (one warp a sample's 32 words, a division i / T and two dependent
// loads per compare, the thresholds re-read for every sample) ran at 36x
// that bound.  The design, after fused_dwn.cu's encode_tile:
//   * a persistent grid walks tiles of 32 samples, one a lane; the
//     features of a tile are staged [f][lane] with cp.async, the next
//     tile's arriving while one is encoded;
//   * a block stages its slice of the thresholds once (cp.async, padded
//     with zeros to whole words); a word's 32 thresholds are eight 16-byte
//     broadcasts into registers, compared with each feature the word
//     spans (one or two at T = 200), with no division past one per word;
//   * the tile's words go out through a padded [word][33] shared tile, so
//     that a warp's stores are whole rows, coalesced;
//   * below 132 tiles the words are split over slices (grid.y) to fill
//     the card, and so are thresholds too large for one block;
//   * features too many for two tiles in half a block (F > 454) take
//     thermometer_encode_packed_rows_kernel, the first design, kept.
// The compares stay strict and IEEE whichever kernel runs.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tiles.cuh"

namespace {

constexpr int kThreads = 256;  // float encode; packed rows: 8 warps
constexpr int kChunk = 4 * kThreads;  // float elements one block writes
constexpr int kTileRows = 32;         // samples of a packed tile, a lane each
constexpr int kTileThreads = 512;     // packed tiles: 16 warps
constexpr int kMaxSmem = 232448;      // dynamic shared memory of a block

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

// The first packed design, kept for features too many for a tile: one
// warp owns 32 consecutive output words of one sample, lane i compares bit
// 32*j + i of word j and __ballot_sync packs them.
__global__ void __launch_bounds__(kThreads)
    thermometer_encode_packed_rows_kernel(const float* __restrict__ x,
                                          const float* __restrict__ th, int B,
                                          int F, int T, int W, int chunks,
                                          uint32_t* __restrict__ out) {
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

struct EncodeTiles {
  const float* x;   // (B, F)
  const float* th;  // (F, T)
  uint32_t* out;    // (B, W)
  int B, F, T, W;
  int tiles, ws;    // tiles of kTileRows; output words per slice
};

// Shared-memory byte offsets of thermometer_encode_packed_kernel's parts:
// the slice's thresholds (ws*32 floats, zeros past F*T), its output tile
// ([ws][kTileRows + 1] words: padded, so that writing it by lane and
// reading it by word are both conflict-free) and two feature buffers
// ([F][kTileRows] floats each); off[3] is the total.
__host__ __device__ void encode_tiles_layout(int F, int ws, size_t off[4]) {
  off[0] = 0;
  off[1] = align16((size_t)ws * 32 * 4);
  off[2] = off[1] + align16((size_t)ws * (kTileRows + 1) * 4);
  off[3] = off[2] + 2 * (size_t)F * kTileRows * 4;
}

// Tile t's features into xs as [f][lane]; rows past B are zeros.
__device__ void stage_features(const EncodeTiles& p, float* xs, int t) {
  const long long row0 = (long long)t * kTileRows;
  const int n = kTileRows * p.F;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / p.F, f = e - r * p.F;
    float* d = xs + f * kTileRows + r;
    if (row0 + r < p.B)
      cp_async4(d, p.x + (row0 + r) * p.F + f);
    else
      *d = 0.0f;
  }
}

// The word of flat bits i0 .. i0 + 31 of the lane's sample: ths holds the
// word's 32 thresholds (16-byte aligned), x_lane the lane's features at a
// stride of kTileRows.  The thresholds are read once, as eight 16-byte
// broadcasts, and compared with each feature the word spans, keeping the
// bits of that feature's run; bits past F*T stay 0.
__device__ __forceinline__ uint32_t encode_word(const float* ths,
                                                const float* x_lane, int i0,
                                                int FT, int T) {
  const int nb = min(32, FT - i0);
  float t[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = reinterpret_cast<const float4*>(ths)[q];
    t[4 * q] = v.x;
    t[4 * q + 1] = v.y;
    t[4 * q + 2] = v.z;
    t[4 * q + 3] = v.w;
  }
  int f = i0 / T, j0 = 0;
  uint32_t acc = 0;
  while (j0 < nb) {
    const int j1 = min(nb, (f + 1) * T - i0);
    const float xf = x_lane[f * kTileRows];
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) m |= static_cast<uint32_t>(xf > t[j]) << j;
    const uint32_t hi = j1 >= 32 ? kFull : (1u << j1) - 1u;
    acc |= m & hi & ~((1u << j0) - 1u);
    j0 = j1;
    ++f;
  }
  return acc;
}

__global__ void __launch_bounds__(kTileThreads)
    thermometer_encode_packed_kernel(const __grid_constant__ EncodeTiles p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's slice: output words [w0, w0 + nws), flat bits from w0*32
  const int w0 = blockIdx.y * p.ws, nws = min(p.ws, p.W - w0);
  const int FT = p.F * p.T;
  size_t off[4];
  encode_tiles_layout(p.F, p.ws, off);
  float* ths = reinterpret_cast<float*>(sm + off[0]);
  uint32_t* outs = reinterpret_cast<uint32_t*>(sm + off[1]);
  float* xs = reinterpret_cast<float*>(sm + off[2]);
  const int x_floats = p.F * kTileRows;
  constexpr int kOut = kTileRows + 1;  // output tile row pitch

  // the slice's thresholds, once per block, zeros past F*T
  const int nth = min(FT - w0 * 32, nws * 32);
  stage(ths, p.th + (size_t)w0 * 32, nth * 4);
  for (int i = nth + tid; i < nws * 32; i += blockDim.x) ths[i] = 0.0f;
  int t = blockIdx.x;
  if (t < p.tiles) stage_features(p, xs, t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int it = 0; t < p.tiles; t += gridDim.x, ++it) {
    const float* x_lane = xs + (it & 1) * x_floats + lane;
    const long long row0 = (long long)t * kTileRows;
    const int rows = (int)min((long long)kTileRows, p.B - row0);
    // the next tile's features arrive while this one is encoded
    if (t + (int)gridDim.x < p.tiles)
      stage_features(p, xs + ((it + 1) & 1) * x_floats, t + gridDim.x);
    cp_async_commit();
    for (int w = warp; w < nws; w += nwarps)
      outs[w * kOut + lane] =
          encode_word(ths + w * 32, x_lane, (w0 + w) * 32, FT, p.T);
    __syncthreads();
    // the tile back to (B, W) rows: neighbouring threads write
    // neighbouring words of a row
    for (int i = tid; i < rows * nws; i += blockDim.x) {
      const int r = i / nws, w = i - r * nws;
      p.out[(row0 + r) * p.W + w0 + w] = outs[w * kOut + r];
    }
    cp_async_wait_all();
    __syncthreads();
  }
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

// K3 on tiles of 32 samples over S slices of ws output words each, on a
// card of sms SMs; smem: the plan's dynamic shared memory in bytes
// (kernel.py: plan_thermometer_encode_packed), which must be this
// layout's.  info: walkers (grid.x), blocks an SM holds.
extern "C" int thermometer_encode_packed_launch(const void* x, const void* th,
                                                int B, int F, int T,
                                                void* out, int S, int ws,
                                                int sms, int smem, int* info,
                                                void* stream) {
  const long long FT = (long long)F * T;
  if (B <= 0 || F <= 0 || T <= 0 || FT > 0x7fffffffLL || ws < 1 ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  EncodeTiles p = {};
  p.x = static_cast<const float*>(x);
  p.th = static_cast<const float*>(th);
  p.out = static_cast<uint32_t*>(out);
  p.B = B;
  p.F = F;
  p.T = T;
  p.W = (int)((FT + 31) / 32);
  p.tiles = (B + kTileRows - 1) / kTileRows;
  p.ws = ws;
  if (S != (p.W + ws - 1) / ws || S > 65535)
    return (int)cudaErrorInvalidValue;
  size_t off[4];
  encode_tiles_layout(F, ws, off);
  if (off[3] != (size_t)smem || off[3] > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(thermometer_encode_packed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, thermometer_encode_packed_kernel, kTileThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: each slice's tiles walked by as many blocks as
  // the card holds beside the other slices'
  const int walkers = min(p.tiles, max(1, sms * per_sm / S));
  thermometer_encode_packed_kernel<<<dim3(walkers, S), kTileThreads, smem,
                                     (cudaStream_t)stream>>>(p);
  info[0] = walkers;
  info[1] = per_sm;
  return (int)cudaGetLastError();
}

// The rows kernel: the first design, for any F.
extern "C" int thermometer_encode_packed_rows_launch(const void* x,
                                                     const void* th, int B,
                                                     int F, int T, void* out,
                                                     void* stream) {
  if (B <= 0 || F <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const int W = (F * T + 31) / 32;
  const int chunks = (W + 31) / 32;
  const long long warps = (long long)B * chunks;
  const long long grid = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  thermometer_encode_packed_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, B, F, T, W, chunks, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* thermometer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
