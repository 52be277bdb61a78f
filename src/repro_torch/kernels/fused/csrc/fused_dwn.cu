// Fused DWN inference kernels for Hopper (sm_90a): features -> thermometer
// bits -> LUT layer(s) -> group popcount -> first argmax, one launch.
//
// Replaces the three fused Pallas TPU kernels:
//   * fused_dwn_kernel<n>       <- src/repro/kernels/fused/kernel.py
//     (+ fused_dwn_combine_kernel) fused_dwn (_fused_kernel)
//   * fused_tiles_kernel<false> <- src/repro/kernels/fused/kernel.py
//                                  fused_dwn_packed (_fused_packed_kernel)
//   * fused_tiles_kernel<true>  <- src/repro/kernels/fused/kernel.py
//                                  fused_dwn_batch_major (_fused_bm_kernel)
//
// fused_dwn_kernel, the float datapath: one layer of m LUTs with float32
// tables (m, 2^n), n <= 8.  Its bits come from its own compares, so they
// are exactly 0 or 1, and the reference's multilinear corner product then
// equals the table entry they address, for finite tables: the kernel
// reads tables[l, addr] and compares only the m*n wired bits (wire i =
// f*T + t is x[f] > th[f, t]), never all F*T.  LUT l counts for class
// l / g, g = m / C; LUTs from g*C on count for no class (the reference's
// one-hot class map has a zero row for them) and are not evaluated.  What
// bounds it on an H100: it moves 1.05 MB at lg width (x, thresholds,
// wires, f32 tables, counts) against 59 M wired compares, 9.8 M table
// reads and 9.8 M class adds at B=4096, so it is bound by operations.
// The design (the rows kernel re-reads the model per block of rows, with
// lanes over LUTs, conflicting table reads and a read-modify-write of a
// shared-memory sum per output):
//   * lanes are samples: a warp evaluates one LUT for 32 samples, so every
//     read of a wire (8 uint16 feature offsets, 8 thresholds: three
//     16-byte broadcasts) is one address for all lanes, x sits in shared
//     memory as [group][f][lane] and a lane's table read is tab[addr];
//   * the counted LUTs are cut into chunks (up to 32 LUTs of one class
//     group); a lane adds its sample's outputs of a chunk in LUT order in
//     a register and writes the chunk's sum to a scratch (chunks, B);
//     fused_dwn_combine_kernel, launched right after, adds each class's
//     chunk sums in chunk order and takes the first argmax.  The order of
//     every float sum is fixed by (m, C) alone, so the counts do not depend
//     on the layout, the batch or the run, and no atomics are needed;
//   * the f32 tables (614 KB at lg width) do not fit a block, so the
//     chunks are cut into slices (grid.y), whole class groups where one
//     fits (lg-2400: one group of 480 LUTs, 146 KB with its wires, a slice)
//     else pieces of one group; a block stages its slice once with cp.async
//     and walks tiles of 32*G samples (a persistent grid, the next tile's
//     features arriving while one is computed); below 132 tiles the
//     slices are cut narrower (down to one chunk) to fill the card;
//   * features too wide for two tiles in half a block (F > 454) take
//     fused_dwn_rows_kernel, the port's first float kernel, kept as it
//     was.
//
// fused_tiles_kernel, the two served kernels (packed: encode all F*T bits,
// then word-addressed layers; batch-major: the first layer compares only
// its m0*n wired bits).  Per sample the work is F*T compares (packed) or
// m0*n (batch-major), m*n one-bit selects per layer, one table read per
// LUT and C popcounts per 32 LUTs of the last layer; the bytes that must
// move are only x, the model (wires, one-bit-per-entry tables, thresholds,
// about 90-110 KB at lg-2400) and the (B, C) counts, so the kernels are
// bound by operations.  What the design does about it:
//   * the model is read once per block, not once per sample: each block
//     stages its part of it in shared memory with cp.async and keeps it
//     for every tile of samples it takes (a persistent grid);
//   * lanes are samples: a warp evaluates one LUT for 32 samples at once,
//     so every read of a wire, threshold, table or class mask is one
//     broadcast from shared memory, the same address for all lanes;
//   * activations live in shared memory as [word][lane] (word w of the
//     lane's sample at w*32 + lane), so reading wire i is one
//     conflict-free load, (act[(i & ~31) + lane] >> (i & 31)) & 1, and a
//     lane packs its 32 outputs of a word in a register with no ballot;
//   * a table of n <= 6 inputs is one or two words and a lane's output is
//     a shift of them; wider tables are read word by word; at n = 6 a
//     warp takes LUTs in pairs, whose wires and tables are 16-byte
//     broadcasts;
//   * the last layer's outputs never leave registers: each lane adds
//     popc(word & mask[c]) to its sample's count of class c in shared
//     memory (integer atomics, so the sums do not depend on the order);
//   * filling the card: a block takes block_b samples (rounded up to a
//     multiple of 32) at a time and its 16 warps split that tile's 32-LUT
//     words; when there are fewer tiles than SMs the last layer's words
//     are also split over S blocks (grid.y), each staging only its slice
//     of that layer, and each adds its partial counts to the output with
//     float atomics (integers below 2^24, so exact in any order); a small
//     kernel launched just before zeroes that output and the per-tile
//     arrival counters, and the last block of a tile to arrive takes the
//     first argmax;
//   * a model larger than shared memory: the last layer is cut into
//     slices (grid.y) as narrow as a block's shared memory needs; a model
//     that does not fit even so (every layer but the last whole, and one
//     32-LUT word of the last: a fan-in-16 table alone is 8 KB a LUT) is
//     read from global memory instead, the same broadcasts through the
//     read-only cache (kStaged = false).  The activations of 32 samples
//     must fit a block either way: the wrappers refuse wider layers.
// Tensor cores are not used: the work is compares, shifts and table
// selects; the TPU's one-hot matrix formulation would be thousands of
// times as many multiply-adds.
// Rows past B are never read or written (their lanes compute on zeros),
// LUTs past m are zero-table pad LUTs whose bits stay 0, and the pad bits
// of a ragged last thermometer word (F*T % 32 != 0) are 0.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tiles.cuh"

namespace {

constexpr int kMaxLayers = 8;        // == ref.MAX_LAYERS (word-addressed)
constexpr int kMaxStack = kMaxLayers + 1;  // batch-major: direct + rest
constexpr int kMaxFanIn = 16;        // == ref.MAX_FAN_IN
constexpr int kFloatMaxFanIn = 8;    // == kernel.FUSED_DWN_MAX_FAN_IN
constexpr int kThreads = 256;        // fused_dwn_rows_kernel: 8 warps
constexpr int kTileThreads = 512;    // the tile kernels: 16 warps
constexpr int kMaxSmem = 232448;     // dynamic shared memory of a block

// ---------------------------------------------------------------------------
// fused_tiles_kernel
// ---------------------------------------------------------------------------

struct Layer {
  int m, n, tw;           // LUTs (a multiple of 32), fan-in, table words
  const void* wires;      // (m, n): int32 bit indices into the previous
                          // layer's bits, or (direct layer) int16 features
  const float* wth;       // direct layer: (m, n) thresholds; else null
  const uint32_t* tab;    // (m, tw) one bit per entry
  int wires_s, wth_s, tab_s;  // byte offsets of the staged copies
};

// Everything a launch needs, built on the host (launch_tiles, layout).
struct Plan {
  const float* x;
  int B, F;
  const float* th;        // packed: (F, T) thresholds
  int T;
  int L;                  // layers; batch-major's layer 0 is direct-wire
  Layer layer[kMaxStack];
  const uint32_t* masks;  // (C, W_last) class masks
  int C, W_last;
  float* counts;          // (B, C); zeroed before the launch when S > 1
  int* idx;               // (B,)
  int* arrive;            // (tiles,) blocks done per tile, right after
                          // counts in memory; zeroed with them
  int G;                  // 32-sample groups per tile (block_b / 32)
  int tiles, S, ws;       // tiles; slices of the last layer, words each
  // shared-memory byte offsets: thresholds, class masks, two x buffers
  // ([g][f][lane], x_words floats each), two activation buffers
  // ([g][word][lane], buf_words words a group), class counts
  // ([g][c][lane]) and the last-arrival flag
  int th_s, mask_s, x_s, x_words, buf_s0, buf_s1, buf_words, cnt_s, flag_s;
};

// The features of tile t into xs as [g][f][lane]; rows past B are zeros.
// P: Plan (K1, K2) or FloatTiles (K6).
template <typename P>
__device__ void stage_x(const P& p, float* xs, int t) {
  const long long row0 = (long long)t * p.G * 32;
  const int n = p.G * 32 * p.F;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / p.F, f = e - r * p.F;
    float* d = xs + ((r >> 5) * p.F + f) * 32 + (r & 31);
    if (row0 + r < p.B)
      cp_async4(d, p.x + (row0 + r) * p.F + f);
    else
      *d = 0.0f;
  }
}

// Bit `i` of the lane's sample in activations laid out [word][lane]
// (act_lane = act + lane): one conflict-free load.
__device__ __forceinline__ uint32_t act_bit(const uint32_t* act_lane,
                                            uint32_t i) {
  return (act_lane[i & ~31u] >> (i & 31u)) & 1u;
}

// LUTs j0 .. j0 + span - 1 of a 32-LUT word of a word-addressed layer,
// for this lane's sample: bit j of the result is LUT j's output.  `act`
// is the group's activations ([word][lane]), `wires` and `tab` the
// word's first LUT (see model_ld).  Fan-in 6 (the JSC models') takes LUTs
// in pairs: their 12 wires are three 16-byte broadcasts and their tables
// one (j0 and span are even).
template <bool kStaged>
__device__ __forceinline__ uint32_t word_luts(const uint32_t* act,
                                              const int* wires,
                                              const uint32_t* tab, int n,
                                              int tw, int lane, int j0,
                                              int span) {
  const uint32_t* act_lane = act + lane;
  uint32_t out = 0;
  if (n == 6) {
#pragma unroll 2
    for (int j = j0; j < j0 + span; j += 2) {
      const int4* wp = reinterpret_cast<const int4*>(wires + j * 6);
      const int4 a = model_ld<kStaged>(wp), b = model_ld<kStaged>(wp + 1),
                 c = model_ld<kStaged>(wp + 2);
      const uint4 t =
          model_ld<kStaged>(reinterpret_cast<const uint4*>(tab + j * 2));
      const uint32_t addr0 =
          act_bit(act_lane, a.x) | act_bit(act_lane, a.y) << 1 |
          act_bit(act_lane, a.z) << 2 | act_bit(act_lane, a.w) << 3 |
          act_bit(act_lane, b.x) << 4 | act_bit(act_lane, b.y) << 5;
      const uint32_t addr1 =
          act_bit(act_lane, b.z) | act_bit(act_lane, b.w) << 1 |
          act_bit(act_lane, c.x) << 2 | act_bit(act_lane, c.y) << 3 |
          act_bit(act_lane, c.z) << 4 | act_bit(act_lane, c.w) << 5;
      out |= (table6(t.x, t.y, addr0) | table6(t.z, t.w, addr1) << 1) << j;
    }
    return out;
  }
  for (int j = j0; j < j0 + span; ++j) {
    const int* wl = wires + j * n;
    uint32_t addr = 0;
    for (int k = 0; k < n; ++k)
      addr |= act_bit(act_lane, static_cast<uint32_t>(
                                    model_ld<kStaged>(wl + k)))
              << k;
    out |= table_bit<kStaged>(tab + j * tw, n, addr) << j;
  }
  return out;
}

// LUTs j0 .. j0 + span - 1 of a 32-LUT word of the direct-wire first
// layer (batch-major): wire k of LUT j compares feature wf[j, k] of the
// lane's sample (xs: the group's [f][lane] features) with threshold
// wt[j, k].  Fan-in 6 takes LUTs in pairs: 12 feature indices in three
// 8-byte broadcasts, 12 thresholds in three 16-byte ones, two tables in
// one.
template <bool kStaged>
__device__ __forceinline__ uint32_t word_direct(const float* xs,
                                                const uint16_t* wf,
                                                const float* wt,
                                                const uint32_t* tab, int n,
                                                int tw, int lane, int j0,
                                                int span) {
  const float* x_lane = xs + lane;
  uint32_t out = 0;
  if (n == 6) {
#pragma unroll 2
    for (int j = j0; j < j0 + span; j += 2) {
      const uint2* fp = reinterpret_cast<const uint2*>(wf + j * 6);
      const float4* tp = reinterpret_cast<const float4*>(wt + j * 6);
      const uint2 f0 = model_ld<kStaged>(fp), f1 = model_ld<kStaged>(fp + 1),
                  f2 = model_ld<kStaged>(fp + 2);
      const float4 h0 = model_ld<kStaged>(tp), h1 = model_ld<kStaged>(tp + 1),
                   h2 = model_ld<kStaged>(tp + 2);
      const uint4 t =
          model_ld<kStaged>(reinterpret_cast<const uint4*>(tab + j * 2));
      const uint32_t f[12] = {f0.x & 0xffffu, f0.x >> 16, f0.y & 0xffffu,
                              f0.y >> 16,     f1.x & 0xffffu, f1.x >> 16,
                              f1.y & 0xffffu, f1.y >> 16,     f2.x & 0xffffu,
                              f2.x >> 16,     f2.y & 0xffffu, f2.y >> 16};
      const float h[12] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y,
                           h1.z, h1.w, h2.x, h2.y, h2.z, h2.w};
      uint32_t addr0 = 0, addr1 = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        addr0 |= static_cast<uint32_t>(x_lane[f[k] * 32] > h[k]) << k;
        addr1 |= static_cast<uint32_t>(x_lane[f[6 + k] * 32] > h[6 + k])
                 << k;
      }
      out |= (table6(t.x, t.y, addr0) | table6(t.z, t.w, addr1) << 1) << j;
    }
    return out;
  }
  for (int j = j0; j < j0 + span; ++j) {
    uint32_t addr = 0;
    for (int k = 0; k < n; ++k)
      addr |= static_cast<uint32_t>(
                  x_lane[model_ld<kStaged>(wf + j * n + k) * 32] >
                  model_ld<kStaged>(wt + j * n + k))
              << k;
    out |= table_bit<kStaged>(tab + j * tw, n, addr) << j;
  }
  return out;
}

// Packed encode of one tile: bit i = f*T + t of each sample is
// x[f] > th[i], written as [g][word][lane] into `act`.  A word's 32
// thresholds are read once (staged: eight 16-byte broadcasts, the staged
// thresholds padded to a whole word; else 32 broadcasts from global
// memory, none past F*T) and compared with each feature the word spans
// (one for most words when T >= 32), keeping the bits of that feature's
// run.
template <bool kStaged>
__device__ void encode_tile(const Plan& p, int G, const float* xs,
                            const float* th, uint32_t* act, int warp,
                            int nwarps, int lane) {
  const int FT = p.F * p.T, W0 = (FT + 31) >> 5;
  for (int it = warp; it < G * W0; it += nwarps) {
    const int g = it / W0, w = it - g * W0, i0 = w * 32;
    const float* xg = xs + g * p.F * 32 + lane;
    const int nb = min(32, FT - i0);
    float t[32];
    if constexpr (kStaged) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = reinterpret_cast<const float4*>(th + i0)[q];
        t[4 * q] = v.x;
        t[4 * q + 1] = v.y;
        t[4 * q + 2] = v.z;
        t[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) t[j] = j < nb ? __ldg(th + i0 + j) : 0.0f;
    }
    int f = i0 / p.T, j0 = 0;
    uint32_t acc = 0;
    while (j0 < nb) {
      const int j1 = min(nb, (f + 1) * p.T - i0);
      const float xf = xg[f * 32];
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) m |= static_cast<uint32_t>(xf > t[j]) << j;
      const uint32_t hi = j1 >= 32 ? kFull : (1u << j1) - 1u;
      acc |= m & hi & ~((1u << j0) - 1u);
      j0 = j1;
      ++f;
    }
    act[(g * p.buf_words + w) * 32 + lane] = acc;
  }
}

// Zeroes n ints: the split tiles' counts and arrival counters.
__global__ void zero_kernel(int* p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = 0;
}

// kStaged: the model (thresholds, every layer but the last, the block's
// slice of the last layer and its class masks) is staged in shared memory;
// else it is read from global memory, where it does not fit.
template <bool kDirect, bool kStaged>
__global__ void __launch_bounds__(kTileThreads)
    fused_tiles_kernel(const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's slice of the last layer: words [w0, w1)
  const int w0 = blockIdx.y * p.ws, w1 = min(p.W_last, w0 + p.ws);
  const int nws = w1 - w0;

  // the model, once per block
  if (kStaged) {
    if (!kDirect) stage(sm + p.th_s, p.th, p.F * p.T * 4);
    for (int l = 0; l < p.L; ++l) {
      const Layer& ly = p.layer[l];
      const bool last = l == p.L - 1, direct = kDirect && l == 0;
      const int a = last ? w0 : 0, luts = (last ? nws : ly.m >> 5) * 32;
      const int wb = direct ? 2 : 4;
      stage(sm + ly.wires_s,
            static_cast<const char*>(ly.wires) + (size_t)a * 32 * ly.n * wb,
            luts * ly.n * wb);
      if (direct)
        stage(sm + ly.wth_s, ly.wth + (size_t)a * 32 * ly.n,
              luts * ly.n * 4);
      stage(sm + ly.tab_s, ly.tab + (size_t)a * 32 * ly.tw,
            luts * ly.tw * 4);
    }
    for (int c = 0; c < p.C; ++c)
      stage(sm + p.mask_s + c * nws * 4,
            p.masks + (size_t)c * p.W_last + w0, nws * 4);
  }
  int t = blockIdx.x;
  float* xbuf = reinterpret_cast<float*>(sm + p.x_s);
  if (t < p.tiles) stage_x(p, xbuf, t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  int* cnt = reinterpret_cast<int*>(sm + p.cnt_s);
  // class mask c of the slice's word w at masks[c * mask_stride + w]
  const uint32_t* masks =
      kStaged ? reinterpret_cast<const uint32_t*>(sm + p.mask_s)
              : p.masks + w0;
  const int mask_stride = kStaged ? nws : p.W_last;
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(sm + p.buf_s0);
  uint32_t* buf1 = reinterpret_cast<uint32_t*>(sm + p.buf_s1);
  const float* th =
      kStaged ? reinterpret_cast<const float*>(sm + p.th_s) : p.th;
  const int bw = p.buf_words;
  for (int k = 0; t < p.tiles; t += gridDim.x, ++k) {
    const float* xs = xbuf + (k & 1) * p.x_words;
    const long long row0 = (long long)t * p.G * 32;
    const int rows = (int)min((long long)p.G * 32, p.B - row0);
    const int G = (rows + 31) >> 5;  // groups holding a row below B
    // the next tile's features arrive while this one is computed
    if (t + (int)gridDim.x < p.tiles)
      stage_x(p, xbuf + ((k + 1) & 1) * p.x_words, t + gridDim.x);
    cp_async_commit();
    for (int i = tid; i < G * p.C * 32; i += blockDim.x) cnt[i] = 0;
    if (!kDirect)
      encode_tile<kStaged>(p, G, xs, th, buf0, warp, nwarps, lane);
    __syncthreads();

    for (int l = 0; l < p.L; ++l) {
      const Layer& ly = p.layer[l];
      const bool last = l == p.L - 1, direct = kDirect && l == 0;
      const int a = last ? w0 : 0, nw = last ? nws : ly.m >> 5;
      const int in_b = kDirect ? (l + 1) & 1 : l & 1;
      const uint32_t* in = in_b ? buf1 : buf0;
      uint32_t* out = in_b ? buf0 : buf1;
      const int n = ly.n, tw = ly.tw;
      // the layer's (slice's) first wire and table word
      const char* wires =
          kStaged ? reinterpret_cast<const char*>(sm + ly.wires_s)
                  : static_cast<const char*>(ly.wires) +
                        (size_t)a * 32 * n * (direct ? 2 : 4);
      const uint32_t* tab0 =
          kStaged ? reinterpret_cast<const uint32_t*>(sm + ly.tab_s)
                  : ly.tab + (size_t)a * 32 * tw;
      // the last layer's words may be split into parts of 32 / parts
      // LUTs (an even number: fan-in 6 takes pairs), so that a slice of a
      // few words still gives every warp work
      int parts = 1;
      while (last && parts < 16 && G * nw * parts < nwarps) parts *= 2;
      const int span = 32 / parts;
      for (int it = warp; it < G * nw * parts; it += nwarps) {
        const int g = it / (nw * parts), r = it - g * nw * parts;
        const int rel = r / parts, j0 = (r - rel * parts) * span;
        const uint32_t* tab = tab0 + rel * 32 * tw;
        uint32_t word;
        if (direct) {
          const float* xg = xs + g * p.F * 32;
          const uint16_t* wf =
              reinterpret_cast<const uint16_t*>(wires) + rel * 32 * n;
          const float* wt =
              (kStaged ? reinterpret_cast<const float*>(sm + ly.wth_s)
                       : ly.wth + (size_t)a * 32 * n) +
              rel * 32 * n;
          word = word_direct<kStaged>(xg, wf, wt, tab, n, tw, lane, j0, span);
        } else {
          const uint32_t* act = in + g * bw * 32;
          const int* wi = reinterpret_cast<const int*>(wires) + rel * 32 * n;
          word = word_luts<kStaged>(act, wi, tab, n, tw, lane, j0, span);
        }
        if (last) {
          for (int c = 0; c < p.C; ++c) {
            const int v = __popc(
                word & model_ld<kStaged>(masks + c * mask_stride + rel));
            if (v) atomicAdd(cnt + (g * p.C + c) * 32 + lane, v);
          }
        } else {
          out[(g * bw + a + rel) * 32 + lane] = word;
        }
      }
      __syncthreads();
    }

    // counts and the first argmax (ties keep the lower class)
    if (p.S == 1) {
      for (int r = tid; r < rows; r += blockDim.x) {
        const int* cr = cnt + (r >> 5) * p.C * 32 + (r & 31);
        int best = -1, best_c = 0;
        for (int c = 0; c < p.C; ++c) {
          const int v = cr[c * 32];
          p.counts[(row0 + r) * p.C + c] = (float)v;
          if (v > best) {
            best = v;
            best_c = c;
          }
        }
        p.idx[row0 + r] = best_c;
      }
    } else {
      int* flag = reinterpret_cast<int*>(sm + p.flag_s);
      for (int r = tid; r < rows; r += blockDim.x) {
        const int* cr = cnt + (r >> 5) * p.C * 32 + (r & 31);
        for (int c = 0; c < p.C; ++c)
          if (cr[c * 32]) atomicAdd(p.counts + (row0 + r) * p.C + c,
                                    (float)cr[c * 32]);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) *flag = atomicAdd(p.arrive + t, 1) == p.S - 1;
      __syncthreads();
      if (*flag) {
        __threadfence();
        for (int r = tid; r < rows; r += blockDim.x) {
          float best = -1.0f;
          int best_c = 0;
          for (int c = 0; c < p.C; ++c) {
            const float v = __ldcg(p.counts + (row0 + r) * p.C + c);
            if (v > best) {
              best = v;
              best_c = c;
            }
          }
          p.idx[row0 + r] = best_c;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// fused_dwn_rows_kernel: the first float kernel, kept for features too wide
// for fused_dwn_kernel's tiles of 32 samples
// ---------------------------------------------------------------------------

// Shared memory of fused_dwn_rows_kernel, in floats: one tile's tables
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
__global__ void __launch_bounds__(kThreads) fused_dwn_rows_kernel(
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
      int wf[kFloatMaxFanIn];
      float wt[kFloatMaxFanIn];
#pragma unroll
      for (int k = 0; k < kFloatMaxFanIn; ++k) {
        wf[k] = k < n ? wf_s[k * block_m + j] : 0;
        wt[k] = k < n ? wt_s[k * block_m + j] : 0.0f;
      }
      const float* tl = tab_s + (size_t)j * A;
      float* pl = part_s + (t0 + j) / g * 32 + lane;
      for (int r = warp; r < rows; r += nwarps) {
        const float* xr = x_s + r * F;
        uint32_t addr = 0;
#pragma unroll
        for (int k = 0; k < kFloatMaxFanIn; ++k)
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

// ---------------------------------------------------------------------------
// fused_dwn_kernel (K6) and fused_dwn_combine_kernel
// ---------------------------------------------------------------------------

// The counted LUTs (the first g*C) are cut into chunks: up to 32
// consecutive LUTs of one class group, the unit whose outputs one lane
// adds in LUT order.  Class c's chunks are c*cpc .. c*cpc + cpc - 1, and
// its chunk k holds LUTs c*g + 32k .. min(c*g + 32k + 32, (c + 1)*g) - 1.
// Slice s of a launch (grid.y) is piece s % ppc, of cs chunks, of unit
// s / ppc, which holds chunks [u*ucs, u*ucs + ucs): whole class groups
// (ppc = 1) or one group cut into pieces (ucs = cpc).
struct FloatTiles {
  const float* x;        // (B, F)
  const float* th;       // (F, T)
  const int* mapping;    // (m, n) wire indices f*T + t
  const float* tables;   // (m, 2^n)
  float* part;           // (nchunks, B): each chunk's sum per sample
  int B, F, T;
  int g, cpc, nchunks;   // LUTs of a class group, chunks of one, chunks
  int G, tiles;          // 32-sample groups per tile; tiles
  int ucs, ppc, cs;      // slices (above)
};

// A LUT's staged wires: 8 uint16 feature offsets f*32 into the group's
// [f][lane] features, then 8 float thresholds (slots past n unused).
constexpr int kWireBytes = 48;

// Shared memory of fused_dwn_kernel: the slice's tables ([cs*32][2^n]
// floats, first, 16-byte aligned for the vector copy), its wires
// ([cs*32][kWireBytes]) and two feature buffers ([G][F][32] floats).
__host__ __device__ size_t fused_dwn_tiles_smem(int F, int n, int G,
                                                int cs) {
  return (size_t)cs * 32 * ((4 << n) + kWireBytes) + 2 * (size_t)G * F * 128;
}

template <int N>
__global__ void __launch_bounds__(kTileThreads)
    fused_dwn_kernel(const __grid_constant__ FloatTiles p) {
  constexpr int A = 1 << N;
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's slice: chunks [c0, c0 + nc)
  const int u = blockIdx.y / p.ppc;
  const int u1 = min(p.nchunks, (u + 1) * p.ucs);
  const int c0 = u * p.ucs + (blockIdx.y - u * p.ppc) * p.cs;
  const int nc = max(0, min(u1, c0 + p.cs) - c0);
  float* tab_s = reinterpret_cast<float*>(sm);
  unsigned char* wire_s = sm + (size_t)p.cs * 32 * A * 4;
  float* xbuf =
      reinterpret_cast<float*>(wire_s + (size_t)p.cs * 32 * kWireBytes);
  const int x_words = p.G * p.F * 32;

  // the slice, once per block: tables copied, wires turned into feature
  // offsets and thresholds
  for (int q = 0; q < nc; ++q) {
    const int c = (c0 + q) / p.cpc, k = c0 + q - c * p.cpc;
    stage(tab_s + q * 32 * A, p.tables + (size_t)(c * p.g + 32 * k) * A,
          min(32, p.g - 32 * k) * A * 4);
  }
  for (int i = tid; i < nc * 256; i += blockDim.x) {
    const int q = i >> 8, j = (i >> 3) & 31, b = i & 7;
    const int c = (c0 + q) / p.cpc, k = c0 + q - c * p.cpc;
    uint16_t off = 0;
    float th = 0.0f;
    if (b < N && 32 * k + j < p.g) {
      const int wire =
          __ldg(p.mapping + (size_t)(c * p.g + 32 * k + j) * N + b);
      off = static_cast<uint16_t>(wire / p.T * 32);
      th = __ldg(p.th + wire);
    }
    unsigned char* w = wire_s + (q * 32 + j) * kWireBytes;
    reinterpret_cast<uint16_t*>(w)[b] = off;
    reinterpret_cast<float*>(w + 16)[b] = th;
  }
  int t = blockIdx.x;
  if (t < p.tiles) stage_x(p, xbuf, t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int it = 0; t < p.tiles; t += gridDim.x, ++it) {
    const float* xs = xbuf + (it & 1) * x_words;
    const long long row0 = (long long)t * p.G * 32;
    const int G = (int)min((long long)p.G, (p.B - row0 + 31) / 32);
    // the next tile's features arrive while this one is computed
    if (t + (int)gridDim.x < p.tiles)
      stage_x(p, xbuf + ((it + 1) & 1) * x_words, t + gridDim.x);
    cp_async_commit();
    // a warp takes one chunk of one group: its lanes' 32 samples
    for (int item = warp; item < G * nc; item += nwarps) {
      const int grp = item / nc, q = item - grp * nc;
      const int k = (c0 + q) % p.cpc;
      const int cnt = min(32, p.g - 32 * k);
      const float* x_lane = xs + grp * p.F * 32 + lane;
      const unsigned char* w = wire_s + q * 32 * kWireBytes;
      const float* tb = tab_s + q * 32 * A;
      float acc = 0.0f;
      for (int j = 0; j < cnt; ++j, w += kWireBytes, tb += A) {
        const uint4 o = *reinterpret_cast<const uint4*>(w);
        const float4 h0 = *reinterpret_cast<const float4*>(w + 16);
        const float4 h1 = N > 4 ? *reinterpret_cast<const float4*>(w + 32)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const uint32_t off[8] = {o.x & 0xffffu, o.x >> 16, o.y & 0xffffu,
                                 o.y >> 16,     o.z & 0xffffu, o.z >> 16,
                                 o.w & 0xffffu, o.w >> 16};
        const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        uint32_t addr = 0;
#pragma unroll
        for (int b = 0; b < N; ++b)
          addr |= static_cast<uint32_t>(x_lane[off[b]] > h[b]) << b;
        acc += tb[addr];
      }
      const long long row = row0 + grp * 32 + lane;
      if (row < p.B) p.part[(size_t)(c0 + q) * p.B + row] = acc;
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// counts[r, c]: the sum of class c's chunk sums in chunk order; idx[r]:
// the first argmax (ties keep the lower class).  A block takes 32 rows
// (lanes) and its warps split the classes, so that a row's loads are in
// flight together; after the barrier the first warp reads the block's
// counts back and takes the argmax.
constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads)
    fused_dwn_combine_kernel(const float* __restrict__ part, int B, int C,
                             int cpc, float* __restrict__ counts,
                             int* __restrict__ idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * 32 + lane;
  if (r < B) {
    for (int c = warp; c < C; c += kCombineThreads / 32) {
      const float* pc = part + (size_t)c * cpc * B + r;
      float s = 0.0f;
#pragma unroll 8
      for (int k = 0; k < cpc; ++k) s += __ldg(pc + (size_t)k * B);
      counts[r * C + c] = s;
    }
  }
  __syncthreads();
  if (warp == 0 && r < B) {
    float best = 0.0f;
    int best_c = 0;
    for (int c = 0; c < C; ++c) {
      const float s = counts[r * C + c];
      if (c == 0 || s > best) {
        best = s;
        best_c = c;
      }
    }
    idx[r] = best_c;
  }
}

template <int N>
cudaError_t launch_fused_dwn(const FloatTiles& p, int S, int C, int sms,
                             int plan_smem, float* counts, int* idx,
                             cudaStream_t stream, int* info) {
  // the caller planned the layout (kernel.py: plan_fused_dwn); its byte
  // total must be this layout's
  const size_t smem = fused_dwn_tiles_smem(p.F, N, p.G, p.cs);
  if (smem != (size_t)plan_smem || smem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = prepare_smem(fused_dwn_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_dwn_kernel<N>, kTileThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid: each slice's tiles walked by as many blocks as
  // the card holds beside the other slices'
  const int walkers = min(p.tiles, max(1, sms * per_sm / S));
  fused_dwn_kernel<N><<<dim3(walkers, S), kTileThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_dwn_combine_kernel<<<(p.B + 31) / 32, kCombineThreads, 0, stream>>>(
      p.part, p.B, C, p.cpc, counts, idx);
  info[0] = walkers;
  info[1] = per_sm;
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// meta: L rows of (m, n, wire offset, table offset, table words) of the
// word-addressed layers; they go to p->layer[first..].
cudaError_t fill_layers(Plan* p, int first, const int* meta, int num_layers,
                        const void* wires, const void* tab) {
  if (num_layers < 0 || num_layers > kMaxLayers) return cudaErrorInvalidValue;
  for (int L = 0; L < num_layers; ++L) {
    Layer& ly = p->layer[first + L];
    ly.m = meta[5 * L + 0];
    ly.n = meta[5 * L + 1];
    ly.tw = meta[5 * L + 4];
    ly.wires = static_cast<const int*>(wires) + meta[5 * L + 2];
    ly.wth = nullptr;
    ly.tab = static_cast<const uint32_t*>(tab) + meta[5 * L + 3];
    if (ly.m <= 0 || ly.m % 32 || ly.n < 1 || ly.n > kMaxFanIn)
      return cudaErrorInvalidValue;
  }
  p->L = first + num_layers;
  return cudaSuccess;
}

// The shared-memory layout of a block whose slice of the last layer is
// p.ws words, with the model (staged) or without it; returns its bytes.
template <bool kDirect>
size_t layout(Plan& p, bool staged) {
  size_t off = 0;
  p.th_s = 0;
  // thresholds, padded to a whole word for the encode's 16-byte reads
  if (staged && !kDirect) off = (size_t)(p.F * p.T + 31) / 32 * 128;
  int bw = kDirect ? 0 : (p.F * p.T + 31) / 32;
  for (int l = 0; l < p.L; ++l) {
    Layer& ly = p.layer[l];
    const bool last = l == p.L - 1, direct = kDirect && l == 0;
    if (!last) bw = max(bw, ly.m / 32);
    if (!staged) continue;
    const size_t luts = (size_t)(last ? p.ws : ly.m / 32) * 32;
    ly.wires_s = (int)off;
    off = align16(off + luts * ly.n * (direct ? 2 : 4));
    ly.wth_s = (int)off;
    if (direct) off = align16(off + luts * ly.n * 4);
    ly.tab_s = (int)off;
    off = align16(off + luts * ly.tw * 4);
  }
  p.mask_s = (int)off;
  if (staged) off = align16(off + (size_t)p.C * p.ws * 4);
  p.x_s = (int)off;
  p.x_words = p.G * p.F * 32;
  off = align16(off + 2 * (size_t)p.x_words * 4);
  // activation buffers: the packed encode and every layer's output but
  // the last's, alternating between two
  const int outputs = kDirect ? p.L - 1 : p.L;
  p.buf_words = bw;
  p.buf_s0 = (int)off;
  if (outputs >= 1) off += (size_t)p.G * bw * 32 * 4;
  p.buf_s1 = (int)off;
  if (outputs >= 2) off += (size_t)p.G * bw * 32 * 4;
  p.cnt_s = (int)off;
  off += (size_t)p.G * p.C * 32 * 4;
  p.flag_s = (int)off;
  return off + 16;
}

// Where a launch keeps the model, and its tile.  Staged if the model fits
// a block's shared memory beside a tile of 32 samples, the last layer cut
// into the widest slices of p.ws words that fit if it must be; else the
// model is read from global memory.  Then the tile: block_b samples
// rounded up to a multiple of 32 (p.G groups), no more groups than B
// fills, and down to the most that fit.  False if not even a tile of 32
// samples fits (activations too wide: the wrappers refuse those first).
template <bool kDirect>
bool fit(Plan& p, int block_b, bool* staged) {
  const auto fits = [&](bool st) {
    return layout<kDirect>(p, st) <= (size_t)kMaxSmem;
  };
  p.G = 1;
  p.ws = p.W_last;
  *staged = true;
  if (!fits(true)) {
    int lo = 0, hi = p.W_last;  // fits(lo) or lo == 0; !fits(hi)
    while (hi - lo > 1) {
      p.ws = (lo + hi) / 2;
      (fits(true) ? lo : hi) = p.ws;
    }
    *staged = lo > 0;
    p.ws = *staged ? lo : p.W_last;
  }
  if (!fits(*staged)) return false;
  // shared memory grows by the same bytes with each group
  const size_t one = layout<kDirect>(p, *staged);
  p.G = 2;
  const size_t per_group = layout<kDirect>(p, *staged) - one;
  const long long want =
      min((long long)(block_b + 31) / 32, (p.B + 31LL) / 32);
  p.G = (int)max(1LL, min(want, 1 + (long long)((kMaxSmem - one) /
                                                   per_group)));
  return fits(*staged);
}

// Tiles, slices and the shared-memory layout of one launch; then the
// launch itself on `stream`.  info: whether the zero kernel was launched
// first, whether the model was staged, slices per tile, samples per tile,
// dynamic shared memory in bytes.
template <bool kDirect>
cudaError_t launch_tiles(Plan& p, int block_b, cudaStream_t stream,
                         int* info) {
  if (p.B <= 0 || p.F <= 0 || p.C <= 0 || block_b <= 0 || p.L < 1 ||
      p.layer[p.L - 1].m != 32 * p.W_last)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  bool staged = true;
  if (!fit<kDirect>(p, block_b, &staged)) return cudaErrorInvalidValue;
  const int fit_ws = p.ws;
  p.tiles = (int)((p.B + 32LL * p.G - 1) / (32LL * p.G));
  auto kernel = staged ? fused_tiles_kernel<kDirect, true>
                       : fused_tiles_kernel<kDirect, false>;
  // fewer tiles than SMs: split the last layer's words over S blocks per
  // tile (one block an SM: a second block per SM that repeats the
  // tile's encode and adds its counts through global atomics was
  // slower); and never slices wider than fit
  p.S = p.tiles >= sms ? 1
                       : max(1, min(p.W_last, (sms + p.tiles / 2) / p.tiles));
  p.S = max(p.S, (p.W_last + fit_ws - 1) / fit_ws);
  p.ws = (p.W_last + p.S - 1) / p.S;
  p.S = (p.W_last + p.ws - 1) / p.ws;
  if (p.S > 65535) return cudaErrorInvalidValue;  // grid.y
  const size_t smem = layout<kDirect>(p, staged);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTileThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // blocks that split a tile add into counts and count their arrival:
  // both zeroed first by one small kernel (the caller allocates arrive
  // right after counts; in a CUDA graph a kernel node was cheaper than a
  // memset node)
  if (p.S > 1) {
    const int n = p.B * p.C + p.tiles;
    zero_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<int*>(p.counts), n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  info[0] = p.S > 1;
  info[1] = staged;
  info[2] = p.S;
  info[3] = 32 * p.G;
  info[4] = (int)smem;
  // a persistent grid: at most as many tile walkers as fit on the card
  const int walkers = p.S > 1 ? p.tiles : min(p.tiles, sms * per_sm);
  kernel<<<dim3(walkers, p.S), kTileThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_dwn_rows_launch(const void* x, const void* th, int B,
                                     int F, int T, const void* mapping,
                                     const void* tables, int m, int n,
                                     int C, void* counts, void* idx,
                                     int block_b, int block_m,
                                     void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || m <= 0 || n < 1 || n > kFloatMaxFanIn ||
      C <= 0 ||
      block_b <= 0 || block_m <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * fused_dwn_smem_floats(F, C, n, block_b, block_m);
  const cudaError_t err = prepare_smem(fused_dwn_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = n >= 2 && (uintptr_t)tables % 16 == 0;
  const int grid = (B + block_b - 1) / block_b;
  fused_dwn_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)th, B, F, T, (const int*)mapping,
      (const float*)tables, m, n, C, m / C, (float*)counts, (int*)idx,
      block_b, block_m, vec4);
  return (int)cudaGetLastError();
}

// K6 on tiles of 32*G samples: the fused kernel over S slices of the
// counted LUTs (ucs, ppc, cs as in FloatTiles), then the combine kernel,
// on a card of sms SMs; smem: the plan's dynamic shared memory in bytes.
// part: (C * ceil((m / C) / 32), B) floats of scratch.  info: walkers
// (grid.x), blocks an SM holds.
extern "C" int fused_dwn_launch(const void* x, const void* th, int B, int F,
                                int T, const void* mapping,
                                const void* tables, int m, int n, int C,
                                void* part, void* counts, void* idx, int G,
                                int ucs, int ppc, int cs, int S, int sms,
                                int smem, int* info, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || m <= 0 || n < 1 || n > kFloatMaxFanIn ||
      C <= 0 || G < 1 || ucs < 1 || ppc < 1 || cs < 1 || S < 1 ||
      sms < 1 || F * 32 > 0xffff)
    return (int)cudaErrorInvalidValue;
  FloatTiles p = {};
  p.x = static_cast<const float*>(x);
  p.th = static_cast<const float*>(th);
  p.mapping = static_cast<const int*>(mapping);
  p.tables = static_cast<const float*>(tables);
  p.part = static_cast<float*>(part);
  p.B = B;
  p.F = F;
  p.T = T;
  p.g = m / C;
  p.cpc = (p.g + 31) / 32;
  p.nchunks = C * p.cpc;
  p.G = G;
  p.tiles = (int)((B + 32LL * G - 1) / (32LL * G));
  p.ucs = ucs;
  p.ppc = ppc;
  p.cs = cs;
  // the slices must cover every chunk, each piece within its unit
  const long long units = (p.nchunks + ucs - 1) / ucs;
  if ((long long)cs * ppc < ucs || (ppc > 1 && cs > ucs) ||
      S != max(1LL, units * ppc) || S > 65535)
    return (int)cudaErrorInvalidValue;
  float* c = static_cast<float*>(counts);
  int* i = static_cast<int*>(idx);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 1:
      return (int)launch_fused_dwn<1>(p, S, C, sms, smem, c, i, st, info);
    case 2:
      return (int)launch_fused_dwn<2>(p, S, C, sms, smem, c, i, st, info);
    case 3:
      return (int)launch_fused_dwn<3>(p, S, C, sms, smem, c, i, st, info);
    case 4:
      return (int)launch_fused_dwn<4>(p, S, C, sms, smem, c, i, st, info);
    case 5:
      return (int)launch_fused_dwn<5>(p, S, C, sms, smem, c, i, st, info);
    case 6:
      return (int)launch_fused_dwn<6>(p, S, C, sms, smem, c, i, st, info);
    case 7:
      return (int)launch_fused_dwn<7>(p, S, C, sms, smem, c, i, st, info);
    default:
      return (int)launch_fused_dwn<8>(p, S, C, sms, smem, c, i, st, info);
  }
}

extern "C" int fused_dwn_packed_launch(
    const void* x, const void* th, int B, int F, int T, const int* meta,
    int num_layers, const void* wires, const void* tab, const void* masks,
    int C, int W_last, void* counts, void* idx, void* arrive, int block_b,
    int* info, void* stream) {
  Plan p = {};
  p.x = static_cast<const float*>(x);
  p.B = B;
  p.F = F;
  p.th = static_cast<const float*>(th);
  p.T = T;
  cudaError_t err = fill_layers(&p, 0, meta, num_layers, wires, tab);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0) return (int)cudaErrorInvalidValue;
  p.masks = static_cast<const uint32_t*>(masks);
  p.C = C;
  p.W_last = W_last;
  p.counts = static_cast<float*>(counts);
  p.idx = static_cast<int*>(idx);
  p.arrive = static_cast<int*>(arrive);
  if (p.arrive != reinterpret_cast<int*>(p.counts) + (size_t)B * C)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tiles<false>(p, block_b, (cudaStream_t)stream, info);
}

extern "C" int fused_dwn_batch_major_launch(
    const void* x, int B, int F, const void* wire_f, const void* wire_th,
    const void* tab0, int m0, int n0, int tw0, const int* meta,
    int num_layers, const void* wires, const void* tab, const void* masks,
    int C, int W_last, void* counts, void* idx, void* arrive, int block_b,
    int* info, void* stream) {
  if (m0 <= 0 || m0 % 32 || n0 < 1 || n0 > kMaxFanIn)
    return (int)cudaErrorInvalidValue;
  Plan p = {};
  p.x = static_cast<const float*>(x);
  p.B = B;
  p.F = F;
  Layer& first = p.layer[0];
  first.m = m0;
  first.n = n0;
  first.tw = tw0;
  first.wires = wire_f;
  first.wth = static_cast<const float*>(wire_th);
  first.tab = static_cast<const uint32_t*>(tab0);
  cudaError_t err = fill_layers(&p, 1, meta, num_layers, wires, tab);
  if (err != cudaSuccess) return (int)err;
  p.masks = static_cast<const uint32_t*>(masks);
  p.C = C;
  p.W_last = W_last;
  p.counts = static_cast<float*>(counts);
  p.idx = static_cast<int*>(idx);
  p.arrive = static_cast<int*>(arrive);
  if (p.arrive != reinterpret_cast<int*>(p.counts) + (size_t)B * C)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tiles<true>(p, block_b, (cudaStream_t)stream, info);
}

// fused_dwn's combine kernel on its own: part (C * cpc, B) chunk sums ->
// counts (B, C), idx (B,).
extern "C" int fused_dwn_combine_launch(const void* part, int B, int C,
                                        int cpc, void* counts, void* idx,
                                        void* stream) {
  if (B <= 0 || C <= 0 || cpc < 0) return (int)cudaErrorInvalidValue;
  fused_dwn_combine_kernel<<<(B + 31) / 32, kCombineThreads, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const float*>(part), B, C, cpc, static_cast<float*>(counts),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// The zero kernel of a split launch on its own: n ints at p zeroed.
extern "C" int fused_dwn_zero_launch(void* p, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  zero_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<int*>(p), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_dwn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
