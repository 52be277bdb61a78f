// LUT-layer evaluation for Hopper (sm_90a): one layer of LUTs on float32
// bits (lut_eval_tiles_kernel, and lut_eval_rows_kernel for rows its
// tiles do not take) or on packed bits (lut_eval_packed_kernel, and
// lut_eval_packed_rows_kernel and lut_eval_packed_block_kernel for shapes
// its tiles do not take).
//
// Replaces the Pallas TPU kernels
//   lut_eval        <- src/repro/kernels/lut_eval/kernel.py (_lut_eval_kernel)
//   lut_eval_packed <- src/repro/kernels/lut_eval/kernel.py
//                      (_lut_eval_packed_kernel)
//
// lut_eval_tiles_kernel.  With s_i = bits[b, mapping[l, i]] (i < n), LUT
// l of row b outputs the multilinear function of its inputs,
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
// What bounds it on an H100: per (row, LUT) 2^n - 1 lerps, each an FMA,
// and a subtraction for each lerp above the lowest level (the lowest
// level's 2^(n-1) differences are of table entries alone, once per LUT):
// 94 float instructions at n = 6, with n gathers.  At lg width (C=3200,
// m=2400) and B=4096 that is 0.98 G instructions, 0.029 ms at the issue
// rate, against 92.4 MB (0.028 ms), so it is bound by operations.  The
// first design (lanes over LUTs, 8 rows a block, two blocks an SM at 128
// registers) ran at 0.094 ms: with its table loads replaced by constants
// it took 0.056, with the lerps alone 0.041, and with every LUT reading
// one of 64 tables that sit in L1 still 0.090 (a scratch A/B on the
// card): a table load's latency, one per corner in the lerp chain, set
// its pace, not L2's bandwidth.  The design:
//   * a tile is 16 rows, staged with 16-byte cp.async copies (205 KB at
//     lg width, one block an SM, so a thread may hold 255 registers);
//   * lanes are LUTs and a thread evaluates its LUT for 8 rows; two warps
//     share each 32 LUTs, one for each half of the tile, so a table entry
//     is loaded once for 8 rows and leaves L2 once per 16 rows (the second
//     warp finds it in L1), half what the first design read;
//   * the table loads (coalesced, 128 bytes a warp) run ahead of the
//     lerps: a pass's upper 32 corners load while its lower 32 fold, the
//     next pass's lower 32 and wires while its upper ones fold; they
//     carry an L2 evict-last policy and the outputs are streaming stores,
//     so that the 614 KB of tables stay in L2 while 92 MB of rows and
//     outputs pass;
//   * a persistent grid walks the tiles, the next tile's rows prefetched
//     into L2, and no barrier falls inside a tile's walk over its LUTs,
//     128 a pass (19 passes at m = 2400, the last three-quarters full);
//     below 132 tiles the passes are split over slices (grid.y);
//   * rows too wide for a tile (C > 3632) take lut_eval_rows_kernel, the
//     first design, kept as it was;
//   * fan-in 9 to 16 (tables of 2 KB to 256 KB a LUT, corner-major), and
//     rows past the rows kernel's 58,112 bits, take lut_eval_wide_kernel:
//     a thread a LUT, kWideRows rows a thread read straight from global
//     memory, the fan-in a run-time argument (one instance for each
//     corner block of 2^LOGH, LOGH = min(n, 5), not one per fan-in), the
//     same lerps in the same order, and the tables and wires loaded with
//     the evict-last policy.
// It runs at 3.0x the bound: beside 784 float instructions for 8 rows of
// a LUT at n = 6 it issues about 650 others, mostly the corner-major
// table's loads (one per corner and thread) and their addresses.
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
// operations, so it is bound by operations.  The design is one
// word-addressed layer of fused_dwn.cu's tile kernel (the rows kernel has
// one warp a sample with lanes over LUTs, re-reading the wires and tables
// for every sample through L1/L2 and packing each word with a ballot):
//   * the layer is staged once per block in shared memory (tables with
//     cp.async; each wire's word and bit made one 16-bit wire, w << 7 |
//     ((b - k) & 31), while staging) and kept for every tile of 32
//     samples the block takes (a persistent grid, the next tile's words
//     arriving while one is computed);
//   * lanes are samples: input words sit as [word][lane], so a wire is one
//     conflict-free load, a funnel shift that brings its bit to place k
//     and an and-or (wire_bit); every read of the layer is a broadcast,
//     and at n = 6 LUTs go in pairs (three 8-byte and one 16-byte
//     broadcast); a lane packs its 32 outputs of a word in a register;
//   * the tile's words go back through a padded shared [word][33] tile,
//     so that a warp's stores are whole rows, coalesced;
//   * below 132 tiles the layer's words are split over slices (grid.y),
//     and a slice of few words over parts of a word (OR-ed in shared
//     memory), to fill the card;
//   * rows too wide for two tiles in half a block (W_in > 454 words) and
//     layers whose 32-LUT word fits no block (fan-in 16) take
//     lut_eval_packed_rows_kernel, the port's first packed kernel, kept
//     as it was; rows past its 7264 words (8 warps' rows in a block) take
//     lut_eval_packed_block_kernel, below, and rows past the 58,112 words
//     one block stages the first kernel reading each row from global
//     memory (kStagedRow = false).
//
// lut_eval_packed_block_kernel.  The same function on rows past 7264
// words (F = 16 at T = 16,384 after K3: 8192 words).  What bounds it: the
// rows' bytes, 134 MB at B = 4096 (0.0405 ms at 3.35 TB/s), against 59 M
// random 4-byte reads of them; the first kernel on such rows (one warp a
// sample reading its row word by word from global memory, its 8 warps'
// rows 256 KB, past L1) took 1.31 ms, each row fetched as 32-byte sectors
// for 4 useful bytes and every LUT's wires and table reloaded a sample.
// The design:
//   * a block stages R rows with 16-byte cp.async copies, each row's
//     bytes leaving device memory once: as many as fit, cap = 227 KB /
//     (4 W_in); from two on in two groups of cap / 2 rows (R = 6 at 8192
//     words), one arriving while the other is evaluated, a persistent
//     grid walking the groups; one row a group up to 58,112 words;
//   * lanes are LUTs, 32 a warp (one output word), and a thread evaluates
//     its LUT on every row of the group: a wire is one shared-memory read
//     at a random word (about 3.5-way bank conflicts across 32 lanes, 25
//     us of wavefronts on 132 SMs at B = 4096), a funnel shift and an
//     and-or, each wire kept as one 32-bit value, word << 7 | ((bit - k)
//     & 31);
//   * up to fan-in 6 and 5 words a warp (m <= 2560), each warp's wires
//     and table words sit in registers for the whole launch (126
//     registers, one block an SM), loaded once a block; otherwise they are
//     loaded for every group through L1;
//   * a ballot a row packs each output word; a layer of fewer words than
//     the block's 16 warps splits each word's rows over warps.
// At K4_WIDE (B = 4096, 2400 LUT6) on an NVIDIA H100 80GB HBM3 at 700 W,
// in CUDA graphs, in turns (scripts/k4_block_rows.py): two groups of 3
// rows 0.0552-0.0553 ms (kept; 1.36x the bound), of 2 rows 0.0571-0.0573,
// of 1 row 0.0766-0.0770; one group of 7 rows 0.0754, of 4 rows
// 0.0689-0.0691, of 1 row 0.0977; the first kernel 1.321.
//
// Interface: plain C functions (loaded with ctypes) that launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tiles.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps (float; packed rows: a sample each)
constexpr int kTileThreads = 512;  // lut_eval_packed_kernel: 16 warps
constexpr int kMaxSmem = 232448;   // dynamic shared memory of a block
constexpr int kRows = 8;       // float rows kernel: rows one block stages
constexpr int kMaxFanIn = 8;   // float tiles and rows: 2^8 corners at most
constexpr int kWideMaxFanIn = 16;  // float wide kernel (== ref.MAX_FAN_IN)
constexpr int kWideRows = 4;       // float wide kernel: rows a thread
constexpr int kFloatTileRows = 16;  // float tiles: rows of a tile
constexpr int kPassLuts = 128;  // float tiles: LUTs of a pass (4 warps' lanes)
constexpr int kLutRows = 8;     // float tiles: rows a thread evaluates
// float tiles: the tile's row groups, and a block's threads
constexpr int kRowGroups = kFloatTileRows / kLutRows;
constexpr int kFloatThreads = kPassLuts * kRowGroups;

// The first float design, kept for rows too wide for a tile: a block
// stages rows_per_block (<= kRows) rows in shared memory and thread t
// evaluates LUT l = t, t + kThreads, ... for all of them, loading each
// table entry once per block from global memory (corner-major, so lanes
// read neighbouring LUTs); the last block may hold fewer rows.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) lut_eval_rows_kernel(
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
cudaError_t launch_lut_eval_rows(const float* bits, int B, int C,
                                 const int* mapping, const float* tab_t,
                                 int m, int rows_per_block, float* out,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)rows_per_block * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lut_eval_rows_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + rows_per_block - 1) / rows_per_block;
  lut_eval_rows_kernel<N><<<grid, kThreads, smem, stream>>>(
      bits, B, C, mapping, tab_t, m, rows_per_block, out);
  return cudaGetLastError();
}

// lut_eval_tiles_kernel: tiles of kFloatTileRows rows, the layer's
// passes of kPassLuts LUTs split into slices of cps passes (grid.y).
struct FloatTiles {
  const float* bits;   // (B, C)
  const int* mapping;  // (m, n) wire indices
  const float* tab_t;  // (2^n, m) tables, corner-major
  float* out;          // (B, m)
  int B, C, m;
  int tiles, cps;      // tiles of kFloatTileRows; passes per slice
};

// A tile's row pitch in floats: C rounded up to 4, so that every row
// starts 16-byte aligned.
__host__ __device__ int row_pitch(int C) { return (C + 3) & ~3; }

// Dynamic shared memory of lut_eval_tiles_kernel: the tile's rows.
__host__ __device__ size_t float_tiles_bytes(int C) {
  return align16((size_t)kFloatTileRows * row_pitch(C) * 4);
}

// Tile t's rows into rows_s, 16 bytes a copy where the rows allow it
// (rows past B are zeros).
__device__ void stage_float_rows(const FloatTiles& p, float* rows_s, int t) {
  const long long row0 = (long long)t * kFloatTileRows;
  const int rows = (int)min((long long)kFloatTileRows, p.B - row0);
  const int pitch = row_pitch(p.C);
  for (int r = 0; r < kFloatTileRows; ++r) {
    if (r < rows) {
      stage(rows_s + r * pitch, p.bits + (row0 + r) * p.C, p.C * 4);
    } else {
      for (int c = threadIdx.x; c < p.C; c += blockDim.x)
        rows_s[r * pitch + c] = 0.0f;
    }
  }
}

// Tile t's rows into L2, one 128-byte line at a time.
__device__ void prefetch_float_rows(const FloatTiles& p, int t) {
  const long long row0 = (long long)t * kFloatTileRows;
  const long long n = min((long long)kFloatTileRows, p.B - row0) * p.C;
  const float* src = p.bits + row0 * p.C;
  for (long long i = (long long)threadIdx.x * 32; i < n;
       i += (long long)blockDim.x * 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + i));
}

// The tables and wires stay in L2 across tiles while the rows and outputs
// stream past them: their loads carry an evict-last policy
// (evict_last_policy, ld_evict_last: tiles.cuh).

// Folds corner a's table value t into one row's lerp tree: v is the hi
// side of each level whose bit of a is 1 (fmaf(s, hi - lo, lo), input 0
// first), and waits as the lo side at the first level whose bit is 0;
// after the last corner the whole tree has folded into res.
template <int N>
__device__ __forceinline__ void fold(float t, int a, const float* s,
                                     float* pend, float& res) {
  float v = t;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if ((a >> k) & 1) {
      v = fmaf(s[k], v - pend[k], pend[k]);
    } else {
      pend[k] = v;
      return;
    }
  }
  res = v;
}

// The same for corner h + a of a tree streamed in blocks of 2^LOGH
// corners, a < 2^LOGH known at compile time and h (a multiple of 2^LOGH)
// only at run time: the levels below LOGH fold as in fold<N>, and at a
// block's last corner the levels above follow the bits of h.  The same
// operations in the same order as fold<N>(t, h + a, ...).
template <int N, int LOGH>
__device__ __forceinline__ void fold_block(float t, int h, int a,
                                           const float* s, float* pend,
                                           float& res) {
  float v = t;
#pragma unroll
  for (int k = 0; k < LOGH; ++k) {
    if ((a >> k) & 1) {
      v = fmaf(s[k], v - pend[k], pend[k]);
    } else {
      pend[k] = v;
      return;
    }
  }
  bool held = false;
#pragma unroll
  for (int k = LOGH; k < N; ++k) {
    if (!held) {
      if ((h >> k) & 1) {
        v = fmaf(s[k], v - pend[k], pend[k]);
      } else {
        pend[k] = v;
        held = true;
      }
    }
  }
  if (!held) res = v;
}

// Lanes are LUTs: warp w evaluates LUTs (w / G) * 32 + lane of each pass
// of kPassLuts for the kLutRows rows from (w % G) * kLutRows of the tile
// (G = kRowGroups), so that a table entry loaded once serves kLutRows
// rows, and the G warps that load it read it from L2 once (the others
// find it in L1).  Up to fan-in 6 the loads run ahead of the lerps: a
// pass's corners from 32 on load while its first 32 fold, and the next
// pass's first 32 corners and wires while its last ones fold (a lane past
// m loads LUT m - 1 and stores nothing, so that every lane's pipeline
// stays full).  At 7 and 8 the corners go in blocks of 32 through a loop
// that is not unrolled, so that no register spills.  The outputs are
// streaming stores, 128 bytes a warp and row.
template <int N>
__global__ void __launch_bounds__(kFloatThreads, 1)
    lut_eval_tiles_kernel(const __grid_constant__ FloatTiles p) {
  constexpr int A = 1 << N;
  constexpr int LO = A < 32 ? A : 32;  // corners loaded a pass ahead
  constexpr bool kAhead = N <= 6;
  extern __shared__ __align__(16) float rows_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = (warp % kRowGroups) * kLutRows;      // this warp's 1st row
  const int lut = (warp / kRowGroups) * 32 + lane;    // its LUT in a pass
  const int pitch = row_pitch(p.C);
  const float* my_rows = rows_s + g0 * pitch;
  const int passes = (p.m + kPassLuts - 1) / kPassLuts;
  const int pa0 = blockIdx.y * p.cps, pa1 = min(passes, pa0 + p.cps);
  const uint64_t keep = evict_last_policy();
  // the LUT a lane loads in pass pa: its own, or the last one past m
  auto lut_of = [&](int pa) { return min(pa * kPassLuts + lut, p.m - 1); };
  float lo[LO];  // the first corners of the pass to come
  int wn[N];     // and its wires
  if constexpr (kAhead) {
    const int l = lut_of(pa0);
    const float* tp = p.tab_t + l;
#pragma unroll
    for (int a = 0; a < LO; ++a, tp += p.m) lo[a] = ld_evict_last(tp, keep);
#pragma unroll
    for (int k = 0; k < N; ++k)
      wn[k] = ld_evict_last(p.mapping + (size_t)l * N + k, keep);
  }

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const long long row0 = (long long)t * kFloatTileRows;
    // rows of this warp's group that lie before B
    const int group_rows =
        (int)min((long long)kFloatTileRows, p.B - row0) - g0;
    __syncthreads();  // the last tile's rows are no longer read
    stage_float_rows(p, rows_s, t);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // the next tile's rows move to L2 while this one is evaluated
    if (t + (int)gridDim.x < p.tiles) prefetch_float_rows(p, t + gridDim.x);
    for (int pa = pa0; pa < pa1; ++pa) {
      const int l = lut_of(pa);
      float s[kLutRows][N], pend[kLutRows][N], res[kLutRows];
      if constexpr (kAhead) {
        float hi[A - LO + 1];
        const float* tp = p.tab_t + (size_t)LO * p.m + l;
#pragma unroll
        for (int a = LO; a < A; ++a, tp += p.m)
          hi[a - LO] = ld_evict_last(tp, keep);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float* col = my_rows + wn[k];
#pragma unroll
          for (int r = 0; r < kLutRows; ++r, col += pitch) s[r][k] = *col;
        }
#pragma unroll
        for (int a = 0; a < LO; ++a) {
#pragma unroll
          for (int r = 0; r < kLutRows; ++r)
            fold<N>(lo[a], a, s[r], pend[r], res[r]);
        }
        // the next pass (or, after the last, this slice's first pass of
        // the next tile): its first corners and wires
        const int ln = lut_of(pa + 1 < pa1 ? pa + 1 : pa0);
        const float* tn = p.tab_t + ln;
#pragma unroll
        for (int a = 0; a < LO; ++a, tn += p.m) lo[a] = ld_evict_last(tn, keep);
#pragma unroll
        for (int k = 0; k < N; ++k)
          wn[k] = ld_evict_last(p.mapping + (size_t)ln * N + k, keep);
#pragma unroll
        for (int a = LO; a < A; ++a) {
#pragma unroll
          for (int r = 0; r < kLutRows; ++r)
            fold<N>(hi[a - LO], a, s[r], pend[r], res[r]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float* col =
              my_rows + ld_evict_last(p.mapping + (size_t)l * N + k, keep);
#pragma unroll
          for (int r = 0; r < kLutRows; ++r, col += pitch) s[r][k] = *col;
        }
#pragma unroll 1
        for (int h = 0; h < A; h += 32) {
          float tt[32];
#pragma unroll
          for (int a = 0; a < 32; ++a)
            tt[a] = ld_evict_last(p.tab_t + (size_t)(h + a) * p.m + l, keep);
#pragma unroll
          for (int a = 0; a < 32; ++a) {
#pragma unroll
            for (int r = 0; r < kLutRows; ++r)
              fold_block<N, 5>(tt[a], h, a, s[r], pend[r], res[r]);
          }
        }
      }
      if (pa * kPassLuts + lut < p.m) {
#pragma unroll
        for (int r = 0; r < kLutRows; ++r)
          if (r < group_rows)
            __stcs(p.out + (row0 + g0 + r) * p.m + l, res[r]);
      }
    }
  }
}

template <int N>
cudaError_t launch_lut_eval_tiles(const FloatTiles& p, int S, int sms,
                                  int smem, int* info, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lut_eval_tiles_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lut_eval_tiles_kernel<N>, kFloatThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid: each slice's tiles walked by as many blocks as the
  // card holds beside the other slices'
  const int walkers = min(p.tiles, max(1, sms * per_sm / S));
  lut_eval_tiles_kernel<N>
      <<<dim3(walkers, S), kFloatThreads, smem, stream>>>(p);
  info[0] = walkers;
  info[1] = per_sm;
  return cudaGetLastError();
}

// The corner-block fold of the wide kernel: fold_block<N, LOGH> with the
// fan-in n a run-time value (levels LOGH .. n - 1 follow the bits of h),
// the same operations in the same order as fold<n>(t, h + a, ...).
template <int LOGH>
__device__ __forceinline__ void fold_wide(float t, int h, int a, int n,
                                          const float* s, float* pend,
                                          float& res) {
  float v = t;
#pragma unroll
  for (int k = 0; k < LOGH; ++k) {
    if ((a >> k) & 1) {
      v = fmaf(s[k], v - pend[k], pend[k]);
    } else {
      pend[k] = v;
      return;
    }
  }
  bool held = false;
#pragma unroll
  for (int k = LOGH; k < kWideMaxFanIn; ++k) {
    if (!held && k < n) {
      if ((h >> k) & 1) {
        v = fmaf(s[k], v - pend[k], pend[k]);
      } else {
        pend[k] = v;
        held = true;
      }
    }
  }
  if (!held) res = v;
}

// K8 where the tiles and rows kernels do not reach (fan-in above 8, rows
// past 58,112 bits): thread l of block x is LUT x * kThreads + l (lanes
// over LUTs, so a corner's table load is coalesced), and evaluates it
// for kWideRows rows at a time, row groups strided over grid.y; its
// wires and each row's n bits go to registers, then the 2^n corners
// stream through fold_wide in blocks of 2^LOGH (LOGH = min(n, 5)).
template <int LOGH>
__global__ void __launch_bounds__(kThreads) lut_eval_wide_kernel(
    const float* __restrict__ bits, int B, int C,
    const int* __restrict__ mapping, const float* __restrict__ tab_t, int m,
    int n, float* __restrict__ out) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= m) return;
  const uint64_t keep = evict_last_policy();
  int wire[kWideMaxFanIn];
#pragma unroll
  for (int k = 0; k < kWideMaxFanIn; ++k)
    wire[k] = k < n ? ld_evict_last(mapping + (size_t)l * n + k, keep) : 0;
  const int A = 1 << n;
  for (long long r0 = (long long)blockIdx.y * kWideRows; r0 < B;
       r0 += (long long)gridDim.y * kWideRows) {
    float s[kWideRows][kWideMaxFanIn], pend[kWideRows][kWideMaxFanIn],
        res[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      res[r] = 0.0f;
#pragma unroll
      for (int k = 0; k < kWideMaxFanIn; ++k)
        s[r][k] = k < n && r0 + r < B ? __ldg(bits + (r0 + r) * C + wire[k])
                                      : 0.0f;
    }
    for (int h = 0; h < A; h += 1 << LOGH) {
#pragma unroll
      for (int a = 0; a < (1 << LOGH); ++a) {
        const float t = ld_evict_last(tab_t + (size_t)(h + a) * m + l, keep);
#pragma unroll
        for (int r = 0; r < kWideRows; ++r)
          fold_wide<LOGH>(t, h, a, n, s[r], pend[r], res[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r)
      if (r0 + r < B) __stcs(out + (r0 + r) * m + l, res[r]);
  }
}

// The first packed kernel, kept for input rows too wide for
// lut_eval_packed_kernel's tiles of 32 samples: one warp a sample, lanes
// over LUTs; the warp's row staged in shared memory (kStagedRow) or, past
// 7264 words, read from global memory.
template <bool kStagedRow>
__global__ void __launch_bounds__(kThreads) lut_eval_packed_rows_kernel(
    const uint32_t* __restrict__ words, int B, int W_in,
    const int* __restrict__ widx, const int* __restrict__ boff,
    const uint32_t* __restrict__ tab, int m, int n, int tw,
    uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (row >= B) return;  // the whole warp leaves
  const uint32_t* in = words + row * W_in;
  if (kStagedRow) {
    uint32_t* s = smem + (size_t)warp * W_in;
    for (int w = lane; w < W_in; w += 32) s[w] = __ldg(in + w);
    __syncwarp();
    in = s;
  }
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
      for (int k = 0; k < n; ++k) {
        const uint32_t w =
            kStagedRow ? in[__ldg(wi + k)] : __ldg(in + __ldg(wi + k));
        addr |= ((w >> __ldg(bo + k)) & 1u) << k;
      }
      const uint32_t t = __ldg(tab + (size_t)lut * tw + (addr >> 5));
      const uint32_t word = __ballot_sync(kFull, (t >> (addr & 31u)) & 1u);
      if (lane == j) mine = word;
    }
    if (lane < nw) o[w0 + lane] = mine;
  }
}

// lut_eval_packed_block_kernel: rows past the staged rows kernel's 7264
// words, a group of `group` rows staged a block and shared by all its
// LUTs.  Items are (output word, row part): part p of a group is its rows
// p, p + parts, ... (parts > 1 only where the layer has fewer words than
// the block has warps); warp w takes items w, w + kBlockWarps, ...
constexpr int kBlockThreads = 512;  // 16 warps
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kBlockMaxGroup = 8;   // rows a group: <= 7 past 7264 words
// the cached instance keeps each of its items' wires and table words in
// registers for the whole launch: up to kBlockSlots items a warp, fan-in
// up to kBlockFanIn (tables of at most 2 words)
constexpr int kBlockSlots = 5;
constexpr int kBlockFanIn = 6;

struct BlockRows {
  const uint32_t* words;  // (B, W_in)
  const int* widx;        // (m, n) input word of each wire
  const int* boff;        // (m, n) its bit
  const uint32_t* tab;    // (m, tw) one bit per entry
  uint32_t* out;          // (B, W_out)
  int B, W_in, n, tw, W_out;
  int group, bufs;        // rows a group; groups staged (1, or 2: overlap)
  int groups, parts;      // ceil(B / group); row parts of an item
  int buf_words;          // one group's buffer: group * W_in, 16-byte units
};

// Group g's rows into buf with 16-byte cp.async copies where both sides
// allow it (one contiguous span of rows * W_in words).
__device__ __forceinline__ void stage_group(const BlockRows& p, uint32_t* buf,
                                            int g) {
  const long long row0 = (long long)g * p.group;
  const int rows = (int)min((long long)p.group, p.B - row0);
  stage(buf, p.words + row0 * p.W_in, rows * p.W_in * 4);
}

// The wire of LUT `lut`'s input k as one 32-bit value, word << 7 | ((bit -
// k) & 31): the word's byte offset is v >> 5 (bits 5 and 6 are zero), and
// rotating the word right by v & 31 brings the bit to place k.
__device__ __forceinline__ uint32_t block_wire(const BlockRows& p, int lut,
                                               int k) {
  const size_t i = (size_t)lut * p.n + k;
  return (uint32_t)__ldg(p.widx + i) << 7 | ((__ldg(p.boff + i) - k) & 31);
}

// Bit k of a LUT's address on the row at `row` (bytes) from its wire v.
__device__ __forceinline__ uint32_t block_bit(const char* row, uint32_t v,
                                              int k) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(row + (v >> 5));
  return __funnelshift_r(t, t, v) & (1u << k);
}

// kCached: fan-in <= kBlockFanIn and at most kBlockSlots items a warp,
// whose wires and table words sit in registers; else they are loaded for
// every group (through L1).  A persistent grid walks the groups, the next
// one arriving in the second buffer while one is evaluated (bufs == 2).
template <bool kCached>
__global__ void __launch_bounds__(kBlockThreads, 1)
    lut_eval_packed_block_kernel(const __grid_constant__ BlockRows p) {
  extern __shared__ __align__(16) uint32_t groups_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = p.W_out * p.parts;
  const int row_bytes = p.W_in * 4;
  uint32_t wires[kCached ? kBlockSlots : 1][kBlockFanIn];
  uint32_t tabs[kCached ? kBlockSlots : 1][2];
  if constexpr (kCached) {
#pragma unroll
    for (int s = 0; s < kBlockSlots; ++s) {
      const int item = warp + s * kBlockWarps;
      const int lut = min(item / p.parts, p.W_out - 1) * 32 + lane;
#pragma unroll
      for (int k = 0; k < kBlockFanIn; ++k)
        wires[s][k] = k < p.n ? block_wire(p, lut, k) : 0u;
      tabs[s][0] = __ldg(p.tab + (size_t)lut * p.tw);
      tabs[s][1] = p.tw > 1 ? __ldg(p.tab + (size_t)lut * p.tw + 1) : 0u;
    }
  }
  int g = blockIdx.x;
  if (g < p.groups) stage_group(p, groups_s, g);
  cp_async_commit();
  for (int it = 0; g < p.groups; g += gridDim.x, ++it) {
    const int buf = p.bufs == 2 ? it & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // group g has landed; the other buffer is free
    if (p.bufs == 2 && g + (int)gridDim.x < p.groups)
      stage_group(p, groups_s + (buf ^ 1) * p.buf_words, g + gridDim.x);
    cp_async_commit();
    const char* rows =
        reinterpret_cast<const char*>(groups_s + buf * p.buf_words);
    const long long row0 = (long long)g * p.group;
    const int valid = (int)min((long long)p.group, p.B - row0);
    // one item on every row of its part: a ballot a row packs its word,
    // which lane i keeps for the part's row i and stores
    auto evaluate = [&](int item, const uint32_t* wire, const uint32_t* t) {
      const int word = item / p.parts, part = item - word * p.parts;
      const int lut = word * 32 + lane;
      uint32_t mine = 0;
#pragma unroll
      for (int i = 0; i < kBlockMaxGroup; ++i) {
        const int r = part + i * p.parts;
        if (r >= p.group) break;
        const char* row = rows + r * row_bytes;
        uint32_t addr = 0, bit;
        if constexpr (kCached) {
#pragma unroll
          for (int k = 0; k < kBlockFanIn; ++k)
            if (k < p.n) addr |= block_bit(row, wire[k], k);
          bit = p.n <= 5 ? t[0] >> addr & 1u : table6(t[0], t[1], addr);
        } else {
          for (int k = 0; k < p.n; ++k)
            addr |= block_bit(row, block_wire(p, lut, k), k);
          bit = table_bit<false>(p.tab + (size_t)lut * p.tw, p.n, addr);
        }
        const uint32_t w = __ballot_sync(kFull, bit);
        if (lane == i) mine = w;
      }
      const int r = part + lane * p.parts;
      if (r < valid) p.out[(row0 + r) * p.W_out + word] = mine;
    };
    if constexpr (kCached) {
#pragma unroll
      for (int s = 0; s < kBlockSlots; ++s)
        if (warp + s * kBlockWarps < items)
          evaluate(warp + s * kBlockWarps, wires[s], tabs[s]);
    } else {
      for (int item = warp; item < items; item += kBlockWarps)
        evaluate(item, wires[0], tabs[0]);
    }
    if (p.bufs == 1) {
      __syncthreads();  // the group is read; the next one may land
      if (g + (int)gridDim.x < p.groups)
        stage_group(p, groups_s, g + gridDim.x);
      cp_async_commit();
    }
  }
}

// lut_eval_packed_kernel: one word-addressed layer over tiles of
// kTileRows samples, one a lane, the layer's words split into slices of ws
// (grid.y).
constexpr int kTileRows = 32;

struct PackedTiles {
  const uint32_t* words;  // (B, W_in)
  const int* widx;        // (m, n) input word of each wire
  const int* boff;        // (m, n) its bit
  const uint32_t* tab;    // (m, tw) one bit per entry
  uint32_t* out;          // (B, W_out)
  int B, W_in, n, tw, W_out;
  int tiles, ws;          // tiles of kTileRows; output words per slice
};

// Shared-memory byte offsets of lut_eval_packed_kernel's parts: the
// slice's wires (ws*32*n, 16 bits each), its tables (ws*32*tw words), its
// output tile ([ws][kTileRows + 1] words: padded, so that writing it by
// lane and reading it by word are both conflict-free) and two activation
// buffers ([W_in][kTileRows] words each); off[4] is the total.
__host__ __device__ void packed_tiles_layout(int W_in, int n, int tw, int ws,
                                             size_t off[5]) {
  off[0] = 0;
  off[1] = align16((size_t)ws * 32 * n * 2);
  off[2] = off[1] + align16((size_t)ws * 32 * tw * 4);
  off[3] = off[2] + align16((size_t)ws * (kTileRows + 1) * 4);
  off[4] = off[3] + 2 * (size_t)W_in * kTileRows * 4;
}

// Bit k of a LUT's address, from its staged wire k, v = w << 7 | ((b - k)
// & 31) for input word w < 512, bit b: word w of the lane's sample is at
// byte w * 128 of the [word][lane] activations (act_lane = act + lane), and
// rotating it right by (b - k) & 31 brings bit b to position k (mask =
// 1 << k).  One load, one funnel shift, one and-or.
__device__ __forceinline__ uint32_t wire_bit(const char* act_lane,
                                             uint32_t v, uint32_t mask) {
  const uint32_t t =
      *reinterpret_cast<const uint32_t*>(act_lane + (v & 0xff80u));
  return __funnelshift_r(t, t, v) & mask;
}

// LUTs j0 .. j0 + span - 1 of a 32-LUT word of the layer for this lane's
// sample, as fused_dwn.cu's word_luts, with 16-bit wires (wire_bit).  Fan-in
// 6 takes LUTs in pairs: their 12 wires are three 8-byte broadcasts and
// their tables one 16-byte one (j0 and span are even).
__device__ __forceinline__ uint32_t layer_word(const uint32_t* act,
                                               const uint16_t* wires,
                                               const uint32_t* tab, int n,
                                               int tw, int lane, int j0,
                                               int span) {
  const char* act_lane = reinterpret_cast<const char*>(act + lane);
  uint32_t out = 0;
  if (n == 6) {
#pragma unroll 2
    for (int j = j0; j < j0 + span; j += 2) {
      const uint2* wp = reinterpret_cast<const uint2*>(wires + j * 6);
      const uint2 a = wp[0], b = wp[1], c = wp[2];
      const uint4 t = *reinterpret_cast<const uint4*>(tab + j * 2);
      const uint32_t addr0 =
          wire_bit(act_lane, a.x, 1u) | wire_bit(act_lane, a.x >> 16, 2u) |
          wire_bit(act_lane, a.y, 4u) | wire_bit(act_lane, a.y >> 16, 8u) |
          wire_bit(act_lane, b.x, 16u) | wire_bit(act_lane, b.x >> 16, 32u);
      const uint32_t addr1 =
          wire_bit(act_lane, b.y, 1u) | wire_bit(act_lane, b.y >> 16, 2u) |
          wire_bit(act_lane, c.x, 4u) | wire_bit(act_lane, c.x >> 16, 8u) |
          wire_bit(act_lane, c.y, 16u) | wire_bit(act_lane, c.y >> 16, 32u);
      out |= (table6(t.x, t.y, addr0) | table6(t.z, t.w, addr1) << 1) << j;
    }
    return out;
  }
  for (int j = j0; j < j0 + span; ++j) {
    const uint16_t* wl = wires + j * n;
    uint32_t addr = 0;
    for (int k = 0; k < n; ++k) addr |= wire_bit(act_lane, wl[k], 1u << k);
    out |= table_bit<true>(tab + j * tw, n, addr) << j;
  }
  return out;
}

// Tile t's input words into act as [word][lane]; rows past B are zeros.
__device__ void stage_acts(const PackedTiles& p, uint32_t* act, int t) {
  const long long row0 = (long long)t * kTileRows;
  const int n = kTileRows * p.W_in;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / p.W_in, w = e - r * p.W_in;
    uint32_t* d = act + w * kTileRows + r;
    if (row0 + r < p.B)
      cp_async4(d, p.words + (row0 + r) * p.W_in + w);
    else
      *d = 0u;
  }
}

__global__ void __launch_bounds__(kTileThreads)
    lut_eval_packed_kernel(const __grid_constant__ PackedTiles p) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // this block's slice: output words [w0, w0 + nws)
  const int w0 = blockIdx.y * p.ws, nws = min(p.ws, p.W_out - w0);
  size_t off[5];
  packed_tiles_layout(p.W_in, p.n, p.tw, p.ws, off);
  uint16_t* wires = reinterpret_cast<uint16_t*>(sm + off[0]);
  uint32_t* tabs = reinterpret_cast<uint32_t*>(sm + off[1]);
  uint32_t* outs = reinterpret_cast<uint32_t*>(sm + off[2]);
  uint32_t* acts = reinterpret_cast<uint32_t*>(sm + off[3]);
  const int a_words = p.W_in * kTileRows;
  constexpr int kOut = kTileRows + 1;  // output tile row pitch

  // the slice, once per block: tables copied, each wire's word and bit
  // made one 16-bit wire (wire_bit); k = i % n, the wire's place in its
  // LUT, is stepped along rather than divided out
  stage(tabs, p.tab + (size_t)w0 * 32 * p.tw, nws * 32 * p.tw * 4);
  const size_t wire0 = (size_t)w0 * 32 * p.n;
  const int k_step = blockDim.x % p.n;
  for (int i = tid, k = tid % p.n; i < nws * 32 * p.n; i += blockDim.x) {
    wires[i] = static_cast<uint16_t>(__ldg(p.widx + wire0 + i) << 7 |
                                     ((__ldg(p.boff + wire0 + i) - k) & 31));
    k += k_step;
    if (k >= p.n) k -= p.n;
  }
  int t = blockIdx.x;
  if (t < p.tiles) stage_acts(p, acts, t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // a slice of few words still gives every warp work: each word in parts
  // of 32 / parts LUTs (an even number: fan-in 6 takes pairs), OR-ed
  // together
  int parts = 1;
  while (parts < 16 && nws * parts < nwarps) parts *= 2;
  const int span = 32 / parts;
  for (int it = 0; t < p.tiles; t += gridDim.x, ++it) {
    const uint32_t* act = acts + (it & 1) * a_words;
    const long long row0 = (long long)t * kTileRows;
    const int rows = (int)min((long long)kTileRows, p.B - row0);
    // the next tile's words arrive while this one is computed
    if (t + (int)gridDim.x < p.tiles)
      stage_acts(p, acts + ((it + 1) & 1) * a_words, t + gridDim.x);
    cp_async_commit();
    if (parts > 1) {
      for (int i = tid; i < nws * kOut; i += blockDim.x) outs[i] = 0u;
      __syncthreads();
    }
    for (int item = warp; item < nws * parts; item += nwarps) {
      const int rel = item / parts, j0 = (item - rel * parts) * span;
      const uint32_t word =
          layer_word(act, wires + rel * 32 * p.n, tabs + rel * 32 * p.tw,
                     p.n, p.tw, lane, j0, span);
      if (parts == 1)
        outs[rel * kOut + lane] = word;
      else
        atomicOr(outs + rel * kOut + lane, word);
    }
    __syncthreads();
    // the tile back to (B, W_out) rows: neighbouring threads write
    // neighbouring words of a row
    for (int i = tid; i < rows * nws; i += blockDim.x) {
      const int r = i / nws, w = i - r * nws;
      p.out[(row0 + r) * p.W_out + w0 + w] = outs[w * kOut + r];
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace

// K8 on tiles of 16 rows over S slices of cps 128-LUT passes each, on a
// card of sms SMs; smem: the plan's dynamic shared memory in bytes
// (kernel.py: plan_lut_eval), which must be this layout's.  info: walkers
// (grid.x), blocks an SM holds.
extern "C" int lut_eval_launch(const void* bits, int B, int C,
                               const void* mapping, const void* tab_t, int m,
                               int n, void* out, int S, int cps, int sms,
                               int smem, int* info, void* stream) {
  if (B <= 0 || C <= 0 || m <= 0 || n < 1 || n > kMaxFanIn || cps < 1 ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  const int passes = (m + kPassLuts - 1) / kPassLuts;
  if (S != (passes + cps - 1) / cps || S > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = float_tiles_bytes(C);
  if (bytes != (size_t)smem || bytes > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  FloatTiles p = {};
  p.bits = static_cast<const float*>(bits);
  p.mapping = static_cast<const int*>(mapping);
  p.tab_t = static_cast<const float*>(tab_t);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.C = C;
  p.m = m;
  p.tiles = (B + kFloatTileRows - 1) / kFloatTileRows;
  p.cps = cps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 1: return (int)launch_lut_eval_tiles<1>(p, S, sms, smem, info, st);
    case 2: return (int)launch_lut_eval_tiles<2>(p, S, sms, smem, info, st);
    case 3: return (int)launch_lut_eval_tiles<3>(p, S, sms, smem, info, st);
    case 4: return (int)launch_lut_eval_tiles<4>(p, S, sms, smem, info, st);
    case 5: return (int)launch_lut_eval_tiles<5>(p, S, sms, smem, info, st);
    case 6: return (int)launch_lut_eval_tiles<6>(p, S, sms, smem, info, st);
    case 7: return (int)launch_lut_eval_tiles<7>(p, S, sms, smem, info, st);
    default: return (int)launch_lut_eval_tiles<8>(p, S, sms, smem, info, st);
  }
}

// The float rows kernel; rows: rows per block, 1..kRows, with rows * C
// floats of shared memory.
extern "C" int lut_eval_rows_launch(const void* bits, int B, int C,
                                    const void* mapping, const void* tab_t,
                                    int m, int n, int rows, void* out,
                                    void* stream) {
  if (B <= 0 || C <= 0 || m <= 0 || n < 1 || n > kMaxFanIn || rows < 1 ||
      rows > kRows)
    return (int)cudaErrorInvalidValue;
  const float* b = (const float*)bits;
  const int* mp = (const int*)mapping;
  const float* t = (const float*)tab_t;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 1: return (int)launch_lut_eval_rows<1>(b, B, C, mp, t, m, rows, o, st);
    case 2: return (int)launch_lut_eval_rows<2>(b, B, C, mp, t, m, rows, o, st);
    case 3: return (int)launch_lut_eval_rows<3>(b, B, C, mp, t, m, rows, o, st);
    case 4: return (int)launch_lut_eval_rows<4>(b, B, C, mp, t, m, rows, o, st);
    case 5: return (int)launch_lut_eval_rows<5>(b, B, C, mp, t, m, rows, o, st);
    case 6: return (int)launch_lut_eval_rows<6>(b, B, C, mp, t, m, rows, o, st);
    case 7: return (int)launch_lut_eval_rows<7>(b, B, C, mp, t, m, rows, o, st);
    default:
      return (int)launch_lut_eval_rows<8>(b, B, C, mp, t, m, rows, o, st);
  }
}

// K4 on tiles of 32 samples over S slices of ws output words each, on a
// card of sms SMs; smem: the plan's dynamic shared memory in bytes
// (kernel.py: plan_lut_eval_packed), which must be this layout's.
// info: walkers (grid.x), blocks an SM holds.
extern "C" int lut_eval_packed_launch(const void* words, int B, int W_in,
                                      const void* widx, const void* boff,
                                      const void* tab, int m, int n, int tw,
                                      void* out, int S, int ws, int sms,
                                      int smem, int* info, void* stream) {
  if (B <= 0 || W_in <= 0 || W_in > 511 || m <= 0 || m % 32 != 0 ||
      n <= 0 || n > 31 || tw != ((1LL << n) + 31) / 32 || ws < 1 ||
      S != (m / 32 + ws - 1) / ws || S > 65535 || sms < 1)
    return (int)cudaErrorInvalidValue;
  PackedTiles p = {};
  p.words = static_cast<const uint32_t*>(words);
  p.widx = static_cast<const int*>(widx);
  p.boff = static_cast<const int*>(boff);
  p.tab = static_cast<const uint32_t*>(tab);
  p.out = static_cast<uint32_t*>(out);
  p.B = B;
  p.W_in = W_in;
  p.n = n;
  p.tw = tw;
  p.W_out = m / 32;
  p.tiles = (B + kTileRows - 1) / kTileRows;
  p.ws = ws;
  size_t off[5];
  packed_tiles_layout(W_in, n, tw, ws, off);
  if (off[4] != (size_t)smem || off[4] > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lut_eval_packed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lut_eval_packed_kernel, kTileThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: each slice's tiles walked by as many blocks as
  // the card holds beside the other slices'
  const int walkers = min(p.tiles, max(1, sms * per_sm / S));
  lut_eval_packed_kernel<<<dim3(walkers, S), kTileThreads, smem,
                           (cudaStream_t)stream>>>(p);
  info[0] = walkers;
  info[1] = per_sm;
  return (int)cudaGetLastError();
}

// The rows kernel: one warp a sample, its row staged (staged != 0: rows
// of up to 7264 words) or read from global memory (any width).
extern "C" int lut_eval_packed_rows_launch(const void* words, int B,
                                           int W_in, const void* widx,
                                           const void* boff, const void* tab,
                                           int m, int n, int tw, void* out,
                                           int staged, void* stream) {
  if (B <= 0 || W_in <= 0 || m <= 0 || m % 32 != 0 || n <= 0 || n > 31 ||
      tw != ((1LL << n) + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      staged ? (size_t)(kThreads / 32) * W_in * sizeof(uint32_t) : 0;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? lut_eval_packed_rows_kernel<true>
                       : lut_eval_packed_rows_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + kThreads / 32 - 1) / (kThreads / 32);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, B, W_in, (const int*)widx, (const int*)boff,
      (const uint32_t*)tab, m, n, tw, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// K4 on rows past the staged rows kernel's: groups of `group` rows
// (1..kBlockMaxGroup), `bufs` of them staged a block (2: the next group
// arrives while one is evaluated), on a card of sms SMs; smem: the plan's
// dynamic shared memory in bytes (kernel.py: plan_lut_eval_packed), bufs
// buffers of group * W_in words, each rounded up to 16 bytes.  info:
// walkers (grid.x), blocks an SM holds, whether the wires and tables sit
// in registers (the cached instance).
extern "C" int lut_eval_packed_block_launch(const void* words, int B,
                                            int W_in, const void* widx,
                                            const void* boff, const void* tab,
                                            int m, int n, int tw, void* out,
                                            int group, int bufs, int sms,
                                            int smem, int* info,
                                            void* stream) {
  if (B <= 0 || W_in <= 0 || W_in > (1 << 25) || m <= 0 || m % 32 != 0 ||
      n <= 0 || n > 31 || tw != ((1LL << n) + 31) / 32 || group < 1 ||
      group > kBlockMaxGroup || (bufs != 1 && bufs != 2) || sms < 1)
    return (int)cudaErrorInvalidValue;
  const size_t buf = align16((size_t)group * W_in * 4);
  if (bufs * buf != (size_t)smem || (size_t)smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  BlockRows p = {};
  p.words = static_cast<const uint32_t*>(words);
  p.widx = static_cast<const int*>(widx);
  p.boff = static_cast<const int*>(boff);
  p.tab = static_cast<const uint32_t*>(tab);
  p.out = static_cast<uint32_t*>(out);
  p.B = B;
  p.W_in = W_in;
  p.n = n;
  p.tw = tw;
  p.W_out = m / 32;
  p.group = group;
  p.bufs = bufs;
  p.groups = (B + group - 1) / group;
  // a layer of fewer words than warps splits each word's rows over parts
  p.parts = p.W_out >= kBlockWarps
                ? 1
                : min(group, (kBlockWarps + p.W_out - 1) / p.W_out);
  p.buf_words = (int)(buf / 4);
  const bool cached =
      n <= kBlockFanIn &&
      (p.W_out * p.parts + kBlockWarps - 1) / kBlockWarps <= kBlockSlots;
  auto kernel = cached ? lut_eval_packed_block_kernel<true>
                       : lut_eval_packed_block_kernel<false>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBlockThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int walkers = min(p.groups, sms * per_sm);
  kernel<<<walkers, kBlockThreads, smem, (cudaStream_t)stream>>>(p);
  info[0] = walkers;
  info[1] = per_sm;
  info[2] = cached;
  return (int)cudaGetLastError();
}

// K8's wide kernel: fan-in 1 to kWideMaxFanIn, rows of any width.
extern "C" int lut_eval_wide_launch(const void* bits, int B, int C,
                                    const void* mapping, const void* tab_t,
                                    int m, int n, void* out, void* stream) {
  if (B <= 0 || C <= 0 || m <= 0 || n < 1 || n > kWideMaxFanIn)
    return (int)cudaErrorInvalidValue;
  const long long groups = (B + kWideRows - 1LL) / kWideRows;
  const dim3 grid((m + kThreads - 1) / kThreads,
                  (unsigned)(groups < 65535 ? groups : 65535));
  cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bits;
  const int* mp = (const int*)mapping;
  const float* t = (const float*)tab_t;
  float* o = (float*)out;
  switch (min(n, 5)) {
    case 1: lut_eval_wide_kernel<1><<<grid, kThreads, 0, st>>>(b, B, C, mp, t, m, n, o); break;
    case 2: lut_eval_wide_kernel<2><<<grid, kThreads, 0, st>>>(b, B, C, mp, t, m, n, o); break;
    case 3: lut_eval_wide_kernel<3><<<grid, kThreads, 0, st>>>(b, B, C, mp, t, m, n, o); break;
    case 4: lut_eval_wide_kernel<4><<<grid, kThreads, 0, st>>>(b, B, C, mp, t, m, n, o); break;
    default: lut_eval_wide_kernel<5><<<grid, kThreads, 0, st>>>(b, B, C, mp, t, m, n, o); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lut_eval_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
