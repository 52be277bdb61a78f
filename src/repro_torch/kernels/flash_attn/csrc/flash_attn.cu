// Flash attention for Hopper (sm_90a): causal or full online-softmax
// attention over bf16 q, k, v with float32 running max, denominator and
// accumulator, in the grouped-query layout of the model.
//
// Replaces the Pallas TPU kernel
//   flash_attention <- src/repro/kernels/flash_attn/kernel.py
//                      (_flash_kernel, its pallas_call at :89)
// and the GQA repeat and sequence padding of its op (flash_attn/ops.py).
//
// What it computes: q (B, S, H, hd), k and v (B, S, KH, hd), all bf16 and
// contiguous; query head h reads key/value head h / (H / KH).  For each
// (b, h) and query row i, o[b, i, h] = softmax_j(q_i . k_j * hd^-0.5) v_j
// over the keys j < S (and j <= i when causal), cast to bf16.  Keys at or
// past S are masked for both causal values (the reference's op pads them
// with zeros and lets them into the non-causal softmax; this kernel does
// not).  Masked scores are -1e30 and their probabilities are exactly 0;
// the denominator is summed in float32 before P is rounded to bf16 for
// P V; the output divides by max(l, 1e-30), so a row with no key is 0,
// never NaN; query rows at or past S are not written.
//
// What bounds it on an H100.  At the served shape (B=4, S=2048, H=32,
// KH=8, hd=128) a causal launch does 2*B*H*S*(S+1)*hd = 1.375e11
// tensor-core operations (the two products over the lower triangle)
// against 168 MB of q, k, v and o (0.050 ms at 3.35 TB/s), so it is bound
// by operations: 0.139 ms at the published 989 TFLOP/s bf16.  So are
// granite-moe's (H=24, KH=8, hd=64: 5.16e10 operations, 0.052 ms) and
// phi3-mini's (H=KH=32, hd=96: 1.03e11, 0.104 ms).  At hd 64 a score's
// ex2 (16 a clock an SM) costs as much SM time as its 256 tensor-core
// operations (4096 a clock), so the softmax, not the products, sets the
// pace there.
//
// hd = 64 (granite-moe), 96 (phi3-mini) and 128 (qwen3-8b, qwen3-14b,
// qwen2-7b, mixtral) run the Hopper design, namespace ws, a template on
// hd:
//   * one block of 288 threads owns 128 query rows of one (b, h): two
//     consumer warpgroups (warps 0-7) of 64 rows each and one producer
//     warp (warp 8), one thread of which issues every TMA copy.  288
//     threads leave 224 registers to each; a full producer warpgroup with
//     setmaxnreg (384 threads) was tried first at hd 128, but ptxas (CUDA
//     12.9) kept the consumers' code near the launch bound's 168 registers
//     and serialised the wgmmas;
//   * shared memory: Q's 128 x hd tile (loaded once) and a ring of K and of
//     V tiles (Shape<hd>: keys a tile, stages); at hd 128 32 KB of Q and 2
//     stages of 96-key tiles (24 KB each), 129 KB in all, one block per SM.
//     Each tile has a full mbarrier (TMA completes its bytes) and an empty
//     one (each consumer warp arrives once it has read it).  K and V are
//     released apart: K as soon as Q K^T has landed, V after P V, and the
//     producer issues K_j before V_{j-1}, the order in which the consumers
//     need them (one empty barrier per stage for both held each stage a
//     product longer: 0.54 against 0.43 ms at 2 stages, hd 128);
//   * TMA reads the model's layout in place through 4-d tensor maps: q and
//     o over (hd, H, S, B), k and v over (hd, KH, S, B), boxes of 64
//     head-dim columns (128 bytes, the largest inner box of the 128-byte
//     swizzle), so a tile is (hd + 63) / 64 boxes: one at hd 64, two at
//     128, and two at hd 96, whose second box's columns 96-127 lie past the
//     map's hd and arrive as zeros.  A barrier expects every box's whole
//     bytes, zeros included, as for rows past S.  The maps are encoded on
//     the host at every launch (cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint[ByVersion]) and passed by value as
//     __grid_constant__ parameters, which a CUDA graph captures.  Rows past
//     S arrive as zeros; the score mask below still applies;
//   * S = Q K^T runs on wgmma m64n{keys}k16 with both operands in shared
//     memory, K-major as TMA stores them (128-byte swizzle descriptors,
//     8-row groups 1024 bytes apart, k-steps 32 bytes into the span, four
//     a box): hd / 16 k-steps, 6 at hd 96, which never reach the zeros;
//   * the softmax runs in registers in the log2 domain, one FFMA and one
//     ex2.approx.ftz per score: the accumulator gives each row to one quad
//     of lanes, so a row's max is two shuffles; tiles that cross S or the
//     consumer's diagonal are masked with one compare per score against a
//     per-row limit (a per-score key test compiled to a branch per score
//     and cost a third of the kernel's time at hd 128);
//   * O += P V runs on wgmma m64n{hd}k16 with P from registers (the score
//     fragment rounded to bf16 pairs is the A fragment) and V MN-major in
//     shared memory (transpose-B bit set; lbo = the 64-column boxes'
//     distance, so hd 96's columns 64-95 come from the second box, sbo =
//     1024);
//   * overlap: within a consumer, Q K^T of tile j is issued together with
//     P V of tile j - 1 and the softmax of tile j runs while P V does; the
//     two consumers take turns issuing (named barriers 1 and 2), so one's
//     softmax runs while the other's products do.  At hd 128, 96-key tiles
//     are the largest at which S, P and O in flight together (48 + 24 + 64
//     = 136 registers) compile without spills; at 112 and 128 keys ptxas
//     spilled P and serialised the wgmmas.  hd 96 and 64 hold 48 and 32
//     floats of O, which leaves room for larger key tiles (shapes tried
//     below);
//   * epilogue: each consumer normalises its rows, writes them as bf16 in
//     the swizzled layout into its part of Q's buffer and stores them with
//     one TMA box per 64 columns; the map clips rows past S (and hd 96's
//     columns 96-127);
//   * causal blocks run the heaviest query blocks first, and KV tiles
//     wholly above the diagonal are never loaded.  The grid is one block
//     a (query block, b, h), walked query block by query block over groups
//     of (b, h) pairs; a group holds every pair unless the launch's K and
//     V exceed 40 MB of the 50 MB L2 and each KV head serves one query head
//     (head_group), as phi3-mini's 32 do, where each query block would
//     otherwise read its keys from device memory again.
// Measured at hd 128, B=4, S=2048, H=32, KH=8 in CUDA graphs on an NVIDIA
// H100 80GB HBM3 at 700 W, each step against the first design's 0.70 ms
// in the same run: producer/consumer split alone 0.284 ms, with the
// consumers' turns 0.271, with the overlap inside each consumer
// 0.262-0.265 (about 520 TFLOP/s, 1.9x the bound;
// scaled_dot_product_attention 0.252 there).
// Shapes tried at hd 64 (B=4, S=2048, H=24, KH=8) and hd 96 (B=4, S=2048,
// H=KH=32), causal, in CUDA graphs on the same card, four calls of
// scripts/k10_tiles.py, each shape twice in turns (ms; registers a thread;
// none spilled unless said):
//   hd 64: 128 keys, 2 stages 0.147-0.150 (154 registers, kept); 128 keys,
//     3 stages 0.147-0.151, 4 stages 0.148; 112 keys 0.152-0.166 (142); 96
//     keys 0.153-0.157 (130), 3 stages 0.155.  The first design 0.350-0.386,
//     scaled_dot_product_attention 0.137-0.165.
//   hd 96: 96 keys, 2 stages 0.241-0.246 (146, kept); 112 keys 0.239-0.248
//     (158); 96 keys, 3 stages 0.241-0.259; 112 keys, 3 stages 0.249-0.263;
//     128 keys spilled 48 bytes (166 registers) and serialised the wgmmas.
//     Ordered by query block alone (before head_group) every shape took
//     0.331-0.368; groups of 12 pairs 0.241-0.263, of 3 0.258-0.268, of 24
//     and 48 0.257-0.270.  The first design 0.635-0.658, SDPA 0.249-0.256.
//   GQA in groups of whole KV heads: hd 64 in groups of 12-48 pairs
//     0.141-0.144, by query block 0.145-0.150; hd 128 at 4 x 2048 0.266-0.291
//     against 0.262-0.296, at 8 x 2048 in groups of 36 0.572-0.584 against
//     0.534-0.599.
//   Two identical launches (hd 96 in groups of 12) differed by 9 % with
//     their place in the turns, so shapes and orders within that of each
//     other are not told apart: the first shapes stay, and GQA launches
//     keep the order by query block.

// Any other head dim up to 256 runs on the smallest instance at or above
// it (instance_for): the Hopper design at 64, 96 and 128 where hd is a
// multiple of 8 (the maps span hd columns, so the rest of a box arrives
// as zeros and is never stored), else the mma design at 16, 32, 64, 96
// or 256, whose tiles zero-fill the columns past hd and whose output
// writes the first hd.  The scale is always the operands' hd^-0.5.  hd
// 32 and 256 have mma instances of their own (at hd 256, 128 float
// accumulators a thread leave no room for Q's fragments, so Q keeps a
// tile of its own in shared memory).
//
// hd = 16 (the reduced archs that the card tests use) runs the first
// design, namespace mma: 4 warps of mma.sync m16n8k16 over 64 query rows,
// K and V double-buffered with cp.async, both products fed by ldmatrix
// (hd 16 rows are 32 bytes, below the 128-byte swizzle span of the Hopper
// design).  Its hd-64 and hd-96 instances are kept behind
// flash_attn_mma_launch, for a same-call comparison only.  Rows are padded
// by 8 bf16 (16 bytes), so the eight row addresses of an ldmatrix fall in
// distinct bank groups at every hd.  Shared memory: two K and two V stages
// of 64 x (hd + 8) bf16, 12,288 B at hd 16, 36,864 at 64 and 53,248 at 96
// (at 256 a fifth tile for Q, 168,960 B).  The grid is (query blocks,
// b * h) with the pairs past grid.y's 65,535 folded into grid.x.
// A thread holds hd / 8 output n-tiles, hd / 2 float accumulators (48 at
// hd 96), beside hd / 4 registers of Q fragments and 32 scores.
//
// Interface: a plain C function (loaded with ctypes) that launches on the
// caller's stream and returns cudaGetLastError().
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// hd = 16, and 64 and 96 for comparison: the first design, mma.sync with
// cp.async double buffering
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;

static_assert(kBQ == kBK, "the Q tile is staged in a K stage");

template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;        // bf16 per padded row
  static constexpr int kElems = kBK * kStride;  // one K, V or Q tile
  // Q's fragments stay in registers up to hd 128; at hd 256 beside 128
  // accumulators they would spill, so Q keeps a tile of its own and its
  // fragments are read from it at each k-step
  static constexpr bool kQInSmem = HD > 128;
  // two stages of K and two of V; Q in the second K stage, or its own
  static constexpr int kSmemBytes =
      (kQInSmem ? 5 : 4) * kElems * (int)sizeof(bf16);
};

// 16 bytes global -> shared; zero-filled when !valid (src is then unread)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) of one head, `stride` elements apart in
// global memory, into a padded shared tile; rows at or past S, and the
// columns from the head dim hd (<= HD) to the instance's HD, are
// zero-filled.  A head dim that is a multiple of 8 moves in 16-byte
// cp.async copies (a chunk past hd is a zero fill); another one element
// by element, with plain loads and stores (the tile is read after the
// block's next barrier either way).
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int S,
                                          int tid, int hd) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  if (hd % 8 == 0) {
#pragma unroll
    for (int c = tid; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks, k = c % kChunks;
      const int row = row0 + r;
      const bool valid = row < S && k * 8 < hd;
      cp_async_16(dst + r * Tile<HD>::kStride + k * 8,
                  src + (valid ? row * stride + k * 8 : 0), valid);
    }
    return;
  }
  for (int e = tid; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, col = e % HD;
    const int row = row0 + r;
    dst[r * Tile<HD>::kStride + col] =
        row < S && col < hd ? src[row * stride + col] : __float2bfloat16(0.0f);
  }
}

// HD: the instance; hd <= HD the operands' head dim, whose columns fill
// the first hd of each tile row (the rest are zeros, which add nothing
// to Q K^T, and whose output columns are never written).  The grid is
// (query blocks x parts, min(BH, 65535)): (b, h) pair blockIdx.y +
// part * gridDim.y, so that any B * H runs.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KH,
    int hd, int BH, int causal, float scale_log2) {
  constexpr int kStride = Tile<HD>::kStride;
  constexpr int kElems = Tile<HD>::kElems;
  constexpr int kSteps = HD / 16;  // k-steps of Q K^T over the head dim
  constexpr int kOut = HD / 8;     // 8-wide output column tiles
  constexpr bool kQInSmem = Tile<HD>::kQInSmem;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // stages sK, sK + kElems
  bf16* sV = sK + 2 * kElems;                     // stages sV, sV + kElems
  // Q: in the second K stage until its fragments are in registers, or
  // (kQInSmem) in a tile of its own throughout
  bf16* sQ = kQInSmem ? sK + 4 * kElems : sK + kElems;

  const int nq = (S + kBQ - 1) / kBQ;
  const int part = (int)blockIdx.x / nq;
  const int qi = (int)blockIdx.x - part * nq;
  const int qb = causal ? nq - 1 - qi : qi;
  const int bh = part * (int)gridDim.y + (int)blockIdx.y;
  if (bh >= BH) return;  // the whole block: past the last pair
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)KH * hd;
  const bf16* qg = q + ((long long)b * S * H + h) * hd;
  const bf16* kg = k + ((long long)b * S * KH + kvh) * hd;
  const bf16* vg = v + ((long long)b * S * KH + kvh) * hd;
  bf16* og = o + ((long long)b * S * H + h) * hd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, quad = lane & 3;  // mma row group, lane in it
  const int mi = lane >> 3, mr = lane & 7;     // ldmatrix matrix, its row
  const int q0 = qb * kBQ;
  const int wrow = warp * 16;                  // the warp's first row

  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  load_tile<HD, kBQ>(sQ, qg, q_stride, q0, S, tid, hd);
  load_tile<HD, kBK>(sK, kg, kv_stride, 0, S, tid, hd);
  load_tile<HD, kBK>(sV, vg, kv_stride, 0, S, tid, hd);
  cp_async_commit();

  uint32_t qf[kQInSmem ? 1 : kSteps][4];
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  // rows grp and grp + 8 of the warp: running max (log2 domain) and this
  // lane's share of the denominator
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; tile j - 1 is no longer read
    if (!kQInSmem && j == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ldmatrix_x4(qf[ks], sQ + (wrow + (mi & 1) * 8 + mr) * kStride +
                                ks * 16 + (mi >> 1) * 8);
      __syncthreads();  // Q's stage is free for tile 1
    }
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int row0 = (j + 1) * kBK;
      load_tile<HD, kBK>(sK + st * kElems, kg, kv_stride, row0, S, tid, hd);
      load_tile<HD, kBK>(sV + st * kElems, vg, kv_stride, row0, S, tid, hd);
      cp_async_commit();
    }
    const bf16* cK = sK + (j & 1) * kElems;
    const bf16* cV = sV + (j & 1) * kElems;

    // scores: 16 rows x 64 keys per warp, 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qa[4];
      if constexpr (kQInSmem) {
        ldmatrix_x4(qa, sQ + (wrow + (mi & 1) * 8 + mr) * kStride + ks * 16 +
                            (mi >> 1) * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kQInSmem ? 0 : ks][e];
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, cK + (np * 16 + (mi >> 1) * 8 + mr) * kStride +
                            ks * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    const int key0 = j * kBK;
    const bool masked = key0 + kBK > S ||
                        (causal && key0 + kBK - 1 > q0 + wrow);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int key = key0 + n * 8 + quad * 2 + (e & 1);
          const int row = q0 + wrow + grp + (e >> 1) * 8;
          if (key >= S || (causal && key > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // probabilities (exactly 0 where masked), their row sums in float32,
    // and the bf16 A fragments of P for the second product
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            s[n][e] == kNegInf ? 0.0f : exp2f(s[n][e] - m_run[r]);
        s[n][e] = p;
        l_run[r] += p;
      }
      pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(s[n][0], s[n][1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: 4 k-steps of 16 keys, output columns in pairs of tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kOut / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + (kk * 16 + (mi & 1) * 8 + mr) * kStride +
                                  dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
    l_run[r] = 1.0f / fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + grp + r * 8;
    if (row >= S) continue;
    bf16* orow = og + row * q_stride + quad * 2;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      const float lo = acc[n][2 * r] * l_run[r];
      const float hi = acc[n][2 * r + 1] * l_run[r];
      const int col = n * 8 + quad * 2;  // the first hd columns only
      if (col + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < hd) orow[n * 8] = __float2bfloat16(lo);
        if (col + 1 < hd) orow[n * 8 + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// the instance HD at head dim hd <= HD; B * H past grid.y's 65,535 folds
// into grid.x (parts of at most 65,535 pairs)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int hd, int causal, float scale_log2,
           cudaStream_t stream) {
  const long long BH = (long long)B * H;
  const long long gy = BH < 65535 ? BH : 65535;
  const long long nq = (S + kBQ - 1) / kBQ, parts = (BH + gy - 1) / gy;
  if (hd < 1 || hd > HD || BH > 0x7fffffff || nq * parts > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int smem = Tile<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(nq * parts), (unsigned)gy);
  flash_attn_kernel_mma<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KH, hd,
      (int)BH, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// hd = 64, 96 and 128: TMA, wgmma and a warp-specialised pipeline
// ---------------------------------------------------------------------------
namespace ws {

constexpr int kBQ = 128;          // query rows per block, 64 per consumer
constexpr int kConsumers = 2;
// two consumer warpgroups (warps 0-7) and one producer warp (warp 8): 288
// threads, so the launch bounds give every thread 224 registers
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kBoxCols = 64;            // head-dim columns per TMA box
constexpr int kRowBytes = kBoxCols * 2;  // 128: the swizzle span
constexpr int kOutRows = kBQ / kConsumers;  // 64: one consumer's rows
// named barriers (0 is __syncthreads): 1 + c is consumer c's turn to
// issue, 3 + c its epilogue
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

// keys per K/V tile and tiles in the ring, per head dim (the shapes tried
// are in the header)
template <int HD>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int kBK = 128, kStages = 2;
};
template <>
struct Shape<96> {
  static constexpr int kBK = 96, kStages = 2;
};
template <>
struct Shape<128> {
  static constexpr int kBK = 96, kStages = 2;
};

template <int HD>
struct Cfg {
  static constexpr int kBK = Shape<HD>::kBK;
  static constexpr int kStages = Shape<HD>::kStages;
  // 64-column boxes a tile: hd 96's second box is half out of bounds
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kQHalf = kBQ * kRowBytes;  // one 64-column box of Q
  static constexpr int kKVHalf = kBK * kRowBytes;
  // whole boxes: TMA counts the zeros it writes out of bounds
  static constexpr int kQBytes = kBoxes * kQHalf;
  static constexpr int kKVBytes = kBoxes * kKVHalf;
  static constexpr int kS = kBK / 2;     // score floats per thread
  static constexpr int kO = HD / 2;      // output floats per thread
  static constexpr int kPSteps = kBK / 16;  // k-steps of P V
  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  // mbarriers: Q full, then K full, V full, K empty and V empty per stage
  static constexpr int kBarBytes = 8 * (1 + 4 * kStages);
  static constexpr int kSmemBytes = kOffBar + kBarBytes + 1024;  // + slack

  static_assert(HD % 16 == 0 && HD <= 128, "Q K^T takes 16 columns a step");
  static_assert(kBK % 16 == 0 && kBK <= 256, "P V takes 16 keys a step");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// one box of a 4-d tensor map into shared memory; rows and columns out of
// bounds arrive as zeros and count towards the barrier's bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory to a 4-d tensor map; rows and columns out of
// bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma descriptor of a tile in shared memory laid out as TMA writes it
// with 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
// (sbo); lbo is the distance between 64-column halves for an MN-major
// operand and unused for a K-major one
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the accumulator operands of an m64nN product: N / 2 floats a thread
#define WG_REGS32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define WG_REGS48                                                            \
  WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
            "%44, %45, %46, %47"
#define WG_REGS56 WG_REGS48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_REGS64 WG_REGS56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D48 WG_D32, WG_D8(32), WG_D8(40)
#define WG_D56 WG_D48, WG_D8(48)
#define WG_D64 WG_D56, WG_D8(56)

// d (64 x N f32, wgmma layout) (+)= A (64 x 16, shared) . B (16 x N,
// shared, K-major); scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N f32) += A (64 x 16 bf16, registers) . B (16 x N, shared,
// MN-major: the transpose-B bit is set)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

// the operands after the accumulators are numbered from N / 2
#define WG_SS(N, A, B, P, REGS, D)                                          \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<N>(float (&d)[N / 2], uint64_t da, \
                                              uint64_t db, int scale_d) {   \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 REGS "}, %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"            \
                 : D                                                        \
                 : "l"(da), "l"(db), "r"(scale_d));                         \
  }
#define WG_RS(N, A0, A1, A2, A3, B, P, REGS, D)                              \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_rs<N>(                               \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 REGS "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B    \
                 ", p, 1, 1, 1;\n}\n"                                        \
                 : D                                                         \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(1));                                                  \
  }
WG_SS(96, 48, 49, 50, WG_REGS48, WG_D48)
WG_SS(128, 64, 65, 66, WG_REGS64, WG_D64)
WG_RS(64, 32, 33, 34, 35, 36, 37, WG_REGS32, WG_D32)
WG_RS(96, 48, 49, 50, 51, 52, 53, WG_REGS48, WG_D48)
WG_RS(128, 64, 65, 66, 67, 68, 69, WG_REGS64, WG_D64)
#undef WG_SS
#undef WG_RS

// S (64 x kBK) = Q K^T from the descriptors of this consumer's 64 rows of
// Q and of the K tile, both K-major: HD / 16 k-steps of 16 head-dim
// columns, each 32 bytes into a 128-byte swizzle span, four a 64-column box
// (the address field counts 16-byte units)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<HD>::kS], uint64_t dq,
                                         uint64_t dk) {
  using C = Cfg<HD>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int off = (ks % 4) * 2;
    wgmma_ss<C::kBK>(s, dq + (ks / 4) * (C::kQHalf / 16) + off,
                     dk + (ks / 4) * (C::kKVHalf / 16) + off, ks > 0);
  }
  wgmma_commit();
}

// O (64 x HD) += P V: P from registers, V MN-major from its descriptor
// (lbo the boxes' distance: at hd 96 columns 64-95 are the second box's
// first half); k-step kk takes keys 16 kk .. 16 kk + 15, two 8-row groups
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[Cfg<HD>::kO], const uint32_t (&pf)[Cfg<HD>::kPSteps][4],
    uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Cfg<HD>::kPSteps; ++kk)
    wgmma_rs<HD>(o, pf[kk], dv + kk * (16 * kRowBytes / 16));
  wgmma_commit();
}

// P's bf16 A fragments from the probabilities in the accumulator layout:
// k-step kk holds score columns 8 kk .. 8 kk + 7 of this thread
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 16][4],
                                       const float (&p)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      pf[kk][a] = pack_bf16(p[8 * kk + 2 * a], p[8 * kk + 2 * a + 1]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one consumer thread's two rows (row_lo and
// row_lo + 8) over tiles of BK keys, in the log2 domain: p = 2^(s *
// scale_log2 - m * scale_log2) with one FFMA and one ex2 per score
template <int BK>
struct Softmax {
  static constexpr int kS = BK / 2;
  int S, causal, row0, row_lo, quad;
  float scale_log2;
  float m[2] = {kNegInf, kNegInf};  // running max of each row's scores
  float l[2] = {0.0f, 0.0f};        // this lane's share of each row's sum

  __device__ Softmax(int S_, int causal_, int row0_, int row_lo_, int quad_,
                     float scale_log2_)
      : S(S_), causal(causal_), row0(row0_), row_lo(row_lo_), quad(quad_),
        scale_log2(scale_log2_) {}

  // turns the scores of the tile at key0 into probabilities, exactly 0
  // where masked (keys at or past S, and above the diagonal when causal:
  // their score is -1e30, and the running max is a real score from tile 0
  // on, since key 0 is unmasked for every row, so 2^(-1e30 * scale - m)
  // is 0); sums them in float32 before P is rounded to bf16; returns each
  // row's rescale factor for O
  __device__ __forceinline__ float2 tile(float (&s)[kS], int key0) {
    if (key0 + BK > S || (causal && key0 + BK - 1 > row0)) {
      // score i of this thread is key key0 + 2 quad + c(i), c(i) = 8 (i / 4)
      // + i % 2; row r keeps the keys below lim[r] + key0 + 2 quad
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lim[r] = (causal ? min(S, row_lo + 8 * r + 1) : S) - key0 - 2 * quad;
#pragma unroll
      for (int i = 0; i < kS; ++i)
        if ((i >> 2) * 8 + (i & 1) >= lim[(i >> 1) & 1]) s[i] = kNegInf;
    }
    // two partial maxima and sums a row, for shorter dependency chains
    float mx[4] = {m[0], m[1], m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int k = ((i >> 1) & 1) + 2 * ((i >> 2) & 1);
      mx[k] = fmaxf(mx[k], s[i]);
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], mx[r + 2]);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = ex2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
    }
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, -ms[r]));
      sum[r + 2 * ((i >> 2) & 1)] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r] + sum[r + 2]);
    return make_float2(alpha[0], alpha[1]);
  }

  // 1 / max(l, 1e-30) of each row, the lanes' shares summed
  __device__ __forceinline__ float2 inverse_sums() {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r] + __shfl_xor_sync(kFull, l[r], 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      inv[r] = 1.0f / fmaxf(sum, 1e-30f);
    }
    return make_float2(inv[0], inv[1]);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_kernel_ws(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to, int S, int H,
                         int KH, int causal, float scale_log2, int group) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK, kStages = C::kStages, kBoxes = C::kBoxes;
  constexpr int kQHalf = C::kQHalf, kKVHalf = C::kKVHalf;
  constexpr int kKVBytes = C::kKVBytes, kO = C::kO;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + C::kOffK, sV = base + C::kOffV;
  const uint32_t bar_q = base + C::kOffBar;
  // full barriers complete when TMA has written a tile; empty ones when
  // every consumer warp has read it
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages,
                 bar_ek = bar_v + 8 * kStages, bar_ev = bar_ek + 8 * kStages;

  // the block's query block and (b, h): the (b, h) pairs run in groups of
  // `group`, one group after another; in a group the query blocks run
  // heaviest first (when causal) and the group's pairs fastest
  const int nq = (S + kBQ - 1) / kBQ;
  const int g0 = (int)blockIdx.x / (group * nq) * group;  // its first pair
  const int gn = min(group, (int)gridDim.x / nq - g0);    // its pairs
  const int r = (int)blockIdx.x - g0 * nq;
  const int qb = causal ? nq - 1 - r / gn : r / gn;
  const int bh = g0 + r % gn;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = qb * kBQ;
  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  const int tid = threadIdx.x;
  // the warp, broadcast from lane 0 so that the compiler sees it is the
  // same across each warp (wgmma under a branch it cannot prove uniform is
  // serialised)
  const int warp_id = __shfl_sync(kFull, tid / 32, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, 4 * kConsumers);  // one per consumer warp
      mbar_init(bar_ev + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id == kProducerWarp) {
    // producer warp: one thread keeps the ring full
    if (tid % 32 == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&to);
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        tma_load(sQ + x * kQHalf, &tq, bar_q, x * kBoxCols, h, q0, b);
      // tile j of K or V into its stage, once both consumers have released
      // the tile kStages before it
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t full,
                      uint32_t empty, int j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * st, (j / kStages - 1) & 1);
        dst += st * kKVBytes;
        mbar_expect_tx(full + 8 * st, kKVBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(dst + x * kKVHalf, map, full + 8 * st, x * kBoxCols, kvh,
                   j * kBK, b);
      };
      // the consumers need K_j together with V_{j-1}
      load(sK, &tk, bar_k, bar_ek, 0);
      for (int j = 1; j < n_tiles; ++j) {
        load(sK, &tk, bar_k, bar_ek, j);
        load(sV, &tv, bar_v, bar_ev, j - 1);
      }
      load(sV, &tv, bar_v, bar_ev, n_tiles - 1);
    }
  } else {
    // consumer warpgroups: 64 query rows each, both products on wgmma
    const int c = warp_id / 4;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int grp = lane >> 2, quad = lane & 3;
    const int row0 = q0 + c * kOutRows;         // the consumer's first row
    const int row_lo = row0 + warp * 16 + grp;  // rows row_lo, row_lo + 8
    const uint32_t qa = sQ + c * kOutRows * kRowBytes;
    // wgmma descriptors: Q's rows, then K and V stage 0 (a stage is
    // kKVBytes / 16 further)
    const uint64_t dq = sw128_desc(qa, 16, 1024);
    const uint64_t dk = sw128_desc(sK, 16, 1024);
    const uint64_t dv = sw128_desc(sV, kKVHalf, 1024);

    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.0f;
    Softmax<kBK> sm(S, causal, row0, row_lo, quad, scale_log2);
    float s[C::kS];
    uint32_t pf[C::kPSteps][4];  // P of the last tile, bf16 A fragments

    if (c == 1) bar_arrive(kTurnBar, 256);  // consumer 0 issues first
    mbar_wait(bar_q, 0);

    // tile 0: S_0 = Q K_0^T and its softmax
    mbar_wait(bar_k, 0);
    bar_sync(kTurnBar + c, 256);
    issue_qk<HD>(s, dq, dk);
    bar_arrive(kTurnBar + 1 - c, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bar_ek);  // K_0 released
    sm.tile(s, 0);
    pack_p<kBK>(pf, s);

    // tile j: S_j is issued with O += P_{j-1} V_{j-1}; the softmax of S_j
    // runs while P V does
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(bar_k + 8 * st, (j / kStages) & 1);
      bar_sync(kTurnBar + c, 256);
      issue_qk<HD>(s, dq, dk + st * (kKVBytes / 16));
      mbar_wait(bar_v + 8 * sp, ((j - 1) / kStages) & 1);
      issue_pv<HD>(o, pf, dv + sp * (kKVBytes / 16));
      bar_arrive(kTurnBar + 1 - c, 256);
      wgmma_wait<1>();  // S_j has landed; P V may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(bar_ek + 8 * st);  // K_j released
      const float2 alpha = sm.tile(s, j * kBK);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
      pack_p<kBK>(pf, s);
      if (lane == 0) mbar_arrive(bar_ev + 8 * sp);  // V_{j-1} released
    }

    // the last tile's P V
    const int last = n_tiles - 1;
    mbar_wait(bar_v + 8 * (last % kStages), (last / kStages) & 1);
    bar_sync(kTurnBar + c, 256);
    issue_pv<HD>(o, pf, dv + (last % kStages) * (kKVBytes / 16));
    if (c == 0) bar_arrive(kTurnBar + 1, 256);  // one turn per sync
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: normalise, stage bf16 rows in this consumer's part of Q's
    // buffer in the swizzled layout, and store them with one TMA box per
    // 64 columns (the map clips rows past S and hd 96's columns 96-127)
    const float2 inv = sm.inverse_sums();
    unsigned char* out = smem + (qa - base);
#pragma unroll
    for (int i = 0; i < kO; i += 2) {
      const int r = (i >> 1) & 1, col8 = i >> 2;  // 8-column group
      const int row = warp * 16 + grp + r * 8;
      unsigned char* dst = out + (col8 / 8) * kQHalf + row * kRowBytes +
                           (((col8 % 8) ^ (row % 8)) * 16) + quad * 4;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[i] * (r ? inv.y : inv.x),
                                o[i + 1] * (r ? inv.y : inv.x));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(kStoreBar + c, 128);
    if (t == 0 && row0 < S) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        tma_store(&to, qa + x * kQHalf, x * kBoxCols, h, row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over (hd, heads, S, B) of a contiguous bf16 (B, S, heads, hd)
// tensor, box (64, 1, rows, 1), 128-byte swizzle, zeros out of bounds
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int heads, int hd, int rows) {
  const cuuint64_t row = (cuuint64_t)hd * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K and V bytes that the blocks in flight may keep in L2 (50 MB)
constexpr double kKVInL2 = 40e6;

// the (b, h) pairs a group of blocks walks together (see the kernel).  All
// of them, so that the blocks run by query block alone, unless the
// launch's K and V pass kKVInL2 and each KV head serves one query head.
// There (phi3-mini's 32 KV heads at S = 2048: 100 MB) the 132 blocks in
// flight read the K and V of 132 heads, and every query block of a pair
// would read its key prefix from device memory again: 2.3x the products'
// time, since the re-read bytes grow with KH and the products with H.
// Groups of heads that bring in a quarter of kKVInL2 keep the two groups
// in flight in L2 (hd 96 at 4 x 2048: 0.336 -> 0.244 ms).  With H / KH
// query heads a KV head the re-reads are H / KH times fewer for the same
// products and hide under them: at qwen3-8b's 8 x 2048 (67 MB) groups of
// 9 KV heads took 0.572-0.584 ms and the order by query block 0.534-0.599,
// in the same turns on an H100 (scripts/k10_tiles.py), so GQA launches
// keep that order.
int head_group(int B, int S, int H, int KH, int hd) {
  const double kv = 4.0 * S * hd;  // K and V bytes of one head
  if (H != KH || B * KH * kv <= kKVInL2) return B * H;
  return max(1, (int)(kKVInL2 / 4 / kv));
}

// the instance HD at head dim hd <= HD, a multiple of 8 (TMA's rows are
// whole 16-byte units): the maps span hd columns, so the columns from hd
// to HD arrive as zeros and are never stored, as hd 96's 96-127 are on
// its own instance
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int hd, int causal, float scale_log2,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  // one block a (query block, b, h)
  const long long blocks = (long long)B * H * ((S + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffff || hd < 1 || hd > HD || hd % 8)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, encode, q, B, S, H, hd, kBQ) ||
      !make_map(&tk, encode, k, B, S, KH, hd, C::kBK) ||
      !make_map(&tv, encode, v, B, S, KH, hd, C::kBK) ||
      !make_map(&to, encode, o, B, S, H, hd, kOutRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel_ws<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  flash_attn_kernel_ws<HD><<<(unsigned)blocks, kThreads, C::kSmemBytes,
                             stream>>>(tq, tk, tv, to, S, H, KH, causal,
                                       scale_log2,
                                       head_group(B, S, H, KH, hd));
  return (int)cudaGetLastError();
}

}  // namespace ws

// the launch's arguments checked, and hd^-0.5 in the log2 domain of exp2f
bool valid_args(int B, int S, int H, int KH, int hd, float* scale_log2) {
  *scale_log2 = kLog2e / sqrtf((float)hd);
  return B > 0 && S > 0 && H > 0 && KH > 0 && H % KH == 0;
}

}  // namespace

// The instance that runs head dim hd (1 <= hd <= 256): the smallest at or
// above it, 16, 32, 64, 96, 128 or 256, where TMA reads hd (a multiple of
// 8) on the Hopper design; another hd above 32 runs the mma.sync design's
// hd-64 or hd-96 instance, or its hd-256 one above 96.  Returns the
// instance; *tma whether it is the Hopper design's.  0 for hd outside.
int instance_for(int hd, bool* tma) {
  *tma = false;
  if (hd < 1 || hd > 256) return 0;
  if (hd <= 16) return 16;
  if (hd <= 32) return 32;
  *tma = hd % 8 == 0;
  if (hd <= 64) return 64;
  if (hd <= 96) return 96;
  if (hd <= 128 && *tma) return 128;
  *tma = false;
  return 256;
}

// q (B, S, H, hd), k and v (B, S, KH, hd), o (B, S, H, hd): bf16,
// contiguous, 16-byte aligned where hd is a multiple of 8.  1 <= hd <=
// 256, scaled by hd^-0.5 whatever instance runs it (instance_for);
// H % KH == 0; B * H * ceil(S / 128) < 2^31 on the Hopper design.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KH, int hd,
                                 int causal, void* stream) {
  float scale_log2;
  if (!valid_args(B, S, H, KH, hd, &scale_log2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bool tma = false;
  switch (instance_for(hd, &tma)) {
    case 16:
      return mma::launch<16>(q, k, v, o, B, S, H, KH, hd, causal, scale_log2,
                             st);
    case 32:
      return mma::launch<32>(q, k, v, o, B, S, H, KH, hd, causal, scale_log2,
                             st);
    case 64:
      return tma ? ws::launch<64>(q, k, v, o, B, S, H, KH, hd, causal,
                                  scale_log2, st)
                 : mma::launch<64>(q, k, v, o, B, S, H, KH, hd, causal,
                                   scale_log2, st);
    case 96:
      return tma ? ws::launch<96>(q, k, v, o, B, S, H, KH, hd, causal,
                                  scale_log2, st)
                 : mma::launch<96>(q, k, v, o, B, S, H, KH, hd, causal,
                                   scale_log2, st);
    case 128:
      return ws::launch<128>(q, k, v, o, B, S, H, KH, hd, causal, scale_log2,
                             st);
    case 256:
      return mma::launch<256>(q, k, v, o, B, S, H, KH, hd, causal,
                              scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The instance and design flash_attn_launch runs at head dim hd: the
// instance's hd, negated for the mma.sync design; 0 outside 1..256.
extern "C" int flash_attn_instance(int hd) {
  bool tma = false;
  const int inst = instance_for(hd, &tma);
  return tma ? inst : -inst;
}

// the first design (mma.sync) at hd 64 and 96, with flash_attn_launch's
// arguments: kept for a same-call comparison with the Hopper design, which
// flash_attn_launch runs at those head dims; B * H <= 65535
extern "C" int flash_attn_mma_launch(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KH, int hd, int causal,
                                     void* stream) {
  float scale_log2;
  if (!valid_args(B, S, H, KH, hd, &scale_log2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return mma::launch<64>(q, k, v, o, B, S, H, KH, hd, causal, scale_log2,
                             st);
    case 96:
      return mma::launch<96>(q, k, v, o, B, S, H, KH, hd, causal, scale_log2,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory a flash_attn_launch at head dim hd asks for,
// -1 outside 1..256
extern "C" int flash_attn_smem_bytes(int hd) {
  switch (flash_attn_instance(hd)) {
    case -16:
      return mma::Tile<16>::kSmemBytes;
    case -32:
      return mma::Tile<32>::kSmemBytes;
    case -64:
      return mma::Tile<64>::kSmemBytes;
    case -96:
      return mma::Tile<96>::kSmemBytes;
    case -256:
      return mma::Tile<256>::kSmemBytes;
    case 64:
      return ws::Cfg<64>::kSmemBytes;
    case 96:
      return ws::Cfg<96>::kSmemBytes;
    case 128:
      return ws::Cfg<128>::kSmemBytes;
    default:
      return -1;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
