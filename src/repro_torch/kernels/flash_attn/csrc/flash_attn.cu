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
// by operations: 0.139 ms at the published 989 TFLOP/s bf16.
//
// hd = 128 (qwen3-8b's heads) runs the Hopper design, namespace ws:
//   * one block of 288 threads owns 128 query rows of one (b, h): two
//     consumer warpgroups (warps 0-7) of 64 rows each and one producer
//     warp (warp 8), one thread of which issues every TMA copy.  288
//     threads leave 224 registers to each; a full producer warpgroup with
//     setmaxnreg (384 threads) was tried first, but ptxas (CUDA 12.9) kept
//     the consumers' code near the launch bound's 168 registers and
//     serialised the wgmmas;
//   * shared memory: Q's 128 x 128 tile (32 KB, loaded once) and a ring of
//     2 stages of K and of V tiles of 96 keys (24 KB each), 129 KB in all,
//     one block per SM.  Each tile has a full mbarrier (TMA completes its
//     bytes) and an empty one (each consumer warp arrives once it has read
//     it).  K and V are released apart: K as soon as Q K^T has landed, V
//     after P V, and the producer issues K_j before V_{j-1}, the order in
//     which the consumers need them (one empty barrier per stage for both
//     held each stage a product longer: 0.54 against 0.43 ms at 2 stages);
//   * TMA reads the model's layout in place through 4-d tensor maps: q and
//     o over (hd, H, S, B), k and v over (hd, KH, S, B), boxes of 64
//     head-dim columns (128 bytes, the largest inner box of the 128-byte
//     swizzle), so each tile is two boxes.  The maps are encoded on the
//     host at every launch (cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint[ByVersion]) and passed by value as
//     __grid_constant__ parameters, which a CUDA graph captures.  Rows past
//     S arrive as zeros; the score mask above still applies;
//   * S = Q K^T runs on wgmma m64n96k16 with both operands in shared
//     memory, K-major as TMA stores them (128-byte swizzle descriptors,
//     8-row groups 1024 bytes apart, k-steps 32 bytes into the span);
//   * the softmax runs in registers in the log2 domain, one FFMA and one
//     ex2.approx.ftz per score: the accumulator gives each row to one quad
//     of lanes, so a row's max is two shuffles; tiles that cross S or the
//     consumer's diagonal are masked with one compare per score against a
//     per-row limit (a per-score key test compiled to a branch per score
//     and cost a third of the kernel's time);
//   * O += P V runs on wgmma m64n128k16 with P from registers (the score
//     fragment rounded to bf16 pairs is the A fragment) and V MN-major in
//     shared memory (transpose-B bit set; lbo = the 64-column halves'
//     distance, sbo = 1024);
//   * overlap: within a consumer, Q K^T of tile j is issued together with
//     P V of tile j - 1 and the softmax of tile j runs while P V does; the
//     two consumers take turns issuing (named barriers 1 and 2), so one's
//     softmax runs while the other's products do.  96-key tiles are the
//     largest at which S, P and O in flight together (136 registers)
//     compile without spills; at 112 and 128 keys ptxas spilled P and
//     serialised the wgmmas;
//   * epilogue: each consumer normalises its rows, writes them as bf16 in
//     the swizzled layout into its half of Q's buffer and stores them with
//     two TMA boxes; the map clips rows past S;
//   * causal blocks run the heaviest query blocks first (blockIdx.y walks
//     query blocks from the last, blockIdx.x the (b, h)), and KV tiles
//     wholly above the diagonal are never loaded.
// Measured at the served shape in CUDA graphs on an NVIDIA H100 80GB HBM3
// at 700 W, each step against the first design's 0.70 ms in the same run:
// producer/consumer split alone 0.284 ms, with the consumers' turns 0.271,
// with the overlap inside each consumer 0.262-0.265 (about 520 TFLOP/s,
// 1.9x the bound; scaled_dot_product_attention 0.252 there).

// hd = 16 (the reduced archs that the card tests use), 64 (granite-moe)
// and 96 (phi3-mini) keep the first design, namespace mma: 4 warps of
// mma.sync m16n8k16 over 64 query rows, K and V double-buffered with
// cp.async, both products fed by ldmatrix (hd = 16 rows are 32 bytes,
// below the 128-byte swizzle span of the Hopper design; a 192-byte hd-96
// row spans one and a half, and that design's boxes are cut for 128).
// Rows are padded by 8 bf16 (16 bytes), so the eight row addresses of an
// ldmatrix fall in distinct bank groups at every hd.  Shared memory: two
// K and two V stages of 64 x (hd + 8) bf16, 12,288 B at hd 16, 36,864 at
// 64 and 53,248 at 96.  A thread holds hd / 8 output n-tiles, hd / 2
// float accumulators (48 at hd 96), beside hd / 4 registers of Q
// fragments and 32 scores.
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
// hd = 16: the first design, mma.sync with cp.async double buffering
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
  // two stages of K and two of V; Q is staged in the second K stage
  static constexpr int kSmemBytes = 4 * kElems * (int)sizeof(bf16);
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
// global memory, into a padded shared tile; rows at or past S are
// zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int S,
                                          int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, k = c % kChunks;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async_16(dst + r * Tile<HD>::kStride + k * 8,
                src + (valid ? row : 0) * stride + k * 8, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int KH,
    int causal, float scale_log2) {
  constexpr int kStride = Tile<HD>::kStride;
  constexpr int kElems = Tile<HD>::kElems;
  constexpr int kSteps = HD / 16;  // k-steps of Q K^T over the head dim
  constexpr int kOut = HD / 8;     // 8-wide output column tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // stages sK, sK + kElems
  bf16* sV = sK + 2 * kElems;                     // stages sV, sV + kElems
  bf16* sQ = sK + kElems;  // until its fragments are in registers

  const int nq = gridDim.x;
  const int qb = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KH * HD;
  const bf16* qg = q + ((long long)b * S * H + h) * HD;
  const bf16* kg = k + ((long long)b * S * KH + kvh) * HD;
  const bf16* vg = v + ((long long)b * S * KH + kvh) * HD;
  bf16* og = o + ((long long)b * S * H + h) * HD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, quad = lane & 3;  // mma row group, lane in it
  const int mi = lane >> 3, mr = lane & 7;     // ldmatrix matrix, its row
  const int q0 = qb * kBQ;
  const int wrow = warp * 16;                  // the warp's first row

  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  load_tile<HD, kBQ>(sQ, qg, q_stride, q0, S, tid);
  load_tile<HD, kBK>(sK, kg, kv_stride, 0, S, tid);
  load_tile<HD, kBK>(sV, vg, kv_stride, 0, S, tid);
  cp_async_commit();

  uint32_t qf[kSteps][4];
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
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
        ldmatrix_x4(qf[ks], sQ + (wrow + (mi & 1) * 8 + mr) * kStride +
                                ks * 16 + (mi >> 1) * 8);
      __syncthreads();  // Q's stage is free for tile 1
    }
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      const int row0 = (j + 1) * kBK;
      load_tile<HD, kBK>(sK + st * kElems, kg, kv_stride, row0, S, tid);
      load_tile<HD, kBK>(sV + st * kElems, vg, kv_stride, row0, S, tid);
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
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, cK + (np * 16 + (mi >> 1) * 8 + mr) * kStride +
                            ks * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
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
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * l_run[r],
                                acc[n][2 * r + 1] * l_run[r]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int causal, float scale_log2, cudaStream_t stream) {
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;  // grid y
  const int smem = Tile<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attn_kernel_mma<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KH, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// hd = 128: TMA, wgmma and a warp-specialised pipeline
// ---------------------------------------------------------------------------
namespace ws {

constexpr int kHD = 128;
constexpr int kBQ = 128;          // query rows per block, 64 per consumer
constexpr int kBK = 96;           // keys per K/V tile
constexpr int kStages = 2;        // K and V tiles in the ring
constexpr int kConsumers = 2;
// two consumer warpgroups (warps 0-7) and one producer warp (warp 8): 288
// threads, so the launch bounds give every thread 224 registers
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kBoxCols = 64;            // head-dim columns per TMA box
constexpr int kRowBytes = kBoxCols * 2;  // 128: the swizzle span
constexpr int kQHalf = kBQ * kRowBytes;  // one 64-column half of Q
constexpr int kKVHalf = kBK * kRowBytes;
constexpr int kQBytes = 2 * kQHalf;
constexpr int kKVBytes = 2 * kKVHalf;
constexpr int kOutRows = kBQ / kConsumers;  // 64: one consumer's rows
constexpr int kS = kBK / 2;                 // score floats per thread
constexpr int kO = kHD / 2;                 // output floats per thread
constexpr int kPSteps = kBK / 16;           // k-steps of P V
// byte offsets from the 1024-aligned base of dynamic shared memory
constexpr int kOffK = kQBytes;
constexpr int kOffV = kOffK + kStages * kKVBytes;
constexpr int kOffBar = kOffV + kStages * kKVBytes;
// mbarriers: Q full, then K full, V full, K empty and V empty per stage
constexpr int kBarBytes = 8 * (1 + 4 * kStages);
constexpr int kSmemBytes = kOffBar + kBarBytes + 1024;  // + alignment slack
// named barriers (0 is __syncthreads): 1 + c is consumer c's turn to
// issue, 3 + c its epilogue
constexpr int kTurnBar = 1;
constexpr int kStoreBar = 3;

static_assert(kS == 48, "Q K^T is instantiated as m64n96k16");
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");

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

// one box of a 4-d tensor map into shared memory; rows out of bounds
// arrive as zeros and count towards the barrier's bytes
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

// one box from shared memory to a 4-d tensor map; rows out of bounds are
// not written
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

// d (64 x 96 f32, wgmma layout) (+)= A (64 x 16, shared) . B (16 x 96,
// shared, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) . B (16 x 128, shared,
// MN-major: the transpose-B bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x kBK) = Q K^T from the descriptors of this consumer's 64 rows of
// Q and of the K tile, both K-major: 8 k-steps of 16 head-dim columns, each
// 32 bytes into a 128-byte swizzle span, the second four in the second
// 64-column half (the address field counts 16-byte units)
__device__ __forceinline__ void issue_qk(float (&s)[kS], uint64_t dq,
                                         uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks) {
    const int off = (ks % 4) * 2;
    wgmma_ss_n96(s, dq + (ks / 4) * (kQHalf / 16) + off,
                 dk + (ks / 4) * (kKVHalf / 16) + off, ks > 0);
  }
  wgmma_commit();
}

// O (64 x 128) += P V: P from registers, V MN-major from its descriptor;
// k-step kk takes keys 16 kk .. 16 kk + 15, two 8-row groups
__device__ __forceinline__ void issue_pv(float (&o)[kO],
                                         const uint32_t (&pf)[kPSteps][4],
                                         uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk)
    wgmma_rs_n128(o, pf[kk], dv + kk * (16 * kRowBytes / 16));
  wgmma_commit();
}

// P's bf16 A fragments from the probabilities in the accumulator layout:
// k-step kk holds score columns 8 kk .. 8 kk + 7 of this thread
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kPSteps][4],
                                       const float (&p)[kS]) {
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
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
// row_lo + 8), in the log2 domain: p = 2^(s * scale_log2 - m * scale_log2)
// with one FFMA and one ex2 per score
struct Softmax {
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
    if (key0 + kBK > S || (causal && key0 + kBK - 1 > row0)) {
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

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_kernel_ws(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to, int S, int H,
                         int KH, int causal, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + kOffK, sV = base + kOffV;
  const uint32_t bar_q = base + kOffBar;
  // full barriers complete when TMA has written a tile; empty ones when
  // every consumer warp has read it
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages,
                 bar_ek = bar_v + 8 * kStages, bar_ev = bar_ek + 8 * kStages;

  // heaviest query blocks first: blockIdx.y walks them, x the (b, h)
  const int nq = gridDim.y;
  const int qb = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int bh = blockIdx.x;
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
      mbar_expect_tx(bar_q, kQBytes);
      tma_load(sQ, &tq, bar_q, 0, h, q0, b);
      tma_load(sQ + kQHalf, &tq, bar_q, kBoxCols, h, q0, b);
      // tile j of K or V into its stage, once both consumers have released
      // the tile kStages before it
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t full,
                      uint32_t empty, int j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + 8 * st, (j / kStages - 1) & 1);
        dst += st * kKVBytes;
        mbar_expect_tx(full + 8 * st, kKVBytes);
        tma_load(dst, map, full + 8 * st, 0, kvh, j * kBK, b);
        tma_load(dst + kKVHalf, map, full + 8 * st, kBoxCols, kvh, j * kBK,
                 b);
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
    Softmax sm(S, causal, row0, row_lo, quad, scale_log2);
    float s[kS];
    uint32_t pf[kPSteps][4];  // P of the last tile, bf16 A fragments

    if (c == 1) bar_arrive(kTurnBar, 256);  // consumer 0 issues first
    mbar_wait(bar_q, 0);

    // tile 0: S_0 = Q K_0^T and its softmax
    mbar_wait(bar_k, 0);
    bar_sync(kTurnBar + c, 256);
    issue_qk(s, dq, dk);
    bar_arrive(kTurnBar + 1 - c, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bar_ek);  // K_0 released
    sm.tile(s, 0);
    pack_p(pf, s);

    // tile j: S_j is issued with O += P_{j-1} V_{j-1}; the softmax of S_j
    // runs while P V does
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(bar_k + 8 * st, (j / kStages) & 1);
      bar_sync(kTurnBar + c, 256);
      issue_qk(s, dq, dk + st * (kKVBytes / 16));
      mbar_wait(bar_v + 8 * sp, ((j - 1) / kStages) & 1);
      issue_pv(o, pf, dv + sp * (kKVBytes / 16));
      bar_arrive(kTurnBar + 1 - c, 256);
      wgmma_wait<1>();  // S_j has landed; P V may still run
      fence_regs(s);
      if (lane == 0) mbar_arrive(bar_ek + 8 * st);  // K_j released
      const float2 alpha = sm.tile(s, j * kBK);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
      pack_p(pf, s);
      if (lane == 0) mbar_arrive(bar_ev + 8 * sp);  // V_{j-1} released
    }

    // the last tile's P V
    const int last = n_tiles - 1;
    mbar_wait(bar_v + 8 * (last % kStages), (last / kStages) & 1);
    bar_sync(kTurnBar + c, 256);
    issue_pv(o, pf, dv + (last % kStages) * (kKVBytes / 16));
    if (c == 0) bar_arrive(kTurnBar + 1, 256);  // one turn per sync
    wgmma_wait<0>();
    fence_regs(o);

    // epilogue: normalise, stage bf16 rows in this consumer's part of Q's
    // buffer in the swizzled layout, and store them with TMA
    const float2 inv = sm.inverse_sums();
    unsigned char* out = smem + (qa - base);
#pragma unroll
    for (int i = 0; i < kO; i += 2) {
      const int r = (i >> 1) & 1, col8 = i >> 2;  // 8-column group 0..15
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
      tma_store(&to, qa, 0, h, row0, b);
      tma_store(&to, qa + kQHalf, kBoxCols, h, row0, b);
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

// a 4-d map over (hd, heads, S, B) of a contiguous bf16 (B, S, heads, 128)
// tensor, box (64, 1, rows, 1), 128-byte swizzle, zeros out of bounds
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B,
              int S, int heads, int rows) {
  const cuuint64_t row = (cuuint64_t)kHD * sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)kHD, (cuuint64_t)heads,
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

int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int causal, float scale_log2, cudaStream_t stream) {
  // grid x holds batch x query heads, y the query blocks
  if ((long long)B * H > 0x7fffffff || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, encode, q, B, S, H, kBQ) ||
      !make_map(&tk, encode, k, B, S, KH, kBK) ||
      !make_map(&tv, encode, v, B, S, KH, kBK) ||
      !make_map(&to, encode, o, B, S, H, kOutRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel_ws, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_attn_kernel_ws<<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, to, S, H, KH, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace ws

}  // namespace

// q (B, S, H, hd), k and v (B, S, KH, hd), o (B, S, H, hd): bf16,
// contiguous, 16-byte aligned.  hd is 16, 64, 96 or 128; H % KH == 0;
// B * H <= 65535 at hd 16, 64 and 96, S <= 128 * 65535 at hd 128.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KH, int hd,
                                 int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  // hd^-0.5 in the log2 domain of exp2f
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return mma::launch<16>(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    case 64:
      return mma::launch<64>(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    case 96:
      return mma::launch<96>(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    case 128:
      return ws::launch(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory a launch at head dim hd asks for, -1 for a
// head dim without an instance
extern "C" int flash_attn_smem_bytes(int hd) {
  switch (hd) {
    case 16:
      return mma::Tile<16>::kSmemBytes;
    case 64:
      return mma::Tile<64>::kSmemBytes;
    case 96:
      return mma::Tile<96>::kSmemBytes;
    case 128:
      return ws::kSmemBytes;
    default:
      return -1;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
