// Flash attention for Hopper (sm_90a): causal or full online-softmax
// attention over bf16 q, k, v with float32 running max, denominator and
// accumulator, in the grouped-query layout of the model.
//
// Replaces the Pallas TPU kernel
//   flash_attention <- src/repro/kernels/flash_attn/kernel.py
//                      (_flash_kernel)
// and the GQA repeat and sequence padding of its op (flash_attn/ops.py).
//
// What it computes: q (B, S, H, hd), k and v (B, S, KH, hd), all bf16 and
// contiguous; query head h reads key/value head h / (H / KH).  For each
// (b, h) and query row i, o[b, i, h] = softmax_j(q_i . k_j * hd^-0.5) v_j
// over the keys j < S (and j <= i when causal), cast to bf16.  Keys at or
// past S are masked for both causal values (the reference's op pads them
// with zeros and lets them into the non-causal softmax; this kernel does
// not).  Masked scores are -1e30 and their probabilities are exactly 0;
// the output divides by max(l, 1e-30), so a row with no key is 0, never
// NaN.
//
// What bounds it on an H100.  At the served shape (B=4, S=2048, H=32,
// KH=8, hd=128) a causal launch does 2*B*H*S*(S+1)*hd = 1.37e11
// tensor-core operations (the two products over the lower triangle)
// against 168 MB of q, k, v and o (0.050 ms at 3.35 TB/s), so it is bound
// by operations: 0.139 ms at the published 989 TFLOP/s.  The design:
//   * one block of 4 warps owns 64 query rows of one (b, h), 16 rows per
//     warp; causal blocks run the heaviest query rows first;
//   * K and V stream through shared memory in tiles of 64 keys, two
//     stages deep with cp.async (zero-filled past S), so the next tile
//     loads while this one computes; rows are padded by 8 bf16 so that
//     ldmatrix reads are free of bank conflicts; Q passes through the
//     second K stage into registers, so a block takes 69.6 KB at hd 128
//     and three blocks fit an SM (168 registers a thread allow three
//     too); a separate Q tile (87 KB, two blocks) was 12 % slower;
//   * both products run on the tensor cores with mma.sync m16n8k16 (bf16
//     in, float32 accumulate): S = Q K^T from ldmatrix fragments of Q and
//     K, then O += P V with P rounded to bf16 in registers (as the model's
//     masked path rounds it) and V read with ldmatrix.trans;
//   * the softmax runs in the log2 domain in registers; the row max is
//     reduced over the 4 lanes that share a row, the denominator is kept
//     per lane in float32 (before the bf16 rounding of P) and reduced once
//     at the end;
//   * KV tiles wholly above the diagonal are never loaded; masks are
//     applied only in the tiles that cross the diagonal or S.
// Warpgroup MMA (wgmma), TMA and warp specialisation are left to a later
// change.
//
// Interface: a plain C function (loaded with ctypes) that launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBQ == kBK, "the Q tile is staged in a K stage");

template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;        // bf16 per padded row
  static constexpr int kElems = kBK * kStride;  // one K, V or Q tile
  // two stages of K and two of V; Q is staged in the second K stage
  static constexpr int kSmemBytes = 4 * kElems * (int)sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
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
  const int smem = Tile<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attn_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, KH, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KH, hd), o (B, S, H, hd): bf16,
// contiguous, 16-byte aligned.  hd is 16 or 128; H % KH == 0;
// B * H <= 65535.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KH, int hd,
                                 int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  // hd^-0.5 in the log2 domain of exp2f
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KH, causal, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
