// Causal (or full) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (_attn_kernel / flash_attention): online-softmax attention, K and V read
// through the kv-head index h / (H / Hkv) and never repeated, causal mask
// with diagonal offset skv - sq, Dv != Dh allowed (each 1..256), f32
// softmax statistics and accumulator, output in the inputs' type.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/flash_attention.py).  The entry launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
//
// Layout: q [B, Sq, H, Dh], k [B, Skv, Hkv, Dh], v [B, Skv, Hkv, Dv],
// o [B, Sq, H, Dv], all contiguous: the kernel indexes the heads in place,
// so the wrapper transposes nothing.  Two routes, picked by the type.
//
// bf16 route: the products on the tensor cores.
//
// What bounds it on the H100.  At zamba2's prefill (S = 1024, H = 32,
// Dh = Dv = 80, causal) the function reads q, k, v and writes o once:
// 21 MB, 6.3 us at 3.35 TB/s; its products are 2 (Dh + Dv) flops per
// visible (query, key) pair, 5.4 GFLOP, 5.4 us at the 989 TFLOP/s of the
// bf16 tensor cores.  So bytes and tensor-core operations bound it about
// equally, and only the tensor cores get near either: on the CUDA cores
// in f32 the products alone take 80 us.
//
// Design (FlashAttention-2's).  A block of 4 warps owns 64 query rows of
// one (batch, head), each warp 16 of them.  Q's tile is copied to shared
// memory once and read into registers as mma A-fragments (ldmatrix); for
// padded widths above 128 the fragments are read again from shared memory
// at each k-step, so that registers hold only the output.  K and V are
// walked in tiles of 64 rows (32 where a padded width exceeds 128) through
// a two-stage ring: the next tile's 16-byte cp.async.cg copies are issued
// right after the one barrier per tile and fly while the current tile is
// multiplied.  S = Q K^T runs through mma.sync m16n8k16 bf16 with f32
// sums, K's B-fragments read by ldmatrix; each thread keeps its part of
// the 16 x BKV score tile in registers.  The row max is taken on the
// unscaled f32 scores, and the scale log2(e) / sqrt(Dh) joins the
// exponent as one FFMA before exp2f; the row max and row sum live in the
// quad of lanes that share an mma row (the sum is reduced across the quad
// once, at the end).  P is rounded to bf16 in registers and becomes the
// A-fragment of O += P V, with V's B-fragments read by ldmatrix.trans from
// the row-major [key, Dv] tile; O stays in f32 registers and is rounded
// once.  Rounding P is the one rounding the
// reference does not do: at most 2^-9 relative per probability.
//
// KV tiles wholly above the causal diagonal of the block are never
// loaded, and a warp skips those wholly above its own 16 rows; only tiles
// that cross the diagonal or the ragged end are masked (score -1e30 and
// probability exactly 0, as in the reference), the rest take an unmasked
// path.  In shared memory Dh and Dv are both zero-padded to the larger of
// the two rounded up to a multiple of 16, with one template instance per
// padded width (zamba2's 80 runs 5 k-steps exactly); rows are padded by
// 16 more bytes, so a row's pitch is an odd multiple of 16 bytes modulo
// 128 and the 8 rows an ldmatrix reads hit 8 distinct 16-byte bank
// groups.  Where a row is not 16-byte aligned in device memory (Dh or
// Dv not a multiple of 8, or an operand offset from its allocation) the
// same kernel loads element by element instead of by cp.async.  Q tiles
// with the most KV tiles are launched first (blockIdx.x reversed), so that
// the short causal blocks fill in behind the long ones.
//
// f32 route: the products on the CUDA cores.
//
// The reference computes f32 attention with f32 products and the port
// allows no TF32 (repro_torch.device.strict_numerics), so f32 has no
// tensor-core route: at zamba2's shape its 5.4 GFLOP of f32 products need
// 80 us at the card's 67 TFLOP/s.  One block of 256 threads owns a tile of 64
// query rows of one (batch, head).  It stages the Q tile once (scaled by
// 1/sqrt(Dh), in f32) and walks the KV dimension in tiles of 64 rows, so
// shared memory stays O(tile) at any sequence length (the Pallas spec
// stages all of K and V per head, which does not fit in 227 KB once S
// reaches a few thousand).  KV tiles wholly above the causal diagonal are
// never read.  Each thread holds a 4 x 4 patch of the score tile and a
// 4 x (16 NJ) patch of the output accumulator, with rows ty + 16 i and
// columns tx + 16 j, so that the 16 threads that share a row sit in one
// half-warp and the row max and row sum are shuffles.  Q and K rows are
// padded to Dh + 1 floats so that the 16 threads reading 16 K rows hit 16
// banks.  Masked scores are -1e30 and their probabilities exactly 0, as
// in the reference.  It is bound by shared-memory loads and FMA issue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block (both routes)
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32 route
// ---------------------------------------------------------------------------
constexpr int kBKV = 64;         // key rows per tile
constexpr int kThreads = 256;    // 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// reduce over the 16 lanes of a half-warp
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int dh, int dv) {
  return sizeof(float) * ((size_t)(kBQ + kBKV) * (dh + 1) +
                          (size_t)kBKV * dv + (size_t)kBQ * (kBKV + 1));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int sq, int skv, int h, int hkv, int dh, int dv, int causal,
    float scale) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  const int ldp = kBKV + 1;
  float* s_q = smem;                  // [kBQ][ldk]
  float* s_k = s_q + kBQ * ldk;       // [kBKV][ldk]
  float* s_v = s_k + kBKV * ldk;      // [kBKV][dv]
  float* s_p = s_v + kBKV * dv;       // [kBQ][ldp]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / h, head = bh - b * h;
  const int kvh = head / (h / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int off = skv - sq;           // causal diagonal offset

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)head * dh;
  const T* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const T* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;
  T* ob = o + (size_t)b * sq * o_row + (size_t)head * dv;

  for (int idx = tid; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, c = idx - r * dh;
    const int gr = q0 + r;
    s_q[r * ldk + c] = gr < sq ? to_f32(qb[gr * q_row + c]) * scale : 0.0f;
  }

  int n_tiles = (skv + kBKV - 1) / kBKV;
  if (causal) {   // the highest key any row of this tile can see
    const int last_key = min(q0 + kBQ, sq) - 1 + off;
    n_tiles = min(n_tiles, last_key / kBKV + 1);
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();   // the last tile's P and V are no longer read
    for (int idx = tid; idx < kBKV * dh; idx += kThreads) {
      const int r = idx / dh, c = idx - r * dh;
      const int gr = k0 + r;
      s_k[r * ldk + c] = gr < skv ? to_f32(kb[gr * k_row + c]) : 0.0f;
    }
    for (int idx = tid; idx < kBKV * dv; idx += kThreads) {
      const int r = idx / dv, c = idx - r * dv;
      const int gr = k0 + r;
      s_v[r * dv + c] = gr < skv ? to_f32(vb[gr * v_row + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
      bool valid[4];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < skv && (!causal || kpos <= qpos + off);
        s[i][j] = valid[j] ? s[i][j] : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float corr = expf(m[i] - m_new);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        s_p[row * ldp + tx + 16 * j] = p;
        ls += p;
      }
      l[i] = l[i] * corr + half_warp_sum(ls);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < dv) {
          const float vv = s_v[kk * dv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // the scores were scaled on the way in, so m is in the exponent's units
    if (lse != nullptr && tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(denom);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) ob[row * o_row + col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int skv, int h, int hkv,
                   int dh, int dv, int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dh, dv);
  auto kernel = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, h, hkv, dh,
      dv, causal, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, float* lse, int b, int sq, int skv, int h,
                         int hkv, int dh, int dv, int causal,
                         cudaStream_t stream) {
  if (dv <= 64)
    return launch<float, 4>(q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv,
                            causal, stream);
  if (dv <= 128)
    return launch<float, 8>(q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv,
                            causal, stream);
  return launch<float, 16>(q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv,
                           causal, stream);
}

// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;                 // 16 query rows each
constexpr int kTcThreads = 32 * kWarps;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `src_bytes`
// (16 or 0) are read and the rest filled with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i receives its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows r0 .. r0 + ROWS - 1 (columns 0 .. DP - 1) of a [n_rows, d]
// operand with row stride `stride` into a shared tile of pitch LD; rows at
// or past n_rows and columns at or past d become zeros.  `vec`: rows are
// 16-byte aligned and d is a multiple of 8, so 16-byte cp.async copies
// (zero-filled where out of range); otherwise element by element.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          size_t stride, int r0, int n_rows,
                                          int d, bool vec) {
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      const int gr = r0 + r;
      const bool in = gr < n_rows && c < d;
      cp_async16(smem_addr(s + r * LD + c), in ? g + gr * stride + c : g,
                 in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < ROWS * DP; i += kTcThreads) {
      const int r = i / DP, c = i - r * DP;
      const int gr = r0 + r;
      s[r * LD + c] = gr < n_rows && c < d ? g[gr * stride + c] : zero;
    }
  }
}

template <int D>
struct TcShape {
  static constexpr int kBKV = D > 128 ? 32 : 64;
  static constexpr int kL = D + 8;      // shared pitch of Q, K and V rows
  static constexpr size_t kSmem =
      sizeof(bf16) * ((size_t)kBQ * kL + 4 * (size_t)kBKV * kL);
};

// D: the larger of Dh and Dv padded to a multiple of 16
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int h, int hkv, int dh, int dv,
    int causal, int vec, float scale_log2) {
  constexpr int BKV = TcShape<D>::kBKV, L = TcShape<D>::kL;
  constexpr int KQ = D / 16;       // k-steps of Q K^T
  constexpr int NS = BKV / 8;      // n-tiles of a warp's score tile
  constexpr int NO = D / 8;        // n-tiles of a warp's output
  constexpr bool kQInRegs = D <= 128;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][L]
  bf16* s_k = s_q + kBQ * L;                       // [2][BKV][L]
  bf16* s_v = s_k + 2 * BKV * L;                   // [2][BKV][L]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  const int bh = blockIdx.y, b = bh / h, head = bh - b * h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int off = skv - sq;            // causal diagonal offset

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const bf16* qb = q + (size_t)b * sq * q_row + (size_t)head * dh;
  const bf16* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const bf16* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;
  bf16* ob = o + (size_t)b * sq * o_row + (size_t)head * dv;

  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) {   // the highest key any row of this tile can see
    const int last_key = min(q0 + kBQ, sq) - 1 + off;
    n_tiles = min(n_tiles, last_key / BKV + 1);
  }

  load_tile<kBQ, D, L>(s_q, qb, q_row, q0, sq, dh, vec);
  load_tile<BKV, D, L>(s_k, kb, k_row, 0, skv, dh, vec);
  load_tile<BKV, D, L>(s_v, vb, v_row, 0, skv, dv, vec);
  cp_async_commit();

  // this lane's rows of the warp's 16: w_row0 + quad_row and + 8
  const int w_row0 = q0 + 16 * warp;
  const int row_a = w_row0 + quad_row, row_b = row_a + 8;
  // ldmatrix row addresses: A (Q) rows lane & 15, column half lane >> 4;
  // B of Q K^T (K rows) key lane & 7 + 8 (lane >> 4), column half
  // (lane >> 3) & 1; B of P V (V rows, transposed) key lane & 7 +
  // 8 ((lane >> 3) & 1), column half lane >> 4
  const uint32_t q_addr = smem_addr(
      s_q + (16 * warp + (lane & 15)) * L + 8 * (lane >> 4));
  const int k_off = ((lane & 7) + 8 * (lane >> 4)) * L + 8 * ((lane >> 3) & 1);
  const int v_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L + 8 * (lane >> 4);

  uint32_t qf[kQInRegs ? KQ : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copies overwrite
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * BKV, nxt = stage ^ 1;
      load_tile<BKV, D, L>(s_k + nxt * BKV * L, kb, k_row, k1, skv, dh, vec);
      load_tile<BKV, D, L>(s_v + nxt * BKV * L, vb, v_row, k1, skv, dv, vec);
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < KQ; ++ks) ldmatrix_x4(qf[ks], q_addr + ks * 32);
      }
    }
    const int k0 = t * BKV;
    if (causal && k0 > w_row0 + 15 + off) continue;   // above this warp

    const bf16* sk = s_k + stage * BKV * L;
    const bf16* sv = s_v + stage * BKV * L;
    const uint32_t k_base = smem_addr(sk + k_off);
    const uint32_t v_base = smem_addr(sv + v_off);

    // S = Q K^T for the warp's 16 rows and the tile's BKV keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, q_addr + ks * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_base + (jp * 16 * L + ks * 16) * 2);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // mask only a tile that crosses the diagonal or the ragged end
    if (k0 + BKV > skv || (causal && k0 + BKV - 1 > w_row0 + off)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + quad_col + (e & 1);
          const int qpos = e < 2 ? row_a : row_b;
          if (!(kpos < skv && (!causal || kpos <= qpos + off)))
            s[j][e] = kNegInf;
        }
    }
    // online softmax on the unscaled scores; the scale log2(e) / sqrt(Dh)
    // joins the exponent as one FFMA
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2], m_scaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      m_scaled[i] = mx[i] * scale_log2;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked: exp2 of about -1e29, exactly 0
        const float p = exp2f(fmaf(s[j][e], scale_log2, -m_scaled[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, P rounded to bf16 as the A-fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_base + (kk * 16 * L + jp * 16) * 2);
        mma_bf16(acc[2 * jp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * jp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // the quad's partial row sums, then O / l rounded once
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= sq) continue;
    // m is the unscaled row max: lse = m / sqrt(Dh) + log l, where
    // 1 / sqrt(Dh) = scale_log2 ln 2
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * sq + row] =
          m[i] * (scale_log2 * 0.6931471805599453f) + logf(fmaxf(l[i], 1e-30f));
    bf16* orow = ob + row * o_row;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + quad_col;
      const float x0 = acc[j][2 * i] * inv[i], x1 = acc[j][2 * i + 1] * inv[i];
      if (vec && col + 1 < dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < dv) orow[col] = __float2bfloat16(x0);
        if (col + 1 < dv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, float* lse, int b, int sq, int skv, int h,
                        int hkv, int dh, int dv, int causal,
                        cudaStream_t stream) {
  const size_t bytes = TcShape<D>::kSmem;
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // 16-byte rows in device memory for cp.async: Dh, Dv multiples of 8
  // and every operand 16-byte aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  const int vec = dh % 8 == 0 && dv % 8 == 0 && any % 16 == 0;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, skv, h,
      hkv, dh, dv, causal, vec, scale_log2);
  return cudaGetLastError();
}

// One instance per padded width; where Dh and Dv differ, both are padded
// to the larger.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, float* lse, int b, int sq, int skv, int h,
                          int hkv, int dh, int dv, int causal,
                          cudaStream_t stream) {
#define FA_ARGS q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv, causal, stream
  switch ((max(dh, dv) + 15) / 16 * 16) {
#define FA_WIDTH(d) \
  case d:           \
    return launch_bf16<d>(FA_ARGS);
    FA_WIDTH(16) FA_WIDTH(32) FA_WIDTH(48) FA_WIDTH(64)
    FA_WIDTH(80) FA_WIDTH(96) FA_WIDTH(112) FA_WIDTH(128)
    FA_WIDTH(144) FA_WIDTH(160) FA_WIDTH(176) FA_WIDTH(192)
    FA_WIDTH(208) FA_WIDTH(224) FA_WIDTH(240) FA_WIDTH(256)
#undef FA_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_ARGS
}

// ---------------------------------------------------------------------------
// Backward: the gradient of the forward above in q, k and v
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the reference differentiates attention with
// XLA's autodiff of ref.attention (S <= 1024) or with its own blocked
// custom VJP, _flash_bwd (repro/kernels/ref.py:142), in f32.  These
// kernels compute what _flash_bwd computes, from the forward's output O
// and its row log-sum-exp (lse, f32 [B, H, Sq], written by the forward
// kernels above when asked for):
//
//   D_i   = sum_c dO_ic O_ic                           (pre-pass)
//   P_ij  = exp(S_ij - lse_i),  S = Q K^T / sqrt(Dh)   (recomputed)
//   dS_ij = P_ij (dO_i . V_j - D_i)
//   dQ    = dS K / sqrt(Dh);  dK = dS^T Q / sqrt(Dh);  dV = P^T dO
//
// with the causal diagonal offset by Skv - Sq and masked pairs exactly 0,
// as in the reference.  K and V are read through the kv-head index and
// never repeated.  Every output element is summed by one thread in a
// fixed order, with no atomics, so a gradient is the same bit for bit on
// every call.  Two routes, picked by the type; both begin with the D
// pre-pass (one warp per row, f32 sums).
//
// bf16 route: the products on the tensor cores.
//
// What bounds it on the H100.  At starcoder2's train shape (B 2, S 1024,
// H 24 over 2 kv heads, Dh = Dv = 128, causal) the function must read q,
// k, v, O, dO and lse once and write dq, dk and dv once: 54.7 MB, 16 us at
// 3.35 TB/s.  Its products are 2 (3 Dh + 2 Dv) flops per visible (query,
// key) pair (S once, dP, dV, dK, dQ): 32 GFLOP, 0.0326 ms at the 989
// TFLOP/s of the bf16 tensor cores.  So operations bound it, and only the
// tensor cores come near: on the CUDA cores in f32 the same work needs
// 0.48 ms.
//
// What it computes, and where it rounds.  S = Q K^T and dP = dO V^T are
// f32 sums of bf16 products (mma.sync m16n8k16); P = exp2(S log2(e) /
// sqrt(Dh) - lse log2(e)) and dS = P (dP - D) are f32 in registers.  Then
// P and dS are rounded to bf16 in registers, as the A-fragments of the
// three products that take them (dV += P^T dO, dK += dS^T Q, dQ += dS K),
// whose sums are f32.  Each gradient is scaled and rounded to bf16 once.
// Rounding P and dS is what the reference does not do: at most 2^-9
// relative each (tests/test_torch_attention_bwd_bf16.py holds a plain
// emulation of this arithmetic to the oracles at the card's 2e-2).
//
// Design: FlashAttention-2's backward, made deterministic.  Three or four
// kernels a call, a number fixed by the shape (flash_attention_bwd_splits):
//   - dq: a block of 4 warps owns 64 query rows of one (batch, head), 16
//     per warp.  Q and dO are copied to shared memory once; the key tiles
//     the rows can see, 32 keys each, come through a two-stage cp.async
//     ring of K and V, and the query tiles that see the most keys are
//     launched first.  Per tile S and dP run on mma.sync, P and dS stay in
//     registers, and dQ += dS K takes K's B-fragments by ldmatrix.trans.
//     dQ stays in f32 registers, each element summed in key order by one
//     thread.
//   - dk/dv: a block of 4 warps owns 64 key rows of one (batch, kv head)
//     (32 where the padded width exceeds 128) and one slice of the group's
//     query heads: the grid is (key tiles, B Hkv, G).  K and V are copied
//     to shared memory once; the block walks its heads' query tiles that
//     can see its keys through a two-stage ring of Q, dO, lse and D.  Each
//     warp computes S^T = K Q^T and dP^T = V dO^T for 16 keys, P^T and
//     dS^T in registers, then dV += P^T dO and dK += dS^T Q with dO's and
//     Q's B-fragments read by ldmatrix.trans.  dK and dV stay in f32
//     registers.  Where the width exceeds 128 two warps share a 16-key
//     strip, each keeping half of the columns of dK and dV (both compute
//     the strip's S^T and dP^T), so that registers hold the sums.
//   - G = 1: the dk/dv kernel scales and rounds its sums.  G > 1: each
//     block writes f32 partials to scratch [G, B, Skv, Hkv, Dh + Dv] and a
//     fourth kernel sums the G partials in index order and rounds once.
//     G is the smallest divisor of the group H / Hkv that gives at least
//     two dk/dv blocks per SM (2 x 132); the whole group where none does.
//     At starcoder2's train shape the group of 12 splits as G = 6: 384
//     blocks of two heads each, against 64 blocks on 132 SMs unsplit, and
//     25 MB of partials.
//   S and dP are recomputed by both dq and dk/dv, 1.4 times the least
//   work: the price of a dq without atomics.  As in the forward: one
//   template instance per padded width (16..256), rows padded by 16 bytes
//   so that an ldmatrix hits 8 distinct bank groups, element-by-element
//   loads where a row is not 16-byte aligned, tiles wholly above the
//   causal diagonal never walked, and only the tiles that cross it or a
//   ragged end masked.
//
// f32 route: the products on the CUDA cores.
//
// The reference is f32 and the port allows no TF32
// (repro_torch.device.strict_numerics), so f32 keeps the first design,
// bound at 0.48 ms by the 67 TFLOP/s of the f32 CUDA cores at
// starcoder2's shape.  Every operand is widened into f32 shared memory
// and every product is an fmaf.  Three kernels: the pre-pass, dq (one
// block per (batch, head, 64-row query tile), looping over the key tiles
// it can see) and dk/dv (one block per (batch, kv head, 32-row key tile),
// looping over the group's query heads and, for each, the query tiles
// that can see it, in that fixed order).  Each thread holds a 4 x RJ
// patch of the score tile (rows ty + 16 i, columns tx + 16 j) and of its
// output sums, as the f32 forward route does; rows of Q, K, V and dO are
// padded by one float so that 16 threads reading 16 rows hit 16 banks.
// It is limited by shared-memory loads and FMA issue.

constexpr int kBwdThreads = 256;   // 16 x 16
constexpr int kBwdBQ = 64;         // query rows per tile, both kernels
constexpr int kBwdKvRows = 32;     // key rows per block of the dk/dv kernel

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// D = rowsum(dO * O) in f32, one warp per (batch, query row, head); rows of
// o and dout are contiguous [B, Sq, H, Dv], dd is [B, H, Sq]
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) flash_attention_bwd_dot(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dd, int n_rows, int sq, int h, int dv) {
  const int row = (blockIdx.x * kBwdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const size_t base = (size_t)row * dv;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32)
    s = fmaf(to_f32(o[base + c]), to_f32(dout[base + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int head = row % h, bi = row / h;    // bi = b * sq + i
    const int i = bi % sq, b = bi / sq;
    dd[((size_t)b * h + head) * sq + i] = s;
  }
}

size_t bwd_dq_smem(int dh, int dv, int bkv) {
  return sizeof(float) * ((size_t)(kBwdBQ + bkv) * (dh + 1 + dv + 1) +
                          (size_t)kBwdBQ * (bkv + 1));
}

// dq for a tile of 64 query rows of one (batch, head).  NJ: the columns of
// Dh each thread owns, in steps of 16; BKV: key rows per tile (64, or 32
// where 64 would not fit in shared memory).
template <typename T, int NJ, int BKV>
__global__ void __launch_bounds__(kBwdThreads) flash_attention_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dq, int sq, int skv, int h, int hkv, int dh, int dv,
    int causal, float scale) {
  constexpr int RJ = BKV / 16;
  extern __shared__ float smem[];
  const int ldq = dh + 1, ldv = dv + 1, lds = BKV + 1;
  float* s_q = smem;                    // [kBwdBQ][ldq], times 1/sqrt(Dh)
  float* s_do = s_q + kBwdBQ * ldq;     // [kBwdBQ][ldv]
  float* s_k = s_do + kBwdBQ * ldv;     // [BKV][ldq]
  float* s_v = s_k + BKV * ldq;         // [BKV][ldv]
  float* s_ds = s_v + BKV * ldv;        // [kBwdBQ][lds]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / h, head = bh - b * h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdBQ;   // longest first
  const int off = skv - sq;

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)head * dh;
  const T* dob = dout + (size_t)b * sq * o_row + (size_t)head * dv;
  const T* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const T* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;
  T* dqb = dq + (size_t)b * sq * q_row + (size_t)head * dh;

  for (int idx = tid; idx < kBwdBQ * dh; idx += kBwdThreads) {
    const int r = idx / dh, c = idx - r * dh, gr = q0 + r;
    s_q[r * ldq + c] = gr < sq ? to_f32(qb[gr * q_row + c]) * scale : 0.0f;
  }
  for (int idx = tid; idx < kBwdBQ * dv; idx += kBwdThreads) {
    const int r = idx / dv, c = idx - r * dv, gr = q0 + r;
    s_do[r * ldv + c] = gr < sq ? to_f32(dob[gr * o_row + c]) : 0.0f;
  }
  float row_lse[4], row_d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < sq ? lse[(size_t)bh * sq + row] : 0.0f;
    row_d[i] = row < sq ? dd[(size_t)bh * sq + row] : 0.0f;
  }

  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) {   // the highest key any row of this tile can see
    const int last_key = min(q0 + kBwdBQ, sq) - 1 + off;
    n_tiles = min(n_tiles, last_key / BKV + 1);
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();   // the last tile's K and dS are no longer read
    for (int idx = tid; idx < BKV * dh; idx += kBwdThreads) {
      const int r = idx / dh, c = idx - r * dh, gr = k0 + r;
      s_k[r * ldq + c] = gr < skv ? to_f32(kb[gr * k_row + c]) : 0.0f;
    }
    for (int idx = tid; idx < BKV * dv; idx += kBwdThreads) {
      const int r = idx / dv, c = idx - r * dv, gr = k0 + r;
      s_v[r * ldv + c] = gr < skv ? to_f32(vb[gr * v_row + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][RJ], dp[4][RJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float a[4], bv[RJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) bv[j] = s_k[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < dv; ++c) {
      float a[4], bv[RJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_do[(ty + 16 * i) * ldv + c];
#pragma unroll
      for (int j = 0; j < RJ; ++j) bv[j] = s_v[(tx + 16 * j) * ldv + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = qpos < sq && kpos < skv &&
                           (!causal || kpos <= qpos + off);
        const float p = valid ? expf(s[i][j] - row_lse[i]) : 0.0f;
        s_ds[(ty + 16 * i) * lds + tx + 16 * j] = p * (dp[i][j] - row_d[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_ds[(ty + 16 * i) * lds + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < dh) {
          const float kv = s_k[kk * ldq + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) dqb[row * q_row + col] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

size_t bwd_dkv_smem(int dh, int dv) {
  return sizeof(float) *
         ((size_t)(kBwdKvRows + kBwdBQ) * (dh + 1 + dv + 1) +
          2 * (size_t)kBwdKvRows * (kBwdBQ + 1) + 2 * (size_t)kBwdBQ);
}

// dk and dv for a tile of 32 key rows of one (batch, kv head), summed over
// the group's query heads and their query tiles in a fixed order.  NJ: the
// columns of max(Dh, Dv) each thread owns, in steps of 16.
template <typename T, int NJ>
__global__ void __launch_bounds__(kBwdThreads) flash_attention_bwd_dkv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dk, T* __restrict__ dvo, int sq, int skv, int h,
    int hkv, int dh, int dv, int causal, float scale) {
  constexpr int BKV = kBwdKvRows, RI = BKV / 16, RJ = kBwdBQ / 16;
  extern __shared__ float smem[];
  const int ldq = dh + 1, ldv = dv + 1, ldp = kBwdBQ + 1;
  float* s_k = smem;                     // [BKV][ldq]
  float* s_v = s_k + BKV * ldq;          // [BKV][ldv]
  float* s_q = s_v + BKV * ldv;          // [kBwdBQ][ldq], times 1/sqrt(Dh)
  float* s_do = s_q + kBwdBQ * ldq;      // [kBwdBQ][ldv]
  float* s_p = s_do + kBwdBQ * ldv;      // [BKV][ldp]: P^T
  float* s_ds = s_p + BKV * ldp;         // [BKV][ldp]: dS^T
  float* s_lse = s_ds + BKV * ldp;       // [kBwdBQ]
  float* s_d = s_lse + kBwdBQ;           // [kBwdBQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.y, b = bkv / hkv, kvh = bkv - b * hkv;
  const int group = h / hkv;
  const int k0 = blockIdx.x * BKV;
  const int off = skv - sq;

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const T* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const T* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;
  T* dkb = dk + (size_t)b * skv * k_row + (size_t)kvh * dh;
  T* dvb = dvo + (size_t)b * skv * v_row + (size_t)kvh * dv;

  for (int idx = tid; idx < BKV * dh; idx += kBwdThreads) {
    const int r = idx / dh, c = idx - r * dh, gr = k0 + r;
    s_k[r * ldq + c] = gr < skv ? to_f32(kb[gr * k_row + c]) : 0.0f;
  }
  for (int idx = tid; idx < BKV * dv; idx += kBwdThreads) {
    const int r = idx / dv, c = idx - r * dv, gr = k0 + r;
    s_v[r * ldv + c] = gr < skv ? to_f32(vb[gr * v_row + c]) : 0.0f;
  }

  // the first query row that can see key k0
  const int n_qt = (sq + kBwdBQ - 1) / kBwdBQ;
  const int qt0 = causal ? max(0, k0 - off) / kBwdBQ : 0;

  float acc_k[RI][NJ], acc_v[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const int head = kvh * group + g;
    const size_t bh = (size_t)b * h + head;
    const T* qb = q + (size_t)b * sq * q_row + (size_t)head * dh;
    const T* dob = dout + (size_t)b * sq * o_row + (size_t)head * dv;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBwdBQ;
      __syncthreads();   // the last tile's Q, dO, P and dS are no longer read
      for (int idx = tid; idx < kBwdBQ * dh; idx += kBwdThreads) {
        const int r = idx / dh, c = idx - r * dh, gr = q0 + r;
        s_q[r * ldq + c] =
            gr < sq ? to_f32(qb[gr * q_row + c]) * scale : 0.0f;
      }
      for (int idx = tid; idx < kBwdBQ * dv; idx += kBwdThreads) {
        const int r = idx / dv, c = idx - r * dv, gr = q0 + r;
        s_do[r * ldv + c] = gr < sq ? to_f32(dob[gr * o_row + c]) : 0.0f;
      }
      if (tid < kBwdBQ) {
        const int gr = q0 + tid;
        s_lse[tid] = gr < sq ? lse[bh * sq + gr] : 0.0f;
        s_d[tid] = gr < sq ? dd[bh * sq + gr] : 0.0f;
      }
      __syncthreads();

      // S^T and dP^T: rows are keys (ty + 16 i), columns queries (tx + 16 j)
      float s[RI][RJ], dp[RI][RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        float a[RI], bq[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = s_k[(ty + 16 * i) * ldq + d];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bq[j] = s_q[(tx + 16 * j) * ldq + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(a[i], bq[j], s[i][j]);
      }
#pragma unroll 4
      for (int c = 0; c < dv; ++c) {
        float a[RI], bq[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = s_v[(ty + 16 * i) * ldv + c];
#pragma unroll
        for (int j = 0; j < RJ; ++j) bq[j] = s_do[(tx + 16 * j) * ldv + c];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) dp[i][j] = fmaf(a[i], bq[j], dp[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int col = tx + 16 * j, qpos = q0 + col;
          const bool valid = qpos < sq && kpos < skv &&
                             (!causal || kpos <= qpos + off);
          const float p = valid ? expf(s[i][j] - s_lse[col]) : 0.0f;
          s_p[(ty + 16 * i) * ldp + col] = p;
          s_ds[(ty + 16 * i) * ldp + col] = p * (dp[i][j] - s_d[col]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kBwdBQ; ++qq) {
        float pa[RI], da[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pa[i] = s_p[(ty + 16 * i) * ldp + qq];
          da[i] = s_ds[(ty + 16 * i) * ldp + qq];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          if (col < dv) {
            const float x = s_do[qq * ldv + col];
#pragma unroll
            for (int i = 0; i < RI; ++i) acc_v[i][j] = fmaf(pa[i], x, acc_v[i][j]);
          }
          if (col < dh) {
            const float x = s_q[qq * ldq + col];
#pragma unroll
            for (int i = 0; i < RI; ++i) acc_k[i][j] = fmaf(da[i], x, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      // s_q held Q / sqrt(Dh), so acc_k is already dS^T Q / sqrt(Dh)
      if (col < dh) dkb[row * k_row + col] = from_f32<T>(acc_k[i][j]);
      if (col < dv) dvb[row * v_row + col] = from_f32<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int NJ, int BKV>
cudaError_t launch_bwd_dq(const T* q, const T* k, const T* v, const T* dout,
                          const float* lse, const float* dd, T* dq, int b,
                          int sq, int skv, int h, int hkv, int dh, int dv,
                          int causal, cudaStream_t stream) {
  const size_t bytes = bwd_dq_smem(dh, dv, BKV);
  auto kernel = flash_attention_bwd_dq<T, NJ, BKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBwdBQ - 1) / kBwdBQ, b * h);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(q, k, v, dout, lse, dd, dq, sq,
                                              skv, h, hkv, dh, dv, causal,
                                              1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_bwd_dkv(const T* q, const T* k, const T* v,
                           const T* dout, const float* lse, const float* dd,
                           T* dk, T* dvo, int b, int sq, int skv, int h,
                           int hkv, int dh, int dv, int causal,
                           cudaStream_t stream) {
  const size_t bytes = bwd_dkv_smem(dh, dv);
  auto kernel = flash_attention_bwd_dkv<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((skv + kBwdKvRows - 1) / kBwdKvRows, b * hkv);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(q, k, v, dout, lse, dd, dk,
                                              dvo, sq, skv, h, hkv, dh, dv,
                                              causal, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}


// the most shared memory a block may ask for on the H100
constexpr size_t kMaxSmem = 232448;

cudaError_t dispatch_bwd_f32(const void* q_, const void* k_, const void* v_,
                             const void* o_, const void* dout_,
                             const float* lse, void* dq_, void* dk_,
                             void* dv_, float* dd, int b, int sq, int skv,
                             int h, int hkv, int dh, int dv, int causal,
                             cudaStream_t stream) {
  using T = float;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dvo = static_cast<T*>(dv_);

  const int n_rows = b * sq * h;
  flash_attention_bwd_dot<T><<<(n_rows + kBwdThreads / 32 - 1) /
                                   (kBwdThreads / 32),
                               kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o_), dout, dd, n_rows, sq, h, dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool wide = bwd_dq_smem(dh, dv, 64) > kMaxSmem;
#define BWD_DQ(nj)                                                          \
  (wide ? launch_bwd_dq<T, nj, 32>(q, k, v, dout, lse, dd, dq, b, sq, skv,  \
                                   h, hkv, dh, dv, causal, stream)          \
        : launch_bwd_dq<T, nj, 64>(q, k, v, dout, lse, dd, dq, b, sq, skv,  \
                                   h, hkv, dh, dv, causal, stream))
  err = dh <= 64 ? BWD_DQ(4) : dh <= 128 ? BWD_DQ(8) : BWD_DQ(16);
#undef BWD_DQ
  if (err != cudaSuccess) return err;

  const int w = max(dh, dv);
#define BWD_DKV(nj)                                                       \
  launch_bwd_dkv<T, nj>(q, k, v, dout, lse, dd, dk, dvo, b, sq, skv, h,  \
                        hkv, dh, dv, causal, stream)
  return w <= 64 ? BWD_DKV(4) : w <= 128 ? BWD_DKV(8) : BWD_DKV(16);
#undef BWD_DKV
}

// ---------------------------------------------------------------------------
// Backward, bf16 route (the design note above)
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSms = 132;          // SMs of the H100 SXM
constexpr int kReduceThreads = 256;

// 4 bytes from global to shared memory, of which the first `src_bytes`
// (4 or 0) are read and the rest filled with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// entries r0 .. r0 + ROWS - 1 of an f32 row vector (lse or D) into shared
// memory; entries at or past n become zeros
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(float* s, const float* g,
                                              int r0, int n) {
  for (int i = threadIdx.x; i < ROWS; i += kTcThreads) {
    const bool in = r0 + i < n;
    cp_async4(smem_addr(s + i), in ? g + r0 + i : g, in ? 4 : 0);
  }
}

// columns col and col + 1 of a bf16 row, each where below n
__device__ __forceinline__ void store_bf16_pair(bf16* row, int col, int n,
                                                float x0, float x1,
                                                bool vec) {
  if (vec && col + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < n) row[col] = __float2bfloat16(x0);
    if (col + 1 < n) row[col + 1] = __float2bfloat16(x1);
  }
}

// the dk/dv kernel's tiles: a padded width above 128 takes 32 rows, so that
// registers hold the sums
constexpr int bwd_tile_rows(int d) { return d > 128 ? 32 : 64; }

template <int D>
struct BwdShape {
  static constexpr int kKeys = bwd_tile_rows(D);    // dk/dv: key rows owned
  static constexpr int kQTile = bwd_tile_rows(D);   // dk/dv: query rows a tile
  // dq: key rows a tile, 32 at every width (64-row tiles were slower at
  // starcoder2's shape on the H100: more registers, coarser causal skips)
  static constexpr int kKTile = 32;
  static constexpr int kL = D + 8;                  // shared pitch of rows
  static constexpr size_t kDkvSmem =
      sizeof(bf16) * (size_t)kL * (2 * kKeys + 4 * kQTile) +
      sizeof(float) * 4 * kQTile;
  static constexpr size_t kDqSmem =
      sizeof(bf16) * (size_t)kL * (2 * kBQ + 4 * kKTile);
};

// dq for 64 query rows of one (batch, head).  D: the larger of Dh and Dv
// padded to a multiple of 16.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_attention_bwd_dq_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    bf16* __restrict__ dq, int sq, int skv, int h, int hkv, int dh, int dv,
    int causal, int vec, float scale_log2, float scale) {
  constexpr int BKV = BwdShape<D>::kKTile, L = BwdShape<D>::kL;
  constexpr int KD = D / 16;       // k-steps over the width
  constexpr int NS = BKV / 8;      // n-tiles of a warp's score tile
  constexpr int NO = D / 8;        // n-tiles of a warp's dQ

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][L]
  bf16* s_do = s_q + kBQ * L;                      // [kBQ][L]
  bf16* s_k = s_do + kBQ * L;                      // [2][BKV][L]
  bf16* s_v = s_k + 2 * BKV * L;                   // [2][BKV][L]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  // launch order: query tiles slowest, those that see the most keys first
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int rank = lin / gridDim.y, bh = lin - rank * gridDim.y;
  const int b = bh / h, head = bh - b * h;
  const int kvh = head / (h / hkv);
  const int q0 = (gridDim.x - 1 - rank) * kBQ;
  const int off = skv - sq;            // causal diagonal offset

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const bf16* qb = q + (size_t)b * sq * q_row + (size_t)head * dh;
  const bf16* dob = dout + (size_t)b * sq * o_row + (size_t)head * dv;
  const bf16* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const bf16* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;
  bf16* dqb = dq + (size_t)b * sq * q_row + (size_t)head * dh;

  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) {   // the highest key any row of this tile can see
    const int last_key = min(q0 + kBQ, sq) - 1 + off;
    n_tiles = min(n_tiles, last_key / BKV + 1);
  }

  load_tile<kBQ, D, L>(s_q, qb, q_row, q0, sq, dh, vec);
  load_tile<kBQ, D, L>(s_do, dob, o_row, q0, sq, dv, vec);
  load_tile<BKV, D, L>(s_k, kb, k_row, 0, skv, dh, vec);
  load_tile<BKV, D, L>(s_v, vb, v_row, 0, skv, dv, vec);
  cp_async_commit();

  // this lane's rows of the warp's 16, with their lse (in log2 units) and D
  const int w_row0 = q0 + 16 * warp;
  const int row_a = w_row0 + quad_row, row_b = row_a + 8;
  float lse2[2], row_d[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    lse2[i] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.0f;
    row_d[i] = row < sq ? dd[(size_t)bh * sq + row] : 0.0f;
  }
  // ldmatrix row addresses: A (Q, dO rows) as the forward's Q; B of S and
  // dP (K, V rows) as the forward's K; B of dS K (K rows, transposed) as
  // the forward's V
  const int a_off = (16 * warp + (lane & 15)) * L + 8 * (lane >> 4);
  const uint32_t q_a = smem_addr(s_q + a_off), do_a = smem_addr(s_do + a_off);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * L + 8 * ((lane >> 3) & 1);
  const int t_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L + 8 * (lane >> 4);
  // k-steps and 16-column groups that hold any of Dh (Dv) columns
  const int gk = (dh + 15) / 16, gv = (dv + 15) / 16;

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    // tile t has landed for every thread, and every warp is done with
    // tile t - 1, whose stage the next copies overwrite
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * BKV, nxt = stage ^ 1;
      load_tile<BKV, D, L>(s_k + nxt * BKV * L, kb, k_row, k1, skv, dh, vec);
      load_tile<BKV, D, L>(s_v + nxt * BKV * L, vb, v_row, k1, skv, dv, vec);
      cp_async_commit();
    }
    const int k0 = t * BKV;
    if (causal && k0 > w_row0 + 15 + off) continue;   // above this warp

    const bf16* sk = s_k + stage * BKV * L;
    const bf16* sv = s_v + stage * BKV * L;
    const uint32_t k_b = smem_addr(sk + b_off), v_b = smem_addr(sv + b_off);
    const uint32_t k_t = smem_addr(sk + t_off);

    // S = Q K^T and dP = dO V^T for the warp's 16 rows and the tile's keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      if (ks < gk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_a + ks * 32);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_b + (jp * 16 * L + ks * 16) * 2);
          mma_bf16(s[2 * jp], a, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
      if (ks < gv) {
        uint32_t a[4];
        ldmatrix_x4(a, do_a + ks * 32);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bv[4];
          ldmatrix_x4(bv, v_b + (jp * 16 * L + ks * 16) * 2);
          mma_bf16(dp[2 * jp], a, bv[0], bv[1]);
          mma_bf16(dp[2 * jp + 1], a, bv[2], bv[3]);
        }
      }
    }

    // P and dS in f32; masked pairs exactly 0, checked only on a tile that
    // crosses the diagonal or a ragged end
    const bool edge = k0 + BKV > skv || w_row0 + 16 > sq ||
                      (causal && k0 + BKV - 1 > w_row0 + off);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[i]));
        if (edge) {
          const int kpos = k0 + 8 * j + quad_col + (e & 1);
          const int qpos = i == 0 ? row_a : row_b;
          if (!(qpos < sq && kpos < skv && (!causal || kpos <= qpos + off)))
            p = 0.0f;
        }
        dp[j][e] = p * (dp[j][e] - row_d[i]);
      }

    // dQ += dS K, dS rounded to bf16 as the A-fragment
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                             pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                             pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        if (jp < gk) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, k_t + (kk * 16 * L + jp * 16) * 2);
          mma_bf16(acc[2 * jp], a, bk[0], bk[1]);
          mma_bf16(acc[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

  // dQ / sqrt(Dh), rounded once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store_bf16_pair(dqb + row * q_row, 8 * j + quad_col, dh,
                      acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale, vec);
  }
}

// dk and dv for the key rows of one (batch, kv head) that a block owns,
// summed over its slice of the group's query heads (blockIdx.z of
// gridDim.z) and their query tiles in a fixed order.  part: null for
// G = 1 (round and write dk, dv), else f32 scratch [G, B, Skv, Hkv,
// Dh + Dv] of which this block writes its slice's sums.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_attention_bwd_dkv_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ part,
    size_t part_stride, int sq, int skv, int h, int hkv, int dh, int dv,
    int causal, int vec, float scale_log2, float scale) {
  constexpr int BKV = BwdShape<D>::kKeys, BQ = BwdShape<D>::kQTile;
  constexpr int L = BwdShape<D>::kL;
  constexpr int STRIPS = BKV / 16;         // 16-key strips: 4, or 2 if wide
  constexpr int PARTS = kWarps / STRIPS;   // column parts of dK, dV: 1 or 2
  constexpr int GROUPS = D / 16;           // 16-column groups of the width
  constexpr int NG = (GROUPS + PARTS - 1) / PARTS;   // groups of a part
  constexpr int KD = D / 16;               // k-steps over the width
  constexpr int NS = BQ / 8;               // n-tiles of a warp's S^T

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);   // [BKV][L]
  bf16* s_v = s_k + BKV * L;                       // [BKV][L]
  bf16* s_q = s_v + BKV * L;                       // [2][BQ][L]
  bf16* s_do = s_q + 2 * BQ * L;                   // [2][BQ][L]
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * BQ * L);   // [2][BQ]
  float* s_d = s_lse + 2 * BQ;                                  // [2][BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quad_row = lane >> 2, quad_col = 2 * (lane & 3);
  const int strip = warp % STRIPS, g0 = (warp / STRIPS) * NG;
  // launch order: key tiles slowest, the first (under the causal mask the
  // one the most queries see) first
  const int n_rest = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int kt = lin / n_rest, rest = lin - kt * n_rest;
  const int bkv = rest % gridDim.y, z = rest / gridDim.y;
  const int b = bkv / hkv, kvh = bkv - b * hkv;
  const int k0 = kt * BKV, ks0 = k0 + 16 * strip;   // block's, warp's keys
  const int off = skv - sq;
  const int group = h / hkv, per = group / gridDim.z;
  const int head0 = kvh * group + z * per;

  const size_t q_row = (size_t)h * dh, k_row = (size_t)hkv * dh;
  const size_t v_row = (size_t)hkv * dv, o_row = (size_t)h * dv;
  const bf16* kb = k + (size_t)b * skv * k_row + (size_t)kvh * dh;
  const bf16* vb = v + (size_t)b * skv * v_row + (size_t)kvh * dv;

  // the walk: `per` heads, each over the query tiles from the first that
  // can see key k0
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt0 = causal ? max(0, k0 - off) / BQ : 0;
  const int n_vis = n_qt - qt0, n_iter = per * n_vis;
  auto issue = [&](int it, int st) {
    const int head = head0 + it / n_vis, q0 = (qt0 + it % n_vis) * BQ;
    const size_t bh = (size_t)b * h + head;
    load_tile<BQ, D, L>(s_q + st * BQ * L,
                        q + (size_t)b * sq * q_row + (size_t)head * dh,
                        q_row, q0, sq, dh, vec);
    load_tile<BQ, D, L>(s_do + st * BQ * L,
                        dout + (size_t)b * sq * o_row + (size_t)head * dv,
                        o_row, q0, sq, dv, vec);
    load_rows_f32<BQ>(s_lse + st * BQ, lse + bh * sq, q0, sq);
    load_rows_f32<BQ>(s_d + st * BQ, dd + bh * sq, q0, sq);
  };

  load_tile<BKV, D, L>(s_k, kb, k_row, k0, skv, dh, vec);
  load_tile<BKV, D, L>(s_v, vb, v_row, k0, skv, dv, vec);
  issue(0, 0);
  cp_async_commit();

  // ldmatrix row addresses: A (the warp's 16 K, V rows) as the forward's
  // Q; B of S^T and dP^T (Q, dO rows) as the forward's K; B of P^T dO and
  // dS^T Q (dO, Q rows, transposed) as the forward's V
  const int a_off = (16 * strip + (lane & 15)) * L + 8 * (lane >> 4);
  const uint32_t k_a = smem_addr(s_k + a_off), v_a = smem_addr(s_v + a_off);
  const int b_off = ((lane & 7) + 8 * (lane >> 4)) * L + 8 * ((lane >> 3) & 1);
  const int t_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * L + 8 * (lane >> 4);
  const int gk = (dh + 15) / 16, gv = (dv + 15) / 16;
  const int key_a = ks0 + quad_row, key_b = key_a + 8;

  float acc_k[2 * NG][4], acc_v[2 * NG][4];
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_iter) {
      issue(it + 1, stage ^ 1);
      cp_async_commit();
    }
    const int q0 = (qt0 + it % n_vis) * BQ;
    // no query of the tile sees the warp's keys
    if (causal && ks0 > min(q0 + BQ, sq) - 1 + off) continue;

    const bf16* sq_t = s_q + stage * BQ * L;
    const bf16* sdo_t = s_do + stage * BQ * L;
    const float* sl = s_lse + stage * BQ;
    const float* sd = s_d + stage * BQ;
    const uint32_t q_b = smem_addr(sq_t + b_off);
    const uint32_t do_b = smem_addr(sdo_t + b_off);

    // S^T = K Q^T and dP^T = V dO^T: rows the warp's 16 keys, columns the
    // tile's queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      if (ks < gk) {
        uint32_t a[4];
        ldmatrix_x4(a, k_a + ks * 32);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bq[4];
          ldmatrix_x4(bq, q_b + (jp * 16 * L + ks * 16) * 2);
          mma_bf16(s[2 * jp], a, bq[0], bq[1]);
          mma_bf16(s[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
      if (ks < gv) {
        uint32_t a[4];
        ldmatrix_x4(a, v_a + ks * 32);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bo[4];
          ldmatrix_x4(bo, do_b + (jp * 16 * L + ks * 16) * 2);
          mma_bf16(dp[2 * jp], a, bo[0], bo[1]);
          mma_bf16(dp[2 * jp + 1], a, bo[2], bo[3]);
        }
      }
    }

    // P^T and dS^T in f32; masked pairs exactly 0, checked only on a tile
    // that crosses the diagonal or a ragged end
    const bool edge = q0 + BQ > sq || ks0 + 16 > skv ||
                      (causal && ks0 + 15 > q0 + off);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(sl + 8 * j + quad_col);
      const float2 d2 =
          *reinterpret_cast<const float2*>(sd + 8 * j + quad_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x, dq = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(s[j][e], scale_log2, -lq * kLog2e));
        if (edge) {
          const int qpos = q0 + 8 * j + quad_col + (e & 1);
          const int kpos = e < 2 ? key_a : key_b;
          if (!(qpos < sq && kpos < skv && (!causal || kpos <= qpos + off)))
            p = 0.0f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dq);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries, P^T and dS^T
    // rounded to bf16 as the A-fragments; this warp's column groups only
    const uint32_t do_t = smem_addr(sdo_t + t_off);
    const uint32_t q_t = smem_addr(sq_t + t_off);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int g = g0 + gi;
        const int col = (kk * 16 * L + g * 16) * 2;
        uint32_t bt[4];
        if (g < gv) {
          ldmatrix_x4_trans(bt, do_t + col);
          mma_bf16(acc_v[2 * gi], pa, bt[0], bt[1]);
          mma_bf16(acc_v[2 * gi + 1], pa, bt[2], bt[3]);
        }
        if (g < gk) {
          ldmatrix_x4_trans(bt, q_t + col);
          mma_bf16(acc_k[2 * gi], da, bt[0], bt[1]);
          mma_bf16(acc_k[2 * gi + 1], da, bt[2], bt[3]);
        }
      }
    }
  }

  // dK / sqrt(Dh) and dV: rounded once here (G = 1), or f32 partials
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? key_a : key_b;
    if (row >= skv) continue;
    const size_t r = ((size_t)b * skv + row) * hkv + kvh;   // [B, Skv, Hkv]
#pragma unroll
    for (int j = 0; j < 2 * NG; ++j) {
      const int col = 16 * g0 + 8 * j + quad_col;
      if (col >= D) continue;
      const float kx0 = acc_k[j][2 * i] * scale;
      const float kx1 = acc_k[j][2 * i + 1] * scale;
      const float v0 = acc_v[j][2 * i], v1 = acc_v[j][2 * i + 1];
      if (part == nullptr) {
        store_bf16_pair(dk + r * dh, col, dh, kx0, kx1, vec);
        store_bf16_pair(dvo + r * dv, col, dv, v0, v1, vec);
      } else {
        float* pr = part + z * part_stride + r * (dh + dv);
        if (col < dh) pr[col] = kx0;
        if (col + 1 < dh) pr[col + 1] = kx1;
        if (col < dv) pr[dh + col] = v0;
        if (col + 1 < dv) pr[dh + col + 1] = v1;
      }
    }
  }
}

// dk and dv from the G partials of [G, n_rows, Dh + Dv]: each element
// summed in index order, then rounded once
__global__ void __launch_bounds__(kReduceThreads) flash_attention_bwd_reduce(
    const float* __restrict__ part, bf16* __restrict__ dk,
    bf16* __restrict__ dvo, size_t n, int dh, int dv, int splits) {
  const int w = dh + dv;
  for (size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kReduceThreads) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    const size_t r = i / w;
    const int c = (int)(i - r * w);
    if (c < dh) dk[r * dh + c] = __float2bfloat16(s);
    else dvo[r * dv + c - dh] = __float2bfloat16(s);
  }
}

// G, as the design note states; 1 on the f32 route
int bwd_splits(int b, int skv, int h, int hkv, int dh, int dv, int dtype) {
  if (dtype != 1) return 1;
  const int group = h / hkv;
  const int rows = bwd_tile_rows((max(dh, dv) + 15) / 16 * 16);
  const long long blocks = (long long)((skv + rows - 1) / rows) * b * hkv;
  for (int g = 1; g < group; ++g)
    if (group % g == 0 && blocks * g >= 2 * kSms) return g;
  return group;
}

template <int D>
cudaError_t launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse, float* dd,
                            bf16* dq, bf16* dk, bf16* dvo, int b, int sq,
                            int skv, int h, int hkv, int dh, int dv,
                            int causal, cudaStream_t stream) {
  using S = BwdShape<D>;
  auto dq_kernel = flash_attention_bwd_dq_tc<D>;
  auto dkv_kernel = flash_attention_bwd_dkv_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kDkvSmem);
  if (err != cudaSuccess) return err;
  // 16-byte rows in device memory for cp.async and paired stores: Dh, Dv
  // multiples of 8 and every operand 16-byte aligned
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dvo);
  const int vec = dh % 8 == 0 && dv % 8 == 0 && any % 16 == 0;
  const float scale = 1.0f / sqrtf((float)dh);
  const float scale_log2 = kLog2e * scale;

  dq_kernel<<<dim3((sq + kBQ - 1) / kBQ, b * h), kTcThreads, S::kDqSmem,
              stream>>>(q, k, v, dout, lse, dd, dq, sq, skv, h, hkv, dh, dv,
                        causal, vec, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int splits = bwd_splits(b, skv, h, hkv, dh, dv, 1);
  // the partials follow D in the scratch
  float* part = splits > 1 ? dd + (size_t)b * h * sq : nullptr;
  const size_t n = (size_t)b * skv * hkv * (dh + dv);
  dkv_kernel<<<dim3((skv + S::kKeys - 1) / S::kKeys, b * hkv, splits),
               kTcThreads, S::kDkvSmem, stream>>>(
      q, k, v, dout, lse, dd, dk, dvo, part, n, sq, skv, h, hkv, dh, dv,
      causal, vec, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const size_t blocks = (n + kReduceThreads - 1) / kReduceThreads;
  const unsigned grid = blocks < 8 * kSms ? (unsigned)blocks : 8 * kSms;
  flash_attention_bwd_reduce<<<grid, kReduceThreads, 0, stream>>>(
      part, dk, dvo, n, dh, dv, splits);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd_bf16(const void* q_, const void* k_, const void* v_,
                              const void* o_, const void* dout_,
                              const float* lse, void* dq_, void* dk_,
                              void* dv_, float* dd, int b, int sq, int skv,
                              int h, int hkv, int dh, int dv, int causal,
                              cudaStream_t stream) {
  const bf16* dout = static_cast<const bf16*>(dout_);
  const int n_rows = b * sq * h;
  flash_attention_bwd_dot<bf16><<<(n_rows + kBwdThreads / 32 - 1) /
                                      (kBwdThreads / 32),
                                  kBwdThreads, 0, stream>>>(
      static_cast<const bf16*>(o_), dout, dd, n_rows, sq, h, dv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define BWD_ARGS                                                         \
  static_cast<const bf16*>(q_), static_cast<const bf16*>(k_),            \
      static_cast<const bf16*>(v_), dout, lse, dd,                       \
      static_cast<bf16*>(dq_), static_cast<bf16*>(dk_),                  \
      static_cast<bf16*>(dv_), b, sq, skv, h, hkv, dh, dv, causal, stream
  switch ((max(dh, dv) + 15) / 16 * 16) {
#define BWD_WIDTH(d) \
  case d:            \
    return launch_bwd_bf16<d>(BWD_ARGS);
    BWD_WIDTH(16) BWD_WIDTH(32) BWD_WIDTH(48) BWD_WIDTH(64)
    BWD_WIDTH(80) BWD_WIDTH(96) BWD_WIDTH(112) BWD_WIDTH(128)
    BWD_WIDTH(144) BWD_WIDTH(160) BWD_WIDTH(176) BWD_WIDTH(192)
    BWD_WIDTH(208) BWD_WIDTH(224) BWD_WIDTH(240) BWD_WIDTH(256)
#undef BWD_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

// Blocks per SM and dynamic shared memory (bytes) of the bf16 route's
// forward, dq and dk/dv kernels at padded width D, in that order, each at
// the shared memory it is launched with.
template <int D>
cudaError_t occupancy_bf16(int* blocks, int* smem) {
  using S = BwdShape<D>;
  auto fwd = flash_attention_bf16_kernel<D>;
  auto dq = flash_attention_bwd_dq_tc<D>;
  auto dkv = flash_attention_bwd_dkv_tc<D>;
  smem[0] = (int)TcShape<D>::kSmem;
  smem[1] = (int)S::kDqSmem;
  smem[2] = (int)S::kDkvSmem;
  cudaError_t e = cudaFuncSetAttribute(
      fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem[0]);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem[1]);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem[2]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], fwd,
                                                      kTcThreads, smem[0]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], dq,
                                                      kTcThreads, smem[1]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], dkv,
                                                      kTcThreads, smem[2]);
  return e;
}

cudaError_t dispatch_occupancy_bf16(int dh, int dv, int* blocks, int* smem) {
  switch ((max(dh, dv) + 15) / 16 * 16) {
#define OCC_WIDTH(d) \
  case d:            \
    return occupancy_bf16<d>(blocks, smem);
    OCC_WIDTH(16) OCC_WIDTH(32) OCC_WIDTH(48) OCC_WIDTH(64)
    OCC_WIDTH(80) OCC_WIDTH(96) OCC_WIDTH(112) OCC_WIDTH(128)
    OCC_WIDTH(144) OCC_WIDTH(160) OCC_WIDTH(176) OCC_WIDTH(192)
    OCC_WIDTH(208) OCC_WIDTH(224) OCC_WIDTH(240) OCC_WIDTH(256)
#undef OCC_WIDTH
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return kMaxHeadDim; }

// blocks[0..2], smem[0..2]: blocks per SM and dynamic shared memory bytes
// of the bf16 route's forward, dq and dk/dv kernels for widths dh, dv.
int flash_attention_bf16_occupancy(int dh, int dv, int* blocks, int* smem) {
  if (dh < 1 || dh > kMaxHeadDim || dv < 1 || dv > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_occupancy_bf16(dh, dv, blocks, smem);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  lse, where not
// null, receives each row's log-sum-exp of the scaled scores, f32
// [B, H, Sq], for the backward.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int b, int sq, int skv, int h, int hkv,
                        int dh, int dv, int causal, int dtype, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || dv < 1 || dv > kMaxHeadDim ||
      hkv < 1 || h % hkv != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_f32(q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv,
                                causal, s)
                 : dispatch_bf16(q, k, v, o, lse, b, sq, skv, h, hkv, dh, dv,
                                 causal, s);
  return (int)err;
}

// G, the blocks that split each kv head's group of query heads in the
// backward's dk/dv kernel (the design note): a call with G > 1 launches
// four kernels, otherwise three.
int flash_attention_bwd_splits(int b, int skv, int h, int hkv, int dh,
                               int dv, int dtype) {
  if (hkv < 1 || h % hkv != 0) return 1;
  return bwd_splits(b, skv, h, hkv, dh, dv, dtype);
}

// The f32 scratch, in floats, that flash_attention_bwd takes for these
// operands: D, B * H * Sq floats, followed where G > 1 by the G dk/dv
// partials [G, B, Skv, Hkv, Dh + Dv].
size_t flash_attention_bwd_scratch(int b, int sq, int skv, int h, int hkv,
                                   int dh, int dv, int dtype) {
  const int g = flash_attention_bwd_splits(b, skv, h, hkv, dh, dv, dtype);
  return (size_t)b * h * sq +
         (g > 1 ? (size_t)g * b * skv * hkv * (dh + dv) : 0);
}

// The gradient in q, k and v (all in `dtype`, shapes as the forward's) of
// the forward that produced o and lse, for the output gradient dout (o's
// shape and type).  dd: f32 scratch of flash_attention_bwd_scratch floats.
// Three kernels, or four where flash_attention_bwd_splits gives G > 1.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv_out, float* dd, int b,
                        int sq, int skv, int h, int hkv, int dh, int dv,
                        int causal, int dtype, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || dv < 1 || dv > kMaxHeadDim ||
      hkv < 1 || h % hkv != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (sq == 0 || skv == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch_bwd_f32(q, k, v, o, dout, lse, dq, dk, dv_out, dd, b,
                             sq, skv, h, hkv, dh, dv, causal, s)
          : dispatch_bwd_bf16(q, k, v, o, dout, lse, dq, dk, dv_out, dd, b,
                              sq, skv, h, hkv, dh, dv, causal, s);
  return (int)err;
}

}  // extern "C"
