// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py (_wkv_kernel /
// rwkv6_wkv) together with the bonus term its wrapper adds.  Per (batch,
// head), with S the [K, V] state carried from chunk to chunk and c the
// running sum of log2 w inside a 64-step chunk (c_{-1} = 0):
//   out_t = sum_k r_t[k] 2^{c_{t-1,k}} S[k,:]
//         + sum_{j<t} (sum_k r_t[k] k_j[k] 2^{c_{t-1,k} - c_{j,k}}) v_j
//         + (sum_k r_t[k] u[k] k_t[k]) v_t
//   S'    = 2^{c_last} o S + sum_j (k_j o 2^{c_last - c_j}) v_j^T
// Every exponent taken is <= 0, so the result is finite for every w in
// (0, 1] (the Pallas body's exp(-cum) overflows once a chunk's log-decays
// sum below about -88).  The bonus is summed with the rest in f32 and the
// output rounded to r's type once.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/rwkv6_wkv.py).  The entry makes three
// launches on the stream it is given, checks each with cudaGetLastError()
// and returns the first error; it allocates nothing.
//
// Layout: r, k [B, S, H, K] and v [B, S, H, V] in one type (f32 or bf16),
// w [B, S, H, K] f32, u [H, K] in r's type, state0 [B, H, K, V] f32 or null
// (zeros); out [B, S, H, V] in r's type, state_out [B, H, K, V] f32.
// Scratch from the caller: ds [B, H, NC, K, V] f32 and clast [B, H, NC, K]
// f32, NC = ceil(S / 64).
//
// What bounds it on the H100.  At rwkv6-3b's prefill (S = 1024, H = 40,
// K = V = 64, bf16) the function reads and writes ~32 MB (w is f32), ~10
// us at 3.35 TB/s, and needs ~0.84 GFLOP of f32 work (the recurrence:
// five operations per (t, h, k, v)), ~13 us on the CUDA cores, so the
// bound is the f32 rate.  The chunked form below does about twice that
// work (score tile, readout, chunk states) and moves the [K, V] chunk
// states through device memory (10.5 MB each way at S = 1024, mostly in
// the 50 MB L2; 168 MB at S = 16,384, where those bytes dominate).
//
// Design: the chunked form of the Pallas kernel, with the state hand-off
// that the TPU made through its sequential grid and an aliased output
// made through device memory (the structure of the chunked GLA / RWKV6
// kernels in flash-linear-attention).  No block walks more than one chunk.
//   1. wkv_chunk_state, grid (NC, B H, V / 64): a chunk's increment
//      dS = sum_j (k_j o 2^{c_last - c_j}) v_j^T and its c_last.
//   2. wkv_state_scan, one thread per (b, h, k, v): walks the chunks,
//      S_{c+1} = 2^{c_last} o S_c + dS_c, writing S_c over dS_c in place,
//      and writes state_out = S_NC.
//   3. wkv_chunk_output, grid (NC, B H, V / 64): one block holds a
//      chunk's [64, 64] score tile and all of V up to 64 columns, so the
//      tile is built once per (chunk, head) at rwkv6-3b's widths.  The
//      tile is cut into 16-step sub-blocks.  Only the four diagonal ones
//      take an exponential per (t, j, k) (the bonus on their diagonal).
//      Below them, for row block I and column block J < I, the decay
//      2^{c_{t-1} - c_j} is factored at two pivots, the step 16 I - 1
//      before row block I and the last step 16 J + 15 of column block J:
//        (r_t 2^{c_{t-1} - c_{16I-1}}) 2^{c_{16I-1} - c_{16J+15}}
//        (k_j 2^{c_{16J+15} - c_j}),
//      three factors with exponents <= 0 (j <= 16J+15 <= 16I-1 <= t-1), so
//      nothing overflows and a factor underflows only where the true term
//      is smaller still.  The off-diagonal blocks are then plain [16, K] x
//      [K, 16] products, with exponentials per (t, k), (j, k) and (I, J, k)
//      only.  The readout's r_t 2^{c_{t-1}} is the same scaled r times
//      2^{c_{16I-1}}.
// Every product is f32 on the CUDA cores (the decays and the state are f32
// in the reference, and the port allows no TF32), from shared memory in
// float4 rows, with 4 x 4 outputs per thread.  Decays use the accurate
// exp2f / log2f (no fast math).  Steps past the end of the sequence carry
// w = 1 and k = v = r = 0, and their output is not written.
//
// Loads: every tile of a chunk is in flight at once (f32 tiles by
// cp.async, bf16 tiles by 16-byte loads held in registers), and the chunk
// state, needed last, arrives while the score tile is built.  K = 64
// (rwkv6-3b) is fixed at compile time; other K take general instances.
//
// What still holds it back (wkv_ablation.py at the repo root times each
// stage): k, v and w are loaded by two kernels and the chunk states
// make a round trip through memory, so loads, running sums and barriers
// take about half the time; the diagonal sub-blocks' exponentials (480
// pairs per chunk and key column, on the special-function units); and
// f32 CUDA-core products that a bf16 hi/lo split on the tensor cores
// would take over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;           // chunk length (steps)
constexpr int kL = 16;           // sub-block length of the score tile
constexpr int kVB = 64;          // V columns per block
constexpr int kThreads = 256;
constexpr int kSeg = 4;          // segments of the running-sum pass
constexpr int kMaxK = 128;       // widest K taken (rwkv6-3b: 64)
constexpr int kLdT = kC + 4;     // row stride of A^T [j][t]
constexpr int kLdV = kVB + 4;    // row stride of [.][v] tiles
constexpr int kKT = 3 * kL;      // rows j of k scaled at a column pivot
constexpr int kTri = kL * (kL - 1) / 2;   // strictly lower pairs per block
constexpr int kDiagExp = (kC / kL) * kTri;
constexpr int kPairs = 6;        // sub-block pairs (I, J), I > J
// 16-byte loads of a bf16 [kC][K] tile per thread, at most
constexpr int kMaxGroups = kC * kMaxK / 8 / kThreads;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// the two bf16 halves of a 32-bit word, first element in the low half
__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// 4 consecutive outputs, 16-byte (f32) or 8-byte (bf16) aligned
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  unsigned b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = __bfloat16_as_ushort(__float2bfloat16(x[i]));
  *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | (b[1] << 16),
                                            b[2] | (b[3] << 16));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// acc[i][j] += a[i] b[j]: one step of an outer-product (register-tile) sum
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a,
                                      float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ void outer_row(float (&acc)[4], float a,
                                          float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][j] += sum_q a[i]_q b[q]_j: four steps of a row-times-tile sum,
// a[i] holding four consecutive k of row i and b[q] row k + q
__device__ __forceinline__ void rows_by_tile(float (&acc)[4][4],
                                             const float4 (&a)[4],
                                             const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    outer_row(acc[i], a[i].x, b[0]);
    outer_row(acc[i], a[i].y, b[1]);
    outer_row(acc[i], a[i].z, b[2]);
    outer_row(acc[i], a[i].w, b[3]);
  }
}

// acc[i][j] += a[i] . b[j]: four steps of a row-times-row sum
__device__ __forceinline__ void rows_by_rows(float (&acc)[4][4],
                                             const float4 (&a)[4],
                                             const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = fmaf(a[i].x, b[j].x, acc[i][j]);
      x = fmaf(a[i].y, b[j].y, x);
      x = fmaf(a[i].z, b[j].z, x);
      acc[i][j] = fmaf(a[i].w, b[j].w, x);
    }
}

// 16-byte copy from global to shared memory, in flight until a
// cp_async_wait covers its group; an invalid one writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `kPending` of the latest committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The tiles of one chunk.  dst[t][c] (row stride ld) = src[t * rstride +
// col0 + c] for t < nrows and col0 + c < width, 0 elsewhere, c < ncols.
// In the vector routes, ncols, width and col0 are multiples of 8 and src
// is 16-byte aligned: f32 tiles move by cp.async, bf16 tiles through
// registers (every load issued before the first is used).  Tiles needed
// late are waited for late.
__device__ __forceinline__ void async_tile(float* dst, int ld,
                                           const float* src, size_t rstride,
                                           int nrows, int col0, int ncols,
                                           int width) {
  const int ng = ncols / 4;
  for (int e = threadIdx.x; e < kC * ng; e += kThreads) {
    const int t = e / ng, c = 4 * (e - t * ng);
    const bool ok = t < nrows && col0 + c < width;
    cp_async16(dst + t * ld + c, ok ? src + t * rstride + col0 + c : src, ok);
  }
}

__device__ __forceinline__ void fetch_bf16(uint4 (&x)[kMaxGroups],
                                           const __nv_bfloat16* src,
                                           size_t rstride, int nrows,
                                           int col0, int ncols, int width) {
  const int ng = ncols / 8;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int t = e / ng, c = 8 * (e - t * ng);
    x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kC * ng && t < nrows && col0 + c < width)
      x[i] = *reinterpret_cast<const uint4*>(src + t * rstride + col0 + c);
  }
}

__device__ __forceinline__ void put_bf16(float* dst, int ld,
                                         const uint4 (&x)[kMaxGroups],
                                         int ncols) {
  const int ng = ncols / 8;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= kC * ng) break;
    const int t = e / ng, c = 8 * (e - t * ng);
    float* p = dst + t * ld + c;
    *reinterpret_cast<float4*>(p) = make_float4(
        bf16_lo(x[i].x), bf16_hi(x[i].x), bf16_lo(x[i].y), bf16_hi(x[i].y));
    *reinterpret_cast<float4*>(p + 4) = make_float4(
        bf16_lo(x[i].z), bf16_hi(x[i].z), bf16_lo(x[i].w), bf16_hi(x[i].w));
  }
}

template <typename T>
__device__ __forceinline__ void scalar_tile(float* dst, int ld,
                                            const T* __restrict__ src,
                                            size_t rstride, int nrows,
                                            int col0, int ncols, int width) {
  for (int e = threadIdx.x; e < kC * ncols; e += kThreads) {
    const int t = e / ncols, c = e - t * ncols;
    dst[t * ld + c] = (t < nrows && col0 + c < width)
                          ? to_f32(src[t * rstride + col0 + c])
                          : 0.0f;
  }
}

// In place over a chunk: c[t][col] holds w on entry and
// sum_{i <= t} log2 max(w_i, 1e-30) on exit; steps and columns past the
// ends count as w = 1.  Each thread scans 16 steps of one column, then
// adds the sums of the segments before its own.  Ends with a barrier.
__device__ __forceinline__ void chunk_log2_cumsum(float* c, int ld, int kp,
                                                  float* tot, int nrows,
                                                  int kd) {
  constexpr int kLen = kC / kSeg;
  for (int e = threadIdx.x; e < kSeg * kp; e += kThreads) {
    const int seg = e / kp, col = e - seg * kp;
    float x[kLen];
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      const int t = seg * kLen + i;
      x[i] = (t < nrows && col < kd)
                 ? log2f(fmaxf(c[t * ld + col], 1e-30f))
                 : 0.0f;
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      acc += x[i];
      c[(seg * kLen + i) * ld + col] = acc;
    }
    tot[seg * kp + col] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSeg * kp; e += kThreads) {
    const int seg = e / kp, col = e - seg * kp;
    if (seg == 0) continue;
    float off = 0.0f;
    for (int q = 0; q < seg; ++q) off += tot[q * kp + col];
#pragma unroll
    for (int i = 0; i < kLen; ++i) c[(seg * kLen + i) * ld + col] += off;
  }
  __syncthreads();
}

size_t smem_state_bytes(int kp) {
  return sizeof(float) * (2 * kC * (kp + 4) + kC * kLdV + kSeg * kp);
}

// Phase 1: dS = sum_j (k_j o 2^{c_last - c_j}) v_j^T for one chunk, one
// (b, h) and 64 columns of V; clast = c_last.  KP: the padded key width,
// fixed at compile time (64, rwkv6-3b's), or 0 to read it from kd.
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads) wkv_chunk_state(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ ds,
    float* __restrict__ clast, int s, int h, int kd, int vd, int nc,
    bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int kp = KP > 0 ? KP : (kd + 3) & ~3, ldk = kp + 4;
  float* s_k = smem;                 // [kC][ldk]  k, then k 2^{c_last - c}
  float* s_c = s_k + kC * ldk;       // [kC][ldk]  w, then c
  float* s_v = s_c + kC * ldk;       // [kC][kLdV] v slice
  float* s_tot = s_v + kC * kLdV;    // [kSeg][kp]

  const int chunk = blockIdx.x, bh = blockIdx.y, v0 = blockIdx.z * kVB;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const T* kb = k + (row0 * h + head) * kd;
  const T* vb = v + (row0 * h + head) * vd;
  const float* wb = w + (row0 * h + head) * kd;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  uint4 xv[kMaxGroups];              // the bf16 v tile, stored once needed
  if (vec) {
    async_tile(s_c, ldk, wb, rk, nrows, 0, kp, kd);
    if constexpr (sizeof(T) == 4)
      async_tile(s_k, ldk, kb, rk, nrows, 0, kp, kd);
    cp_async_commit();
    if constexpr (sizeof(T) == 4) {
      async_tile(s_v, kLdV, vb, rv, nrows, v0, kVB, vd);
    } else {
      uint4 xk[kMaxGroups];
      fetch_bf16(xk, kb, rk, nrows, 0, kp, kd);
      fetch_bf16(xv, vb, rv, nrows, v0, kVB, vd);
      put_bf16(s_k, ldk, xk, kp);
    }
    cp_async_commit();
    cp_async_wait<1>();                // w (and f32 k); v later
  } else {
    scalar_tile(s_k, ldk, kb, rk, nrows, 0, kp, kd);
    scalar_tile(s_c, ldk, wb, rk, nrows, 0, kp, kd);
    scalar_tile(s_v, kLdV, vb, rv, nrows, v0, kVB, vd);
  }
  __syncthreads();
  chunk_log2_cumsum(s_c, ldk, kp, s_tot, nrows, kd);

  const float* c_last = s_c + (kC - 1) * ldk;
  for (int e = threadIdx.x; e < kC * kp; e += kThreads) {
    const int t = e / kp, c = e - t * kp;
    s_k[t * ldk + c] *= exp2f(c_last[c] - s_c[t * ldk + c]);
  }
  const size_t cidx = (size_t)bh * nc + chunk;
  if (blockIdx.z == 0)
    for (int c = threadIdx.x; c < kd; c += kThreads)
      clast[cidx * kd + c] = c_last[c];
  if constexpr (sizeof(T) == 2)
    if (vec) put_bf16(s_v, kLdV, xv, kVB);
  cp_async_wait<0>();
  __syncthreads();

  float* out = ds + cidx * kd * vd;
  const bool vec_out = (vd & 3) == 0;
  for (int q = threadIdx.x; q < (kp / 4) * (kVB / 4); q += kThreads) {
    const int k0 = 4 * (q / (kVB / 4)), c0 = 4 * (q % (kVB / 4));
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < kC; ++j)
      outer(acc, ld4(s_k + j * ldk + k0), ld4(s_v + j * kLdV + c0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i >= kd) break;
      float* row = out + (size_t)(k0 + i) * vd + v0 + c0;
      if (vec_out && v0 + c0 + 3 < vd) {
        store4(row, acc[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (v0 + c0 + j < vd) row[j] = acc[i][j];
      }
    }
  }
}

// Phase 2: per (b, h, k, v), S_{c+1} = 2^{c_last,c} S_c + dS_c over the
// chunks; S_c is written over dS_c, S_NC to state_out.
__global__ void __launch_bounds__(kThreads) wkv_state_scan(
    const float* __restrict__ state0, float* __restrict__ ds,
    const float* __restrict__ clast, float* __restrict__ state_out, int nbh,
    int kd, int vd, int nc) {
  const size_t kv = (size_t)kd * vd;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)nbh * kv) return;
  const size_t bh = e / kv, rem = e - bh * kv;
  const int kk = (int)(rem / vd);
  float st = state0 != nullptr ? state0[e] : 0.0f;
  float* d = ds + bh * nc * kv + rem;
  const float* cl = clast + bh * nc * kd + kk;
  constexpr int kAhead = 8;          // chunks whose loads are in flight
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float inc[kAhead], dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        inc[i] = d[(size_t)(c0 + i) * kv];
        dec[i] = cl[(size_t)(c0 + i) * kd];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        d[(size_t)(c0 + i) * kv] = st;
        st = fmaf(exp2f(dec[i]), st, inc[i]);
      }
  }
  state_out[e] = st;
}

size_t smem_output_bytes(int kp) {
  const int ldk = kp + 4;
  const int k = imax(kC * ldk, kp * kLdV);    // k, then S_c
  const int c = imax(kC * ldk, kC * kLdT);    // w and c, then A^T
  return sizeof(float) * (kC * ldk + k + c + kC * kLdV + kp + kPairs * kp +
                          (kC / kL) * kp + kSeg * kp);
}

// strictly lower pair q of a 16 x 16 block: row tp > column jp
__device__ __forceinline__ void tri_pair(int q, int& tp, int& jp) {
  tp = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)q)) * 0.5f);
  while (tp * (tp - 1) / 2 > q) --tp;
  while ((tp + 1) * tp / 2 <= q) ++tp;
  jp = q - tp * (tp - 1) / 2;
}

// sub-block pair p = I (I - 1) / 2 + J of the score tile, I > J
__device__ __forceinline__ void block_pair(int p, int& bi, int& bj) {
  bi = p < 1 ? 1 : (p < 3 ? 2 : 3);
  bj = p - bi * (bi - 1) / 2;
}

// Phase 3: out for one chunk, one (b, h) and 64 columns of V.  KP as in
// phase 1.
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads, 3) wkv_chunk_output(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const T* __restrict__ u, const float* __restrict__ ds,
    T* __restrict__ out, int s, int h, int kd, int vd, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int kp = KP > 0 ? KP : (kd + 3) & ~3, ldk = kp + 4;
  float* s_r = smem;                 // [kC][ldk] r, scaled in place twice
  float* s_k = s_r + kC * ldk;       // [kC][ldk] k, rows < 48 scaled in
                                     // place; then S_c [kp][kLdV]
  float* s_c = s_k + imax(kC * ldk, kp * kLdV);   // [kC][ldk] w, then c;
                                                  // then A^T [kC][kLdT]
  float* s_v = s_c + imax(kC * ldk, kC * kLdT);   // [kC][kLdV] v slice
  float* s_u = s_v + kC * kLdV;      // [kp]
  float* s_d = s_u + kp;             // [kPairs][kp] 2^{c_{16I-1} - c_{16J+15}}
  float* s_e = s_d + kPairs * kp;    // [4][kp]      2^{c_{16I-1}}
  float* s_tot = s_e + (kC / kL) * kp;   // [kSeg][kp]
  float* s_s = s_k;
  float* s_at = s_c;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, bh = blockIdx.y, v0 = blockIdx.z * kVB;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const T* rb = r + (row0 * h + head) * kd;
  const T* kb = k + (row0 * h + head) * kd;
  const T* vb = v + (row0 * h + head) * vd;
  const float* wb = w + (row0 * h + head) * kd;
  const float* sb = ds + ((size_t)bh * nc + chunk) * kd * vd + v0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  if (vec) {       // kp == kd here
    async_tile(s_c, ldk, wb, rk, nrows, 0, kp, kd);
    if constexpr (sizeof(T) == 4) {
      async_tile(s_r, ldk, rb, rk, nrows, 0, kp, kd);
      async_tile(s_k, ldk, kb, rk, nrows, 0, kp, kd);
    }
    cp_async_commit();
    if constexpr (sizeof(T) == 4) {
      async_tile(s_v, kLdV, vb, rv, nrows, v0, kVB, vd);
    } else {
      uint4 xr[kMaxGroups], xk[kMaxGroups], xv[kMaxGroups];
      fetch_bf16(xr, rb, rk, nrows, 0, kp, kd);
      fetch_bf16(xk, kb, rk, nrows, 0, kp, kd);
      fetch_bf16(xv, vb, rv, nrows, v0, kVB, vd);
      put_bf16(s_r, ldk, xr, kp);
      put_bf16(s_k, ldk, xk, kp);
      put_bf16(s_v, kLdV, xv, kVB);
    }
  } else {
    scalar_tile(s_r, ldk, rb, rk, nrows, 0, kp, kd);
    scalar_tile(s_k, ldk, kb, rk, nrows, 0, kp, kd);
    scalar_tile(s_c, ldk, wb, rk, nrows, 0, kp, kd);
    scalar_tile(s_v, kLdV, vb, rv, nrows, v0, kVB, vd);
  }
  for (int c = tid; c < kp; c += kThreads)
    s_u[c] = c < kd ? to_f32(u[(size_t)head * kd + c]) : 0.0f;
  cp_async_commit();
  cp_async_wait<1>();                // w (and f32 r, k); f32 v later
  __syncthreads();
  chunk_log2_cumsum(s_c, ldk, kp, s_tot, nrows, kd);

  // Diagonal sub-blocks, one (t, j) pair per thread and round: the 480
  // strictly lower pairs first (an exponential per k), then the 64 bonus
  // terms, so that no warp takes more than two of the costly ones.
  float diag[3];
  int diag_at[3];
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    const int e = tid + round * kThreads;
    diag_at[round] = -1;
    if (e >= kDiagExp + kC) continue;
    float acc = 0.0f;
    int t, j;
    if (e < kDiagExp) {
      int tp, jp;
      tri_pair(e % kTri, tp, jp);
      t = (e / kTri) * kL + tp;
      j = (e / kTri) * kL + jp;
      const float* rr = s_r + t * ldk;
      const float* kk = s_k + j * ldk;
      const float* cp = s_c + (t - 1) * ldk;
      const float* cj = s_c + j * ldk;
      float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int c = 0; c < kp; c += 4) {
        const float4 a = ld4(rr + c), bb = ld4(kk + c);
        const float4 x = ld4(cp + c), y = ld4(cj + c);
        part.x = fmaf(a.x * bb.x, exp2f(x.x - y.x), part.x);
        part.y = fmaf(a.y * bb.y, exp2f(x.y - y.y), part.y);
        part.z = fmaf(a.z * bb.z, exp2f(x.z - y.z), part.z);
        part.w = fmaf(a.w * bb.w, exp2f(x.w - y.w), part.w);
      }
      acc = (part.x + part.y) + (part.z + part.w);
    } else {
      t = j = e - kDiagExp;
      const float* rr = s_r + t * ldk;
      const float* kk = s_k + t * ldk;
      for (int c = 0; c < kp; c += 4) {
        const float4 a = ld4(rr + c), bb = ld4(kk + c), uu = ld4(s_u + c);
        acc = fmaf(a.x * bb.x, uu.x, acc);
        acc = fmaf(a.y * bb.y, uu.y, acc);
        acc = fmaf(a.z * bb.z, uu.z, acc);
        acc = fmaf(a.w * bb.w, uu.w, acc);
      }
    }
    diag[round] = acc;
    diag_at[round] = j * kLdT + t;
  }
  // the pivots' decays: pair (I, J) and row block I
  for (int e = tid; e < (kPairs + kC / kL) * kp; e += kThreads) {
    const int p = e / kp, c = e - p * kp;
    if (p < kPairs) {
      int bi, bj;
      block_pair(p, bi, bj);
      s_d[e] = exp2f(s_c[(bi * kL - 1) * ldk + c] -
                         s_c[(bj * kL + kL - 1) * ldk + c]);
    } else {
      const int bi = p - kPairs;
      s_e[bi * kp + c] = bi > 0 ? exp2f(s_c[(bi * kL - 1) * ldk + c])
                                : 1.0f;
    }
  }
  __syncthreads();

  // In place: r_t 2^{c_{t-1} - c_{16I-1}} (row pivot, c_{-1} = 0) and,
  // for j < 48, k_j 2^{c_{16J+15} - c_j} (column pivot).
  for (int e = tid; e < kC * kp; e += kThreads) {
    const int t = e / kp, c = e - t * kp;
    const int piv = (t / kL) * kL - 1;
    const float cprev = t > 0 ? s_c[(t - 1) * ldk + c] : 0.0f;
    const float cpiv = piv >= 0 ? s_c[piv * ldk + c] : 0.0f;
    s_r[t * ldk + c] *= exp2f(cprev - cpiv);
    if (t < kKT)
      s_k[t * ldk + c] *= exp2f(s_c[((t / kL) * kL + kL - 1) * ldk + c] -
                                    s_c[t * ldk + c]);
  }
  __syncthreads();

  // Off-diagonal blocks: 96 4 x 4 tiles (rows 16 I + tr + 4 i, columns
  // 16 J + tc + 4 j), the K sum split over two halves of 96 threads.  A^T
  // over the running sums, with the diagonal blocks and zeros above.
  float acc[4][4] = {};
  const int q = tid % 96, half = tid / 96;
  int bi, bj;
  block_pair(q / 16, bi, bj);
  const int tr0 = bi * kL + (q % 16) / 4, jc0 = bj * kL + q % 4;
  if (half < 2) {
    const int kh = (kp / 8) * 4;
    const int c_end = half == 0 ? kh : kp;
    const float* dp = s_d + (q / 16) * kp;
    for (int c = half == 0 ? 0 : kh; c < c_end; c += 4) {
      const float4 dd = ld4(dp + c);
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = mul4(ld4(s_r + (tr0 + 4 * i) * ldk + c), dd);
        bb[i] = ld4(s_k + (jc0 + 4 * i) * ldk + c);
      }
      rows_by_rows(acc, a, bb);
    }
    if (half == 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s_at[(jc0 + 4 * jj) * kLdT + tr0 + 4 * i] = acc[i][jj];
  }
#pragma unroll
  for (int round = 0; round < 3; ++round)
    if (diag_at[round] >= 0) s_at[diag_at[round]] = diag[round];
  if (tid < 6 * (kC / 4)) {   // the readout's 4 x 4 diagonal tiles read
    const int d = 4 * (tid / 6), p = tid % 6;   // these zeros above t
    const int a = p < 3 ? 0 : (p < 5 ? 1 : 2);
    const int jb = a + 1 + p - (a == 0 ? 0 : (a == 1 ? 3 : 5));
    s_at[(d + jb) * kLdT + d + a] = 0.0f;
  }
  __syncthreads();

  // S_c over k's space (k is read no more)
  if (vec) {
    for (int e = tid; e < kp * (kVB / 4); e += kThreads) {
      const int c = e / (kVB / 4), col = 4 * (e - c * (kVB / 4));
      const bool ok = v0 + col < vd;
      cp_async16(s_s + c * kLdV + col, ok ? sb + (size_t)c * vd + col : sb,
                 ok);
    }
  } else {
    for (int e = tid; e < kp * kVB; e += kThreads) {
      const int c = e / kVB, col = e - c * kVB;
      s_s[c * kLdV + col] =
          (c < kd && v0 + col < vd) ? sb[(size_t)c * vd + col] : 0.0f;
    }
  }
  cp_async_commit();
  if (half == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        s_at[(jc0 + 4 * jj) * kLdT + tr0 + 4 * i] += acc[i][jj];
  // r_t 2^{c_{t-1}} = (r_t 2^{c_{t-1} - c_{16I-1}}) 2^{c_{16I-1}}
  for (int e = tid; e < kC * kp; e += kThreads) {
    const int t = e / kp, c = e - t * kp;
    s_r[t * ldk + c] *= s_e[(t / kL) * kp + c];
  }
  cp_async_wait<0>();
  __syncthreads();

  // out_t = (r_t 2^{c_{t-1}}) . S_c + sum_{j <= t} A[t][j] v_j, rows
  // 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of the slice
  const int ty = tid / (kVB / 4), tx = tid % (kVB / 4);
  const int rt0 = 4 * ty, vc0 = 4 * tx;
  float o[4][4] = {};
#pragma unroll 4
  for (int c = 0; c < kp; c += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = ld4(s_r + (rt0 + i) * ldk + c);
      bb[i] = ld4(s_s + (c + i) * kLdV + vc0);
    }
    rows_by_tile(o, a, bb);
  }
  for (int j = 0; j <= rt0 + 3; ++j)
    outer(o, ld4(s_at + j * kLdT + rt0), ld4(s_v + j * kLdV + vc0));
  const bool vec_out = (vd & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rt0 + i >= nrows) break;
    T* row = out + ((row0 + rt0 + i) * h + head) * vd + v0 + vc0;
    if (vec_out && v0 + vc0 + 3 < vd) {
      store4(row, o[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (v0 + vc0 + jj < vd) store1(row + jj, o[i][jj]);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kernels' shared-memory limits, raised once per instance to what the
// widest K needs (thread-safe: a function-local static).
template <typename T, int KP>
cudaError_t configure() {
  static const cudaError_t err = [] {
    const int kp = KP > 0 ? KP : kMaxK;
    cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_state<T, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_state_bytes(kp));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_chunk_output<T, KP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_output_bytes(kp));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_chunk_output<T, KP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T, int KP>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const void* u, const float* state0,
                   void* out, float* state_out, float* ds, float* clast,
                   int batch, int s, int h, int kd, int vd,
                   cudaStream_t stream) {
  cudaError_t err = configure<T, KP>();
  if (err != cudaSuccess) return err;
  const int kp = (kd + 3) & ~3;
  const int nc = (s + kC - 1) / kC, nbh = batch * h;
  const bool vec = kd % 8 == 0 && vd % 8 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(v) && aligned16(w);
  const dim3 grid(nc, nbh, (vd + kVB - 1) / kVB);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  wkv_chunk_state<T, KP><<<grid, kThreads, smem_state_bytes(kp), stream>>>(
      kt, vt, w, ds, clast, s, h, kd, vd, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n2 = (size_t)nbh * kd * vd;
  wkv_state_scan<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(state0, ds, clast, state_out, nbh, kd, vd, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  wkv_chunk_output<T, KP><<<grid, kThreads, smem_output_bytes(kp), stream>>>(
      rt, kt, vt, w, static_cast<const T*>(u), ds, static_cast<T*>(out), s,
      h, kd, vd, nc, vec);
  return cudaGetLastError();
}

// K = 64 (rwkv6-3b) takes the instances with the key width fixed at
// compile time; any other K the general ones.
template <typename T>
cudaError_t launch_any(const void* r, const void* k, const void* v,
                       const float* w, const void* u, const float* state0,
                       void* out, float* state_out, float* ds, float* clast,
                       int batch, int s, int h, int kd, int vd,
                       cudaStream_t stream) {
  if (kd == 64)
    return launch<T, 64>(r, k, v, w, u, state0, out, state_out, ds, clast,
                         batch, s, h, kd, vd, stream);
  return launch<T, 0>(r, k, v, w, u, state0, out, state_out, ds, clast,
                      batch, s, h, kd, vd, stream);
}

// ---------------------------------------------------------------------------
// The backward (rwkv6_wkv_bwd) replaces no Pallas kernel: the reference
// differentiates the WKV with XLA (repro/kernels/ops.py rwkv6_wkv, through
// repro/kernels/ref.py rwkv6_wkv_chunked or the Pallas kernel's plain
// body).  Per (b, h) and chunk, with p = max(w, 1e-30) the clamped decay
// of a step (1 past the ends), S the state entering the chunk and G the
// gradient of the state leaving it, and E_tj = prod_{j<n<t} p_n:
//   G_{c-1} = P_L o G_c + sum_t (r_t o ecp_t) do_t^T,  P_L = prod_t p_t
//   dr_t = ecp_t o (S do_t) + sum_{j<t} (do_t.v_j) k_j o E_tj
//          + (do_t.v_t) u o k_t
//   dk_j = sum_{t>j} (do_t.v_j) r_t o E_tj + (do_j.v_j) u o r_j
//          + edec_j o (G v_j)
//   dv_j = sum_{t>j} A_tj do_t + beta_j do_j + G^T (k_j o edec_j)
//   du   = sum_{b,t} (do_t.v_t) r_t o k_t
//   dla_i = sum_{t>i} x_t + sum_{j<i<t} y_tj + q + sum_{j<i} z_j
// with ecp_t = prod_{n<t} p_n, edec_j = prod_{n>j} p_n, A_tj = sum_k r_t
// k_j E_tj, beta_j = sum_k r_j u k_j, x_t = r_t o (dr_t's S term), y_tj =
// (do_t.v_j) r_t o k_j o E_tj, z_j = k_j o (dk_j's G term) and q = P_L o
// rowsum(S o G); dla is the gradient of ln p, and dw = dla / w where w >=
// 1e-30, else 0.  dla is summed term by term: as a reverse cumulative sum
// of the gradient of the running log decay, y_{t,t-1} (decay 1) would
// enter it with both signs.
//
// No exponential and no logarithm: every decay is a product of p over its
// own steps, multiplied in step by step (log w runs down to -69 a step, so
// a ratio of two running products, or a difference of two running sums,
// overflows or cancels).  Every factor is <= 1, so a factor underflows
// only where the term is smaller still.  The chunk is cut into four
// 16-step sub-blocks; per (step, channel) elcp_t is the product over the
// steps of t's sub-block before t and ers_j over those of j's after j,
// and et_M is sub-block M's product.  Where t and j lie in sub-blocks
// I > J, E_tj = elcp_t D_IJ ers_j with D_IJ the product of et_M over the
// sub-blocks between, so A, dr and dk there are products of the scaled
// operands r o elcp and k o ers.  Inside one sub-block each (j, channel)
// carries its product along t (one multiply and one FMA a step), and the
// diagonal terms of dr and dk their own, whose last value is elcp or ers.
// The middle term of dla splits by the sub-blocks of t and j against i's
// sub-block m:
//   (a) t after m, j before m:  sum D_IJ Q_IJ, Q_IJ = sum_{t in I, j in J}
//       (r o elcp)_t (do_t.v_j) (k o ers)_j
//   (b) t after m, j in m, j < i:  sum_j (k o ers)_j X_j, X_j the sum over
//       later sub-blocks that dk_j's off-diagonal part also takes
//   (c) t in m, t > i, j before m:  sum_t (r o elcp)_t Y_t, likewise dr's
//   (d) t and j in m:  sum_{t>i} r_t B_it W_t(i), B_it = prod_{i<n<t} p_n,
//       W_t(i) = sum_{j<i} (do_t.v_j) k_j prod_{j<n<=i} p_n, carried along
//       i as W_t(i+1) = p_{i+1} (W_t(i) + (do_t.v_i) k_i).
//
// What bounds it on the H100: at rwkv6-3b's train shape (B 2, S 1024, H
// 40, K = V = 64) the gradient of the sequential recurrence needs about
// 11 f32 operations per (t, h, k, v) (as the SSD's), 3.7 GFLOP, ~55 us
// at 67 TFLOP/s, against ~50 MB read and written, ~15 us: the f32 rate.
// Design: four launches, no block walking more than one chunk, no
// atomics.
//   1. wkv_bwd_state_inc, grid (NC, B H): each chunk's
//      sum_t (r_t o ecp_t) do_t^T and its decay product P_L.
//   2. wkv_bwd_state_scan, one thread per (b, h, k, v): the state's
//      gradient from the last chunk to the first, written over the
//      increments (dstate at the end).
//   3. wkv_bwd_chunk_grad, grid (NC, B H), in two parts with the shared
//      memory reused: the terms that take S and G, ecp o (S do), edec o
//      (G v), G^T (k o edec) and q, into f32 scratch; then the rest of dr,
//      dk, dv and dw and a (b, chunk) partial of du, adding those terms
//      back (they make their round trip through the L2 cache: the block
//      that wrote them reads them).
//   4. wkv_bwd_reduce sums the partials of du in index order, so the same
//      inputs give the same bits.
// The bf16 instance of phase 3 holds two blocks per SM (107 KiB of shared
// memory, 128 registers): r, k, v and do stay bf16 in shared memory
// (exact there), the decays are kept as w (clamped where read; no
// log-decay tile), tiles are reused from part to part, and every tile
// arrives by 16-byte cp.async copies issued before the first is waited
// for (S and G while the step products run).  Its 64 x 64 products do S^T,
// v G^T, (k o edec) G and do v^T run on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), each f32 operand (S, G, k o edec)
// split into two bf16 pieces, hi = bf16(x) and lo = bf16(x - hi), which
// hold it to about 2^-16 of itself.  The rest of the products (A and its
// transpose times do, the off-diagonal sub-blocks of dr and dk, the
// sub-blocks' running products and dla) are f32 on the CUDA cores in
// register tiles, as is all of the f32 route (one block per SM; the port
// allows no TF32).  Steps past the end of S carry w = 1 and zero
// operands, and their gradients are not written.  wkv_ablation.py --part
// bwd times the stages; PERF.md keeps what they showed.

constexpr int kBK = 64;          // widest K and V the backward takes
constexpr int kLdB = kBK + 4;    // row stride of the f32 [.][k], [.][v] tiles
constexpr int kLdP = kC + 1;     // row stride of the [t][j] tile
constexpr int kNSub = kC / kL;   // sub-blocks per chunk
constexpr int kTileB = kC * kLdB;
constexpr int kTileP = kC * kLdP;
constexpr int kTerms = 3 * kC * kBK;   // a chunk's S and G terms in scratch
constexpr unsigned kAll = 0xffffffffu;

// row stride of a [64][64] operand tile in its own type: 16-byte rows,
// each four banks on from the one before
template <typename T>
__host__ __device__ constexpr int ld_op() {
  return sizeof(T) == 4 ? kLdB : kBK + 8;
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y), bf16_hi(x.y));
}

// 16 consecutive elements from shared memory (16-byte aligned), as f32
__device__ __forceinline__ void ld16(const float* p, float (&x)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = ld4(p + 4 * q);
    x[4 * q] = a.x;
    x[4 * q + 1] = a.y;
    x[4 * q + 2] = a.z;
    x[4 * q + 3] = a.w;
  }
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p,
                                     float (&x)[16]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[q];
    const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[8 * q + 2 * i] = bf16_lo(u[i]);
      x[8 * q + 2 * i + 1] = bf16_hi(u[i]);
    }
  }
}

// The bf16 route's tensor-core products (as in mamba2_ssd.cu): mma.sync
// m16n8k16 with bf16 operands from ldmatrix and f32 sums; an f32 operand
// is split into kPieces bf16 pieces, hi = bf16(x) and lo = bf16(x - hi),
// each multiplied in turn.
constexpr int kPieces = 2;             // bf16 pieces of an f32 operand
constexpr int kLdH = kBK + 8;          // row stride of the bf16 [64][64]
constexpr int kTileH = kC * kLdH;      // tiles (ld_op of bf16)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i receives its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// four 8 x 8 b16 matrices, each transposed on the way (as ldmatrix_x4)
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

// (v0, v1) rounded to bf16, v0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An f32 pair as kPieces bf16 pairs, largest first: each piece is the
// bf16 rounding of what the earlier ones leave (each difference is exact
// in f32).  Two pieces hold the pair to about 2^-16 of itself.
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&w)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    w[i] = pack_bf16(v0, v1);
    v0 -= bf16_lo(w[i]);
    v1 -= bf16_hi(w[i]);
  }
}

// A warp's lane terms (bytes) on a bf16 [64][kLdH] tile, for its 16 x 32
// part (rows 16 wm, columns 32 wn) of a 64 x 64 product: an A operand
// [m][k]; a B operand, two n-tiles, from [n][k] rows or (trans) [k][n]
// rows.  The k-step ks and the n-tile pair jp add 32 (ks + jp kLdH) bytes
// (rows) or 32 (ks kLdH + jp) bytes (trans).
struct MmaLanes {
  uint32_t a, b, bt;
  __device__ __forceinline__ MmaLanes(int wm, int wn, int lane)
      : a(2 * ((16 * wm + (lane & 15)) * kLdH + 8 * (lane >> 4))),
        b(2 * ((32 * wn + (lane & 7) + 8 * (lane >> 4)) * kLdH +
               8 * ((lane >> 3) & 1))),
        bt(2 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdH + 32 * wn +
                8 * (lane >> 4))) {}
};

// acc[16 x 32] += a[16 x 64] b^T, a bf16 [m][k] at sh_a and b as npieces
// bf16 pieces [n][k] at sh_b (one tile apart): the warp's part of a 64 x
// 64 x 64 product
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], uint32_t sh_a,
                                         uint32_t sh_b, int npieces,
                                         const MmaLanes& ln) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, sh_a + ln.a + 32 * ks);
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      if (i >= npieces) break;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4(f, sh_b + i * 2 * kTileH + ln.b + 32 * (jp * kLdH + ks));
        mma_bf16(acc[2 * jp], fa, f[0], f[1]);
        mma_bf16(acc[2 * jp + 1], fa, f[2], f[3]);
      }
    }
  }
}

// A [64][64] tile of one chunk in its own type: dst[t][c] = src[t *
// rstride + c] for t < nrows and c < width, 0 elsewhere.  vec: 16-byte
// cp.async copies (width a multiple of 16 / sizeof(T), src 16-byte
// aligned), committed by the caller; else element by element.
template <typename T>
__device__ __forceinline__ void tile_bwd(T* dst, int ld,
                                         const T* __restrict__ src,
                                         size_t rstride, int nrows,
                                         int width, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kNg = kBK / kPer;      // copies per row
    for (int e = threadIdx.x; e < kC * kNg; e += kThreads) {
      const int t = e / kNg, c = kPer * (e - t * kNg);
      const bool ok = t < nrows && c < width;
      cp_async16(reinterpret_cast<float*>(dst + t * ld + c),
                 ok ? static_cast<const void*>(src + t * rstride + c)
                    : static_cast<const void*>(src),
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < kC * kBK; e += kThreads) {
      const int t = e / kBK, c = e - t * kBK;
      dst[t * ld + c] = (t < nrows && c < width) ? src[t * rstride + c]
                                                 : T(0.0f);
    }
  }
}

// Thread (m, c) of a block, m = tid / 64: the clamped decays p of channel
// c over the 16 steps of sub-block m (1 past the ends), and their product
// returned.  s_w: the chunk's w tile.
__device__ __forceinline__ float step_products(const float* s_w, int m, int c,
                                               int nrows, int kd,
                                               float (&p)[kL]) {
  float et = 1.0f;
#pragma unroll
  for (int n = 0; n < kL; ++n) {
    const int t = kL * m + n;
    p[n] = (t < nrows && c < kd) ? fmaxf(s_w[t * kLdB + c], 1e-30f) : 1.0f;
    et *= p[n];
  }
  return et;
}

template <typename T>
size_t smem_bwd_inc_bytes() {
  return sizeof(float) * (2 * kTileB + kNSub * kBK) +
         sizeof(T) * 2 * kC * ld_op<T>();
}

// Backward phase 1: inc = sum_t (r_t o ecp_t) do_t^T for one chunk and one
// (b, h), and plast = P_L, the chunk's decay product.
template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_inc(
    const T* __restrict__ r, const float* __restrict__ w,
    const T* __restrict__ dout, float* __restrict__ inc,
    float* __restrict__ plast, int s, int h, int kd, int vd, int nc,
    bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldo = ld_op<T>();
  float* s_re = smem;                  // [kC][kLdB] r o ecp
  float* s_w = s_re + kTileB;          // [kC][kLdB] w
  float* s_et = s_w + kTileB;          // [kNSub][kBK] sub-block products
  T* s_r = reinterpret_cast<T*>(s_et + kNSub * kBK);   // [kC][ldo]
  T* s_do = s_r + kC * ldo;                            // [kC][ldo]
  const int tid = threadIdx.x, chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  const size_t cidx = (size_t)bh * nc + chunk;
  tile_bwd(s_w, kLdB, w + (row0 * h + head) * kd, rk, nrows, kd, vec);
  tile_bwd(s_r, ldo, r + (row0 * h + head) * kd, rk, nrows, kd, vec);
  cp_async_commit();
  tile_bwd(s_do, ldo, dout + (row0 * h + head) * vd, rv, nrows, vd, vec);
  cp_async_commit();
  cp_async_wait<1>();                  // w and r; do later
  __syncthreads();
  {
    const int m = tid / kBK, c = tid - m * kBK;
    float p[kL];
    const float et = step_products(s_w, m, c, nrows, kd, p);
    s_et[m * kBK + c] = et;
    __syncthreads();
    float e = 1.0f;                    // the sub-blocks before, in order
    for (int q = 0; q < m; ++q) e *= s_et[q * kBK + c];
    if (m == kNSub - 1 && c < kd) plast[cidx * kd + c] = e * et;
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      const int t = kL * m + n;
      s_re[t * kLdB + c] = to_f32(s_r[t * ldo + c]) * e;
      e *= p[n];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // rows tr .. tr + 3 (channels), columns vc .. vc + 3
  const int tr = 4 * (tid >> 4), vc = 4 * (tid & 15);
  float acc[4][4] = {};
#pragma unroll 4
  for (int t = 0; t < kC; ++t)
    outer(acc, ld4(s_re + t * kLdB + tr), ld4(s_do + t * ldo + vc));
  float* out = inc + cidx * kd * vd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tr + i >= kd) break;
    float* row = out + (size_t)(tr + i) * vd + vc;
    if ((vd & 3) == 0 && vc + 3 < vd) {
      store4(row, acc[i]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (vc + jj < vd) row[jj] = acc[i][jj];
    }
  }
}

// Backward phase 2: per (b, h, k, v), from the last chunk to the first:
// the gradient of the state leaving chunk c is written over its
// increment, then G_{c-1} = plast_c G_c + inc_c; dstate = G_{-1} (where
// wanted).
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_scan(
    const float* __restrict__ dstate_out, float* __restrict__ ds,
    const float* __restrict__ plast, float* __restrict__ dstate, int nbh,
    int kd, int vd, int nc) {
  const size_t kv = (size_t)kd * vd;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)nbh * kv) return;
  const size_t bh = e / kv, rem = e - bh * kv;
  const int kk = (int)(rem / vd);
  float g = dstate_out != nullptr ? dstate_out[e] : 0.0f;
  float* d = ds + bh * nc * kv + rem;
  const float* pl = plast + bh * nc * kd + kk;
  constexpr int kAhead = 8;          // chunks whose loads are in flight
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float inc[kAhead], dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        inc[i] = d[(size_t)(c0 - i) * kv];
        dec[i] = pl[(size_t)(c0 - i) * kd];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        d[(size_t)(c0 - i) * kv] = g;
        g = fmaf(dec[i], g, inc[i]);
      }
  }
  if (dstate != nullptr) dstate[e] = g;
}

// shared memory of phase 3's first part (the S and G terms): the f32
// route's tiles, or the bf16 route's (S's, G's and k o edec's pieces, v,
// do, ecp and edec)
template <typename T>
size_t smem_bwd_state_bytes() {
  if constexpr (sizeof(T) == 2)
    return sizeof(float) * (2 * kTileB + kNSub * kBK) +
           sizeof(T) * (3 * kPieces + 2) * kTileH;
  else
    return sizeof(float) * (4 * kTileB + kNSub * kBK) +
           sizeof(T) * 3 * kC * ld_op<T>();
}

// Phase 3's first part on the f32 route: the S and G terms, every product
// f32 FMA on the CUDA cores in 4 x 4 register tiles.
template <typename T>
__device__ __forceinline__ void state_grad_fma(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ dout,
    const float* __restrict__ states, const float* __restrict__ dstates,
    float* __restrict__ terms, float* __restrict__ qout, int s, int h,
    int kd, int vd, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldo = ld_op<T>();
  float* s_s = smem;                   // [kBK][kLdB] S (rows k)
  float* s_g = s_s + kTileB;           // [kBK][kLdB] G (rows k)
  float* s_ecp = s_g + kTileB;         // [kC][kLdB] w, then ecp
  float* s_edec = s_ecp + kTileB;      // [kC][kLdB] edec
  float* s_et = s_edec + kTileB;       // [kNSub][kBK] sub-block products
  T* s_k = reinterpret_cast<T*>(s_et + kNSub * kBK);   // [kC][ldo]
  T* s_v = s_k + kC * ldo;                             // [kC][ldo]
  T* s_do = s_v + kC * ldo;                            // [kC][ldo]
  const int tid = threadIdx.x, chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  const size_t cidx = (size_t)bh * nc + chunk;
  const size_t kv = (size_t)kd * vd;
  tile_bwd(s_ecp, kLdB, w + (row0 * h + head) * kd, rk, nrows, kd, vec);
  tile_bwd(s_k, ldo, k + (row0 * h + head) * kd, rk, nrows, kd, vec);
  cp_async_commit();
  tile_bwd(s_v, ldo, v + (row0 * h + head) * vd, rv, nrows, vd, vec);
  tile_bwd(s_do, ldo, dout + (row0 * h + head) * vd, rv, nrows, vd, vec);
  cp_async_commit();
  tile_bwd(s_s, kLdB, states + cidx * kv, (size_t)vd, kd, vd, vec);
  tile_bwd(s_g, kLdB, dstates + cidx * kv, (size_t)vd, kd, vd, vec);
  cp_async_commit();
  cp_async_wait<2>();                  // w and k; the rest in flight
  __syncthreads();
  {
    const int m = tid / kBK, c = tid - m * kBK;
    float p[kL];
    const float et = step_products(s_ecp, m, c, nrows, kd, p);
    s_et[m * kBK + c] = et;
    __syncthreads();
    float e = 1.0f;                    // ecp: the sub-blocks before, then
    for (int q = 0; q < m; ++q)        // step by step
      e *= s_et[q * kBK + c];
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      s_ecp[(kL * m + n) * kLdB + c] = e;
      e *= p[n];
    }
    e = 1.0f;                          // edec: the sub-blocks after, then
    for (int q = kNSub - 1; q > m; --q)   // step by step
      e *= s_et[q * kBK + c];
#pragma unroll
    for (int n = kL - 1; n >= 0; --n) {
      s_edec[(kL * m + n) * kLdB + c] = e;
      e *= p[n];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int tr = 4 * (tid >> 4), tx = tid & 15;
  float* tb = terms + cidx * kTerms;
  // dr_s rows t, columns c = tx + 16 jj
  {
    float acc[4][4] = {};
#pragma unroll 4
    for (int vv = 0; vv < kBK; vv += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_do + (tr + i) * ldo + vv);
        bb[i] = ld4(s_s + (tx + 16 * i) * kLdB + vv);
      }
      rows_by_rows(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = tr + i, c = tx + 16 * jj;
        tb[t * kBK + c] = s_ecp[t * kLdB + c] * acc[i][jj];
      }
  }
  // dk_s rows j, columns c
  {
    float acc[4][4] = {};
#pragma unroll 4
    for (int vv = 0; vv < kBK; vv += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_v + (tr + i) * ldo + vv);
        bb[i] = ld4(s_g + (tx + 16 * i) * kLdB + vv);
      }
      rows_by_rows(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tr + i, c = tx + 16 * jj;
        tb[kC * kBK + j * kBK + c] = s_edec[j * kLdB + c] * acc[i][jj];
      }
  }
  // dv_s rows j, columns vc .. vc + 3
  {
    const int vc = 4 * tx;
    float acc[4][4] = {};
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = mul4(ld4(s_k + (tr + i) * ldo + c),
                    ld4(s_edec + (tr + i) * kLdB + c));
        bb[i] = ld4(s_g + (c + i) * kLdB + vc);
      }
      rows_by_tile(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store4(tb + 2 * kC * kBK + (tr + i) * kBK + vc, acc[i]);
  }
  if (tid < kBK) {
    float x = 0.0f;
#pragma unroll 4
    for (int vv = 0; vv < kBK; vv += 4) {
      const float4 a = ld4(s_s + tid * kLdB + vv);
      const float4 g = ld4(s_g + tid * kLdB + vv);
      x = fmaf(a.x, g.x, x);
      x = fmaf(a.y, g.y, x);
      x = fmaf(a.z, g.z, x);
      x = fmaf(a.w, g.w, x);
    }
    const float pl = ((s_et[tid] * s_et[kBK + tid]) * s_et[2 * kBK + tid]) *
                     s_et[3 * kBK + tid];
    qout[cidx * kBK + tid] = pl * x;
  }
}

// Phase 3's first part on the bf16 route: the three products on mma.sync,
// S, G and k o edec each split into two bf16 pieces (do and v are exact in
// bf16).  S and G arrive as f32 while the step products run, give q, and
// are rewritten in place as their pieces.
__device__ __forceinline__ void state_grad_tc(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ w, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ states, const float* __restrict__ dstates,
    float* __restrict__ terms, float* __restrict__ qout, int s, int h,
    int kd, int vd, int nc, bool vec) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  bf16* s_sp = reinterpret_cast<bf16*>(smem);   // [kPieces][kC][kLdH] S's
  bf16* s_gp = s_sp + kPieces * kTileH;          // pieces, G's pieces,
  bf16* s_kp = s_gp + kPieces * kTileH;          // k then k o edec's
  bf16* s_v = s_kp + kPieces * kTileH;           // [kC][kLdH] v
  bf16* s_do = s_v + kTileH;                     // [kC][kLdH] do
  float* s_ecp = reinterpret_cast<float*>(s_do + kTileH);   // [kC][kLdB]
                                                            // w, then ecp
  float* s_edec = s_ecp + kTileB;      // [kC][kLdB] edec
  float* s_et = s_edec + kTileB;       // [kNSub][kBK] sub-block products
  float* stage_s = reinterpret_cast<float*>(s_sp);   // [kBK][kLdB] S, G
  float* stage_g = reinterpret_cast<float*>(s_gp);   // as they arrive
  const int tid = threadIdx.x, chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  const size_t cidx = (size_t)bh * nc + chunk;
  const size_t kv = (size_t)kd * vd;
  tile_bwd(s_ecp, kLdB, w + (row0 * h + head) * kd, rk, nrows, kd, vec);
  tile_bwd(s_kp, kLdH, k + (row0 * h + head) * kd, rk, nrows, kd, vec);
  cp_async_commit();
  tile_bwd(s_v, kLdH, v + (row0 * h + head) * vd, rv, nrows, vd, vec);
  tile_bwd(s_do, kLdH, dout + (row0 * h + head) * vd, rv, nrows, vd, vec);
  cp_async_commit();
  tile_bwd(stage_s, kLdB, states + cidx * kv, (size_t)vd, kd, vd, vec);
  tile_bwd(stage_g, kLdB, dstates + cidx * kv, (size_t)vd, kd, vd, vec);
  cp_async_commit();
  cp_async_wait<2>();                  // w and k; the rest in flight
  __syncthreads();
  {
    const int m = tid / kBK, c = tid - m * kBK;
    float p[kL];
    const float et = step_products(s_ecp, m, c, nrows, kd, p);
    s_et[m * kBK + c] = et;
    __syncthreads();
    float e = 1.0f;
    for (int q = 0; q < m; ++q) e *= s_et[q * kBK + c];
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      s_ecp[(kL * m + n) * kLdB + c] = e;
      e *= p[n];
    }
    e = 1.0f;
    for (int q = kNSub - 1; q > m; --q) e *= s_et[q * kBK + c];
#pragma unroll
    for (int n = kL - 1; n >= 0; --n) {
      const int t = kL * m + n;
      s_edec[t * kLdB + c] = e;
      // k o edec over k, in its pieces (this thread's own elements)
      const float x = __bfloat162float(s_kp[t * kLdH + c]) * e;
      const bf16 hi = __float2bfloat16(x);
      s_kp[t * kLdH + c] = hi;
      s_kp[kTileH + t * kLdH + c] = __float2bfloat16(x - __bfloat162float(hi));
      e *= p[n];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kBK) {                     // q, from the f32 S and G
    float x = 0.0f;
#pragma unroll 4
    for (int vv = 0; vv < kBK; vv += 4) {
      const float4 a = ld4(stage_s + tid * kLdB + vv);
      const float4 g = ld4(stage_g + tid * kLdB + vv);
      x = fmaf(a.x, g.x, x);
      x = fmaf(a.y, g.y, x);
      x = fmaf(a.z, g.z, x);
      x = fmaf(a.w, g.w, x);
    }
    const float pl = ((s_et[tid] * s_et[kBK + tid]) * s_et[2 * kBK + tid]) *
                     s_et[3 * kBK + tid];
    qout[cidx * kBK + tid] = pl * x;
  }
  {                                    // S and G into their pieces, in place
    const int r0 = tid >> 5, c = 2 * (tid & 31);
    float2 xs[kC / 8], xg[kC / 8];
#pragma unroll
    for (int i = 0; i < kC / 8; ++i) {
      xs[i] = *reinterpret_cast<const float2*>(stage_s + (r0 + 8 * i) * kLdB + c);
      xg[i] = *reinterpret_cast<const float2*>(stage_g + (r0 + 8 * i) * kLdB + c);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kC / 8; ++i) {
      uint32_t ps[kPieces], pg[kPieces];
      split_pair(xs[i].x, xs[i].y, ps);
      split_pair(xg[i].x, xg[i].y, pg);
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int at = j * kTileH + (r0 + 8 * i) * kLdH + c;
        *reinterpret_cast<uint32_t*>(s_sp + at) = ps[j];
        *reinterpret_cast<uint32_t*>(s_gp + at) = pg[j];
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g8 = lane >> 2, q4 = lane & 3;
  const MmaLanes ln(wm, wn, lane);
  const uint32_t sh_sp = smem_addr(s_sp), sh_gp = smem_addr(s_gp);
  const uint32_t sh_kp = smem_addr(s_kp), sh_v = smem_addr(s_v);
  const uint32_t sh_do = smem_addr(s_do);
  float* tb = terms + cidx * kTerms;
  // each thread's outputs: rows 16 wm + g8 (+ 8), columns 32 wn + 8 nt +
  // 2 q4 (+ 1) of a [64][64] tile, the row scaled by scale (or not)
  auto put = [&](float* out, const float (&acc)[4][4], const float* scale) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int row = 16 * wm + g8 + 8 * r2, col = 32 * wn + 8 * nt + 2 * q4;
        float2 x = make_float2(acc[nt][2 * r2], acc[nt][2 * r2 + 1]);
        if (scale != nullptr) {
          const float2 e = *reinterpret_cast<const float2*>(
              scale + row * kLdB + col);
          x.x *= e.x;
          x.y *= e.y;
        }
        *reinterpret_cast<float2*>(out + row * kBK + col) = x;
      }
  };
  {                                    // dr_s = ecp o (do S^T)
    float acc[4][4] = {};
    mma_rows(acc, sh_do, sh_sp, kPieces, ln);
    put(tb, acc, s_ecp);
  }
  {                                    // dk_s = edec o (v G^T)
    float acc[4][4] = {};
    mma_rows(acc, sh_v, sh_gp, kPieces, ln);
    put(tb + kC * kBK, acc, s_edec);
  }
  {                                    // dv_s = (k o edec) G: the pieces'
    float acc[4][4] = {};              // products hi hi, hi lo, lo hi
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int ia = 0; ia < kPieces; ++ia) {
        uint32_t fa[4];
        ldmatrix_x4(fa, sh_kp + ia * 2 * kTileH + ln.a + 32 * ks);
#pragma unroll
        for (int ib = 0; ib + ia < kPieces; ++ib)
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, sh_gp + ib * 2 * kTileH + ln.bt +
                                     32 * (ks * kLdH + jp));
            mma_bf16(acc[2 * jp], fa, f[0], f[1]);
            mma_bf16(acc[2 * jp + 1], fa, f[2], f[3]);
          }
      }
    put(tb + 2 * kC * kBK, acc, nullptr);
  }
}

// shared memory of backward phase 3: its first part's or its second's,
// whichever is more
template <typename T>
size_t smem_bwd_grad_bytes() {
  const size_t rest = sizeof(float) * (3 * kTileB + kTileP + kBK +
                                       kNSub * kBK + kC + 4 * kBK) +
                      sizeof(T) * 4 * kC * ld_op<T>();
  const size_t terms = smem_bwd_state_bytes<T>();
  return rest > terms ? rest : terms;
}

// Phase 3's second part, given the chunk's S and G terms and q: dr, dk,
// dv, dw and the (b, chunk) partial of du for one chunk and one (b, h).
template <typename T>
__device__ __forceinline__ void chunk_grad(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ u,
    const T* __restrict__ dout, const float* __restrict__ terms,
    const float* __restrict__ qin, T* __restrict__ dr, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ dup,
    int s, int h, int kd, int vd, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldo = ld_op<T>();
  float* s_p = smem;                   // [kC][kLdB] w (1 past the ends)
  float* s_rt = s_p + kTileB;          // [kC][kLdB] r o elcp, then x + pc
  float* s_kt = s_rt + kTileB;         // [kC][kLdB] k o ers, then z + pb
  float* s_m = s_kt + kTileB;          // [kC][kLdP] do_t.v_j at [t][j] for
                                       // t >= j, A_tj at [j][t] for t > j
  float* s_u = s_m + kTileP;           // [kBK] u
  float* s_et = s_u + kBK;             // [kNSub][kBK] sub-block products
  float* s_beta = s_et + kNSub * kBK;  // [kC] beta_t
  float* s_q = s_beta + kC;            // [3][kBK] Q_20, Q_30, Q_31
  float* s_qs = s_q + 3 * kBK;         // [kBK] q
  T* s_r = reinterpret_cast<T*>(s_qs + kBK);   // [kC][ldo] r
  T* s_k = s_r + kC * ldo;                     // [kC][ldo] k
  T* s_v = s_k + kC * ldo;                     // [kC][ldo] v, then (with
  T* s_do = s_v + kC * ldo;                    // do's) x and z per 4 rows
  float* s_xq = reinterpret_cast<float*>(s_v);   // [16][kBK]
  float* s_zq = s_xq + 16 * kBK;                 // [16][kBK]
  const int tid = threadIdx.x, tr = 4 * (tid >> 4), tx = tid & 15;
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  const size_t cidx = (size_t)bh * nc + chunk;
  const float* tb = terms + cidx * kTerms;

  tile_bwd(s_p, kLdB, w + (row0 * h + head) * kd, rk, nrows, kd, vec);
  tile_bwd(s_r, ldo, r + (row0 * h + head) * kd, rk, nrows, kd, vec);
  tile_bwd(s_k, ldo, k + (row0 * h + head) * kd, rk, nrows, kd, vec);
  cp_async_commit();
  tile_bwd(s_v, ldo, v + (row0 * h + head) * vd, rv, nrows, vd, vec);
  tile_bwd(s_do, ldo, dout + (row0 * h + head) * vd, rv, nrows, vd, vec);
  cp_async_commit();
  if (tid < kBK) {
    s_u[tid] = tid < kd ? to_f32(u[(size_t)head * kd + tid]) : 0.0f;
    s_qs[tid] = qin[cidx * kBK + tid];
  }
  cp_async_wait<1>();                  // w, r and k; v and do later
  __syncthreads();

  // One thread per (sub-block m, channel c): p over its 16 steps, r o elcp
  // forward and k o ers backward, step by step, and et_m.  The tile keeps
  // w (dw reads it), set to 1 past the ends; a reader clamps it.
  {
    const int m = tid / kBK, c = tid - m * kBK;
    float p[kL];
    s_et[m * kBK + c] = step_products(s_p, m, c, nrows, kd, p);
    float e = 1.0f;
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      const int t = kL * m + n;
      if (t >= nrows || c >= kd) s_p[t * kLdB + c] = 1.0f;
      s_rt[t * kLdB + c] = to_f32(s_r[t * ldo + c]) * e;
      e *= p[n];
    }
    e = 1.0f;
#pragma unroll
    for (int n = kL - 1; n >= 0; --n) {
      const int t = kL * m + n;
      s_kt[t * kLdB + c] = to_f32(s_k[t * ldo + c]) * e;
      e *= p[n];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // do_t . v_j where t >= j: the bf16 route on mma.sync (both exact in
  // bf16; the warps whose 16 x 32 part lies above the diagonal skip it),
  // the f32 route in rows t and columns j = tx + 16 jj
  if constexpr (sizeof(T) == 2) {
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1;
    if (32 * wn <= 16 * wm + 15) {
      float acc[4][4] = {};
      mma_rows(acc, smem_addr(s_do), smem_addr(s_v), 1,
               MmaLanes(wm, wn, lane));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * wm + (lane >> 2) + 8 * (e >> 1);
          const int j = 32 * wn + 8 * nt + 2 * (lane & 3) + (e & 1);
          if (j <= t) s_m[t * kLdP + j] = acc[nt][e];
        }
    }
  } else {
    float acc[4][4] = {};
#pragma unroll 4
    for (int vv = 0; vv < kBK; vv += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_do + (tr + i) * ldo + vv);
        bb[i] = ld4(s_v + (tx + 16 * i) * ldo + vv);
      }
      rows_by_rows(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (tx + 16 * jj <= tr + i)
          s_m[(tr + i) * kLdP + tx + 16 * jj] = acc[i][jj];
  }
  // A inside the diagonal sub-blocks, one thread per (sub-block m, column
  // j, 16 channels): each channel carries E_tj along t, one multiply a
  // step; the four channel groups are summed by two butterflies (the same
  // sum in every lane).  beta_j likewise.
  {
    const int m = tid >> 6, jl = (tid >> 2) & 15, c0 = 16 * (tid & 3);
    const int j = kL * m + jl;
    float kj[16], e[16], x[16];
    ld16(s_k + j * ldo + c0, kj);
    ld16(s_r + j * ldo + c0, x);
    float bsum = 0.0f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      e[q] = 1.0f;
      bsum = fmaf(x[q] * s_u[c0 + q], kj[q], bsum);
    }
    bsum += __shfl_xor_sync(kAll, bsum, 1);
    bsum += __shfl_xor_sync(kAll, bsum, 2);
    if ((tid & 3) == 0) s_beta[j] = bsum;
#pragma unroll 1
    for (int tl = 1; tl < kL; ++tl) {
      const int t = kL * m + tl;
      float a = 0.0f;
      if (tl > jl) {
        float pt[16];
        ld16(s_r + t * ldo + c0, x);
        ld16(s_p + t * kLdB + c0, pt);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          a = fmaf(x[q] * e[q], kj[q], a);
          e[q] *= fmaxf(pt[q], 1e-30f);
        }
      }
      a += __shfl_xor_sync(kAll, a, 1);
      a += __shfl_xor_sync(kAll, a, 2);
      if ((tid & 3) == 0 && tl > jl) s_m[j * kLdP + t] = a;
    }
  }
  // A on the six sub-block pairs I > J: sum_k (r o elcp)_t D_IJ (k o
  // ers)_j.  Thread (tl, jl) takes row tl of sub-blocks 1..3 and column jl
  // of 0..2, all six pairs: D_20 = et_1 on k's side, D_31 = et_2 on k's,
  // D_30 = et_1 et_2 on both.
  {
    const int tl = tid >> 4, jl = tid & 15;
    float acc[kPairs] = {};
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 e1 = ld4(s_et + kBK + c), e2 = ld4(s_et + 2 * kBK + c);
      const float4 r1 = ld4(s_rt + (kL + tl) * kLdB + c);
      const float4 r2 = ld4(s_rt + (2 * kL + tl) * kLdB + c);
      const float4 r3 = ld4(s_rt + (3 * kL + tl) * kLdB + c);
      const float4 k0 = ld4(s_kt + jl * kLdB + c);
      const float4 k1 = ld4(s_kt + (kL + jl) * kLdB + c);
      const float4 k2 = ld4(s_kt + (2 * kL + jl) * kLdB + c);
      const float4 k0e = mul4(k0, e1), k1e = mul4(k1, e2);
      const float4 r3e = mul4(r3, e2);
      // pairs in block_pair's order: (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
      const float4 as[kPairs] = {r1, r2, r2, r3e, r3, r3};
      const float4 bs[kPairs] = {k0, k0e, k1, k0e, k1e, k2};
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        acc[q] = fmaf(as[q].x, bs[q].x, acc[q]);
        acc[q] = fmaf(as[q].y, bs[q].y, acc[q]);
        acc[q] = fmaf(as[q].z, bs[q].z, acc[q]);
        acc[q] = fmaf(as[q].w, bs[q].w, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      int bi, bj;
      block_pair(q, bi, bj);
      s_m[(kL * bj + jl) * kLdP + kL * bi + tl] = acc[q];
    }
  }
  __syncthreads();

  // Q_IJ for the pairs two or more sub-blocks apart, one thread per (pair,
  // channel)
  if (tid < 3 * kBK) {
    const int pq = tid / kBK, c = tid - pq * kBK;
    const int bi = pq == 0 ? 2 : 3, bj = pq == 2 ? 1 : 0;
    float kc[kL];
#pragma unroll
    for (int n = 0; n < kL; ++n) kc[n] = s_kt[(kL * bj + n) * kLdB + c];
    float acc = 0.0f;
#pragma unroll 1
    for (int t = kL * bi; t < kL * bi + kL; ++t) {
      float inner = 0.0f;
#pragma unroll
      for (int n = 0; n < kL; ++n)
        inner = fmaf(s_m[t * kLdP + kL * bj + n], kc[n], inner);
      acc = fmaf(s_rt[t * kLdB + c], inner, acc);
    }
    s_q[pq * kBK + c] = acc;
  }

  const int sb = tr / kL, bend = kL * sb + kL;   // the rows' sub-block
  // dv rows j, columns vc .. vc + 3: dv_s + beta_j do_j + sum_{t>j}
  // A_tj do_t
  {
    const int vc = 4 * tx;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = ld4(tb + 2 * kC * kBK + (tr + i) * kBK + vc);
      acc[i][0] = x.x;
      acc[i][1] = x.y;
      acc[i][2] = x.z;
      acc[i][3] = x.w;
    }
#pragma unroll 2
    for (int t = tr; t < kC; ++t) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = tr + i;
        a[i] = t > j ? s_m[j * kLdP + t] : (t == j ? s_beta[j] : 0.0f);
      }
      outer(acc, make_float4(a[0], a[1], a[2], a[3]),
            ld4(s_do + t * ldo + vc));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tr + i >= nrows) break;
      T* row = dv + ((row0 + tr + i) * h + head) * vd;
      if ((vd & 3) == 0 && vc + 3 < vd) {
        store4(row + vc, acc[i]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (vc + jj < vd) store1(row + vc + jj, acc[i][jj]);
      }
    }
  }

  // dk rows j, channels c = tx + 16 jj; z + pb and the rows' sum of z are
  // kept for dla
  float colc[4][4], zq[4] = {};
  {
    // X_j = sum_{I>J} D_IJ sum_{t in I} (do_t.v_j) (r o elcp)_t, by Horner
    // from the last sub-block: X <- et_I o X + (sub-block I's sum)
    float xo[4][4] = {};
    for (int bi = kNSub - 1; bi > sb; --bi) {
      if (bi < kNSub - 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            xo[i][jj] *= s_et[bi * kBK + tx + 16 * jj];
#pragma unroll 2
      for (int t = kL * bi; t < kL * bi + kL; ++t) {
        const float* mr = s_m + t * kLdP + tr;
        float rp[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) rp[jj] = s_rt[t * kLdB + tx + 16 * jj];
        outer(xo, make_float4(mr[0], mr[1], mr[2], mr[3]),
              make_float4(rp[0], rp[1], rp[2], rp[3]));
      }
    }
    // inside j's sub-block: t > j, E_tj carried along t; its last value
    // is ers_j
    float dg[4][4] = {}, ers[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ers[i][jj] = 1.0f;
#pragma unroll 1
    for (int t = tr + 1; t < bend; ++t) {
      float pt[4], rr[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pt[jj] = fmaxf(s_p[t * kLdB + tx + 16 * jj], 1e-30f);
        rr[jj] = to_f32(s_r[t * ldo + tx + 16 * jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t > tr + i) {
          const float d = s_m[t * kLdP + tr + i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dg[i][jj] = fmaf(d * rr[jj], ers[i][jj], dg[i][jj]);
            ers[i][jj] *= pt[jj];
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tr + i;
      T* row = dk + ((row0 + j) * h + head) * kd;
      const float bonus = s_m[j * kLdP + j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float st = tb[kC * kBK + j * kBK + c];
        const float val = ((ers[i][jj] * xo[i][jj] + dg[i][jj]) +
                           bonus * s_u[c] * to_f32(s_r[j * ldo + c])) +
                          st;
        const float z = to_f32(s_k[j * ldo + c]) * st;
        colc[i][jj] = z + s_kt[j * kLdB + c] * xo[i][jj];
        zq[jj] += z;
        if (j < nrows && c < kd) store1(row + c, val);
      }
    }
  }

  // dr rows t, channels c; x + pc and the rows' sum of x are kept for dla
  float rowc[4][4], xq[4] = {};
  {
    // Y_t = sum_{J<I} D_IJ sum_{j in J} (do_t.v_j) (k o ers)_j, by Horner
    // from sub-block 0: Y <- et_J o Y + (sub-block J's sum)
    float yo[4][4] = {};
    for (int bj = 0; bj < sb; ++bj) {
      if (bj > 0)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            yo[i][jj] *= s_et[bj * kBK + tx + 16 * jj];
#pragma unroll 2
      for (int j = kL * bj; j < kL * bj + kL; ++j) {
        float kp[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) kp[jj] = s_kt[j * kLdB + tx + 16 * jj];
        outer(yo,
              make_float4(s_m[tr * kLdP + j], s_m[(tr + 1) * kLdP + j],
                          s_m[(tr + 2) * kLdP + j], s_m[(tr + 3) * kLdP + j]),
              make_float4(kp[0], kp[1], kp[2], kp[3]));
      }
    }
    // inside t's sub-block: j < t, E_tj carried down from j = t - 1; its
    // last value is elcp_t
    float dg[4][4] = {}, elcp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) elcp[i][jj] = 1.0f;
#pragma unroll 1
    for (int j = tr + 2; j >= kL * sb; --j) {
      float pj[4], kk[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        pj[jj] = fmaxf(s_p[j * kLdB + tx + 16 * jj], 1e-30f);
        kk[jj] = to_f32(s_k[j * ldo + tx + 16 * jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j < tr + i) {
          const float d = s_m[(tr + i) * kLdP + j];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dg[i][jj] = fmaf(d * kk[jj], elcp[i][jj], dg[i][jj]);
            elcp[i][jj] *= pj[jj];
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + i;
      T* row = dr + ((row0 + t) * h + head) * kd;
      const float bonus = s_m[t * kLdP + t];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float st = tb[t * kBK + c];
        const float val = ((elcp[i][jj] * yo[i][jj] + dg[i][jj]) +
                           bonus * s_u[c] * to_f32(s_k[t * ldo + c])) +
                          st;
        const float x = to_f32(s_r[t * ldo + c]) * st;
        rowc[i][jj] = x + s_rt[t * kLdB + c] * yo[i][jj];
        xq[jj] += x;
        if (t < nrows && c < kd) store1(row + c, val);
      }
    }
  }
  __syncthreads();                     // r o elcp, k o ers, v and do read
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      s_rt[(tr + i) * kLdB + c] = rowc[i][jj];
      s_kt[(tr + i) * kLdB + c] = colc[i][jj];
    }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    s_xq[(tr / 4) * kBK + tx + 16 * jj] = xq[jj];
    s_zq[(tr / 4) * kBK + tx + 16 * jj] = zq[jj];
  }
  __syncthreads();

  // dla for the 16 steps of sub-block m and channel c, then dw
  {
    const int m = tid / kBK, c = tid - m * kBK, i0 = kL * m;
    float pv[kL], rv[kL], kv[kL], rs[kL], wt[kL];
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      pv[n] = fmaxf(s_p[(i0 + n) * kLdB + c], 1e-30f);
      rv[n] = to_f32(s_r[(i0 + n) * ldo + c]);
      kv[n] = to_f32(s_k[(i0 + n) * ldo + c]);
      wt[n] = 0.0f;
    }
    // (sum of x over the later sub-blocks) + sum_{t in m, t > i} (x + pc)
    float xl = 0.0f, ze = 0.0f;
    for (int q = 4 * (m + 1); q < kC / 4; ++q) xl += s_xq[q * kBK + c];
    for (int q = 0; q < 4 * m; ++q) ze += s_zq[q * kBK + c];
    rs[kL - 1] = xl;
#pragma unroll
    for (int n = kL - 1; n > 0; --n)
      rs[n - 1] = rs[n] + s_rt[(i0 + n) * kLdB + c];
    // (a): D_IJ Q_IJ over I > m > J (D_20 = et_1, D_30 = et_1 et_2, D_31
    // = et_2)
    const float e1 = s_et[kBK + c], e2 = s_et[2 * kBK + c];
    float pa = 0.0f;
    if (m == 1) pa = fmaf(e1, s_q[c], (e1 * e2) * s_q[kBK + c]);
    if (m == 2) pa = fmaf(e1 * e2, s_q[kBK + c], e2 * s_q[2 * kBK + c]);
    const float base = s_qs[c] + pa;
    float* dwb = dw + (row0 * h + head) * kd + c;
    float cpre = ze;                   // (sum of z over the earlier
                                       // sub-blocks) + sum_{j in m, j < i}
                                       // (z + pb)
#pragma unroll
    for (int n = 0; n < kL; ++n) {
      // (d): sum_{t>i} r_t B_it W_t(i), B carried along t
      float dd = 0.0f, bt = 1.0f;
#pragma unroll
      for (int t = n + 1; t < kL; ++t) {
        dd = fmaf(rv[t] * bt, wt[t], dd);
        bt *= pv[t];
      }
      const float dla = ((rs[n] + cpre) + base) + dd;
      cpre += s_kt[(i0 + n) * kLdB + c];
#pragma unroll
      for (int t = n + 2; t < kL; ++t)
        wt[t] = (wt[t] + s_m[(i0 + t) * kLdP + i0 + n] * kv[n]) * pv[n + 1];
      const int i = i0 + n;
      if (i < nrows && c < kd) {
        const float wv = s_p[i * kLdB + c];
        dwb[(size_t)i * h * kd] = wv >= 1e-30f ? dla / wv : 0.0f;
      }
    }
    // the sub-block's part of du's partial, sum_t (do_t.v_t) r_t k_t, over
    // the x sums (read above; the barrier before the writes)
    float du = 0.0f;
#pragma unroll
    for (int n = 0; n < kL; ++n)
      du = fmaf(s_m[(i0 + n) * kLdP + i0 + n], rv[n] * kv[n], du);
    __syncthreads();
    s_xq[m * kBK + c] = du;
  }
  // the partial of du: the four sub-blocks' sums in order
  __syncthreads();
  if (tid < kBK && tid < kd)
    dup[(((size_t)b * nc + chunk) * h + head) * kd + tid] =
        ((s_xq[tid] + s_xq[kBK + tid]) + s_xq[2 * kBK + tid]) +
        s_xq[3 * kBK + tid];
}

// Backward phase 3: one chunk and one (b, h).  First the terms that take
// S and G, into terms[cidx] (three [64][64] f32 tiles: dr_s = ecp o (S do)
// at [t][k], dk_s = edec o (G v) at [j][k], dv_s = G^T (k o edec) at
// [j][v]) and qs[cidx] (q, [64]); then, with the shared memory reused, the
// rest of dr, dk, dv, dw and the (b, chunk) partial of du.  The terms make
// a round trip through the L2 cache: the block that wrote them reads them.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    wkv_bwd_chunk_grad(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ w,
                       const T* __restrict__ u, const T* __restrict__ dout,
                       const float* __restrict__ states,
                       const float* __restrict__ dstates,
                       float* __restrict__ terms, float* __restrict__ qs,
                       T* __restrict__ dr, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ dw,
                       float* __restrict__ dup, int s, int h, int kd, int vd,
                       int nc, bool vec) {
  if constexpr (sizeof(T) == 2)
    state_grad_tc(k, v, w, dout, states, dstates, terms, qs, s, h, kd, vd,
                  nc, vec);
  else
    state_grad_fma(k, v, w, dout, states, dstates, terms, qs, s, h, kd, vd,
                   nc, vec);
  __syncthreads();                     // the terms are written (and visible
                                       // to the block); shared memory free
  chunk_grad(r, k, v, w, u, dout, terms, qs, dr, dk, dv, dw, dup, s, h, kd,
             vd, nc, vec);
}

// Backward phase 4: du summed over (b, chunk) in index order, one thread
// per (h, k), rounded to u's type once.
template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_bwd_reduce(
    const float* __restrict__ dup, T* __restrict__ du, int batch, int h,
    int kd, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= h * kd) return;
  float acc = 0.0f;
  for (int bc = 0; bc < batch * nc; ++bc) acc += dup[(size_t)bc * h * kd + e];
  store1(du + e, acc);
}

// Floats of f32 scratch the backward takes, in this order: phase 3's terms
// [B, H, NC, 3, 64, 64] and q [B, H, NC, 64], the state's gradient per
// chunk [B, H, NC, K, V], the chunks' decay products [B, H, NC, K], the
// partials of du [B, NC, H, K].
size_t bwd_scratch_floats(int batch, int s, int h, int kd, int vd) {
  const size_t nc = (s + kC - 1) / kC;
  return (size_t)batch * h * nc *
         ((size_t)kTerms + kBK + (size_t)kd * vd + 2 * kd);
}

template <typename T>
cudaError_t configure_bwd() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_state_inc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bwd_inc_bytes<T>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_bwd_chunk_grad<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bwd_grad_bytes<T>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_bwd_chunk_grad<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

// Blocks per SM of the backward's four kernels, in launch order, at the
// shared memory each is launched with.
template <typename T>
cudaError_t bwd_occupancy(int* blocks) {
  cudaError_t e = configure_bwd<T>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], wkv_bwd_state_inc<T>, kThreads, smem_bwd_inc_bytes<T>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], wkv_bwd_state_scan, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[2], wkv_bwd_chunk_grad<T>, kThreads,
        smem_bwd_grad_bytes<T>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[3], wkv_bwd_reduce<T>, kThreads, 0);
  return e;
}

template <typename T>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* w, const void* u, const void* dout,
                       const float* states, const float* dstate_out,
                       void* dr, void* dk, void* dv, float* dw, void* du,
                       float* dstate, float* scratch, int batch, int s, int h,
                       int kd, int vd, cudaStream_t stream) {
  cudaError_t err = configure_bwd<T>();
  if (err != cudaSuccess) return err;
  const int nc = (s + kC - 1) / kC, nbh = batch * h;
  float* terms = scratch;
  float* qs = terms + (size_t)nbh * nc * kTerms;
  float* dds = qs + (size_t)nbh * nc * kBK;
  float* plast = dds + (size_t)nbh * nc * kd * vd;
  float* dup = plast + (size_t)nbh * nc * kd;
  const bool vec = kd % 8 == 0 && vd % 8 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(v) && aligned16(w) &&
                   aligned16(dout) && aligned16(states) && aligned16(scratch);
  const dim3 grid(nc, nbh);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  wkv_bwd_state_inc<T><<<grid, kThreads, smem_bwd_inc_bytes<T>(), stream>>>(
      rt, w, dot, dds, plast, s, h, kd, vd, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n2 = (size_t)nbh * kd * vd;
  wkv_bwd_state_scan<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(dstate_out, dds, plast, dstate, nbh, kd,
                                    vd, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  wkv_bwd_chunk_grad<T><<<grid, kThreads, smem_bwd_grad_bytes<T>(), stream>>>(
      rt, kt, vt, w, static_cast<const T*>(u), dot, states, dds, terms, qs,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw, dup,
      s, h, kd, vd, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  wkv_bwd_reduce<T><<<(h * kd + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(dup, static_cast<T*>(du), batch, h, kd, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rwkv6_wkv_max_k() { return kMaxK; }
int rwkv6_wkv_chunk() { return kC; }
int rwkv6_wkv_bwd_max_kv() { return kBK; }

size_t rwkv6_wkv_bwd_scratch(int batch, int s, int h, int kd, int vd) {
  return bwd_scratch_floats(batch, s, h, kd, vd);
}

// blocks[0..3]: how many blocks of each of the backward's four kernels
// (state increments, reverse scan, chunk gradients, reduction) one SM
// holds at once, for r's dtype code and key width kd.
int rwkv6_wkv_bwd_blocks_per_sm(int dtype, int kd, int* blocks) {
  if (kd < 1 || kd > kBK || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = dtype == 0 ? bwd_occupancy<float>(blocks)
                                     : bwd_occupancy<__nv_bfloat16>(blocks);
  return (int)err;
}

// The gradient of rwkv6_wkv_fwd: dr, dk, dv and du in r's type, dw and
// dstate in f32.  states: the forward's ds after the call (each chunk's
// starting state); dstate_out and dstate may be null (zeros; not
// written).  K, V <= 64.  scratch: rwkv6_wkv_bwd_scratch(...) floats of
// f32.
int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                  const void* w, const void* u, const void* dout,
                  const void* states, const void* dstate_out, void* dr,
                  void* dk, void* dv, void* dw, void* du, void* dstate,
                  void* scratch, int batch, int s, int h, int kd, int vd,
                  int dtype, void* stream) {
  if (kd < 1 || kd > kBK || vd < 1 || vd > kBK || h < 1 || batch < 1 ||
      s < 1 || batch * h > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(states);
  const float* dso = static_cast<const float*>(dstate_out);
  float* dwf = static_cast<float*>(dw);
  float* dsf = static_cast<float*>(dstate);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t err =
      dtype == 0
          ? launch_bwd<float>(r, k, v, wf, u, dout, sf, dso, dr, dk, dv, dwf,
                              du, dsf, sc, batch, s, h, kd, vd, st)
          : launch_bwd<__nv_bfloat16>(r, k, v, wf, u, dout, sf, dso, dr, dk,
                                      dv, dwf, du, dsf, sc, batch, s, h, kd,
                                      vd, st);
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, u and out alike).  ds
// [B, H, NC, K, V] and clast [B, H, NC, K]: f32 scratch, NC = ceil(S / 64).
int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                  const void* w, const void* u, const void* state0,
                  void* out, void* state_out, void* ds, void* clast,
                  int batch, int s, int h, int kd, int vd, int dtype,
                  void* stream) {
  if (kd < 1 || kd > kMaxK || vd < 1 || h < 1 || batch < 1 || s < 1 ||
      batch * h > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  float* dsf = static_cast<float*>(ds);
  float* cl = static_cast<float*>(clast);
  const cudaError_t err =
      dtype == 0
          ? launch_any<float>(r, k, v, wf, u, s0, out, so, dsf, cl, batch, s,
                              h, kd, vd, st)
          : launch_any<__nv_bfloat16>(r, k, v, wf, u, s0, out, so, dsf, cl,
                                      batch, s, h, kd, vd, st);
  return (int)err;
}

}  // extern "C"
