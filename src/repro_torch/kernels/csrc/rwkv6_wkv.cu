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
// body).  Per (b, h) and chunk, with la = ln max(w, 1e-30), c_t its
// in-chunk running sum (c_{-1} = 0, L the last step), S the state entering
// the chunk and G the gradient of the state leaving it:
//   G_{c-1} = e^{c_L} o G_c + sum_t (r_t o e^{c_{t-1}}) do_t^T
//   dr_t = e^{c_{t-1}} o (S do_t) + sum_{j<t} (do_t.v_j) k_j o E_tj
//          + (do_t.v_t) u o k_t
//   dk_j = sum_{t>j} (do_t.v_j) r_t o E_tj + (do_j.v_j) u o r_j
//          + e^{c_L-c_j} o (G v_j)
//   dv_j = sum_{t>j} A_tj do_t + beta_j do_j + G^T (k_j o e^{c_L-c_j})
//   du   = sum_{b,t} (do_t.v_t) r_t o k_t
//   dla_i = sum_{t>i} x_t + sum_{j<i<t} y_tj + q + sum_{j<i} z_j
// with E_tj = e^{c_{t-1}-c_j}, A_tj = sum_k r_t k_j E_tj, beta_j =
// sum_k r_j u k_j, x_t = r_t o e^{c_{t-1}} o (S do_t), y_tj = (do_t.v_j)
// r_t o k_j o E_tj, z_j = k_j o e^{c_L-c_j} o (G v_j) and q = e^{c_L} o
// rowsum(S o G); dw = dla / w where w >= 1e-30, else 0.  dla is summed term
// by term: as a reverse cumulative sum of the gradient of c, y_{t,t-1}
// (decay e^0) would enter it with both signs.
//
// Every exponent is summed from the log decays of its own steps, never
// the difference of two running sums (log w runs down to -69 a step).
// The chunk is cut into four 16-step sub-blocks.  Per (step, channel) the
// block holds e^{lcp_t} (lcp_t: the sum over the steps of t's sub-block
// before t) and e^{rs_j} (rs_j: the sum over the steps of j's sub-block
// after j), and per sub-block and channel e^{T_M} (its total).  Where t and
// j lie in sub-blocks I > J, E_tj = e^{lcp_t} D_IJ e^{rs_j} with D_IJ the
// product of e^{T_M} over the sub-blocks between; e^{c_{t-1}}, e^{c_L-c_j}
// and e^{c_L} are products of the same factors.  Inside one sub-block the
// exponent is summed step by step.  Every factor is <= 1, so a factor
// underflows only where the term is smaller still.  The middle term of dla
// splits by the sub-blocks of t and j against i's sub-block m:
//   (a) t after m, j before m:  sum D_IJ Q_IJ, Q_IJ = sum_{t in I, j in J}
//       (r_t e^{lcp_t}) (do_t.v_j) (k_j e^{rs_j})
//   (b) t after m, j in m, j < i:  sum_j k_j e^{rs_j} X_j, X_j the sum over
//       later sub-blocks that dk_j's off-diagonal part also takes
//   (c) t in m, t > i, j before m:  sum_t r_t e^{lcp_t} Y_t, likewise dr's
//   (d) t and j in m:  pivoted at i, e^{c_{t-1}-c_i} e^{c_i-c_j}.
//
// What bounds it on the H100: at rwkv6-3b's train shape (B 2, S 1024, H
// 40, K = V = 64) the gradient of the sequential recurrence needs about
// 11 f32 operations per (t, h, k, v) (as the SSD's), 3.7 GFLOP, ~55 us
// at 67 TFLOP/s, against ~50 MB read and written, ~15 us: the f32 rate.
// Design: four launches, no block walking more than one chunk, no
// atomics.
//   1. wkv_bwd_state_inc, grid (NC, B H): each chunk's
//      sum_t (r_t o e^{c_{t-1}}) do_t^T and its total log decay c_L.
//   2. wkv_bwd_state_scan, one thread per (b, h, k, v): the state's
//      gradient from the last chunk to the first, written over the
//      increments (dstate at the end).
//   3. wkv_bwd_chunk_grad, grid (NC, B H): one block holds a chunk's r,
//      k, v, do, la, S and G (K, V <= 64, 190 KiB of shared memory) and
//      writes dr, dk, dv, dw and its (b, chunk) partial of du.  Every
//      product is f32 on the CUDA cores in 4 x 4 register tiles (the
//      port allows no TF32).
//   4. wkv_bwd_reduce sums the partials of du in index order, so the same
//      inputs give the same bits.
// Steps past the end of S carry w = 1 and zero operands, and their
// gradients are not written.  A simple kernel: one block of 256 threads
// per SM, its phases serial behind block barriers, and the diagonal
// sub-blocks' exponentials per (t, j, k).  What holds it back (rwkv6-3b's
// train shape, bf16, on an H100; wkv_ablation.py --part bwd): the chunk
// gradients are about 93% of the call; of them the loads, running sums,
// barriers and stores alone about half, A's diagonal sub-blocks (an
// exponential and a step-by-step sum per (t, j, k)) a quarter, the
// pivoted dla term an eighth.

constexpr int kBK = 64;          // widest K and V the backward takes
constexpr int kLdB = kBK + 4;    // row stride of the [.][k] and [.][v] tiles
constexpr int kLdP = kC + 1;     // row stride of the [t][j] tiles
constexpr int kNSub = kC / kL;   // sub-blocks per chunk
constexpr int kTileB = kC * kLdB;

// product of e^{T_M} over sub-blocks m0 <= M < m1 for channel c
__device__ __forceinline__ float sub_prod(const float* s_et, int m0, int m1,
                                          int c) {
  float x = 1.0f;
  for (int m = m0; m < m1; ++m) x *= s_et[m * kBK + c];
  return x;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          size_t rstride, int nrows,
                                          int width) {
  for (int e = threadIdx.x; e < kC * kBK; e += kThreads) {
    const int t = e / kBK, c = e - t * kBK;
    dst[t * kLdB + c] =
        (t < nrows && c < width) ? to_f32(src[t * rstride + c]) : 0.0f;
  }
}

// the log decays of a chunk, ln max(w, 1e-30); 0 past the ends (w = 1)
__device__ __forceinline__ void load_log_decay(float* dst,
                                               const float* __restrict__ src,
                                               size_t rstride, int nrows,
                                               int width) {
  for (int e = threadIdx.x; e < kC * kBK; e += kThreads) {
    const int t = e / kBK, c = e - t * kBK;
    dst[t * kLdB + c] = (t < nrows && c < width)
                            ? logf(fmaxf(src[t * rstride + c], 1e-30f))
                            : 0.0f;
  }
}

size_t smem_bwd_inc_bytes() { return sizeof(float) * 3 * kTileB; }

// Backward phase 1: inc = sum_t (r_t o e^{c_{t-1}}) do_t^T for one chunk
// and one (b, h), and clast = c_L (natural log).
template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_inc(
    const T* __restrict__ r, const float* __restrict__ w,
    const T* __restrict__ dout, float* __restrict__ inc,
    float* __restrict__ clast, int s, int h, int kd, int vd, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem;                 // r, then r o e^{c_{t-1}}
  float* s_do = s_r + kTileB;
  float* s_la = s_do + kTileB;
  const int tid = threadIdx.x, chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  load_rows(s_r, r + (row0 * h + head) * kd, rk, nrows, kd);
  load_rows(s_do, dout + (row0 * h + head) * vd, rv, nrows, vd);
  load_log_decay(s_la, w + (row0 * h + head) * kd, rk, nrows, kd);
  __syncthreads();
  const size_t cidx = (size_t)bh * nc + chunk;
  if (tid < kBK) {
    float run = 0.0f;                  // c_{t-1}, summed step by step
    for (int t = 0; t < kC; ++t) {
      s_r[t * kLdB + tid] *= expf(run);
      run += s_la[t * kLdB + tid];
    }
    if (tid < kd) clast[cidx * kd + tid] = run;
  }
  __syncthreads();
  const int tr = 4 * (tid >> 4), tx = tid & 15;
  float acc[4][4] = {};
  for (int t = 0; t < kC; ++t) {
    float dv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) dv[jj] = s_do[t * kLdB + tx + 16 * jj];
    outer(acc, ld4(s_r + t * kLdB + tr), make_float4(dv[0], dv[1], dv[2],
                                                     dv[3]));
  }
  float* out = inc + cidx * kd * vd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tr + i, v = tx + 16 * jj;
      if (c < kd && v < vd) out[(size_t)c * vd + v] = acc[i][jj];
    }
}

// Backward phase 2: per (b, h, k, v), from the last chunk to the first:
// the gradient of the state leaving chunk c is written over its
// increment, then G_{c-1} = e^{clast_c} G_c + inc_c; dstate = G_{-1}
// (where wanted).
__global__ void __launch_bounds__(kThreads) wkv_bwd_state_scan(
    const float* __restrict__ dstate_out, float* __restrict__ ds,
    const float* __restrict__ clast, float* __restrict__ dstate, int nbh,
    int kd, int vd, int nc) {
  const size_t kv = (size_t)kd * vd;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)nbh * kv) return;
  const size_t bh = e / kv, rem = e - bh * kv;
  const int kk = (int)(rem / vd);
  float g = dstate_out != nullptr ? dstate_out[e] : 0.0f;
  float* d = ds + bh * nc * kv + rem;
  const float* cl = clast + bh * nc * kd + kk;
  constexpr int kAhead = 8;          // chunks whose loads are in flight
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float inc[kAhead], dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        inc[i] = d[(size_t)(c0 - i) * kv];
        dec[i] = cl[(size_t)(c0 - i) * kd];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 - i >= 0) {
        d[(size_t)(c0 - i) * kv] = g;
        g = fmaf(expf(dec[i]), g, inc[i]);
      }
  }
  if (dstate != nullptr) dstate[e] = g;
}

size_t smem_bwd_grad_bytes() {
  // nine [64][68] tiles, two [64][65]; e^{T}, D, Q, u, q and the (a)
  // terms per channel
  return sizeof(float) * (9 * kTileB + 2 * kC * kLdP + kNSub * kBK +
                          kPairs * kBK + 3 * kBK + 4 * kBK);
}

// Backward phase 3: dr, dk, dv, dw and the (b, chunk) partial of du for
// one chunk and one (b, h).
template <typename T>
__global__ void __launch_bounds__(kThreads) wkv_bwd_chunk_grad(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const T* __restrict__ u, const T* __restrict__ dout,
    const float* __restrict__ states, const float* __restrict__ dstates,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ dup, int s, int h, int kd,
    int vd, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem;                   // [kC][kLdB] r
  float* s_k = s_r + kTileB;           // [kC][kLdB] k
  float* s_v = s_k + kTileB;           // [kC][kLdB] v, then z
  float* s_do = s_v + kTileB;          // [kC][kLdB] do
  float* s_la = s_do + kTileB;         // [kC][kLdB] la
  float* s_elcp = s_la + kTileB;       // [kC][kLdB] e^{lcp_t}
  float* s_ers = s_elcp + kTileB;      // [kC][kLdB] e^{rs_j}
  float* s_s = s_ers + kTileB;         // [kBK][kLdB] S, then x
  float* s_g = s_s + kTileB;           // [kBK][kLdB] G, then pc
  float* s_dov = s_g + kTileB;         // [kC][kLdP] do_t . v_j
  float* s_a = s_dov + kC * kLdP;      // [kC][kLdP] A (beta on the
                                       // diagonal, 0 above), then pb
  float* s_et = s_a + kC * kLdP;       // [kNSub][kBK] e^{T_M}
  float* s_d = s_et + kNSub * kBK;     // [kPairs][kBK] D_IJ
  float* s_q = s_d + kPairs * kBK;     // [3][kBK] Q_20, Q_30, Q_31
  float* s_u = s_q + 3 * kBK;          // [kBK] u
  float* s_sg = s_u + kBK;             // [kBK] q = e^{c_L} rowsum(S o G)
  float* s_pa = s_sg + kBK;            // [kBK] the (a) term of sub-blocks
                                       // 1 and 2 (0 and 3 have none): 32 each
  const int tid = threadIdx.x, tr = 4 * (tid >> 4), tx = tid & 15;
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const size_t rk = (size_t)h * kd, rv = (size_t)h * vd;
  const size_t cidx = (size_t)bh * nc + chunk;
  const size_t kv = (size_t)kd * vd;

  load_rows(s_r, r + (row0 * h + head) * kd, rk, nrows, kd);
  load_rows(s_k, k + (row0 * h + head) * kd, rk, nrows, kd);
  load_rows(s_v, v + (row0 * h + head) * vd, rv, nrows, vd);
  load_rows(s_do, dout + (row0 * h + head) * vd, rv, nrows, vd);
  load_log_decay(s_la, w + (row0 * h + head) * kd, rk, nrows, kd);
  load_rows(s_s, states + cidx * kv, (size_t)vd, kd, vd);
  load_rows(s_g, dstates + cidx * kv, (size_t)vd, kd, vd);
  for (int e = tid; e < kC * kLdP; e += kThreads) s_a[e] = 0.0f;
  if (tid < kBK) s_u[tid] = tid < kd ? to_f32(u[(size_t)head * kd + tid])
                                     : 0.0f;
  __syncthreads();

  // e^{lcp}, e^{rs} and e^{T}: one thread per (sub-block, channel), each
  // sum step by step
  {
    const int m = tid / kBK, c = tid - m * kBK;
    float pre = 0.0f, suf = 0.0f;
    for (int n = kL * m; n < kL * m + kL; ++n) {
      s_elcp[n * kLdB + c] = expf(pre);
      pre += s_la[n * kLdB + c];
    }
    for (int n = kL * m + kL - 1; n >= kL * m; --n) {
      s_ers[n * kLdB + c] = expf(suf);
      suf += s_la[n * kLdB + c];
    }
    s_et[m * kBK + c] = expf(pre);
  }
  __syncthreads();
  for (int e = tid; e < kPairs * kBK; e += kThreads) {
    const int p = e / kBK, c = e - p * kBK;
    int bi, bj;
    block_pair(p, bi, bj);
    s_d[e] = sub_prod(s_et, bj + 1, bi, c);
  }
  if (tid < kBK) {
    float x = 0.0f;
    for (int vv = 0; vv < kBK; ++vv)
      x = fmaf(s_s[tid * kLdB + vv], s_g[tid * kLdB + vv], x);
    s_sg[tid] = sub_prod(s_et, 0, kNSub, tid) * x;
  }
  // do_t . v_j, all (t, j)
  {
    float acc[4][4] = {};
    for (int c = 0; c < kBK; c += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_do + (tr + i) * kLdB + c);
        bb[i] = ld4(s_v + (tx + 16 * i) * kLdB + c);
      }
      rows_by_rows(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        s_dov[(tr + i) * kLdP + tx + 16 * jj] = acc[i][jj];
  }
  __syncthreads();

  // A: the six off-diagonal sub-block pairs, E = e^{lcp_t} D_IJ e^{rs_j};
  // then the diagonal sub-blocks' strictly lower pairs, their exponent
  // summed step by step, and beta on the diagonal
  for (int e = tid; e < kPairs * kL * kL; e += kThreads) {
    const int p = e / (kL * kL), q = e - p * kL * kL;
    int bi, bj;
    block_pair(p, bi, bj);
    const int t = kL * bi + q / kL, j = kL * bj + q % kL;
    const float* dp = s_d + p * kBK;
    float acc = 0.0f;
    for (int c = 0; c < kBK; c += 4) {
      const float4 a =
          mul4(ld4(s_r + t * kLdB + c), ld4(s_elcp + t * kLdB + c));
      const float4 bb =
          mul4(ld4(s_k + j * kLdB + c), ld4(s_ers + j * kLdB + c));
      const float4 d = ld4(dp + c);
      acc = fmaf(a.x * d.x, bb.x, acc);
      acc = fmaf(a.y * d.y, bb.y, acc);
      acc = fmaf(a.z * d.z, bb.z, acc);
      acc = fmaf(a.w * d.w, bb.w, acc);
    }
    s_a[t * kLdP + j] = acc;
  }
  for (int e = tid; e < kDiagExp + kC; e += kThreads) {
    float acc = 0.0f;
    if (e < kDiagExp) {
      int tp, jp;
      tri_pair(e % kTri, tp, jp);
      const int t = (e / kTri) * kL + tp, j = (e / kTri) * kL + jp;
      for (int c = 0; c < kBK; ++c) {
        float x = 0.0f;
        for (int n = j + 1; n < t; ++n) x += s_la[n * kLdB + c];
        acc = fmaf(s_r[t * kLdB + c] * s_k[j * kLdB + c], expf(x), acc);
      }
      s_a[t * kLdP + j] = acc;
    } else {
      const int t = e - kDiagExp;
      for (int c = 0; c < kBK; ++c)
        acc = fmaf(s_r[t * kLdB + c] * s_u[c], s_k[t * kLdB + c], acc);
      s_a[t * kLdP + t] = acc;
    }
  }
  // Q_IJ for the pairs two or more sub-blocks apart, one thread per
  // (pair, channel)
  if (tid < 3 * kBK) {
    const int p = tid / kBK, c = tid - p * kBK;
    const int bi = p == 0 ? 2 : 3, bj = p == 2 ? 1 : 0;
    float acc = 0.0f;
    for (int t = kL * bi; t < kL * bi + kL; ++t) {
      float inner = 0.0f;
      for (int j = kL * bj; j < kL * bj + kL; ++j)
        inner = fmaf(s_dov[t * kLdP + j],
                     s_k[j * kLdB + c] * s_ers[j * kLdB + c], inner);
      acc = fmaf(s_r[t * kLdB + c] * s_elcp[t * kLdB + c], inner, acc);
    }
    s_q[p * kBK + c] = acc;
  }
  __syncthreads();

  // dv rows j, columns v: sum_{t>=j} A_tj do_t + G^T (k_j o e^{c_L-c_j})
  {
    const int sj = tr / kL;
    float acc[4][4] = {};
    for (int t = tr; t < kC; ++t) {
      const float* ar = s_a + t * kLdP + tr;
      float dv4[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dv4[jj] = s_do[t * kLdB + tx + 16 * jj];
      outer(acc, make_float4(ar[0], ar[1], ar[2], ar[3]),
            make_float4(dv4[0], dv4[1], dv4[2], dv4[3]));
    }
    for (int c = 0; c < kBK; ++c) {
      const float after = sub_prod(s_et, sj + 1, kNSub, c);
      float kd4[4], g4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kd4[i] = s_k[(tr + i) * kLdB + c] *
                 (s_ers[(tr + i) * kLdB + c] * after);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) g4[jj] = s_g[c * kLdB + tx + 16 * jj];
      outer(acc, make_float4(kd4[0], kd4[1], kd4[2], kd4[3]),
            make_float4(g4[0], g4[1], g4[2], g4[3]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tr + i >= nrows) break;
      T* row = dv + ((row0 + tr + i) * h + head) * vd;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (tx + 16 * jj < vd) store1(row + tx + 16 * jj, acc[i][jj]);
    }
  }

  // dk rows j, channels c; X (the sum over later sub-blocks), z and
  // pb = k_j e^{rs_j} X_j kept for dla
  float zr[4][4], pb[4][4];
  {
    const int sj = tr / kL;
    float xo[4][4] = {}, dg[4][4] = {}, gv[4][4] = {};
    for (int bi = sj + 1; bi < kNSub; ++bi) {
      const float* dp = s_d + (bi * (bi - 1) / 2 + sj) * kBK;
      float part[4][4] = {};
      for (int t = kL * bi; t < kL * bi + kL; ++t) {
        const float* dr_ = s_dov + t * kLdP + tr;
        float rp[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          rp[jj] = s_r[t * kLdB + c] * s_elcp[t * kLdB + c];
        }
        outer(part, make_float4(dr_[0], dr_[1], dr_[2], dr_[3]),
              make_float4(rp[0], rp[1], rp[2], rp[3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          xo[i][jj] = fmaf(dp[tx + 16 * jj], part[i][jj], xo[i][jj]);
    }
    // inside j's sub-block: t > j, exponent summed from step j + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tr + i, c = tx + 16 * jj;
        float x = 0.0f, acc = 0.0f;
        for (int t = j + 1; t < kL * sj + kL; ++t) {
          acc = fmaf(s_dov[t * kLdP + j] * s_r[t * kLdB + c], expf(x), acc);
          x += s_la[t * kLdB + c];
        }
        dg[i][jj] = acc;
      }
    for (int vv = 0; vv < kBK; vv += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_v + (tr + i) * kLdB + vv);
        bb[i] = ld4(s_g + (tx + 16 * i) * kLdB + vv);
      }
      rows_by_rows(gv, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tr + i;
      T* row = dk + ((row0 + j) * h + head) * kd;
      const float bonus = s_dov[j * kLdP + j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float ers = s_ers[j * kLdB + c];
        const float edec = ers * sub_prod(s_et, sj + 1, kNSub, c);
        const float val = ((ers * xo[i][jj] + dg[i][jj]) +
                           bonus * s_u[c] * s_r[j * kLdB + c]) +
                          edec * gv[i][jj];
        zr[i][jj] = s_k[j * kLdB + c] * edec * gv[i][jj];
        pb[i][jj] = s_k[j * kLdB + c] * ers * xo[i][jj];
        if (j < nrows && c < kd) store1(row + c, val);
      }
    }
  }

  // dr rows t, channels c; Y (the sum over earlier sub-blocks), x and
  // pc = r_t e^{lcp_t} Y_t kept for dla
  float xr[4][4], pc[4][4];
  {
    const int st = tr / kL;
    float yo[4][4] = {}, dg[4][4] = {}, sdo[4][4] = {};
    for (int bj = 0; bj < st; ++bj) {
      const float* dp = s_d + (st * (st - 1) / 2 + bj) * kBK;
      float part[4][4] = {};
      for (int j = kL * bj; j < kL * bj + kL; ++j) {
        float kp[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          kp[jj] = s_k[j * kLdB + c] * s_ers[j * kLdB + c];
        }
        outer(part,
              make_float4(s_dov[tr * kLdP + j], s_dov[(tr + 1) * kLdP + j],
                          s_dov[(tr + 2) * kLdP + j],
                          s_dov[(tr + 3) * kLdP + j]),
              make_float4(kp[0], kp[1], kp[2], kp[3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          yo[i][jj] = fmaf(dp[tx + 16 * jj], part[i][jj], yo[i][jj]);
    }
    // inside t's sub-block: j < t, exponent summed down from step t - 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = tr + i, c = tx + 16 * jj;
        float x = 0.0f, acc = 0.0f;
        for (int j = t - 1; j >= kL * st; --j) {
          acc = fmaf(s_dov[t * kLdP + j] * s_k[j * kLdB + c], expf(x), acc);
          x += s_la[j * kLdB + c];
        }
        dg[i][jj] = acc;
      }
    for (int vv = 0; vv < kBK; vv += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ld4(s_do + (tr + i) * kLdB + vv);
        bb[i] = ld4(s_s + (tx + 16 * i) * kLdB + vv);
      }
      rows_by_rows(sdo, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + i;
      T* row = dr + ((row0 + t) * h + head) * kd;
      const float bonus = s_dov[t * kLdP + t];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float elcp = s_elcp[t * kLdB + c];
        const float ecp = elcp * sub_prod(s_et, 0, st, c);
        const float val = ((ecp * sdo[i][jj] + elcp * yo[i][jj]) +
                           dg[i][jj]) +
                          bonus * s_u[c] * s_k[t * kLdB + c];
        xr[i][jj] = s_r[t * kLdB + c] * ecp * sdo[i][jj];
        pc[i][jj] = s_r[t * kLdB + c] * elcp * yo[i][jj];
        if (t < nrows && c < kd) store1(row + c, val);
      }
    }
  }
  // the (a) terms and the partial of du
  if (tid < 2 * kBK) {
    const int m = 1 + tid / kBK, c = tid % kBK;
    // m = 1: D_20 Q_20 + D_30 Q_30; m = 2: D_30 Q_30 + D_31 Q_31
    // (D_20, D_30, D_31 are pairs 1, 3 and 4 in block_pair's order)
    s_pa[tid] = m == 1 ? fmaf(s_d[1 * kBK + c], s_q[c],
                              s_d[3 * kBK + c] * s_q[kBK + c])
                       : fmaf(s_d[3 * kBK + c], s_q[kBK + c],
                              s_d[4 * kBK + c] * s_q[2 * kBK + c]);
  } else if (tid < 3 * kBK) {
    const int c = tid - 2 * kBK;
    float acc = 0.0f;
    for (int t = 0; t < kC; ++t)
      acc = fmaf(s_dov[t * kLdP + t], s_r[t * kLdB + c] * s_k[t * kLdB + c],
                 acc);
    if (c < kd) dup[(((size_t)b * nc + chunk) * h + head) * kd + c] = acc;
  }
  __syncthreads();                     // A, v, S and G are read
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = tr + i, c = tx + 16 * jj;
      s_v[row * kLdB + c] = zr[i][jj];
      s_a[row * kLdP + c] = pb[i][jj];
      s_s[row * kLdB + c] = xr[i][jj];
      s_g[row * kLdB + c] = pc[i][jj];
    }
  __syncthreads();

  // dla for the 16 steps of sub-block m and channel c, then dw
  {
    const int m = tid / kBK, c = tid - m * kBK;
    const int i0 = kL * m;
    float zpre = 0.0f, xsuf = 0.0f;
    for (int j = 0; j < i0; ++j) zpre += s_v[j * kLdB + c];
    for (int t = kC - 1; t >= i0 + kL; --t) xsuf += s_s[t * kLdB + c];
    float xs[kL], pcs[kL];             // sums over t > i, i in the block
    xs[kL - 1] = xsuf;
    pcs[kL - 1] = 0.0f;
#pragma unroll
    for (int p = kL - 1; p > 0; --p) {
      xs[p - 1] = xs[p] + s_s[(i0 + p) * kLdB + c];
      pcs[p - 1] = pcs[p] + s_g[(i0 + p) * kLdB + c];
    }
    const float pa = (m == 1 || m == 2) ? s_pa[(m - 1) * kBK + c] : 0.0f;
    float zrun = zpre, pbrun = 0.0f;
    float* dwb = dw + (row0 * h + head) * kd + c;
    const float* wb = w + (row0 * h + head) * kd + c;
#pragma unroll 1
    for (int p = 0; p < kL; ++p) {
      const int i = i0 + p;
      // (d): t and j in the sub-block, j < i < t, pivoted at i
      float alpha[kL];
      float ej = 0.0f;
      for (int j = i - 1; j >= i0; --j) {
        ej += s_la[(j + 1) * kLdB + c];
        alpha[j - i0] = s_k[j * kLdB + c] * expf(ej);
      }
      float dd = 0.0f, et = 0.0f;
      for (int t = i + 1; t < i0 + kL; ++t) {
        float inner = 0.0f;
        for (int j = i0; j < i; ++j)
          inner = fmaf(s_dov[t * kLdP + j], alpha[j - i0], inner);
        dd = fmaf(s_r[t * kLdB + c] * expf(et), inner, dd);
        et += s_la[t * kLdB + c];
      }
      const float dla = (((((xs[p] + zrun) + s_sg[c]) + pa) + pbrun) +
                         pcs[p]) + dd;
      zrun += s_v[i * kLdB + c];
      pbrun += s_a[i * kLdP + c];
      if (i < nrows && c < kd) {
        const float wv = wb[(size_t)i * h * kd];
        dwb[(size_t)i * h * kd] = wv >= 1e-30f ? dla / wv : 0.0f;
      }
    }
  }
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

// Floats of f32 scratch the backward takes, in this order: the state's
// gradient per chunk [B, H, NC, K, V], clast [B, H, NC, K], the partials
// of du [B, NC, H, K].
size_t bwd_scratch_floats(int batch, int s, int h, int kd, int vd) {
  const size_t nc = (s + kC - 1) / kC;
  return (size_t)batch * h * nc * ((size_t)kd * vd + 2 * kd);
}

template <typename T>
cudaError_t configure_bwd() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_state_inc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bwd_inc_bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv_bwd_chunk_grad<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bwd_grad_bytes());
    return e;
  }();
  return err;
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
  float* dds = scratch;
  float* clast = dds + (size_t)nbh * nc * kd * vd;
  float* dup = clast + (size_t)nbh * nc * kd;
  const dim3 grid(nc, nbh);
  const T* rt = static_cast<const T*>(r);
  const T* dot = static_cast<const T*>(dout);

  wkv_bwd_state_inc<T><<<grid, kThreads, smem_bwd_inc_bytes(), stream>>>(
      rt, w, dot, dds, clast, s, h, kd, vd, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n2 = (size_t)nbh * kd * vd;
  wkv_bwd_state_scan<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(dstate_out, dds, clast, dstate, nbh, kd,
                                    vd, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  wkv_bwd_chunk_grad<T><<<grid, kThreads, smem_bwd_grad_bytes(), stream>>>(
      rt, static_cast<const T*>(k), static_cast<const T*>(v), w,
      static_cast<const T*>(u), dot, states, dds, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dw, dup, s, h, kd, vd, nc);
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
