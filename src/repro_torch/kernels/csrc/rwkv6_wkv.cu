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

}  // namespace

extern "C" {

int rwkv6_wkv_max_k() { return kMaxK; }
int rwkv6_wkv_chunk() { return kC; }

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
