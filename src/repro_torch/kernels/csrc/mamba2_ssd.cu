// Mamba2 state-space-dual (SSD) scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mamba2_ssd.py (_ssd_kernel /
// mamba2_ssd) together with the D-skip term its wrapper adds.  Per (batch,
// head h), with S the [P, N] state carried from chunk to chunk and cum_t
// the running sum of dt A_h inside a 64-step chunk:
//   y_t = exp(cum_t) C_t . S
//       + sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j + D_h x_t
//   S'  = exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// A_h < 0 and dt >= 0, so every exponent taken is <= 0: the decay is taken
// only where j <= t (above the diagonal the exponent is positive, and the
// reference's exp(...) * tril gives inf * 0 = NaN at long chunks).  The
// D-skip is summed with the rest in f32 and y is rounded to x's type once.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/mamba2_ssd.py).  The entry makes three
// launches on the stream it is given, checks each with cudaGetLastError()
// and returns the first error; it allocates nothing.
//
// Layout: x [B, S, H, P] (f32 or bf16), dt [B, S, H] f32, a [H] f32,
// b, c [B, S, N] in x's type (shared by every head: read by batch index,
// never expanded per head), d [H] f32 or in x's type, state0 [B, H, P, N]
// f32 or null (zeros); y [B, S, H, P] in x's type, state_out [B, H, P, N]
// f32.  Scratch from the caller: ds [B, H, NC, P, N] f32 and clast
// [B, H, NC] f32, NC = ceil(S / 64).
//
// What bounds it on the H100.  At zamba2's prefill (S = 1024, H = 80,
// P = N = 64, bf16) the function reads and writes ~24 MB, ~7 us at 3.35
// TB/s, and needs 1.68 GFLOP of f32 work (the recurrence: five operations
// per (t, h, p, n)), ~25 us on the CUDA cores, so the bound is the f32
// rate.  The chunked form below does about that much f32 work (chunk
// states 2, readout 2, intra-chunk product about 1 flop per (t, h, p, n))
// and moves each chunk's [P, N] state through device memory: 21 MB each
// way at S = 1024, most of it in the 50 MB L2.
//
// Design: the chunked form of the Pallas kernel, with the state hand-off
// that the TPU made through its sequential grid and an aliased output
// made through device memory.  No block walks more than one chunk.
//   1. ssd_chunk_state, grid (NC, B H, P / 64): a chunk's increment
//      dS = sum_j (exp(cum_last - cum_j) dt_j x_j) B_j^T, an outer-product
//      sum over the 64 steps, and its cum_last.
//   2. ssd_state_scan, one thread per (b, h, p, n): walks the chunks,
//      S_{c+1} = exp(cum_last,c) S_c + dS_c, writing S_c over dS_c in
//      place, and writes state_out = S_NC.  The decay is one scalar per
//      (b, h, chunk).
//   3. ssd_chunk_output, grid (NC, B H, P / 64): one block holds a chunk's
//      whole [64, 64] output.  It builds the masked tile
//      G[t, j] = (C_t . B_j) exp(cum_t - cum_j) dt_j (j <= t, else 0), then
//      y = exp(cum_t) C S_c^T + G x + D x in 4 x 4 register tiles.  On the
//      bf16 route C B^T runs on the tensor cores (mma.sync m16n8k16, bf16
//      operands from ldmatrix, f32 sums): products of two bf16 values are
//      exact in f32, so this rounds nothing new, and the tile that every
//      head shares costs a few hundred instructions per block.  The f32
//      route takes it on the CUDA cores (the port allows no TF32).  The
//      readout C S^T and G x are f32 on the CUDA cores: their right
//      operands (the f32 state, and G with dt and the decay folded in)
//      would round on the tensor cores.
// Loads: every tile of a chunk is in flight at once (16-byte cp.async;
// bf16 x and phase 1's bf16 B go through registers and are stored as f32),
// and the chunk state, needed last, arrives while G is built.  N = 64
// (zamba2) is fixed at compile time; other N up to 128 take general
// instances.  Steps past the end of S carry dt = 0 and x = B = C = 0, and
// their output is not written.
//
// What still holds it back (zamba2 bf16, S = 1024, on an H100): the
// output kernel takes about 58% of the call, the chunk states 28% and the
// scan 13%.  The first two are f32 FMA chains on the CUDA cores (C S^T,
// G x and the chunk states' sum: 2.5 x 64^3 FMA per chunk and head) plus
// their shared-memory loads; a bf16 hi/lo split of their f32 operands on
// the tensor cores would take them over.  At S = 16,384 the chunk states'
// round trip through device memory (336 MB each way) makes the scan a
// third of the call.
//
// The backward (mamba2_ssd_bwd) replaces no Pallas kernel: the reference
// differentiates its chunked SSD with XLA (repro/kernels/ref.py:310,
// mamba2_ssd_chunked), which is NaN at zamba2's 256-step chunk.  Its
// formulas are written beside its kernels below.  What bounds it on the
// H100: at zamba2's train shape (B 2, S 1024, H 80, P = N = 64) the
// gradient of the sequential recurrence needs 11 f32 operations per
// (t, h, p, n), 7.4 GFLOP, ~110 us at 67 TFLOP/s, against ~65 MB read
// and written, ~20 us: the f32 rate bounds it, as it does the forward.
// Design: four launches, no block walking more than one chunk, no
// atomics.
//   1. ssd_bwd_state_inc, phase 1's body with other weights: each
//      chunk's sum_t e^{cum_t} dy_t C_t^T.
//   2. ssd_bwd_state_scan, one thread per (b, h, p, n): the state's
//      gradient from the last chunk to the first, written over the
//      increments (dstate at the end), the loads of 8 chunks in flight.
//   3. ssd_bwd_chunk_grad, one block per (chunk, b, h), all of P in
//      64-column tiles (so ddt needs no reduction across blocks): reads
//      the chunk's state S_c, which the forward's phase 2 left in its
//      scratch and the autograd Function saved, instead of recomputing
//      it.  Eight 64 x 64 x 64 products per block (dy.x, S^T dy, G^T x,
//      C B^T, B G^T, and three triangular ones at half the work: the sums
//      for dC and dB, M^T dy).  The bf16 route runs them on the tensor
//      cores (mma.sync m16n8k16, f32 sums): dy.x and C B^T take bf16 on
//      both sides, exact products; the other six have one f32 operand
//      (S, G, M, Dm), which is split into two bf16 pieces (hi, and the
//      rounding of what hi leaves: the value to about 2^-16 of itself),
//      each piece multiplied into the same f32 sums.  The decays, W, its
//      prefix sums, r, v, q and the block sums stay f32 on the CUDA
//      cores.  Tiles come in by 16-byte cp.async (C and B while the first
//      products run), bf16 tiles stay bf16, and the N = 64 instance fits
//      two blocks per SM (110 KiB of shared memory, 128 registers).  The
//      f32 route (the card-vs-CPU checks) takes the same loads and keeps
//      its products f32 on the CUDA cores (the port allows no TF32).  dB
//      and dC are shared by the heads, da and dD by the batch and the
//      chunks: each block writes f32 partials.
//   4. ssd_bwd_reduce sums them in index order, so the same inputs give
//      the same bits.
// Every exponent taken is <= 0 (e^{cum_t - cum_j} with j <= t, and
// e^{cum_L - cum_j}), and each in-chunk one is summed from the log decays
// of its own steps (chunk_segments, seg_exp): as the difference of two
// running sums near -500 (a = -8), its rounding put da 1.6e-4 max|g| from
// the sequential scan's gradient.  Steps past the end of S carry dt = 0
// and zero operands, and their gradients are not written.  What still
// holds it back (zamba2 bf16 train shape, on an H100): step 3 takes about
// 69% of the call, step 1 13%, step 4 10%, the scan 8%; within a diagonal
// sub-block each exponent is a loop of up to 15 adds, taken twice (for Dm
// and for M).  Step 3's phases are serial behind block barriers (the
// 64-thread prefix sums and dla loops among them), and where P spans more
// than one tile, x, dy and G are
// read a second time for phase C.  The scan reads and writes the chunk
// gradients (42 MB each way), and step 3 writes the per-head partials of
// dB and dC that step 4 reads (84 MB).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;           // chunk length (steps)
constexpr int kPB = 64;          // P columns per block
constexpr int kThreads = 256;
constexpr int kMaxState = 128;   // widest N taken (zamba2: 64)
constexpr int kLdG = kC + 4;     // row stride of G^T [j][t]
constexpr int kLdX = kPB + 4;    // row stride of the f32 x tiles
// 16-byte loads of a bf16 [kC][kMaxState] tile per thread, at most
constexpr int kMaxGroups = kC * kMaxState / 8 / kThreads;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
// the two bf16 halves of a 32-bit word, first element in the low half
__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 4 consecutive elements of a shared tile as f32 (16- or 8-byte aligned)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// acc[i][j] += a[i] b[j]: one step of an outer-product (register-tile) sum
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a,
                                      const float (&b)[4]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory, in flight until a
// cp_async_wait covers its group; an invalid one writes zeros and reads
// nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
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

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i receives its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// The tiles of one chunk.  dst[t][c] (row stride ld) = src[t * rstride +
// col0 + c] for t < nrows and col0 + c < width, 0 elsewhere, c < ncols.
// In the vector route ncols, width and col0 are multiples of 8 and src is
// 16-byte aligned: 16-byte cp.async copies, same type in and out.
template <typename T>
__device__ __forceinline__ void async_tile(T* dst, int ld, const T* src,
                                           size_t rstride, int nrows,
                                           int col0, int ncols, int width) {
  constexpr int kPer = 16 / sizeof(T);
  const int ng = ncols / kPer;
  for (int e = threadIdx.x; e < kC * ng; e += kThreads) {
    const int t = e / ng, c = kPer * (e - t * ng);
    const bool ok = t < nrows && col0 + c < width;
    cp_async16(dst + t * ld + c, ok ? src + t * rstride + col0 + c : src, ok);
  }
}

// element by element, any alignment and width; Tout is T or float
template <typename T, typename Tout>
__device__ __forceinline__ void scalar_tile(Tout* dst, int ld,
                                            const T* __restrict__ src,
                                            size_t rstride, int nrows,
                                            int col0, int ncols, int width) {
  for (int e = threadIdx.x; e < kC * ncols; e += kThreads) {
    const int t = e / ncols, c = e - t * ncols;
    const float v = (t < nrows && col0 + c < width)
                        ? to_f32(src[t * rstride + col0 + c])
                        : 0.0f;
    dst[t * ld + c] = Tout(v);   // exact: v came from a Tout or is 0
  }
}

// bf16 tile through registers: every 16-byte load issued before the first
// is stored (fetch), then stored as f32, each row t times scale[t] (put)
__device__ __forceinline__ void fetch_bf16(uint4 (&v)[kMaxGroups],
                                           const bf16* src, size_t rstride,
                                           int nrows, int col0, int ncols,
                                           int width) {
  const int ng = ncols / 8;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int t = e / ng, c = 8 * (e - t * ng);
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kC * ng && t < nrows && col0 + c < width)
      v[i] = *reinterpret_cast<const uint4*>(src + t * rstride + col0 + c);
  }
}

__device__ __forceinline__ void put_bf16(float* dst, int ld,
                                         const uint4 (&v)[kMaxGroups],
                                         int ncols, const float* scale) {
  const int ng = ncols / 8;
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= kC * ng) break;
    const int t = e / ng, c = 8 * (e - t * ng);
    const float w = scale != nullptr ? scale[t] : 1.0f;
    float* q = dst + t * ld + c;
    *reinterpret_cast<float4*>(q) =
        make_float4(w * bf16_lo(v[i].x), w * bf16_hi(v[i].x),
                    w * bf16_lo(v[i].y), w * bf16_hi(v[i].y));
    *reinterpret_cast<float4*>(q + 4) =
        make_float4(w * bf16_lo(v[i].z), w * bf16_hi(v[i].z),
                    w * bf16_lo(v[i].w), w * bf16_hi(v[i].w));
  }
}

// Warp 0 only: the chunk's running sum of dt A_h, two steps per lane
// (steps past the end count dt = 0).  Lane l holds steps 2l and 2l + 1:
// dt in d[], cum in cum[]; returns cum_last.
__device__ __forceinline__ float chunk_cumsum(const float* __restrict__ dtb,
                                              size_t stride, int nrows,
                                              float a_h, float (&d)[2],
                                              float (&cum)[2]) {
  const int lane = threadIdx.x, t = 2 * lane;
  d[0] = t < nrows ? dtb[t * stride] : 0.0f;
  d[1] = t + 1 < nrows ? dtb[(t + 1) * stride] : 0.0f;
  const float la0 = d[0] * a_h, la1 = d[1] * a_h;
  float inc = la0 + la1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  const float prev = __shfl_up_sync(0xffffffffu, inc, 1);
  const float before = lane == 0 ? 0.0f : prev;
  cum[0] = before + la0;
  cum[1] = cum[0] + la1;
  return __shfl_sync(0xffffffffu, cum[1], 31);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

size_t smem_state_bytes(int np) {
  return sizeof(float) * (kC * kLdX + kC * (np + 4) + kC);
}

// Phase 1: dS = sum_j (exp(cum_last - cum_j) dt_j x_j) B_j^T for one chunk,
// one (b, h) and 64 columns of P; clast = cum_last.  NPF: N padded to a
// multiple of 16, fixed at compile time (64, zamba2's), or 0 to derive it
// from n.  With kBwd the same outer-product sum takes the weights
// exp(cum_j) instead: the backward's sum_t exp(cum_t) dy_t C_t^T, with dy
// in x's place and C in B's.
template <typename T, int NPF, bool kBwd>
__device__ __forceinline__ void chunk_state_body(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    float* __restrict__ ds, float* __restrict__ clast, int s, int h, int p,
    int n, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int np = NPF > 0 ? NPF : round16(n), ldb = np + 4;
  float* s_x = smem;                 // [kC][kLdX]  w_j x_j
  float* s_b = s_x + kC * kLdX;      // [kC][ldb]   B
  float* s_w = s_b + kC * ldb;       // [kC]  exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, bh = blockIdx.y, p0 = blockIdx.z * kPB;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const T* xb = x + (row0 * h + head) * p;
  const T* bb = bm + row0 * n;
  const size_t rx = (size_t)h * p;

  uint4 xv[kMaxGroups], bv[kMaxGroups];   // bf16 tiles, stored once
                                         // the decays are known
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      async_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p);
      async_tile(s_b, ldb, bb, (size_t)n, nrows, 0, np, n);
      cp_async_commit();
    } else {
      fetch_bf16(xv, xb, rx, nrows, p0, kPB, p);
      fetch_bf16(bv, bb, (size_t)n, nrows, 0, np, n);
    }
  } else {
    scalar_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p);
    scalar_tile(s_b, ldb, bb, (size_t)n, nrows, 0, np, n);
  }
  if (tid < 32) {
    float d[2], cum[2];
    const float last = chunk_cumsum(dt + row0 * h + head, (size_t)h, nrows,
                                    a[head], d, cum);
    if constexpr (kBwd) {
      s_w[2 * tid] = expf(cum[0]);
      s_w[2 * tid + 1] = expf(cum[1]);
    } else {
      s_w[2 * tid] = expf(last - cum[0]) * d[0];
      s_w[2 * tid + 1] = expf(last - cum[1]) * d[1];
    }
    if (tid == 0 && blockIdx.z == 0) clast[(size_t)bh * nc + chunk] = last;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (sizeof(T) == 2 && vec) {
    put_bf16(s_b, ldb, bv, np, nullptr);
    put_bf16(s_x, kLdX, xv, kPB, s_w);
  } else {
    for (int e = tid; e < kC * kPB; e += kThreads) {
      const int t = e / kPB, c = e - t * kPB;
      s_x[t * kLdX + c] *= s_w[t];
    }
  }
  __syncthreads();

  // dS[p0 + pr][nc0 ..] in 4 x 4 tiles: rows pr .. pr + 3 of the P slice,
  // columns nc0 .. nc0 + 3 of N
  float* out = ds + (((size_t)bh * nc + chunk) * p) * n;
  const bool vec_out = (n & 3) == 0;
  const int ngc = np / 4;
  for (int q = tid; q < (kPB / 4) * ngc; q += kThreads) {
    const int pr = 4 * (q / ngc), n0 = 4 * (q % ngc);
    float acc[4][4] = {};
#pragma unroll 8
    for (int j = 0; j < kC; ++j) {
      const float4 bj = ld4(s_b + j * ldb + n0);
      const float bvals[4] = {bj.x, bj.y, bj.z, bj.w};
      outer(acc, ld4(s_x + j * kLdX + pr), bvals);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = p0 + pr + i;
      if (pp >= p) break;
      float* row = out + (size_t)pp * n + n0;
      if (vec_out && n0 + 3 < n) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n0 + jj < n) row[jj] = acc[i][jj];
      }
    }
  }
}

template <typename T, int NPF>
__global__ void __launch_bounds__(kThreads, 5) ssd_chunk_state(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    float* __restrict__ ds, float* __restrict__ clast, int s, int h, int p,
    int n, int nc, bool vec) {
  chunk_state_body<T, NPF, false>(x, dt, a, bm, ds, clast, s, h, p, n, nc,
                                  vec);
}

// Backward phase 1: the increments of the state's gradient,
// dds_c = sum_t exp(cum_t) dy_t C_t^T, and clast (as phase 1's).
template <typename T, int NPF>
__global__ void __launch_bounds__(kThreads, 5) ssd_bwd_state_inc(
    const T* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ cm,
    float* __restrict__ dds, float* __restrict__ clast, int s, int h, int p,
    int n, int nc, bool vec) {
  chunk_state_body<T, NPF, true>(dy, dt, a, cm, dds, clast, s, h, p, n, nc,
                                 vec);
}

// Phase 2: per (b, h, p, n), S_{c+1} = exp(clast_c) S_c + dS_c over the
// chunks; S_c is written over dS_c, S_NC to state_out.
__global__ void __launch_bounds__(kThreads) ssd_state_scan(
    const float* __restrict__ state0, float* __restrict__ ds,
    const float* __restrict__ clast, float* __restrict__ state_out, int nbh,
    int pn, int nc) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)nbh * pn) return;
  const size_t bh = e / pn, rem = e - bh * pn;
  float st = state0 != nullptr ? state0[e] : 0.0f;
  float* d = ds + bh * nc * pn + rem;
  const float* cl = clast + bh * nc;
  constexpr int kAhead = 8;          // chunks whose loads are in flight
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float inc[kAhead], dec[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        inc[i] = d[(size_t)(c0 + i) * pn];
        dec[i] = cl[c0 + i];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c0 + i < nc) {
        d[(size_t)(c0 + i) * pn] = st;
        st = fmaf(expf(dec[i]), st, inc[i]);
      }
  }
  state_out[e] = st;
}

// Row stride (elements) of phase 3's C and B tiles: bf16 rows an odd
// multiple of 16 bytes (conflict-free ldmatrix), f32 rows 4 floats past a
// multiple of 8 (conflict-free 16-byte loads of 8 rows)
template <typename T>
__host__ __device__ constexpr int pad_ld(int w) {
  return w + (sizeof(T) == 2 ? 8 : 4);
}

template <typename T>
size_t smem_output_bytes(int np) {
  return sizeof(T) * (2 * kC * pad_ld<T>(np)) +
         sizeof(float) * (kC * kLdX + kPB * (np + 4) + kC * kLdG + 3 * kC);
}

// Phase 3: y for one chunk, one (b, h) and 64 columns of P.  NPF as in
// phase 1.  The bf16 N = 64 instance (zamba2's) runs three blocks per SM
// (80 registers, no spills); the others two.
template <typename T, int NPF>
__global__ void __launch_bounds__(
    kThreads, sizeof(T) == 2 && NPF == 64 ? 3 : 2) ssd_chunk_output(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const void* __restrict__ dskip, int d_bf16,
    const float* __restrict__ ds, T* __restrict__ y, int s, int h, int p,
    int n, int nc, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = NPF > 0 ? NPF : round16(n);
  const int ldt = pad_ld<T>(np), lds = np + 4;
  T* s_c = reinterpret_cast<T*>(smem_raw);   // [kC][ldt]  C
  T* s_b = s_c + kC * ldt;                   // [kC][ldt]  B
  float* s_x = reinterpret_cast<float*>(s_b + kC * ldt);   // [kC][kLdX] x
  float* s_s = s_x + kC * kLdX;              // [kPB][lds] S_c
  float* s_g = s_s + kPB * lds;              // [kC][kLdG] G^T, masked
  float* s_cum = s_g + kC * kLdG;            // [kC]
  float* s_dt = s_cum + kC;                  // [kC]
  float* s_e = s_dt + kC;                    // [kC]  exp(cum_t)

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, bh = blockIdx.y, p0 = blockIdx.z * kPB;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const T* xb = x + (row0 * h + head) * p;
  const T* bb = bm + row0 * n;
  const T* cb = cm + row0 * n;
  const float* sb = ds + (((size_t)bh * nc + chunk) * p + p0) * n;
  const size_t rx = (size_t)h * p;
  const int prow = min(kPB, p - p0);       // state rows of this slice

  uint4 xv[kMaxGroups];   // a bf16 x tile, stored as f32 below
  if (vec) {
    async_tile(s_c, ldt, cb, (size_t)n, nrows, 0, np, n);
    async_tile(s_b, ldt, bb, (size_t)n, nrows, 0, np, n);
    if constexpr (sizeof(T) == 4)
      async_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p);
    else
      fetch_bf16(xv, xb, rx, nrows, p0, kPB, p);
    cp_async_commit();
    for (int e = tid; e < kPB * (np / 4); e += kThreads) {
      const int r = e / (np / 4), c = 4 * (e - r * (np / 4));
      const bool ok = r < prow && c < n;
      cp_async16(s_s + r * lds + c, ok ? sb + (size_t)r * n + c : sb, ok);
    }
    cp_async_commit();
  } else {
    scalar_tile(s_c, ldt, cb, (size_t)n, nrows, 0, np, n);
    scalar_tile(s_b, ldt, bb, (size_t)n, nrows, 0, np, n);
    scalar_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p);
    for (int e = tid; e < kPB * np; e += kThreads) {
      const int r = e / np, c = e - r * np;
      s_s[r * lds + c] = (r < prow && c < n) ? sb[(size_t)r * n + c] : 0.0f;
    }
  }
  if (tid < 32) {
    float d[2], cum[2];
    chunk_cumsum(dt + row0 * h + head, (size_t)h, nrows, a[head], d, cum);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s_cum[2 * tid + i] = cum[i];
      s_dt[2 * tid + i] = d[i];
      s_e[2 * tid + i] = expf(cum[i]);
    }
  }
  if constexpr (sizeof(T) == 2)
    if (vec) put_bf16(s_x, kLdX, xv, kPB, nullptr);
  cp_async_wait<1>();                // C, B, x; the chunk state later
  __syncthreads();

  // G^T[j][t] = (C_t . B_j) exp(cum_t - cum_j) dt_j for j <= t, else 0
  if constexpr (sizeof(T) == 2) {
    // warp w: rows 16 (w / 2) .., columns 32 (w % 2) ..; the two warps
    // wholly above the diagonal do nothing (what they would write is
    // never read)
    const int warp = tid >> 5, lane = tid & 31;
    const int mt = warp >> 1, nh = warp & 1;
    if (32 * nh <= 16 * mt + 15) {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[i][e] = 0.0f;
      const uint32_t a_addr = smem_addr(
          s_c + (16 * mt + (lane & 15)) * ldt + 8 * (lane >> 4));
      const uint32_t b_addr = smem_addr(
          s_b + (32 * nh + (lane & 7) + 8 * (lane >> 4)) * ldt +
          8 * ((lane >> 3) & 1));
#pragma unroll 4
      for (int ks = 0; ks < np / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a_addr + ks * 32);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, b_addr + (jp * 16 * ldt + ks * 16) * 2);
          mma_bf16(g[2 * jp], af, bfr[0], bfr[1]);
          mma_bf16(g[2 * jp + 1], af, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * mt + (lane >> 2) + 8 * (e >> 1);
          const int j = 32 * nh + 8 * nt + 2 * (lane & 3) + (e & 1);
          s_g[j * kLdG + t] =
              j <= t ? g[nt][e] * (expf(s_cum[t] - s_cum[j]) * s_dt[j])
                     : 0.0f;
        }
    }
  } else {
    const int tx = tid & 15, ty = tid >> 4;
    float g[4][4] = {};
    for (int c = 0; c < np; c += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = ld4(s_c + (4 * ty + i) * ldt + c);
        bv[i] = ld4(s_b + (tx + 16 * i) * ldt + c);
      }
      rows_by_rows(g, av, bv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = 4 * ty + i, j = tx + 16 * jj;
        s_g[j * kLdG + t] =
            j <= t ? g[i][jj] * (expf(s_cum[t] - s_cum[j]) * s_dt[j]) : 0.0f;
      }
  }
  cp_async_wait<0>();
  __syncthreads();

  // rows 4 ty .. 4 ty + 3, columns tx + 16 jj of the slice:
  // exp(cum_t) C_t . S_c[p] + sum_{j <= t} G[t][j] x_j[p] + D x_t[p]
  const int tx = tid & 15, ty = tid >> 4, tr = 4 * ty;
  float o[4][4] = {};
#pragma unroll 4
  for (int c = 0; c < np; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ld4(s_c + (tr + i) * ldt + c);
      bv[i] = ld4(s_s + (tx + 16 * i) * lds + c);
    }
    rows_by_rows(o, av, bv);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = s_e[tr + i];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) o[i][jj] *= e;
  }
  for (int j = 0; j <= tr + 3; ++j) {
    float xv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      xv[jj] = s_x[j * kLdX + tx + 16 * jj];
    outer(o, ld4(s_g + j * kLdG + tr), xv);
  }
  const float d_h = d_bf16 ? to_f32(static_cast<const bf16*>(dskip)[head])
                           : static_cast<const float*>(dskip)[head];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tr + i;
    if (t >= nrows) break;
    T* row = y + ((row0 + t) * h + head) * p + p0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = tx + 16 * jj;
      if (p0 + c < p)
        store1(row + c, fmaf(d_h, s_x[t * kLdX + c], o[i][jj]));
    }
  }
}

// ---------------------------------------------------------------------------
// The backward.  Per (b, h) and chunk c, with S_c the state entering the
// chunk (phase 2's, saved by the forward) and G_c the gradient of the state
// leaving it (a reverse scan over chunks, started at the final state's
// gradient):
//   dxdt_j = sum_{t>=j} M[t][j] dy_t + e^{cum_L-cum_j} G B_j,
//            M[t][j] = (C_t . B_j) e^{cum_t-cum_j}  (j <= t)
//   dx_j   = dt_j dxdt_j + D dy_j
//   dC_t   = e^{cum_t} S^T dy_t + sum_{j<=t} Dm[t][j] B_j,
//            Dm[t][j] = (dy_t . xdt_j) e^{cum_t-cum_j}  (j <= t)
//   dB_j   = sum_{t>=j} Dm[t][j] C_t + e^{cum_L-cum_j} G^T xdt_j
//   dla_i  = sum_{t>=i} r_t + q + sum_{j<i} v_j + sum_{t>=i} sum_{j<i} W[t][j]
//            r_t = e^{cum_t} C_t . S^T dy_t,  v_j = e^{cum_L-cum_j} B_j . G^T xdt_j,
//            q = e^{cum_L} <G, S>,  W = M o (dy . xdt)
//   ddt_j  = a dla_j + sum_p dxdt_j x_j,  da = sum dt dla,  dD = sum dy . x
// (dla is the gradient of the log decay la = dt a.  Taken term by term,
// not as a reverse cumulative sum of the gradient of cum: there the
// diagonal W[t][t] enters with both signs, and under a strong decay what
// is left after it cancels is below its rounding.)

constexpr int kMaxNH = kMaxState / 64;   // 64-column groups of N, at most
constexpr int kSegVecs = 3;              // la, lc, rs (chunk_segments)
constexpr int kBwdVecs = 7 + kSegVecs;   // per-step vectors (f32 route)
constexpr int kTcVecs = 11 + kSegVecs;   // per-step vectors (bf16 route)
constexpr int kSub = 16;                 // sub-block of the segment sums

// Warp 0 only, given chunk_cumsum's dt (two steps per lane): the chunk's
// log decays la = dt A_h and, per 16-step sub-block, each step's sum from
// the start of its sub-block (lc, inclusive) and the sum of the rest of
// its sub-block (rs, exclusive), into seg[0..63], seg[64..127] and
// seg[128..191]; edec[i] = e^{cum_L - cum_j} for the lane's steps j, its
// exponent rs_j plus the whole sub-blocks after j's.  Every one is a sum of
// terms of one sign, so it holds to the precision of its own size.
__device__ __forceinline__ void chunk_segments(const float (&d)[2],
                                               float a_h, float* seg,
                                               float (&edec)[2]) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kW = kSub / 2;           // lanes per sub-block
  const int lane = threadIdx.x, t = 2 * lane, in_sub = lane & (kW - 1);
  const float la0 = d[0] * a_h, la1 = d[1] * a_h;
  float pre = la0 + la1, suf = la0 + la1;
#pragma unroll
  for (int o = 1; o < kW; o <<= 1) {
    const float u = __shfl_up_sync(kAll, pre, o, kW);
    const float v = __shfl_down_sync(kAll, suf, o, kW);
    if (in_sub >= o) pre += u;
    if (in_sub + o < kW) suf += v;
  }
  const float prev = __shfl_up_sync(kAll, pre, 1, kW);
  const float next = __shfl_down_sync(kAll, suf, 1, kW);
  const float lc0 = (in_sub == 0 ? 0.0f : prev) + la0;
  const float rs1 = in_sub == kW - 1 ? 0.0f : next;
  seg[t] = la0;
  seg[t + 1] = la1;
  seg[kC + t] = lc0;
  seg[kC + t + 1] = lc0 + la1;
  seg[2 * kC + t] = rs1 + la1;
  seg[2 * kC + t + 1] = rs1;
  float after = 0.0f;                    // the sub-blocks after this one
#pragma unroll
  for (int m = kC / kSub - 1; m > 0; --m) {
    const float tot = __shfl_sync(kAll, pre, kW * m + kW - 1);
    if (m > lane / kW) after += tot;
  }
  edec[0] = expf((rs1 + la1) + after);
  edec[1] = expf(rs1 + after);
}

// e^{cum_t - cum_j} for j <= t, from chunk_segments' sums: the exponent
// sum_{j<k<=t} la_k term by term inside one sub-block, else lc_t, the
// whole sub-blocks between and rs_j.  Never a difference of running sums.
__device__ __forceinline__ float seg_exp(const float* seg, int t, int j) {
  const int st = t / kSub, sj = j / kSub;
  float x = 0.0f;
  if (st == sj) {
    for (int k = j + 1; k <= t; ++k) x += seg[k];
  } else {
    x = seg[kC + t] + seg[2 * kC + j];
    for (int m = sj + 1; m < st; ++m) x += seg[kC + kSub * m + kSub - 1];
  }
  return expf(x);
}
constexpr int kPieces = 2;               // bf16 pieces of an f32 operand
constexpr int kLdC = pad_ld<bf16>(kC);   // row stride of bf16 [64][64] tiles

// four 8 x 8 b16 matrices, each transposed on the way (as ldmatrix_x4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
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

// Sum of v over the block, in a fixed order (a butterfly inside each warp,
// then the warps in index order), returned to every thread.  red: 8 floats
// of shared memory, free on entry.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// the sum of v over the four lanes of a quad (one row of an mma tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ constexpr int round64(int n) { return (n + 63) & ~63; }

// A tile of one chunk into shared memory, as async_tile and scalar_tile
// lay it out: 16-byte cp.async copies where the operands allow (vec),
// element by element otherwise.  Each thread walks whole rows' strides, so
// a loop over tiles keeps no per-copy address in a register.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          size_t rstride, int nrows,
                                          int col0, int ncols, int width,
                                          bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int ng = ncols / kPer;       // copies per row, divides kThreads
    const int c = kPer * (threadIdx.x % ng);
    const bool col_ok = col0 + c < width;
#pragma unroll 1
    for (int t = threadIdx.x / ng; t < kC; t += kThreads / ng) {
      const bool ok = col_ok && t < nrows;
      cp_async16(dst + t * ld + c, ok ? src + t * rstride + col0 + c : src,
                 ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < kC * ncols; e += kThreads) {
      const int t = e / ncols, c = e - t * ncols;
      dst[t * ld + c] = (t < nrows && col0 + c < width)
                            ? src[t * rstride + col0 + c]
                            : T(0.0f);
    }
  }
}

// A staged f32 tile [kPB][ncol] (rows of P, unpadded) rewritten in place:
// every thread reads its pairs into registers, the block waits, then
// put(row, col, pair) writes each pair where the route wants it.  A
// thread takes the same column pair in rows kThreads / (ncol / 2) apart.
// NC: ncol fixed at compile time, or 0.
template <int NC, typename Put>
__device__ __forceinline__ void restage(const float* stage, int ncol,
                                        Put put) {
  constexpr int kPairs = (NC > 0 ? NC : kMaxState) * kPB / 2 / kThreads;
  const int half = ncol / 2, step = kThreads / half;
  const int r0 = threadIdx.x / half, c = 2 * (threadIdx.x % half);
  float2 v[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
    if (r0 + i * step < kPB)
      v[i] = *reinterpret_cast<const float2*>(stage +
                                              (r0 + i * step) * ncol + c);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
    if (r0 + i * step < kPB) put(r0 + i * step, c, v[i]);
}

// row[c], row[c + 1] (those below width) to device memory, as one store
// where the pair's address is aligned to it
__device__ __forceinline__ void store_pair(float* row, int c, int width,
                                           float v0, float v1) {
  float* q = row + c;
  if (c + 1 < width && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
  } else {
    if (c < width) q[0] = v0;
    if (c + 1 < width) q[1] = v1;
  }
}
__device__ __forceinline__ void store_pair(bf16* row, int c, int width,
                                           float v0, float v1) {
  bf16* q = row + c;
  if (c + 1 < width && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(q) = pack_bf16(v0, v1);
  } else {
    if (c < width) q[0] = __float2bfloat16(v0);
    if (c + 1 < width) q[1] = __float2bfloat16(v1);
  }
}

// shared memory of ssd_bwd_chunk_grad for N padded to ncol (64 or 128)
template <typename T>
size_t smem_bwd_bytes(int ncol) {
  if constexpr (sizeof(T) == 2) {
    // C, B and two slots of kPieces [64][ncol] bf16 tiles; Dm's pieces, x
    // and dy [64][64] bf16; W [64][kLdG] f32
    const size_t tile = (size_t)kC * pad_ld<bf16>(ncol) * sizeof(bf16);
    const size_t tile_c = (size_t)kC * kLdC * sizeof(bf16);
    return (2 + 2 * kPieces) * tile + (kPieces + 2) * tile_c +
           sizeof(float) * (kC * kLdG + kTcVecs * kC + 32);
  } else {
    const size_t ldn = ncol + 4;
    const size_t fixed = 2 * kC * ldn + 2 * kC * kLdG + kBwdVecs * kC + 32;
    const size_t tiles_a = 2 * kC * kLdX + 2 * ncol * kLdX;  // x, dy, S^T, G^T
    const size_t tiles_b = 2 * kC * ldn + kC * kLdG;          // U, V, W
    const size_t tiles_c = 2 * kC * kLdX + kC * ldn;          // x, dy, G
    const size_t u = tiles_a > tiles_b ? tiles_a : tiles_b;
    return sizeof(float) * (fixed + (u > tiles_c ? u : tiles_c));
  }
}

// The f32 route of backward phase 3 (the card-vs-CPU checks): every
// product f32 FMA on the CUDA cores in 4 x 4 register tiles.
template <int NPF>
__device__ __forceinline__ void chunk_grad_fma(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const void* __restrict__ dskip,
    int d_bf16, const float* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ dstates,
    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
    float* __restrict__ dcp, float* __restrict__ dap,
    float* __restrict__ ddp, int s, int h, int p, int n, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kNC = NPF > 0 ? round64(NPF) : 0;
  const int ncol = NPF > 0 ? round64(NPF) : round64(n);
  const int nh = ncol / 64, ldn = ncol + 4;
  float* s_c = smem;                   // [kC][ldn]  C
  float* s_b = s_c + kC * ldn;         // [kC][ldn]  B
  float* s_m = s_b + kC * ldn;         // [kC][kLdG] M[t][j]
  float* s_dm = s_m + kC * kLdG;       // [kC][kLdG] Dm[t][j]
  float* s_seg = s_dm + kC * kLdG;     // [kSegVecs][kC] chunk_segments'
  float* s_dt = s_seg + kSegVecs * kC; // [kC] dt_t
  float* s_ecum = s_dt + kC;           // [kC] e^{cum_t}
  float* s_edec = s_ecum + kC;         // [kC] e^{cum_L - cum_j}
  float* s_r = s_edec + kC;            // [kC] r_t
  float* s_v = s_r + kC;               // [kC] v_j
  float* s_dla = s_v + kC;             // [kC] dla_i
  float* s_ddt = s_dla + kC;           // [kC] sum_p dxdt_j x_j
  float* s_red = s_ddt + kC;           // [32] block sums; [16] = cum_L
  float* s_un = s_red + 32;            // the tiles of one phase at a time
  // phase A: x, dy [kC][kLdX] (rows t, a 64-column tile of P);
  // S^T, G^T [ncol][kLdX] (rows n), each staged there first as [kPB][ncol]
  float* s_x = s_un;
  float* s_dy = s_x + kC * kLdX;
  float* s_st = s_dy + kC * kLdX;
  float* s_gt = s_st + ncol * kLdX;
  // phase B: U = S^T dy, V = G^T xdt [kC][ldn]; W, then its prefix sums
  float* s_uu = s_un;
  float* s_vv = s_uu + kC * ldn;
  float* s_w = s_vv + kC * ldn;
  // phase C: x, dy as in A; G [kC][ldn] (rows p)
  float* s_g = s_dy + kC * kLdX;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, tr = 4 * ty;
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const float* xb = x + (row0 * h + head) * p;
  const float* dyb = dy + (row0 * h + head) * p;
  const size_t rx = (size_t)h * p;
  const size_t pn = (size_t)p * n;
  const float* sc = states + ((size_t)bh * nc + chunk) * pn;
  const float* gc = dstates + ((size_t)bh * nc + chunk) * pn;
  const float a_h = a[head];

  load_tile(s_c, ldn, cm + row0 * n, (size_t)n, nrows, 0, ncol, n, vec);
  load_tile(s_b, ldn, bm + row0 * n, (size_t)n, nrows, 0, ncol, n, vec);
  cp_async_commit();
  if (tid < 32) {
    float d2[2], cum[2];
    const float last = chunk_cumsum(dt + row0 * h + head, (size_t)h, nrows,
                                    a_h, d2, cum);
    float edec[2];
    chunk_segments(d2, a_h, s_seg, edec);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 2 * tid + i;
      s_dt[k] = d2[i];
      s_ecum[k] = expf(cum[i]);
      s_edec[k] = edec[i];
      s_ddt[k] = 0.0f;
    }
    if (tid == 0) s_red[16] = last;
  }

  // Phase A, over the tiles of P: DX[t][j] = dy_t . x_j, U = S^T dy_t,
  // G^T x_j (dt_j folded in below) and <G, S>, in registers
  float adx[4][4] = {}, au[kMaxNH][4][4] = {}, av[kMaxNH][4][4] = {};
  float q_part = 0.0f;
  for (int p0 = 0; p0 < p; p0 += kPB) {
    __syncthreads();                   // the previous tile is read
    load_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p, vec);
    load_tile(s_dy, kLdX, dyb, rx, nrows, p0, kPB, p, vec);
    load_tile(s_st, ncol, sc + (size_t)p0 * n, (size_t)n, p - p0, 0, ncol,
              n, vec);
    load_tile(s_gt, ncol, gc + (size_t)p0 * n, (size_t)n, p - p0, 0, ncol,
              n, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < kPB * ncol; e += kThreads)
      q_part = fmaf(s_st[e], s_gt[e], q_part);
    // S and G from rows of P to rows of N
    restage<kNC>(
        s_st, ncol, [&](int r, int c, float2 v) {
          s_st[c * kLdX + r] = v.x;
          s_st[(c + 1) * kLdX + r] = v.y;
        });
    restage<kNC>(
        s_gt, ncol, [&](int r, int c, float2 v) {
          s_gt[c * kLdX + r] = v.x;
          s_gt[(c + 1) * kLdX + r] = v.y;
        });
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kPB; c += 4) {
      float4 dyr[4], xr[4], xc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dyr[i] = ld4(s_dy + (tr + i) * kLdX + c);
        xr[i] = ld4(s_x + (tr + i) * kLdX + c);
        xc[i] = ld4(s_x + (tx + 16 * i) * kLdX + c);
      }
      rows_by_rows(adx, dyr, xc);
#pragma unroll
      for (int hh = 0; hh < kMaxNH; ++hh) {
        if (hh < nh) {
          float4 sv[4], gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sv[i] = ld4(s_st + (64 * hh + tx + 16 * i) * kLdX + c);
            gv[i] = ld4(s_gt + (64 * hh + tx + 16 * i) * kLdX + c);
          }
          rows_by_rows(au[hh], dyr, sv);
          rows_by_rows(av[hh], xr, gv);
        }
      }
    }
  }
  const float last = s_red[16];
  const float q = expf(last) * block_sum(q_part, s_red);
  float dd_part = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (tr + i == tx + 16 * jj) dd_part += adx[i][jj];
  const float dd_sum = block_sum(dd_part, s_red);   // phase A is read

  // U, V and, with C B^T, M, Dm and W into shared memory
#pragma unroll
  for (int hh = 0; hh < kMaxNH; ++hh) {
    if (hh < nh) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tr + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int k = 64 * hh + tx + 16 * jj;
          s_uu[t * ldn + k] = au[hh][i][jj];
          s_vv[t * ldn + k] = av[hh][i][jj] * s_dt[t];
        }
      }
    }
  }
  {
    float cb[4][4] = {};
    for (int c = 0; c < ncol; c += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = ld4(s_c + (tr + i) * ldn + c);
        bv[i] = ld4(s_b + (tx + 16 * i) * ldn + c);
      }
      rows_by_rows(cb, cv, bv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int t = tr + i, j = tx + 16 * jj;
        const float e = j <= t ? seg_exp(s_seg, t, j) : 0.0f;
        const float dxm = adx[i][jj] * s_dt[j];     // dy_t . xdt_j
        s_m[t * kLdG + j] = cb[i][jj] * e;
        s_dm[t * kLdG + j] = dxm * e;
        s_w[t * kLdG + j] = cb[i][jj] * (dxm * e);
      }
  }
  __syncthreads();

  // Phase B.  dC rows t, dB rows j, columns 64 hh + tx + 16 jj of N
  for (int hh = 0; hh < nh; ++hh) {
    float o[4][4] = {};
    for (int j = 0; j <= tr + 3; ++j) {
      const float4 dmv = make_float4(
          s_dm[tr * kLdG + j], s_dm[(tr + 1) * kLdG + j],
          s_dm[(tr + 2) * kLdG + j], s_dm[(tr + 3) * kLdG + j]);
      float bv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        bv[jj] = s_b[j * ldn + 64 * hh + tx + 16 * jj];
      outer(o, dmv, bv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tr + i;
      if (t >= nrows) break;
      float* row = dcp + ((size_t)bh * s + t0 + t) * n;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = 64 * hh + tx + 16 * jj;
        if (k < n) row[k] = fmaf(s_ecum[t], s_uu[t * ldn + k], o[i][jj]);
      }
    }
  }
  for (int hh = 0; hh < nh; ++hh) {
    float o[4][4] = {};
    for (int t = tr; t < kC; ++t) {
      float cv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        cv[jj] = s_c[t * ldn + 64 * hh + tx + 16 * jj];
      outer(o, ld4(s_dm + t * kLdG + tr), cv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tr + i;
      if (j >= nrows) break;
      float* row = dbp + ((size_t)bh * s + t0 + j) * n;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = 64 * hh + tx + 16 * jj;
        if (k < n) row[k] = fmaf(s_edec[j], s_vv[j * ldn + k], o[i][jj]);
      }
    }
  }
  // r_t, v_j, and each row of W turned into its exclusive prefix sums
  if (tid < kC) {
    float acc = 0.0f;
    for (int k = 0; k < ncol; ++k)
      acc = fmaf(s_c[tid * ldn + k], s_uu[tid * ldn + k], acc);
    s_r[tid] = s_ecum[tid] * acc;
  } else if (tid < 2 * kC) {
    const int j = tid - kC;
    float acc = 0.0f;
    for (int k = 0; k < ncol; ++k)
      acc = fmaf(s_b[j * ldn + k], s_vv[j * ldn + k], acc);
    s_v[j] = s_edec[j] * acc;
  } else if (tid < 3 * kC) {
    float* row = s_w + (tid - 2 * kC) * kLdG;
    float run = 0.0f;
    for (int i = 0; i < kC; ++i) {
      const float w = row[i];
      row[i] = run;
      run += w;
    }
  }
  __syncthreads();
  if (tid < kC) {
    const int i = tid;
    float rs = 0.0f, vp = 0.0f, ws = 0.0f;
    for (int t = i; t < kC; ++t) rs += s_r[t];
    for (int j = 0; j < i; ++j) vp += s_v[j];
    for (int t = i; t < kC; ++t) ws += s_w[t * kLdG + i];
    s_dla[i] = ((rs + q) + vp) + ws;
  }

  // Phase C, over the tiles of P: dxdt, then dx and sum_p dxdt x
  const float d_h = d_bf16 ? to_f32(static_cast<const bf16*>(dskip)[head])
                           : static_cast<const float*>(dskip)[head];
  for (int p0 = 0; p0 < p; p0 += kPB) {
    __syncthreads();                   // phase B's tiles, or the last, read
    load_tile(s_x, kLdX, xb, rx, nrows, p0, kPB, p, vec);
    load_tile(s_dy, kLdX, dyb, rx, nrows, p0, kPB, p, vec);
    load_tile(s_g, ldn, gc + (size_t)p0 * n, (size_t)n, p - p0, 0, ncol, n,
              vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // rows j = tr + i, columns tx + 16 jj of the tile
    float o[4][4] = {}, gb[4][4] = {};
    for (int t = tr; t < kC; ++t) {
      float dv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dv[jj] = s_dy[t * kLdX + tx + 16 * jj];
      outer(o, ld4(s_m + t * kLdG + tr), dv);
    }
    for (int c = 0; c < ncol; c += 4) {
      float4 bv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bv[i] = ld4(s_b + (tr + i) * ldn + c);
        gv[i] = ld4(s_g + (tx + 16 * i) * ldn + c);
      }
      rows_by_rows(gb, bv, gv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = tr + i;
      float* row = dx + ((row0 + j) * h + head) * p + p0;
      float part = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float g = fmaf(s_edec[j], gb[i][jj], o[i][jj]);
        part = fmaf(g, s_x[j * kLdX + c], part);
        if (j < nrows && p0 + c < p)
          row[c] = fmaf(s_dt[j], g, d_h * s_dy[j * kLdX + c]);
      }
      // the 16 lanes of this row group, in a fixed order
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o2);
      if (tx == 0) s_ddt[j] += part;
    }
  }
  __syncthreads();
  if (tid < nrows)
    ddt[(row0 + tid) * h + head] = fmaf(a_h, s_dla[tid], s_ddt[tid]);
  if (tid == 0) {
    float sa = 0.0f;
    for (int i = 0; i < kC; ++i) sa = fmaf(s_dt[i], s_dla[i], sa);
    dap[(size_t)bh * nc + chunk] = sa;
    ddp[(size_t)bh * nc + chunk] = dd_sum;
  }
}

// The bf16 route of backward phase 3 (zamba2's training), on the tensor
// cores: mma.sync m16n8k16 with bf16 operands from ldmatrix and f32 sums.
// Eight warps; warp w owns rows 16 (w / 2) .. + 15 and columns
// 32 (w % 2) .. + 31 of every [64 x 64] product (per 64 columns of N).
// dy.x^T and C B^T take bf16 on both sides, exact products.  The other
// six have one f32 operand (S, G, M, Dm), split into kPieces bf16 tiles
// when it reaches shared memory; each piece is multiplied by the bf16
// operand into the same f32 sums.  The triangular products skip the
// k-steps wholly outside the triangle.  Shared memory: C and B; slot 0
// holds S's pieces (A), then M's (B, C); slot 1 G's; then Dm's pieces, x
// and dy, and W.  S and G arrive as f32 (cp.async) in their slot and are
// split there.  Where P is one tile, phase C finds x, dy and G's pieces
// still in place from phase A.
template <int NPF>
__device__ __forceinline__ void chunk_grad_tc(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, const void* __restrict__ dskip,
    int d_bf16, const bf16* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ dstates,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
    float* __restrict__ dcp, float* __restrict__ dap,
    float* __restrict__ ddp, int s, int h, int p, int n, int nc, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNC = NPF > 0 ? round64(NPF) : 0;
  constexpr int kNH = NPF > 0 ? round64(NPF) / 64 : kMaxNH;
  const int ncol = NPF > 0 ? round64(NPF) : round64(n);
  const int nh = ncol / 64, ldt = pad_ld<bf16>(ncol);
  const int tile = kC * ldt;                     // elements of a piece
  constexpr int kTileC = kC * kLdC;              // elements of a [64][64]
  bf16* s_c = reinterpret_cast<bf16*>(smem_raw);   // [kC][ldt] C
  bf16* s_b = s_c + tile;                          // [kC][ldt] B
  bf16* slot0 = s_b + tile;
  bf16* slot1 = slot0 + kPieces * tile;
  bf16* s_dm = slot1 + kPieces * tile;             // [kC][kLdC] Dm pieces
  bf16* s_x = s_dm + kPieces * kTileC;             // [kC][kLdC] x
  bf16* s_dy = s_x + kTileC;                       // [kC][kLdC] dy
  float* s_w = reinterpret_cast<float*>(s_dy + kTileC);   // [kC][kLdG] W
  float* stage_s = reinterpret_cast<float*>(slot0);   // [kPB][ncol] S
  float* stage_g = reinterpret_cast<float*>(slot1);   // [kPB][ncol] G
  float* s_seg = s_w + kC * kLdG;      // [kSegVecs][kC] chunk_segments'
  float* s_dt = s_seg + kSegVecs * kC; // [kC] dt_t
  float* s_ecum = s_dt + kC;           // [kC] e^{cum_t}
  float* s_edec = s_ecum + kC;         // [kC] e^{cum_L - cum_j}
  float* s_dla = s_edec + kC;          // [kC] dla_i
  float* s_ddt = s_dla + kC;           // [kC] sum_p dxdt_j x_j
  float* s_rp = s_ddt + kC;            // [2][kC] C_t . U_t, per column half
  float* s_vp = s_rp + 2 * kC;         // [2][kC] B_j . V_j, per column half
  float* s_dp = s_vp + 2 * kC;         // [2][kC] sum_p dxdt x, per half
  float* s_red = s_dp + 2 * kC;        // [32] block sums; [16] cum_L, [17] q,
                                       // [18] sum dy . x

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g8 = lane >> 2, q4 = lane & 3;
  // the warp's [t][j] tile reaches the triangle j <= t
  const bool lower = 32 * wn <= 16 * wm + 15;
  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / h, head = bh - b * h;
  const int t0 = chunk * kC, nrows = min(kC, s - t0);
  const size_t row0 = (size_t)b * s + t0;
  const bf16* xb = x + (row0 * h + head) * p;
  const bf16* dyb = dy + (row0 * h + head) * p;
  const size_t rx = (size_t)h * p;
  const size_t pn = (size_t)p * n;
  const float* sc = states + ((size_t)bh * nc + chunk) * pn;
  const float* gc = dstates + ((size_t)bh * nc + chunk) * pn;

  // ldmatrix lane offsets (elements): an A operand from rows m (non-trans)
  // or from rows k (trans); a B operand, two n-tiles, from rows n
  // (non-trans) or from rows k (trans)
  const int a_row = 16 * wm + (lane & 15), a_col = 8 * (lane >> 4);
  const int at_row = (lane & 7) + 8 * (lane >> 4);
  const int at_col = 16 * wm + 8 * ((lane >> 3) & 1);
  const int b_row = 32 * wn + (lane & 7) + 8 * (lane >> 4);
  const int b_col = 8 * ((lane >> 3) & 1);
  const int bt_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bt_col = 32 * wn + 8 * (lane >> 4);
  // shared addresses (bytes) of the regions, one piece apart, and each
  // fragment's lane term on a tile of row stride ldt or kLdC
  const uint32_t piece = 2 * tile;
  const uint32_t sh_c = smem_addr(smem_raw), sh_b = sh_c + piece;
  const uint32_t sh_s0 = sh_b + piece, sh_s1 = sh_s0 + kPieces * piece;
  const uint32_t sh_dm = sh_s1 + kPieces * piece;
  const uint32_t sh_x = sh_dm + kPieces * 2 * kTileC;
  const uint32_t sh_dy = sh_x + 2 * kTileC;
  const uint32_t la_t = 2 * (a_row * ldt + a_col);
  const uint32_t la_c = 2 * (a_row * kLdC + a_col);
  const uint32_t lat_c = 2 * (at_row * kLdC + at_col);
  const uint32_t lb_t = 2 * (b_row * ldt + b_col);
  const uint32_t lb_c = 2 * (b_row * kLdC + b_col);
  const uint32_t lbt_t = 2 * (bt_row * ldt + bt_col);
  const uint32_t lbt_c = 2 * (bt_row * kLdC + bt_col);
  auto split_into = [&](bf16* pieces, int ld) {
    return [=](int r, int c, float2 v) {
      uint32_t w[kPieces];
      split_pair(v.x, v.y, w);
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
        *reinterpret_cast<uint32_t*>(pieces + i * tile + r * ld + c) = w[i];
    };
  };
  auto load_a = [&](int p0) {          // phase A's tiles of P
    load_tile(s_x, kLdC, xb, rx, nrows, p0, kPB, p, vec);
    load_tile(s_dy, kLdC, dyb, rx, nrows, p0, kPB, p, vec);
    load_tile(stage_s, ncol, sc + (size_t)p0 * n, (size_t)n, p - p0, 0,
              ncol, n, vec);
    load_tile(stage_g, ncol, gc + (size_t)p0 * n, (size_t)n, p - p0, 0,
              ncol, n, vec);
    cp_async_commit();
  };

  load_a(0);
  // C and B, first read in phase B: in flight through phase A
  load_tile(s_c, ldt, cm + row0 * n, (size_t)n, nrows, 0, ncol, n, vec);
  load_tile(s_b, ldt, bm + row0 * n, (size_t)n, nrows, 0, ncol, n, vec);
  cp_async_commit();
  if (tid < 32) {
    float d2[2], cum[2];
    const float last = chunk_cumsum(dt + row0 * h + head, (size_t)h, nrows,
                                    a[head], d2, cum);
    float edec[2];
    chunk_segments(d2, a[head], s_seg, edec);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 2 * tid + i;
      s_dt[k] = d2[i];
      s_ecum[k] = expf(cum[i]);
      s_edec[k] = edec[i];
      s_ddt[k] = 0.0f;
    }
    if (tid == 0) s_red[16] = last;
  }

  // Phase A, over the tiles of P: DX = dy x^T, U = dy S, V = x G and
  // <G, S>, in registers
  float adx[4][4] = {}, au[kNH][4][4] = {}, av[kNH][4][4] = {};
  float q_part = 0.0f;
  for (int p0 = 0; p0 < p; p0 += kPB) {
    if (p0 > 0) {
      __syncthreads();                 // the previous tile is read
      load_a(p0);
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();              // C and B may still be in flight
    }
    __syncthreads();
    for (int e = tid; e < kPB * ncol; e += kThreads)
      q_part = fmaf(stage_s[e], stage_g[e], q_part);
    restage<kNC>(stage_s, ncol, split_into(slot0, ldt));
    restage<kNC>(stage_g, ncol, split_into(slot1, ldt));
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < kPB / 16; ++ks) {
      uint32_t fdy[4], fx[4];
      ldmatrix_x4(fdy, sh_dy + la_c + 32 * ks);
      ldmatrix_x4(fx, sh_x + la_c + 32 * ks);
      if (lower) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t f[4];
          ldmatrix_x4(f, sh_x + lb_c + 32 * (jp * kLdC + ks));
          mma_bf16(adx[2 * jp], fdy, f[0], f[1]);
          mma_bf16(adx[2 * jp + 1], fdy, f[2], f[3]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < kNH; ++hh) {
        if (hh >= nh) break;
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const uint32_t off =
                i * piece + lbt_t + 32 * (ks * ldt + 4 * hh + jp);
            uint32_t f[4];
            ldmatrix_x4_trans(f, sh_s0 + off);
            mma_bf16(au[hh][2 * jp], fdy, f[0], f[1]);
            mma_bf16(au[hh][2 * jp + 1], fdy, f[2], f[3]);
            ldmatrix_x4_trans(f, sh_s1 + off);
            mma_bf16(av[hh][2 * jp], fx, f[0], f[1]);
            mma_bf16(av[hh][2 * jp + 1], fx, f[2], f[3]);
          }
      }
    }
  }
  const float last = s_red[16];
  const float q_sum = block_sum(q_part, s_red);   // A is read
  if (tid == 0) s_red[17] = expf(last) * q_sum;    // q

  // Phase B.  Dm from DX: its pieces into slot 1, its f32 value where W
  // goes; then C B^T, M (split) into slot 0 and W = (C B^T) o Dm
  float dd_part = 0.0f;
  if (lower) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int t = 16 * wm + g8 + 8 * r2;
        const int j = 32 * wn + 8 * nt + 2 * q4;
        float dm[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float e = j + k <= t ? seg_exp(s_seg, t, j + k) : 0.0f;
          const float dxm = adx[nt][2 * r2 + k] * s_dt[j + k];
          dm[k] = dxm * e;
          if (j + k == t) dd_part += adx[nt][2 * r2 + k];
        }
        uint32_t pd[kPieces];
        split_pair(dm[0], dm[1], pd);
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          *reinterpret_cast<uint32_t*>(s_dm + i * kTileC + t * kLdC + j) =
              pd[i];
        *reinterpret_cast<float2*>(s_w + t * kLdG + j) =
            make_float2(dm[0], dm[1]);
      }
  }
  const float dd_sum = block_sum(dd_part, s_red);
  if (tid == 0) s_red[18] = dd_sum;
  cp_async_wait<0>();
  __syncthreads();                     // C and B have landed
  if (lower) {
    float cb[4][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < ncol / 16; ++ks) {
      uint32_t fc[4];
      ldmatrix_x4(fc, sh_c + la_t + 32 * ks);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4(f, sh_b + lb_t + 32 * (jp * ldt + ks));
        mma_bf16(cb[2 * jp], fc, f[0], f[1]);
        mma_bf16(cb[2 * jp + 1], fc, f[2], f[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int t = 16 * wm + g8 + 8 * r2;
        const int j = 32 * wn + 8 * nt + 2 * q4;
        float2* wp = reinterpret_cast<float2*>(s_w + t * kLdG + j);
        const float2 dm = *wp;         // this thread's own, written above
        float m[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float e = j + k <= t ? seg_exp(s_seg, t, j + k) : 0.0f;
          m[k] = cb[nt][2 * r2 + k] * e;
        }
        uint32_t pm[kPieces];
        split_pair(m[0], m[1], pm);
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          *reinterpret_cast<uint32_t*>(slot0 + i * tile + t * kLdC + j) =
              pm[i];
        *wp = make_float2(cb[nt][2 * r2] * dm.x, cb[nt][2 * r2 + 1] * dm.y);
      }
  }
  __syncthreads();

  // Each row t of W turned into its exclusive prefix sums, up to the
  // diagonal (warps 4 and 5, before their products)
  if (tid >= 2 * kC && tid < 3 * kC) {
    const int t = tid - 2 * kC;
    float* row = s_w + t * kLdG;
    float run = 0.0f;
    for (int i = 0; i <= t; ++i) {
      const float w = row[i];
      row[i] = run;
      run += w;
    }
  }
  // dC rows t = e^{cum_t} U + Dm B and dB rows j = e^{cum_L-cum_j} V dt_j
  // + Dm^T C, summed into U's and V's registers; first their scaled
  // values' row sums with C_t and B_j, which r and v are
  float rpart[2] = {}, vpart[2] = {};
#pragma unroll
  for (int hh = 0; hh < kNH; ++hh) {
    if (hh >= nh) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int t = 16 * wm + g8 + 8 * r2;   // also j, for dB
        const int k = 64 * hh + 32 * wn + 8 * nt + 2 * q4;
        const uint32_t cv =
            *reinterpret_cast<const uint32_t*>(s_c + t * ldt + k);
        const uint32_t bv =
            *reinterpret_cast<const uint32_t*>(s_b + t * ldt + k);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& u = au[hh][nt][2 * r2 + i];
          float& v = av[hh][nt][2 * r2 + i];
          u *= s_ecum[t];
          v = (v * s_dt[t]) * s_edec[t];
          rpart[r2] = fmaf(i ? bf16_hi(cv) : bf16_lo(cv), u, rpart[r2]);
          vpart[r2] = fmaf(i ? bf16_hi(bv) : bf16_lo(bv), v, vpart[r2]);
        }
      }
  }
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const float rs = quad_sum(rpart[r2]), vs = quad_sum(vpart[r2]);
    if (q4 == 0) {
      s_rp[wn * kC + 16 * wm + g8 + 8 * r2] = rs;
      s_vp[wn * kC + 16 * wm + g8 + 8 * r2] = vs;
    }
  }
#pragma unroll
  for (int hh = 0; hh < kNH; ++hh) {
    if (hh >= nh) break;
    for (int ks = 0; ks <= wm; ++ks) {           // j <= t
      uint32_t af[kPieces][4];
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
        ldmatrix_x4(af[i], sh_dm + i * 2 * kTileC + la_c + 32 * ks);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sh_b + lbt_t + 32 * (ks * ldt + 4 * hh + jp));
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          mma_bf16(au[hh][2 * jp], af[i], f[0], f[1]);
          mma_bf16(au[hh][2 * jp + 1], af[i], f[2], f[3]);
        }
      }
    }
    for (int ks = wm; ks < kC / 16; ++ks) {      // t >= j
      uint32_t af[kPieces][4];
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
        ldmatrix_x4_trans(af[i],
                          sh_dm + i * 2 * kTileC + lat_c + 32 * ks * kLdC);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sh_c + lbt_t + 32 * (ks * ldt + 4 * hh + jp));
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          mma_bf16(av[hh][2 * jp], af[i], f[0], f[1]);
          mma_bf16(av[hh][2 * jp + 1], af[i], f[2], f[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int t = 16 * wm + g8 + 8 * r2;
        if (t >= nrows) continue;
        const int k = 64 * hh + 32 * wn + 8 * nt + 2 * q4;
        const size_t row = ((size_t)bh * s + t0 + t) * n;
        store_pair(dcp + row, k, n, au[hh][nt][2 * r2],
                   au[hh][nt][2 * r2 + 1]);
        store_pair(dbp + row, k, n, av[hh][nt][2 * r2],
                   av[hh][nt][2 * r2 + 1]);
      }
  }
  __syncthreads();
  if (tid < kC) {
    const int i = tid;
    float rs = 0.0f, vp = 0.0f, ws = 0.0f;
    for (int t = i; t < kC; ++t) rs += s_rp[t] + s_rp[kC + t];
    for (int j = 0; j < i; ++j) vp += s_vp[j] + s_vp[kC + j];
    for (int t = i; t < kC; ++t) ws += s_w[t * kLdG + i];
    s_dla[i] = ((rs + s_red[17]) + vp) + ws;
  }

  // Phase C, over the tiles of P: dxdt = M^T dy + e^{cum_L-cum_j} B G^T,
  // then dx and sum_p dxdt x
  const float d_h = d_bf16 ? to_f32(static_cast<const bf16*>(dskip)[head])
                           : static_cast<const float*>(dskip)[head];
  for (int p0 = 0; p0 < p; p0 += kPB) {
    __syncthreads();                   // the last tile is read
    if (p > kPB) {                     // else phase A's tile is in place
      load_tile(s_x, kLdC, xb, rx, nrows, p0, kPB, p, vec);
      load_tile(s_dy, kLdC, dyb, rx, nrows, p0, kPB, p, vec);
      load_tile(stage_g, ncol, gc + (size_t)p0 * n, (size_t)n, p - p0, 0,
                ncol, n, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      restage<kNC>(stage_g, ncol, split_into(slot1, ldt));
      __syncthreads();
    }
    // B G^T, scaled by e^{cum_L - cum_j}, then M^T dy summed into it
    float o[4][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < ncol / 16; ++ks) {
      uint32_t fb[4];
      ldmatrix_x4(fb, sh_b + la_t + 32 * ks);
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t f[4];
          ldmatrix_x4(f, sh_s1 + i * piece + lb_t + 32 * (jp * ldt + ks));
          mma_bf16(o[2 * jp], fb, f[0], f[1]);
          mma_bf16(o[2 * jp + 1], fb, f[2], f[3]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nt][e] *= s_edec[16 * wm + g8 + 8 * (e >> 1)];
    for (int ks = wm; ks < kC / 16; ++ks) {      // t >= j
      uint32_t af[kPieces][4];
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
        ldmatrix_x4_trans(af[i], sh_s0 + i * piece + lat_c + 32 * ks * kLdC);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sh_dy + lbt_c + 32 * (ks * kLdC + jp));
#pragma unroll
        for (int i = 0; i < kPieces; ++i) {
          mma_bf16(o[2 * jp], af[i], f[0], f[1]);
          mma_bf16(o[2 * jp + 1], af[i], f[2], f[3]);
        }
      }
    }
    float part[2] = {};
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int j = 16 * wm + g8 + 8 * r2;
      bf16* row = dx + ((row0 + j) * h + head) * p + p0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 32 * wn + 8 * nt + 2 * q4;
        const uint32_t xv =
            *reinterpret_cast<const uint32_t*>(s_x + j * kLdC + c);
        const uint32_t dv =
            *reinterpret_cast<const uint32_t*>(s_dy + j * kLdC + c);
        const float g0 = o[nt][2 * r2], g1 = o[nt][2 * r2 + 1];
        part[r2] = fmaf(g0, bf16_lo(xv), part[r2]);
        part[r2] = fmaf(g1, bf16_hi(xv), part[r2]);
        if (j < nrows)
          store_pair(row, c, p - p0,
                     fmaf(s_dt[j], g0, d_h * bf16_lo(dv)),
                     fmaf(s_dt[j], g1, d_h * bf16_hi(dv)));
      }
      const float ps = quad_sum(part[r2]);
      if (q4 == 0) s_dp[wn * kC + j] = ps;
    }
    __syncthreads();
    if (tid < kC) s_ddt[tid] += s_dp[tid] + s_dp[kC + tid];
  }
  __syncthreads();
  if (tid < nrows)
    ddt[(row0 + tid) * h + head] = fmaf(a[head], s_dla[tid], s_ddt[tid]);
  if (tid == 0) {
    float sa = 0.0f;
    for (int i = 0; i < kC; ++i) sa = fmaf(s_dt[i], s_dla[i], sa);
    dap[(size_t)bh * nc + chunk] = sa;
    ddp[(size_t)bh * nc + chunk] = s_red[18];
  }
}

// Backward phase 3: one block per (chunk, b, h), all of P in 64-column
// tiles.  Writes dx and ddt for the chunk's steps, and f32 partials that
// ssd_bwd_reduce sums: dB and dC per head [B, H, S, N], da and dD per
// chunk [B, H, NC].  NPF as in the forward.  The bf16 N = 64 instance
// (zamba2's) runs two blocks per SM; the others one.
template <typename T, int NPF>
__global__ void __launch_bounds__(
    kThreads, sizeof(T) == 2 && NPF == 64 ? 2 : 1) ssd_bwd_chunk_grad(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const void* __restrict__ dskip, int d_bf16,
    const T* __restrict__ dy, const float* __restrict__ states,
    const float* __restrict__ dstates, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dbp,
    float* __restrict__ dcp, float* __restrict__ dap,
    float* __restrict__ ddp, int s, int h, int p, int n, int nc, bool vec) {
  if constexpr (sizeof(T) == 2)
    chunk_grad_tc<NPF>(x, dt, a, bm, cm, dskip, d_bf16, dy, states, dstates,
                       dx, ddt, dbp, dcp, dap, ddp, s, h, p, n, nc, vec);
  else
    chunk_grad_fma<NPF>(x, dt, a, bm, cm, dskip, d_bf16, dy, states, dstates,
                        dx, ddt, dbp, dcp, dap, ddp, s, h, p, n, nc, vec);
}

// Backward phase 2: per (b, h, p, n), from the last chunk to the first:
// the gradient of the state leaving chunk c is written over its increment,
// then G_{c-1} = exp(clast_c) G_c + inc_c; dstate = G_{-1} (where wanted).
// Chunks go kAhead at a time, as in phase 2 of the forward, and the loads
// of the next kAhead are issued before the current ones are written.
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_scan(
    const float* __restrict__ dstate_out, float* __restrict__ dds,
    const float* __restrict__ clast, float* __restrict__ dstate, int nbh,
    int pn, int nc) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)nbh * pn) return;
  const size_t bh = e / pn, rem = e - bh * pn;
  float g = dstate_out != nullptr ? dstate_out[e] : 0.0f;
  float* d = dds + bh * nc * pn + rem;
  const float* cl = clast + bh * nc;
  constexpr int kAhead = 8;          // chunks whose loads are in flight
  float inc[kAhead], dec[kAhead];
  auto fetch = [&](int c1, float (&in)[kAhead], float (&de)[kAhead]) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (c1 - i >= 0) {
        in[i] = d[(size_t)(c1 - i) * pn];
        de[i] = cl[c1 - i];
      }
  };
  fetch(nc - 1, inc, dec);
  for (int c1 = nc - 1; c1 >= 0; c1 -= kAhead) {
    float inc2[kAhead], dec2[kAhead];
    fetch(c1 - kAhead, inc2, dec2);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c1 - i >= 0) {
        d[(size_t)(c1 - i) * pn] = g;
        g = fmaf(expf(dec[i]), g, inc[i]);
      }
      inc[i] = inc2[i];
      dec[i] = dec2[i];
    }
  }
  if (dstate != nullptr) dstate[e] = g;
}

// Backward phase 4: dB and dC summed over the heads in index order, one
// thread per (b, t, n), rounded to the operands' type once; then one
// thread per head sums da and dD over (b, chunk) in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(
    const float* __restrict__ dbp, const float* __restrict__ dcp,
    const float* __restrict__ dap, const float* __restrict__ ddp,
    T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
    void* __restrict__ dd, int d_bf16, int batch, int s, int h, int n,
    int nc) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t sn = (size_t)s * n, total = (size_t)batch * sn;
  if (e < total) {
    const size_t b = e / sn, rem = e - b * sn;
    const float* pb = dbp + b * h * sn + rem;
    const float* pc = dcp + b * h * sn + rem;
    float sb = 0.0f, scc = 0.0f;
    for (int hh = 0; hh < h; ++hh) {
      sb += pb[hh * sn];
      scc += pc[hh * sn];
    }
    store1(db + e, sb);
    store1(dc + e, scc);
  } else if (e < total + h) {
    const int hh = (int)(e - total);
    float sa = 0.0f, sd = 0.0f;
    for (int b = 0; b < batch; ++b)
      for (int c = 0; c < nc; ++c) {
        const size_t i = ((size_t)b * h + hh) * nc + c;
        sa += dap[i];
        sd += ddp[i];
      }
    da[hh] = sa;
    if (d_bf16)
      store1(static_cast<bf16*>(dd) + hh, sd);
    else
      static_cast<float*>(dd)[hh] = sd;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The kernels' shared-memory limits, raised once per instance to what the
// widest N needs (thread-safe: a function-local static).
template <typename T, int NPF>
cudaError_t configure() {
  static const cudaError_t err = [] {
    const int np = NPF > 0 ? NPF : kMaxState;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_state<T, NPF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_state_bytes(np));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_output<T, NPF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_output_bytes<T>(np));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_output<T, NPF>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T, int NPF>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const void* d, int d_bf16,
                   const float* state0, void* y, float* state_out, float* ds,
                   float* clast, int batch, int s, int h, int p, int n,
                   cudaStream_t stream) {
  cudaError_t err = configure<T, NPF>();
  if (err != cudaSuccess) return err;
  const int np = round16(n);
  const int nc = (s + kC - 1) / kC, nbh = batch * h;
  const bool vec = n % 8 == 0 && p % 8 == 0 && aligned16(x) &&
                   aligned16(bm) && aligned16(cm);
  const dim3 grid(nc, nbh, (p + kPB - 1) / kPB);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);

  ssd_chunk_state<T, NPF><<<grid, kThreads, smem_state_bytes(np), stream>>>(
      xt, dt, a, bt, ds, clast, s, h, p, n, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n2 = (size_t)nbh * p * n;
  ssd_state_scan<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(state0, ds, clast, state_out, nbh, p * n, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_chunk_output<T, NPF>
      <<<grid, kThreads, smem_output_bytes<T>(np), stream>>>(
          xt, dt, a, bt, static_cast<const T*>(cm), d, d_bf16, ds,
          static_cast<T*>(y), s, h, p, n, nc, vec);
  return cudaGetLastError();
}

// N = 64 (zamba2) takes the instances with the state width fixed at
// compile time; any other N the general ones.
template <typename T>
cudaError_t launch_any(const void* x, const float* dt, const float* a,
                       const void* bm, const void* cm, const void* d,
                       int d_bf16, const float* state0, void* y,
                       float* state_out, float* ds, float* clast, int batch,
                       int s, int h, int p, int n, cudaStream_t stream) {
  if (n == 64)
    return launch<T, 64>(x, dt, a, bm, cm, d, d_bf16, state0, y, state_out,
                         ds, clast, batch, s, h, p, n, stream);
  return launch<T, 0>(x, dt, a, bm, cm, d, d_bf16, state0, y, state_out, ds,
                      clast, batch, s, h, p, n, stream);
}


// The backward's shared-memory limits, raised once per instance; the
// chunk gradients prefer the largest shared-memory carveout, which holds
// two blocks of the bf16 N = 64 instance on an SM.
template <typename T, int NPF>
cudaError_t configure_bwd() {
  static const cudaError_t err = [] {
    const int np = NPF > 0 ? NPF : kMaxState;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_state_inc<T, NPF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_state_bytes(np));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_grad<T, NPF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bwd_bytes<T>(round64(np)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_grad<T, NPF>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

// Blocks per SM of the backward's four kernels, in launch order, at the
// shared memory a call with state width n gives them.
template <typename T, int NPF>
cudaError_t bwd_occupancy(int n, int* blocks) {
  cudaError_t e = configure_bwd<T, NPF>();
  const int np = round16(n);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], ssd_bwd_state_inc<T, NPF>, kThreads,
        smem_state_bytes(np));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], ssd_bwd_state_scan, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[2], ssd_bwd_chunk_grad<T, NPF>, kThreads,
        smem_bwd_bytes<T>(round64(np)));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[3], ssd_bwd_reduce<T>, kThreads, 0);
  return e;
}

// Floats of f32 scratch the backward takes, in this order: the state's
// gradient per chunk dds [B, H, NC, P, N], clast [B, H, NC], the per-head
// partials of dB and dC [B, H, S, N] each, those of da and dD [B, H, NC]
// each.
size_t bwd_scratch_floats(int batch, int s, int h, int p, int n) {
  const size_t nc = (s + kC - 1) / kC, nbh = (size_t)batch * h;
  return nbh * nc * p * n + nbh * nc + 2 * nbh * s * n + 2 * nbh * nc;
}

template <typename T, int NPF>
cudaError_t launch_bwd(const void* x, const float* dt, const float* a,
                       const void* bm, const void* cm, const void* d,
                       int d_bf16, const void* dy, const float* states,
                       const float* dstate_out, void* dx, float* ddt,
                       float* da, void* db, void* dc, void* dd,
                       float* dstate, float* scratch, int batch, int s,
                       int h, int p, int n, cudaStream_t stream) {
  cudaError_t err = configure_bwd<T, NPF>();
  if (err != cudaSuccess) return err;
  const int np = round16(n);
  const int nc = (s + kC - 1) / kC, nbh = batch * h;
  float* dds = scratch;
  float* clast = dds + (size_t)nbh * nc * p * n;
  float* dbp = clast + (size_t)nbh * nc;
  float* dcp = dbp + (size_t)nbh * s * n;
  float* dap = dcp + (size_t)nbh * s * n;
  float* ddp = dap + (size_t)nbh * nc;
  const bool vec = n % 8 == 0 && p % 8 == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(bm) && aligned16(cm) &&
                   aligned16(states) && aligned16(dds);
  const T* dyt = static_cast<const T*>(dy);
  const T* ct = static_cast<const T*>(cm);

  ssd_bwd_state_inc<T, NPF>
      <<<dim3(nc, nbh, (p + kPB - 1) / kPB), kThreads, smem_state_bytes(np),
         stream>>>(dyt, dt, a, ct, dds, clast, s, h, p, n, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n2 = (size_t)nbh * p * n;
  ssd_bwd_state_scan<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(dstate_out, dds, clast, dstate, nbh,
                                    p * n, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_chunk_grad<T, NPF>
      <<<dim3(nc, nbh), kThreads, smem_bwd_bytes<T>(round64(np)), stream>>>(
          static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), ct, d,
          d_bf16, dyt, states, dds, static_cast<T*>(dx), ddt, dbp, dcp, dap,
          ddp, s, h, p, n, nc, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t n4 = (size_t)batch * s * n + h;
  ssd_bwd_reduce<T><<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads,
                      0, stream>>>(dbp, dcp, dap, ddp, static_cast<T*>(db),
                                   static_cast<T*>(dc), da, dd, d_bf16,
                                   batch, s, h, n, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_any(const void* x, const float* dt, const float* a,
                           const void* bm, const void* cm, const void* d,
                           int d_bf16, const void* dy, const float* states,
                           const float* dstate_out, void* dx, float* ddt,
                           float* da, void* db, void* dc, void* dd,
                           float* dstate, float* scratch, int batch, int s,
                           int h, int p, int n, cudaStream_t stream) {
  if (n == 64)
    return launch_bwd<T, 64>(x, dt, a, bm, cm, d, d_bf16, dy, states,
                             dstate_out, dx, ddt, da, db, dc, dd, dstate,
                             scratch, batch, s, h, p, n, stream);
  return launch_bwd<T, 0>(x, dt, a, bm, cm, d, d_bf16, dy, states,
                          dstate_out, dx, ddt, da, db, dc, dd, dstate,
                          scratch, batch, s, h, p, n, stream);
}

}  // namespace

extern "C" {

int mamba2_ssd_max_state() { return kMaxState; }
int mamba2_ssd_chunk() { return kC; }

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y alike); d_dtype the same
// code for d (float32, or x's type).  ds [B, H, NC, P, N] and clast
// [B, H, NC]: f32 scratch, NC = ceil(S / 64).
int mamba2_ssd_fwd(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, const void* d,
                   const void* state0, void* y, void* state_out, void* ds,
                   void* clast, int batch, int s, int h, int p, int n,
                   int dtype, int d_dtype, void* stream) {
  if (n < 1 || n > kMaxState || p < 1 || h < 1 || batch < 1 || s < 1 ||
      batch * h > 65535 || dtype < 0 || dtype > 1 ||
      (d_dtype != 0 && d_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  float* dsf = static_cast<float*>(ds);
  float* cl = static_cast<float*>(clast);
  const cudaError_t err =
      dtype == 0 ? launch_any<float>(x, dtf, af, bm, cm, d, 0, s0, y, so,
                                     dsf, cl, batch, s, h, p, n, st)
                 : launch_any<bf16>(x, dtf, af, bm, cm, d, d_dtype, s0, y,
                                    so, dsf, cl, batch, s, h, p, n, st);
  return (int)err;
}

size_t mamba2_ssd_bwd_scratch(int batch, int s, int h, int p, int n) {
  return bwd_scratch_floats(batch, s, h, p, n);
}

// blocks[0..3]: how many blocks of each of the backward's four kernels
// (state increments, reverse scan, chunk gradients, reduction) one SM
// holds at once, for x's dtype code and state width n.
int mamba2_ssd_bwd_blocks_per_sm(int dtype, int n, int* blocks) {
  if (n < 1 || n > kMaxState || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      dtype == 0 ? (n == 64 ? bwd_occupancy<float, 64>(n, blocks)
                            : bwd_occupancy<float, 0>(n, blocks))
                 : (n == 64 ? bwd_occupancy<bf16, 64>(n, blocks)
                            : bwd_occupancy<bf16, 0>(n, blocks));
  return (int)err;
}

// The gradient of mamba2_ssd_fwd: dx, db, dc in x's type, ddt, da and
// dstate in f32, dd in d's type.  states: the forward's ds after the call
// (each chunk's starting state); dstate_out and dstate may be null (zeros;
// not written).  scratch: mamba2_ssd_bwd_scratch(...) floats of f32.
int mamba2_ssd_bwd(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, const void* d,
                   const void* dy, const void* states,
                   const void* dstate_out, void* dx, void* ddt, void* da,
                   void* db, void* dc, void* dd, void* dstate, void* scratch,
                   int batch, int s, int h, int p, int n, int dtype,
                   int d_dtype, void* stream) {
  if (n < 1 || n > kMaxState || p < 1 || h < 1 || batch < 1 || s < 1 ||
      batch * h > 65535 || dtype < 0 || dtype > 1 ||
      (d_dtype != 0 && d_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* sts = static_cast<const float*>(states);
  const float* dso = static_cast<const float*>(dstate_out);
  float* ddtf = static_cast<float*>(ddt);
  float* daf = static_cast<float*>(da);
  float* dsf = static_cast<float*>(dstate);
  float* scr = static_cast<float*>(scratch);
  const cudaError_t err =
      dtype == 0
          ? launch_bwd_any<float>(x, dtf, af, bm, cm, d, 0, dy, sts, dso, dx,
                                  ddtf, daf, db, dc, dd, dsf, scr, batch, s,
                                  h, p, n, st)
          : launch_bwd_any<bf16>(x, dtf, af, bm, cm, d, d_dtype, dy, sts,
                                 dso, dx, ddtf, daf, db, dc, dd, dsf, scr,
                                 batch, s, h, p, n, st);
  return (int)err;
}

}  // extern "C"
