// Mamba2 state-space-dual (SSD) scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/mamba2_ssd.py (_ssd_kernel /
// mamba2_ssd).  Per (batch, head), with xdt = dt x and la = dt A, and cum
// the running sum of la inside a chunk:
//   y_t  = exp(cum_t) C_t . S + sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) xdt_j
//   S'   = exp(cum_last) S + sum_j exp(cum_last - cum_j) xdt_j B_j^T
// with S the [P, N] state carried from chunk to chunk.  The D-skip term is
// stateless and added by the wrapper, as in the reference; y leaves the
// kernel in f32 so that the wrapper rounds y + D x to x's type once (a
// bf16 y rounded before the add would cancel against D x to two steps of
// the addends' size).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/mamba2_ssd.py).  The entry launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// Layout: x [B, S, H, P] (f32 or bf16), dt [B, S, H] f32, a [H] f32,
// b, c [B, S, N] in x's type (shared by every head: read by batch index,
// never expanded per head), state0 [B, H, P, N] f32 or null (zeros);
// y [B, S, H, P] f32, state_out [B, H, P, N] f32.
//
// What bounds it on the H100.  At zamba2's prefill (S = 1024, H = 80,
// P = N = 64, bf16) the function reads and writes ~24 MB and needs ~1.7
// GFLOP of f32 work (the recurrence: five operations per (t, h, p, n)), so
// the bound is the f32 CUDA-core rate, ~25 us.  This version does the
// chunked form in f32 on the CUDA cores, operands from shared memory: it
// is bound by shared-memory loads, above the bound by the chunked form's
// extra work (C B^T per chunk) and the loads.
//
// Design.  The TPU kernel carries S through a sequential grid and an
// aliased output; on Hopper blocks run in no order, so the chunk loop is
// inside the block.  A block owns one (batch, head) and a slice of 16 rows
// p of the state (rows of S are independent, so the split is exact and the
// grid is B H P/16 blocks, 320 at zamba2's widths, not B H = 80), and walks
// sub-chunks of 64 steps in order with its [16, N] slice of S in shared
// memory.  The result does not depend on the sub-chunk length beyond
// rounding; 64 keeps the decayed [64, 64] C B^T tile in shared memory
// (a 256 x 256 f32 tile would not fit).  dt is folded in here (no xdt or la
// pass in the wrapper).  The decay exp(cum_t - cum_j) is taken only where
// j <= t: above the diagonal the exponent is positive and can overflow, and
// inf * 0 would be NaN.  Steps past the end of the sequence carry dt = 0:
// they neither decay nor feed the state.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kL = 64;           // sub-chunk length (steps)
constexpr int kPS = 16;          // state rows per block
constexpr int kThreads = 256;
constexpr int kMaxState = 128;   // widest N taken (zamba2: 64)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
size_t smem_bytes(int n) {
  const size_t ldn = n + 1;
  return sizeof(float) * (2 * kL * ldn + kPS * ldn + kL * (kL + 1) +
                          kL * kPS + 3 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba2_ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ state0,
    float* __restrict__ y, float* __restrict__ state_out, int s, int h,
    int p, int n) {
  extern __shared__ float smem[];
  const int ldn = n + 1;            // odd row stride: conflict-free columns
  const int ldg = kL + 1;
  float* s_b = smem;                // [kL][ldn]   B of the sub-chunk
  float* s_c = s_b + kL * ldn;      // [kL][ldn]   C
  float* s_s = s_c + kL * ldn;      // [kPS][ldn]  state slice
  float* s_g = s_s + kPS * ldn;     // [kL][ldg]   decayed, masked C B^T
  float* s_x = s_g + kL * ldg;      // [kL][kPS]   xdt
  float* s_cum = s_x + kL * kPS;    // [kL]        running sum of dt A
  float* s_w = s_cum + kL;          // [kL]        exp(cum_last - cum_j)
  float* s_e = s_w + kL;            // [kL]        exp(cum_t)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / h, head = bh - b * h;
  const int p0 = blockIdx.x * kPS;
  const float a_h = a[head];
  const size_t bs = (size_t)b * s;

  for (int e = tid; e < kPS * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    const int gp = p0 + r;
    s_s[r * ldn + c] = (state0 != nullptr && gp < p)
                           ? state0[((size_t)bh * p + gp) * n + c]
                           : 0.0f;
  }

  for (int t0 = 0; t0 < s; t0 += kL) {
    __syncthreads();   // the last sub-chunk's readers and state writes done
    for (int e = tid; e < kL * n; e += kThreads) {
      const int r = e / n, c = e - r * n;
      const int t = t0 + r;
      const size_t gi = (bs + t) * n + c;
      s_b[r * ldn + c] = t < s ? to_f32(bm[gi]) : 0.0f;
      s_c[r * ldn + c] = t < s ? to_f32(cm[gi]) : 0.0f;
    }
    for (int e = tid; e < kL * kPS; e += kThreads) {
      const int r = e / kPS, c = e - r * kPS;
      const int t = t0 + r, gp = p0 + c;
      float v = 0.0f;
      if (t < s && gp < p) {
        const size_t row = (bs + t) * h + head;
        v = to_f32(x[row * p + gp]) * dt[row];
      }
      s_x[r * kPS + c] = v;
    }
    if (tid < 32) {   // inclusive scan of dt A, two steps per lane
      const int t = t0 + 2 * tid;
      const float la0 = t < s ? dt[(bs + t) * h + head] * a_h : 0.0f;
      const float la1 = t + 1 < s ? dt[(bs + t + 1) * h + head] * a_h : 0.0f;
      const float pair = la0 + la1;
      float inc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += u;
      }
      const float prev = __shfl_up_sync(0xffffffffu, inc, 1);
      const float before = tid == 0 ? 0.0f : prev;
      s_cum[2 * tid] = before + la0;
      s_cum[2 * tid + 1] = before + la0 + la1;
    }
    __syncthreads();

    const float cum_last = s_cum[kL - 1];
    if (tid < kL) {
      s_w[tid] = expf(cum_last - s_cum[tid]);
      s_e[tid] = expf(s_cum[tid]);
    }
    {   // G[t][j] = (C_t . B_j) exp(cum_t - cum_j) for j <= t, else 0
      const int tx = tid & 15, ty = tid >> 4;
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = s_c[(ty + 16 * i) * ldn + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_b[(tx + 16 * j) * ldn + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = tx + 16 * j;
          s_g[t * ldg + jj] =
              jj <= t ? g[i][j] * expf(s_cum[t] - s_cum[jj]) : 0.0f;
        }
      }
    }
    __syncthreads();

    {   // y_t = exp(cum_t) C_t . S + sum_{j <= t} G[t][j] xdt_j
      const int pc = tid & 15, ty = tid >> 4;
      const int gp = p0 + pc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        float inter = 0.0f;
#pragma unroll 4
        for (int c = 0; c < n; ++c)
          inter = fmaf(s_c[t * ldn + c], s_s[pc * ldn + c], inter);
        float intra = 0.0f;
        for (int j = 0; j <= t; ++j)
          intra = fmaf(s_g[t * ldg + j], s_x[j * kPS + pc], intra);
        if (t0 + t < s && gp < p)
          y[((bs + t0 + t) * h + head) * p + gp] = inter * s_e[t] + intra;
      }
    }
    __syncthreads();

    {   // S = exp(cum_last) S + sum_j exp(cum_last - cum_j) xdt_j B_j
      const float dec = expf(cum_last);
      for (int e = tid; e < kPS * n; e += kThreads) {
        const int r = e / n, c = e - r * n;
        float acc = 0.0f;
#pragma unroll 4
        for (int j = 0; j < kL; ++j)
          acc = fmaf(s_w[j] * s_x[j * kPS + r], s_b[j * ldn + c], acc);
        s_s[r * ldn + c] = dec * s_s[r * ldn + c] + acc;
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < kPS * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    const int gp = p0 + r;
    if (gp < p) state_out[((size_t)bh * p + gp) * n + c] = s_s[r * ldn + c];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* state0,
                   float* y, float* state_out, int batch, int s, int h, int p,
                   int n, cudaStream_t stream) {
  const size_t bytes = smem_bytes(n);
  auto kernel = mamba2_ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kPS - 1) / kPS, batch * h);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), state0, y, state_out, s, h, p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mamba2_ssd_max_state() { return kMaxState; }

// dtype: 0 = float32, 1 = bfloat16 (x, b and c alike; y is float32)
int mamba2_ssd_fwd(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, const void* state0,
                   void* y, void* state_out, int batch, int s, int h, int p,
                   int n, int dtype, void* stream) {
  if (n < 1 || n > kMaxState || p < 1 || h < 1 || batch < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* s0 = static_cast<const float*>(state0);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, dtf, af, bm, cm, s0, yf, so, batch, s,
                                 h, p, n, st)
                 : launch<__nv_bfloat16>(x, dtf, af, bm, cm, s0, yf, so,
                                         batch, s, h, p, n, st);
  return (int)err;
}

}  // extern "C"
