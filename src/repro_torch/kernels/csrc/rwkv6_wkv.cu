// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_scan.py (_wkv_kernel /
// rwkv6_wkv) together with the bonus term its wrapper adds.  Per (batch,
// head), with S the [K, V] state carried from chunk to chunk and cum the
// running sum of log w inside a chunk (cum_{-1} = 0):
//   out_t = sum_k r_t[k] e^{cum_{t-1,k}} S[k,:]
//         + sum_{j<t} (sum_k r_t[k] k_j[k] e^{cum_{t-1,k} - cum_{j,k}}) v_j
//         + (sum_k r_t[k] u[k] k_t[k]) v_t
//   S'    = e^{cum_last} o S + sum_j (k_j o e^{cum_last - cum_j}) v_j^T
// Every exponent is <= 0, so the result is finite for every w in (0, 1]
// (the Pallas body's exp(-cum) overflows once a chunk's log-decays sum
// below about -88).  The bonus is summed with the rest in f32 and the
// output rounded to r's type once.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/rwkv6_wkv.py).  The entry launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
//
// Layout: r, k [B, S, H, K] and v [B, S, H, V] in one type (f32 or bf16),
// w [B, S, H, K] f32, u [H, K] in r's type, state0 [B, H, K, V] f32 or null
// (zeros); out [B, S, H, V] in r's type, state_out [B, H, K, V] f32.
//
// What bounds it on the H100.  At rwkv6-3b's prefill (S = 1024, H = 40,
// K = V = 64, bf16) the function reads and writes ~32 MB (w is f32), ~10
// us at 3.35 TB/s, and needs ~0.84 GFLOP of f32 work (the recurrence:
// five operations per (t, h, k, v): decay, outer product, add, and the
// r . state multiply-add), ~13 us on the CUDA cores, so the bound is the
// f32 rate.  This version is far above it: the decay-weighted score
// tile takes one exponential per (t, j, k) pair, since a factored
// e^{cum_{t-1}} e^{-cum_j} overflows; each V slice recomputes that tile;
// and every product runs in f32 on the CUDA cores from shared memory.
//
// Design.  The TPU kernel carries S through a sequential grid and an
// aliased output; on Hopper blocks run in no order, so the chunk loop is
// inside the block.  A block owns one (batch, head) and a slice of 16
// columns of V (columns of S and of the output depend only on the same
// column of v, so the split is exact and the grid is B H V/16 blocks, 160
// at rwkv6-3b's widths, not B H = 40), and walks chunks of 64 steps in
// order with its [K, 16] slice of S in shared memory.  The result does not
// depend on the chunk length beyond rounding.  The score tile's diagonal
// holds the bonus r_t . (u o k_t), so out is one pass over the tile.
// Decays are kept in log2 units (exp2f).  Steps past the end of the
// sequence carry w = 1 and k = v = r = 0: they neither decay nor feed the
// state, and their output is not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kC = 64;           // chunk length (steps)
constexpr int kVS = 16;          // state columns per block
constexpr int kThreads = 256;
constexpr int kSeg = 4;          // segments of the cumulative-sum pass
constexpr int kMaxK = 128;       // widest K taken (rwkv6-3b: 64)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int kd) {
  const size_t ldk = kd + 1;
  return sizeof(float) * (3 * kC * ldk + kC * (kC + 1) + kC * kVS +
                          kd * kVS + kSeg * kd + kd);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rwkv6_wkv_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const T* __restrict__ u, const float* __restrict__ state0,
    T* __restrict__ out, float* __restrict__ state_out, int s, int h, int kd,
    int vd) {
  extern __shared__ float smem[];
  const int ldk = kd + 1;            // odd row stride: conflict-free columns
  const int ldc = kC + 1;
  float* s_r = smem;                 // [kC][ldk]  r, then r e^{cum_{t-1}}
  float* s_k = s_r + kC * ldk;       // [kC][ldk]  k, then k e^{cum_last - cum_j}
  float* s_c = s_k + kC * ldk;       // [kC][ldk]  log2 w, then its running sum
  float* s_a = s_c + kC * ldk;       // [kC][ldc]  score tile, bonus on the diagonal
  float* s_v = s_a + kC * ldc;       // [kC][kVS]  v slice
  float* s_s = s_v + kC * kVS;       // [kd][kVS]  state slice
  float* s_tot = s_s + kd * kVS;     // [kSeg][kd] segment sums of log2 w
  float* s_u = s_tot + kSeg * kd;    // [kd]       u

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / h, head = bh - b * h;
  const int v0 = blockIdx.x * kVS;
  const size_t bs = (size_t)b * s;

  for (int e = tid; e < kd * kVS; e += kThreads) {
    const int row = e / kVS, col = e - row * kVS;
    const int gv = v0 + col;
    s_s[e] = (state0 != nullptr && gv < vd)
                 ? state0[((size_t)bh * kd + row) * vd + gv]
                 : 0.0f;
  }
  for (int e = tid; e < kd; e += kThreads)
    s_u[e] = to_f32(u[(size_t)head * kd + e]);

  for (int t0 = 0; t0 < s; t0 += kC) {
    __syncthreads();   // the last chunk's readers and state writes done
    for (int e = tid; e < kC * kd; e += kThreads) {
      const int t = e / kd, c = e - t * kd;
      const bool in = t0 + t < s;
      const size_t gi = ((bs + t0 + t) * h + head) * kd + c;
      s_r[t * ldk + c] = in ? to_f32(r[gi]) : 0.0f;
      s_k[t * ldk + c] = in ? to_f32(k[gi]) : 0.0f;
      s_c[t * ldk + c] = in ? log2f(fmaxf(w[gi], 1e-30f)) : 0.0f;
    }
    for (int e = tid; e < kC * kVS; e += kThreads) {
      const int t = e / kVS, c = e - t * kVS;
      const int gv = v0 + c;
      s_v[e] = (t0 + t < s && gv < vd)
                   ? to_f32(v[((bs + t0 + t) * h + head) * vd + gv])
                   : 0.0f;
    }
    __syncthreads();

    // running sum of log2 w over the chunk: each thread scans 16 steps of
    // one column, then adds the sums of the segments before its own
    constexpr int kLen = kC / kSeg;
    for (int e = tid; e < kSeg * kd; e += kThreads) {
      const int seg = e / kd, c = e - seg * kd;
      float acc = 0.0f;
      for (int t = seg * kLen; t < (seg + 1) * kLen; ++t) {
        acc += s_c[t * ldk + c];
        s_c[t * ldk + c] = acc;
      }
      s_tot[seg * kd + c] = acc;
    }
    __syncthreads();
    for (int e = tid; e < kSeg * kd; e += kThreads) {
      const int seg = e / kd, c = e - seg * kd;
      float off = 0.0f;
      for (int q = 0; q < seg; ++q) off += s_tot[q * kd + c];
      if (seg > 0)
        for (int t = seg * kLen; t < (seg + 1) * kLen; ++t)
          s_c[t * ldk + c] += off;
    }
    __syncthreads();

    {   // A[t][j] = sum_k r_t k_j 2^{c_{t-1} - c_j} for j < t;
        // A[t][t] = sum_k r_t u k_t; 0 above the diagonal
      const int tx = tid & 15, ty = tid >> 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int c = 0; c < kd; ++c) {
        float rv[4], cp[4], kv[4], cj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          rv[i] = s_r[t * ldk + c];
          cp[i] = t > 0 ? s_c[(t - 1) * ldk + c] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = tx + 16 * j;
          kv[j] = s_k[jj * ldk + c];
          cj[j] = s_c[jj * ldk + c];
        }
        const float uc = s_u[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = tx + 16 * j;
            if (jj < t)
              acc[i][j] = fmaf(rv[i] * kv[j], exp2f(cp[i] - cj[j]),
                               acc[i][j]);
            else if (jj == t)
              acc[i][j] = fmaf(rv[i] * kv[j], uc, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_a[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();

    // decayed operands: r_t 2^{c_{t-1}} (readout of S) and
    // k_j 2^{c_last - c_j} (update of S); both exponents <= 0
    for (int e = tid; e < kC * kd; e += kThreads) {
      const int t = e / kd, c = e - t * kd;
      const float clast = s_c[(kC - 1) * ldk + c];
      const float ct = s_c[t * ldk + c];
      const float cprev = t > 0 ? s_c[(t - 1) * ldk + c] : 0.0f;
      s_r[t * ldk + c] *= exp2f(cprev);
      s_k[t * ldk + c] *= exp2f(clast - ct);
    }
    __syncthreads();

    {   // out_t = (r_t 2^{c_{t-1}}) . S + sum_{j <= t} A[t][j] v_j
      const int vc = tid & 15, ty = tid >> 4;
      const int gv = v0 + vc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        float acc = 0.0f;
        for (int c = 0; c < kd; ++c)
          acc = fmaf(s_r[t * ldk + c], s_s[c * kVS + vc], acc);
        for (int j = 0; j <= t; ++j)
          acc = fmaf(s_a[t * ldc + j], s_v[j * kVS + vc], acc);
        if (t0 + t < s && gv < vd)
          store(&out[((bs + t0 + t) * h + head) * vd + gv], acc);
      }
    }
    __syncthreads();

    // S = 2^{c_last} o S + sum_j (k_j 2^{c_last - c_j}) v_j^T
    for (int e = tid; e < kd * kVS; e += kThreads) {
      const int c = e / kVS, vc = e - c * kVS;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < kC; ++j)
        acc = fmaf(s_k[j * ldk + c], s_v[j * kVS + vc], acc);
      s_s[e] = exp2f(s_c[(kC - 1) * ldk + c]) * s_s[e] + acc;
    }
  }
  __syncthreads();

  for (int e = tid; e < kd * kVS; e += kThreads) {
    const int row = e / kVS, col = e - row * kVS;
    const int gv = v0 + col;
    if (gv < vd) state_out[((size_t)bh * kd + row) * vd + gv] = s_s[e];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const void* u, const float* state0,
                   void* out, float* state_out, int batch, int s, int h,
                   int kd, int vd, cudaStream_t stream) {
  const size_t bytes = smem_bytes(kd);
  auto kernel = rwkv6_wkv_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((vd + kVS - 1) / kVS, batch * h);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, static_cast<const T*>(u), state0,
      static_cast<T*>(out), state_out, s, h, kd, vd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int rwkv6_wkv_max_k() { return kMaxK; }

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, u and out alike)
int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                  const void* w, const void* u, const void* state0,
                  void* out, void* state_out, int batch, int s, int h,
                  int kd, int vd, int dtype, void* stream) {
  if (kd < 1 || kd > kMaxK || vd < 1 || h < 1 || batch < 1 || s < 0 ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  const cudaError_t err =
      dtype == 0 ? launch<float>(r, k, v, wf, u, s0, out, so, batch, s, h,
                                 kd, vd, st)
                 : launch<__nv_bfloat16>(r, k, v, wf, u, s0, out, so, batch,
                                         s, h, kd, vd, st);
  return (int)err;
}

}  // extern "C"
