// Causal (or full) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (_attn_kernel / flash_attention): online-softmax attention, K and V read
// through the kv-head index h / (H / Hkv) and never repeated, causal mask
// with diagonal offset skv - sq, Dv != Dh allowed, f32 softmax statistics
// and accumulator, output in the inputs' type (f32 or bf16).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/flash_attention.py).  The entry launches on
// the stream it is given, allocates nothing and returns cudaGetLastError().
//
// Layout: q [B, Sq, H, Dh], k [B, Skv, Hkv, Dh], v [B, Skv, Hkv, Dv],
// o [B, Sq, H, Dv], all contiguous: the kernel indexes the heads in place,
// so the wrapper transposes nothing.
//
// What bounds it on the H100.  At zamba2's prefill (S = 1024, H = 32,
// Dh = 80, bf16) the function moves ~21 MB and does ~5.4 GFLOP of
// products: at the bf16 tensor-core rate both take a few microseconds, so
// the bound is the tensor cores and HBM together.  This first version does
// the products on the CUDA cores in f32 (an FMA per multiply-add, operands
// from shared memory), so it is bound by shared-memory loads and FMA
// issue, tens of times above the bound; wgmma tiles fed by TMA are the
// next step (see PERF.md).
//
// Design.  One block of 256 threads owns a tile of 64 query rows of one
// (batch, head).  It stages the Q tile once (scaled by 1/sqrt(Dh), in f32)
// and walks the KV dimension in tiles of 64 rows, so shared memory stays
// O(tile) at any sequence length (the Pallas spec stages all of K and V per
// head, which does not fit in 227 KB once S reaches a few thousand).  KV
// tiles wholly above the causal diagonal are never read.  Each thread holds
// a 4 x 4 patch of the score tile and a 4 x (16 NJ) patch of the output
// accumulator, with rows ty + 16 i and columns tx + 16 j, so that the 16
// threads that share a row sit in one half-warp and the row max and row
// sum are shuffles.  Q and K rows are padded to Dh + 1 floats so that the
// 16 threads reading 16 K rows hit 16 banks.  Masked scores are -1e30 and
// their probabilities exactly 0, as in the reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 64;         // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// NJ: output columns per thread / 16, so 16 NJ >= Dv
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int h,
    int hkv, int dh, int dv, int causal, float scale) {
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
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) ob[row * o_row + col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int skv, int h, int hkv, int dh, int dv,
                   int causal, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dh, dv);
  auto kernel = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, hkv, dh, dv,
      causal, 1.0f / sqrtf((float)dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int sq, int skv, int h, int hkv, int dh, int dv,
                     int causal, cudaStream_t stream) {
  if (dv <= 64)
    return launch<T, 4>(q, k, v, o, b, sq, skv, h, hkv, dh, dv, causal,
                        stream);
  if (dv <= 128)
    return launch<T, 8>(q, k, v, o, b, sq, skv, h, hkv, dh, dv, causal,
                        stream);
  return launch<T, 16>(q, k, v, o, b, sq, skv, h, hkv, dh, dv, causal,
                       stream);
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return kMaxHeadDim; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike)
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int skv, int h, int hkv, int dh,
                        int dv, int causal, int dtype, void* stream) {
  if (dh < 1 || dh > kMaxHeadDim || dv < 1 || dv > kMaxHeadDim ||
      hkv < 1 || h % hkv != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (sq == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, b, sq, skv, h, hkv, dh, dv, causal, s)
          : dispatch<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, hkv, dh, dv,
                                    causal, s);
  return (int)err;
}

}  // extern "C"
