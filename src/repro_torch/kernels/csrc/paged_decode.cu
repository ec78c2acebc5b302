// Paged flash decode for Hopper (sm_90a): one query token per lane
// against a shared KV page pool.
//
// Replaces the TPU kernel decode_attention.py:_paged_decode_kernel
// (src/repro/kernels/decode_attention.py, pl.pallas_call at line 220).
// It computes what that kernel computes, not a block-by-block copy:
//   q (B, H, hd); k/v pools (P, KV, ps, hd); tables (B, W) int32;
//   lengths (B,) int32; out (B, H, hd) in q's dtype.
//   Page j of lane b is tables[b, j] clamped to [0, P-1].  The G = H/KV
//   query heads of one KV head are handled together.  Softmax is online
//   in f32, masked to lengths[b]; pages at or past ceil(len/ps) are never
//   read.  A lane of length 0 writes zeros.
//
// What bounds it on an H100: the bytes of K/V it must read,
//   2 * sum_b len_b * KV * hd * sizeof(dtype),
// at 3.35 TB/s (its arithmetic, 4 * sum_b len_b * H * hd flops, is far
// below the tensor-core rate).  At the main path's shapes that is well
// under a microsecond of memory time.
//
// What this design does about that bound: nothing yet.  One thread block
// per (lane, kv head), so only B * KV = 16 blocks run on 132 SMs, each
// walking its pages in sequence: the kernel is bound by the latency of
// that walk, not by bytes.  Within the walk it keeps latency down: each
// thread loads 16-byte chunks of K and V and prefetches the next page's
// chunks into registers while the current page is computed; a token's
// scores are reduced across the threads holding its chunks with warp
// shuffles; one warp per query row updates the softmax.  A later change
// splits a lane's pages across blocks and merges the partial softmax
// states in a second pass.
//
// Built by repro_torch/kernels/decode_attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry points return the CUDA error of
// the launch (0 on success) and never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;   // 16-byte K (and V) chunks per thread/page

// 16 bytes of T as f32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void to_f32(const uint4& u, float* out) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = f[i];
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_f32(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory (all f32): q rows and their accumulators (G x hd each),
// one V page (ps x hd), the page's scores/probabilities (G x ps), and the
// running max, denominator and rescale factor per query row.
__host__ __device__ inline size_t smem_floats(int G, int ps, int hd) {
  return 2 * (size_t)G * hd + (size_t)ps * hd + (size_t)G * ps + 3 * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int G, int P, int ps, int hd, int W,
                    float scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + G * hd;
  float* v_s = acc_s + G * hd;
  float* s_s = v_s + ps * hd;
  float* m_s = s_s + G * ps;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = kThreads / 32;
  const int H = KV * G;
  // a page is ps * parts 16-byte chunks; chunk c holds elements
  // [part * VEC, part * VEC + VEC) of token c / parts.  parts is a power
  // of two <= 32, so the threads of one token sit in one warp.
  const int parts = hd / VEC;
  const int nchunks = ps * parts;

  const int len = lengths[b];
  int npages = len > 0 ? (len + ps - 1) / ps : 0;
  if (npages > W) npages = W;

  const size_t row0 = ((size_t)b * H + (size_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int* tbl = tables + (size_t)b * W;
  auto page_base = [&](int pj) -> size_t {
    int page = tbl[pj];
    page = page < 0 ? 0 : (page > P - 1 ? P - 1 : page);
    return ((size_t)page * KV + h) * (size_t)ps * hd;
  };
  uint4 k_reg[kMaxChunks];
  uint4 v_reg[kMaxChunks];
  auto load_page = [&](int pj) {
    const size_t base = page_base(pj);
    const uint4* kp = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vp = reinterpret_cast<const uint4*>(v_pages + base);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = tid + j * kThreads;
      if (c < nchunks) {
        k_reg[j] = kp[c];
        v_reg[j] = vp[c];
      }
    }
  };
  if (npages > 0) load_page(0);
  __syncthreads();

  for (int pj = 0; pj < npages; ++pj) {
    const int k_start = pj * ps;
    // V chunks to shared; scores from the K chunks held in registers
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = tid + j * kThreads;
      if (j * kThreads >= nchunks) break;        // uniform across the block
      const int token = c / parts;
      const int part = c % parts;
      float kf[VEC];
      if (c < nchunks) {
        float vf[VEC];
        Vec<T>::to_f32(v_reg[j], vf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v_s[c * VEC + i] = vf[i];
        Vec<T>::to_f32(k_reg[j], kf);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = 0.f;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * hd + part * VEC;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot += qg[i] * kf[i];
        for (int o = parts / 2; o > 0; o >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        if (part == 0 && c < nchunks) {
          s_s[g * ps + token] =
              (k_start + token < len) ? dot * scale : kNegInf;
        }
      }
    }
    // prefetch the next page while this one is finished
    if (pj + 1 < npages) load_page(pj + 1);
    __syncthreads();

    // online softmax, one warp per query row.  The page's first token is
    // always valid (k_start < len), so the new max is finite and masked
    // scores underflow to exactly 0.
    for (int g = warp; g < G; g += nwarps) {
      float* row = s_s + g * ps;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, row[t]);
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float e = expf(row[t] - mx);
        row[t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i % hd;
      const float* prow = s_s + g * ps;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < ps; ++t) a += prow[t] * v_s[t * hd + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    out[row0 + i] = from_f32<T>(acc_s[i] / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lengths, void* out, int B, int H,
           int KV, int P, int ps, int hd, int W, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = smem_floats(G, ps, hd) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, lengths, static_cast<T*>(out),
      KV, G, P, ps, hd, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
int repro_paged_decode(int dtype, const void* q, const void* k_pages,
                       const void* v_pages, const int* tables,
                       const int* lengths, void* out, int B, int H, int KV,
                       int P, int ps, int hd, int W, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k_pages, v_pages, tables, lengths, out, B, H, KV,
                         P, ps, hd, W, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, out,
                                 B, H, KV, P, ps, hd, W, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes one block needs, so the wrapper can refuse shapes
// that do not fit before it launches.
long long repro_paged_decode_smem_bytes(int G, int ps, int hd) {
  return (long long)(smem_floats(G, ps, hd) * sizeof(float));
}

// Most 16-byte chunks of one K (or V) page the kernel holds per thread.
int repro_paged_decode_max_chunks() { return kMaxChunks * kThreads; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
