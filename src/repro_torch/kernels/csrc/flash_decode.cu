// Flash decode for Hopper (sm_90a): one query token per lane against a
// dense per-lane KV cache.
//
// Replaces the TPU kernel decode_attention.py:_decode_kernel
// (src/repro/kernels/decode_attention.py, pl.pallas_call at line 110).
// It computes what that kernel computes, not a block-by-block copy:
//   q (B, H, hd); k/v caches (B, KV, S, hd); lengths (B,) int32;
//   out (B, H, hd) in q's dtype.  Lane b attends the first
//   min(lengths[b], S) positions of its cache; tiles past that are never
//   read.  The G = H / KV query heads of one KV head are handled
//   together.  Softmax is online in f32, and probabilities stay f32 for
//   the PV product.  A lane of length 0 writes zeros, as the TPU kernel
//   does.  The serving engine's ring buffers need nothing more: RoPE is
//   applied when a position is written, so the order of the W slots does
//   not matter, and a ring that has wrapped has all W slots valid.
//
// What bounds it on an H100: the bytes of K/V it must read,
//   2 * sum_b min(len_b, S) * KV * hd * sizeof(dtype),
// at 3.35 TB/s; its arithmetic (4 * sum_b len_b * H * hd flops) is far
// below the card's rate.  At the serving path's shapes (4 slots, one KV
// head, hd 256, up to 2048 positions) that is a few microseconds at most.
//
// What this design does about that bound: not enough yet.  One thread
// block per (lane, KV head), so only B * KV blocks run on 132 SMs, each
// walking its cache in sequence: it is bound by the latency of that
// walk.  Within the walk it keeps latency down: 16-byte loads, the next
// 32-position tile prefetched into registers while the current one is
// computed, a warp per query head with a lane per position so that the
// scores and the softmax of a tile need no shared-memory round trip, and
// K/V rows padded in shared memory so that the reads are free of bank
// conflicts.  Splitting a lane's cache across blocks (and merging the
// partial softmax states in a second pass) is the next step.
//
// Built by repro_torch/kernels/decode_attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry point returns the CUDA error of
// the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;         // cache positions per tile: a lane each
constexpr int kMaxChunks = 8;   // 16-byte K (and V) chunks per thread/tile

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
// one K and one V tile (rows padded to hd + 1), the tile's probabilities
// (G x 32), and the running max, denominator and rescale factor per row.
__host__ __device__ inline size_t smem_floats(int G, int hd) {
  return 2 * (size_t)G * hd + 2 * (size_t)kBK * (hd + 1) + (size_t)G * kBK +
         3 * (size_t)G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int KV, int G, int S, int hd,
                    float scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* q_s = smem;
  float* acc_s = q_s + G * hd;
  float* k_s = acc_s + G * hd;
  float* v_s = k_s + kBK * ld;
  float* p_s = v_s + kBK * ld;
  float* m_s = p_s + G * kBK;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int H = KV * G;
  const int parts = hd / VEC;       // 16-byte chunks per cache row
  const int nchunks = kBK * parts;  // per tile, for K and for V each

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int ntiles = (len + kBK - 1) / kBK;

  const size_t row0 = ((size_t)b * H + (size_t)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(q[row0 + i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const size_t base = ((size_t)b * KV + h) * (size_t)S * hd;
  const uint4* kp = reinterpret_cast<const uint4*>(k + base);
  const uint4* vp = reinterpret_cast<const uint4*>(v + base);
  uint4 k_reg[kMaxChunks];
  uint4 v_reg[kMaxChunks];
  // chunk c of a tile holds elements [part * VEC, part * VEC + VEC) of
  // row c / parts; rows at or past len are zeros and are never read
  auto load_tile = [&](int t) {
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = tid + j * kThreads;
      if (c < nchunks) {
        const int pos = t * kBK + c / parts;
        if (pos < len) {
          const size_t off = (size_t)t * nchunks + c;
          k_reg[j] = kp[off];
          v_reg[j] = vp[off];
        } else {
          k_reg[j] = make_uint4(0u, 0u, 0u, 0u);
          v_reg[j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
  if (ntiles > 0) load_tile(0);

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();   // the previous tile's readers of k_s/v_s are done
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = tid + j * kThreads;
      if (c < nchunks) {
        const int row = c / parts;
        const int col = (c % parts) * VEC;
        float kf[VEC], vf[VEC];
        Vec<T>::to_f32(k_reg[j], kf);
        Vec<T>::to_f32(v_reg[j], vf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          k_s[row * ld + col + i] = kf[i];
          v_s[row * ld + col + i] = vf[i];
        }
      }
    }
    __syncthreads();
    if (t + 1 < ntiles) load_tile(t + 1);   // in flight during the math

    // scores and online softmax: a warp per query head, a lane per
    // position of the tile
    const int pos = t * kBK + lane;
    const float* krow = k_s + lane * ld;
    for (int g = warp; g < G; g += kWarps) {
      const float* qg = q_s + g * hd;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) dot += qg[d] * krow[d];
      const bool ok = pos < len;
      const float s = ok ? dot * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      // the tile's first position is always valid (t * 32 < len), so
      // m_new is finite
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      p_s[g * kBK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i % hd;
      const float* prow = p_s + g * kBK;
      float a = acc_s[i] * c_s[g];
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) a += prow[r] * v_s[r * ld + d];
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = l_s[i / hd];
    out[row0 + i] = from_f32<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int H, int KV, int S, int hd, float scale,
           cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = smem_floats(G, hd) * sizeof(float);
  // raised only when a launch needs more than any before it: a launch
  // captured into a CUDA graph later then issues no attribute call
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  flash_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), KV, G, S, hd,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
int repro_flash_decode(int dtype, const void* q, const void* k,
                       const void* v, const int* lengths, void* out, int B,
                       int H, int KV, int S, int hd, float scale,
                       void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || S <= 0 || hd <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = dtype == 0 ? 4 : 8;
  if (hd % vec || kBK * (hd / vec) > kMaxChunks * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, lengths, out, B, H, KV, S, hd, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, H, KV, S, hd,
                                 scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes one block needs, so the wrapper can refuse shapes
// that do not fit before it launches.
long long repro_flash_decode_smem_bytes(int G, int hd) {
  return (long long)(smem_floats(G, hd) * sizeof(float));
}

// Largest head dim the kernel takes for a dtype of elem_bytes bytes.
int repro_flash_decode_max_head_dim(int elem_bytes) {
  return kMaxChunks * kThreads / kBK * (16 / elem_bytes);
}

const char* repro_flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
