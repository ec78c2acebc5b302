// Flash attention for Hopper (sm_90a): causal GQA attention with an
// optional sliding window and a query offset, for prefill.
//
// Replaces the TPU kernel flash_attention.py:_attn_kernel
// (src/repro/kernels/flash_attention.py, pl.pallas_call at line 115).
// It computes what that kernel computes, not a block-by-block copy:
//   q (B, H, Sq, hd); k, v (B, KV, Skv, hd); out (B, H, Sq, hd), each
//   with its own (batch, head, position) strides and a unit last stride.
//   Query i sits at position q_offset + i and attends key j iff
//   (not causal or j <= q_offset + i) and (no window or
//   j > q_offset + i - window).  With q_offset = 0 this is the TPU
//   kernel's function.  The G = H / KV query heads of one KV head share
//   that head's K/V tiles (the TPU kernel's index maps do the same).
//   Scores, the online softmax (m, l, acc) and the PV product are f32;
//   probabilities are not rounded to the value dtype.  A row with no
//   valid key writes zeros (the dense oracle would give the mean of V;
//   no caller asks for such a row).
//
// What bounds it on an H100: operations.  A (B, H, S, S) causal prefill
// does 4 * H * sum_i(keys seen by query i) * hd flops against
// (2 H + 2 KV) * S * hd elements moved; at recurrentgemma's G = 16 and
// hd = 256 that is hundreds of flops per byte, above the card's ~295
// bf16 flops per byte, so the tensor cores (989 TFLOP/s bf16) set the
// bound.
//
// What this design does about that bound: little yet.  It is the simple
// version: f32 FMAs on the CUDA cores out of shared memory, no tensor
// cores (wgmma / mma.sync) and no TMA.  What it does do:
//   * one block per (batch, KV head, tile of query positions) holds
//     64 query rows (BQ = 64 / G positions x the G heads of the KV head),
//     so each K/V tile loaded from memory serves all G heads;
//   * key tiles wholly outside the causal / window mask are never
//     loaded (the TPU kernel's @pl.when(relevant));
//   * each thread computes a 4 x 2 tile of scores and a 4 x (hd / 16)
//     tile of the output from registers, with rows padded by one float
//     in shared memory so that the reads are free of bank conflicts;
//   * ragged edges (Sq, Skv not multiples of the tiles) are masked here,
//     where the TPU kernel asserts divisibility.
//
// Built by repro_torch/kernels/flash_attention.py with
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
constexpr int kRows = 64;   // query rows (position x head) per block
constexpr int kBK = 32;     // keys per tile
constexpr int kLP = kBK + 1;

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

struct Strides {
  long long b, h, s;   // elements
};

// Shared memory (all f32): the query tile, one K and one V tile (rows
// padded to hd + 1), the tile's scores / probabilities, and the running
// max, denominator and rescale factor of each row.
__host__ __device__ inline size_t smem_floats(int hd) {
  return (size_t)(kRows + 2 * kBK) * (hd + 1) + (size_t)kRows * kLP +
         3 * kRows;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int KV, int G, int Sq, int Skv, int BQ, int nqt,
                       int causal, int window, int q_offset, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LD = HD + 1;
  constexpr int PARTS = HD / VEC;   // 16-byte chunks per row
  constexpr int TD = HD / 16;       // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRows * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  float* m_s = p_s + kRows * kLP;
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;
  const int b = bh / KV;
  const int h = bh % KV;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);   // query positions in this tile
  const int live = nq * G;           // rows r < live are real; r -> (r / G, r % G)

  for (int c = tid; c < kRows * PARTS; c += kThreads) {
    const int r = c / PARTS;
    const int part = c % PARTS;
    float f[VEC];
    if (r < live) {
      const T* src = q + b * qs.b + (long long)(h * G + r % G) * qs.h +
                     (long long)(q0 + r / G) * qs.s + part * VEC;
      Vec<T>::to_f32(*reinterpret_cast<const uint4*>(src), f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) q_s[r * LD + part * VEC + i] = f[i];
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // keys any row of this tile may see; tiles outside are skipped
  const int qlo = q_offset + q0;
  const int qhi = q_offset + q0 + nq - 1;
  const int kmin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kmax = causal ? min(Skv - 1, qhi) : Skv - 1;
  const int t_lo = kmin / kBK;
  const int t_hi = kmax >= kmin ? kmax / kBK : t_lo - 1;

  const int rg = tid / 16;   // rows 4 rg .. 4 rg + 3
  const int cg = tid % 16;   // keys cg, cg + 16; dims cg + 16 j
  float acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's readers of k_s/v_s/p_s are done
    for (int c = tid; c < kBK * PARTS; c += kThreads) {
      const int r = c / PARTS;
      const int part = c % PARTS;
      const int key = k0 + r;
      float fk[VEC], fv[VEC];
      if (key >= kmin && key <= kmax) {
        const long long off = part * VEC;
        Vec<T>::to_f32(*reinterpret_cast<const uint4*>(
                           k + b * ks.b + h * ks.h + key * ks.s + off),
                       fk);
        Vec<T>::to_f32(*reinterpret_cast<const uint4*>(
                           v + b * vs.b + h * vs.h + key * vs.s + off),
                       fv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) fk[i] = fv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[r * LD + part * VEC + i] = fk[i];
        v_s[r * LD + part * VEC + i] = fv[i];
      }
    }
    __syncthreads();

    // scores: a 4 x 2 tile per thread
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    const float* qrow = q_s + (rg * 4) * LD;
    const float* krow = k_s + cg * LD;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float k0v = krow[d];
      const float k1v = krow[16 * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qrow[i * LD + d];
        sc[i][0] += qv * k0v;
        sc[i][1] += qv * k1v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qpos = q_offset + q0 + r / G;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + cg + 16 * j;
        bool ok = r < live && key < Skv;
        if (causal && key > qpos) ok = false;
        if (window > 0 && key <= qpos - window) ok = false;
        p_s[r * kLP + cg + 16 * j] = ok ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row, a lane per key
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float s = p_s[r * kLP + lane];
      const bool ok = s > 0.5f * kNegInf;
      float mx = ok ? s : kNegInf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      p_s[r * kLP + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: a 4 x TD tile per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    const float* prow = p_s + (rg * 4) * kLP;
#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = prow[i * kLP + key];
      const float* vrow = v_s + key * LD + cg;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const float vv = vrow[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();   // final l_s (and, with no tile, its init) visible

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= live) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* dst = out + b * os.b + (long long)(h * G + r % G) * os.h +
             (long long)(q0 + r / G) * os.s + cg;
#pragma unroll
    for (int j = 0; j < TD; ++j) dst[16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
           int KV, int Sq, int Skv, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int BQ = kRows / G;
  const int nqt = (Sq + BQ - 1) / BQ;
  const size_t smem = smem_floats(HD) * sizeof(float);
  // set once, at the first launch: a launch captured into a CUDA graph
  // later then issues no attribute call
  static bool configured = false;
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  flash_attention_kernel<T, HD><<<B * KV * nqt, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, KV, G,
      Sq, Skv, BQ, nqt, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, Strides qs, Strides ks, Strides vs, Strides os,
                int B, int H, int KV, int Sq, int Skv, int causal,
                int window, int q_offset, float scale, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq, Skv,
                           causal, window, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq,
                            Skv, causal, window, q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, H, KV, Sq,
                            Skv, causal, window, q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; strides in elements, (batch, head,
// position) for each of q, k, v, out; window <= 0 means none.  Returns
// the launch's cudaError_t.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* out, long long qsb,
                          long long qsh, long long qss, long long ksb,
                          long long ksh, long long kss, long long vsb,
                          long long vsh, long long vss, long long osb,
                          long long osh, long long oss, int B, int H, int KV,
                          int Sq, int Skv, int hd, int causal, int window,
                          int q_offset, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || H / KV > kRows || Sq <= 0 || Skv < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_hd<float>(hd, q, k, v, out, qs, ks, vs, os, B, H, KV, Sq,
                              Skv, causal, window, q_offset, scale, s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, qs, ks, vs, os, B, H,
                                      KV, Sq, Skv, causal, window, q_offset,
                                      scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes one block needs at head dim hd.
long long repro_flash_attention_smem_bytes(int hd) {
  return (long long)(smem_floats(hd) * sizeof(float));
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
