// Split-K ("flash-decoding") attention of one query token per lane, shared
// by flash_decode.cu (a dense cache per lane) and paged_decode.cu (a shared
// page pool read through block tables).  The two differ only in where the
// K/V row of a cached position lies (row_offset below).
//
// A call is two kernels on one stream:
//   split: grid (B * KV * ceil(G / 16), n_splits), 128 threads.  Block
//     (lane b, KV head h, head tile, split s) attends query heads
//     [16 * tile, 16 * tile + 16) of h's group over positions
//     [s * per_split, min((s + 1) * per_split, len_b)) and writes its
//     partial softmax state: the running max m, the denominator l and the
//     unnormalised sum acc = sum_j exp(score_j - m) * v_j, all f32.  A split
//     that starts at or past len_b returns at once and writes nothing.
//   merge: one 256-thread block per query row (b, h, g).  It combines the
//     partials of the splits that start below len_b,
//       out = sum_s exp(m_s - M) * acc_s / sum_s exp(m_s - M) * l_s,
//     M = max_s m_s, and never reads the partial of a split that returned
//     early (its memory is uninitialised).  A lane of length 0 writes zeros.
// flash_decode.cu also launches each pass alone, for a ring cut along its
// positions over several ranks: the split kernel with kEmpty, which leaves
// an empty partial (m = -inf, l = 0, acc = 0) for every split it skips, and
// the merge with kAll, which reads every partial it is given.
//
// Inside a split block K/V come in 32-position tiles by 16-byte cp.async
// straight into shared memory in the cache's own type (rows padded by 16
// bytes so that ldmatrix and vector reads are free of bank conflicts); a
// split of more than one tile double-buffers them, the next tile in flight
// while the current one is computed.  Softmax is online in f32 across the
// tiles of a split, a warp per query row and a lane per position.
//   bf16: QK^T and PV on the tensor cores with mma.sync m16n8k16.
//     The 16 query heads of a tile are the m16 rows (rows past G are zero);
//     K stored row-major by position is already the col-major B operand;
//     V goes through ldmatrix.trans.  Each f32 probability enters the PV
//     product as a pair of bf16 values, hi + lo, which keep it to ~2^-17;
//     scores, softmax and accumulators stay f32.
//   f32: the same tiles on FMAs, probabilities f32.
//
// Shapes the kernels take: head_dim a multiple of 16, at most 256.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90_mma.cuh"

namespace decode_split {

using namespace sm90;   // cp.async, ldmatrix, mma.sync, warp reductions

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;       // split block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // positions per tile: a lane each
constexpr int kRows = 16;           // query heads per block: mma's m16
constexpr int kLdS = kTile + 8;     // row stride of the score/prob tiles
constexpr int kMaxHeadDim = 256;
constexpr int kMergeThreads = 256;
constexpr int kMaxItems = kRows * kMaxHeadDim / 4 / kThreads;

struct Params {
  const void* q;            // (B, KV * G, hd)
  const void* k;            // dense (B, KV, S, hd); paged (P, KV, ps, hd)
  const void* v;
  const int* lengths;       // (B,)
  const int* tables;        // paged: (B, W); dense: unused
  float* acc;               // (B, KV, n_splits, G, hd) partials
  float* m;                 // (B, KV, n_splits, G)
  float* l;                 // (B, KV, n_splits, G)
  void* out;                // (B, KV * G, hd)
  int KV, G, hd;
  int n_positions;          // S (dense) or W * ps (paged)
  int per_split;            // positions per split
  int n_splits;
  int S;                    // dense ring depth
  int P, ps, W;             // paged pool pages, page size, table width
  float scale;
};

// Element offset of the K (or V) row of cached position pos of (b, h).
template <bool kPaged>
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int h,
                                             int pos) {
  if constexpr (kPaged) {
    int page = p.tables[(size_t)b * p.W + pos / p.ps];
    page = page < 0 ? 0 : (page > p.P - 1 ? p.P - 1 : page);
    return (((size_t)page * p.KV + h) * p.ps + pos % p.ps) * p.hd;
  } else {
    return (((size_t)b * p.KV + h) * p.S + pos) * p.hd;
  }
}

__device__ __forceinline__ int lane_length(const Params& p, int b) {
  const int len = p.lengths[b];
  return len < 0 ? 0 : (len > p.n_positions ? p.n_positions : len);
}

// ---------------------------------------------------------------------------
// shared-memory layout of a split block (bytes; every region 16-byte aligned)
// ---------------------------------------------------------------------------

struct Layout {
  int ld;                   // row stride of q/K/V tiles, in elements
  size_t k, v, s, p, stats, total;
};

__host__ __device__ inline Layout layout(int hd, int elem, int stages) {
  Layout L;
  L.ld = hd + 16 / elem;
  const size_t row = (size_t)L.ld * elem;
  L.k = kRows * row;                                  // q tile at 0
  L.v = L.k + (size_t)stages * kTile * row;
  L.s = L.v + (size_t)stages * kTile * row;
  L.p = L.s + kRows * kLdS * sizeof(float);   // f32, or bf16 hi and lo
  L.stats = L.p + kRows * kLdS * sizeof(float);
  L.total = L.stats + 3 * kRows * sizeof(float);      // m, l, rescale
  return L;
}

// a split of more than one tile double-buffers its K/V tiles
__host__ __device__ inline int stages_for(int per_split) {
  return per_split > kTile ? 2 : 1;
}

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------

// 4 consecutive elements of T (8-byte aligned for bf16) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// the split kernel's body
// ---------------------------------------------------------------------------

// cp.async of K/V rows [t0, t0 + kTile) into one stage; rows at or past
// end are zero-filled (a zero V row times a zero probability stays 0)
template <typename T, bool kPaged>
__device__ __forceinline__ void load_tile(const Params& p, int b, int h,
                                          int t0, int end, T* k_dst,
                                          T* v_dst, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const int parts = p.hd / VEC;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int c = threadIdx.x; c < kTile * parts; c += kThreads) {
    const int r = c / parts;
    const int col = (c % parts) * VEC;
    const int pos = t0 + r;
    const bool ok = pos < end;
    const size_t off = ok ? row_offset<kPaged>(p, b, h, pos) + col : 0;
    cp_async16(k_dst + r * ld + col, k + off, ok);
    cp_async16(v_dst + r * ld + col, v + off, ok);
  }
}

// kEmpty (the split-only entry): a split that starts at or past the lane's
// length writes a defined empty partial, m = -inf, l = 0 and acc = 0, so
// that a merge over every split (kAll below) may read it.
template <typename T, bool kPaged, bool kEmpty = false>
__device__ __forceinline__ void split_body(const Params& p) {
  constexpr bool kMma = sizeof(T) == 2;      // bf16 on the tensor cores
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];

  // the merge grid may launch now (a programmatic dependent launch); it
  // waits for this grid's writes before it reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tiles_g = (p.G + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles_g;
  const int g0 = (blockIdx.x % tiles_g) * kRows;
  const int b = bh / p.KV;
  const int h = bh % p.KV;
  const int split = blockIdx.y;
  const int len = lane_length(p, b);
  const int start = split * p.per_split;
  if (start >= len) {                       // the merge never reads it,
    if constexpr (kEmpty) {                 // unless it reads every split
      const int rows = min(kRows, p.G - g0);
      const size_t prow = ((size_t)bh * p.n_splits + split) * p.G + g0;
      if (threadIdx.x < rows) {
        p.m[prow + threadIdx.x] = __int_as_float(0xff800000);  // -inf
        p.l[prow + threadIdx.x] = 0.f;
      }
      float* acc = p.acc + prow * p.hd;
      for (int i = threadIdx.x; i < rows * p.hd; i += kThreads) acc[i] = 0.f;
    }
    return;
  }
  const int end = min(start + p.per_split, len);
  const int ntiles = (end - start + kTile - 1) / kTile;
  const int rows = min(kRows, p.G - g0);    // valid query heads here

  const Layout L = layout(p.hd, sizeof(T), stages_for(p.per_split));
  const int ld = L.ld;
  T* q_s = reinterpret_cast<T*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  auto k_stage = [&](int st) {
    return reinterpret_cast<T*>(smem + L.k) + st * kTile * ld;
  };
  auto v_stage = [&](int st) {
    return reinterpret_cast<T*>(smem + L.v) + st * kTile * ld;
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hd = p.hd;

  // q rows of this head tile (rows past G zero-filled), then tile 0
  {
    const T* q = static_cast<const T*>(p.q);
    const size_t row0 = (size_t)bh * p.G + g0;
    const int parts = hd / VEC;
    for (int c = tid; c < kRows * parts; c += kThreads) {
      const int r = c / parts;
      const int col = (c % parts) * VEC;
      const bool ok = r < rows;
      cp_async16(q_s + r * ld + col, q + (row0 + (ok ? r : 0)) * hd + col,
                 ok);
    }
  }
  load_tile<T, kPaged>(p, b, h, start, end, k_stage(0), v_stage(0), ld);
  cp_async_commit();
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // accumulators: mma fragments of this warp's 16-column pairs, or float4
  // (row, column) items on the FMA path
  float acc_mma[4][2][4];
  float4 acc_fma[kMaxItems];
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_mma[j][n][i] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) acc_fma[j] = make_float4(0, 0, 0, 0);
  }
  const int n4 = hd / 4;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = start + t * kTile;
    if (t + 1 < ntiles) {
      load_tile<T, kPaged>(p, b, h, t0 + kTile, end, k_stage((t + 1) & 1),
                           v_stage((t + 1) & 1), ld);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = k_stage(t & 1);
    const T* v_s = v_stage(t & 1);

    // scores of the tile (unscaled) -> s_s
    if constexpr (kMma) {
      // warp w: positions [8w, 8w + 8) of the tile, all 16 rows
      if (t0 + warp * 8 < end) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f};
        float c1[4] = {0.f, 0.f, 0.f, 0.f};
        const T* qa = q_s + (lane & 15) * ld + (lane >> 4) * 8;
        const T* kb =
            k_s + (warp * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
        for (int kk = 0; kk < hd; kk += 32) {
          uint32_t a[4], bb[2];
          ldsm_x4(a, qa + kk);
          ldsm_x2(bb, kb + kk);
          mma_bf16(c0, a, bb[0], bb[1]);
          if (kk + 16 < hd) {
            ldsm_x4(a, qa + kk + 16);
            ldsm_x2(bb, kb + kk + 16);
            mma_bf16(c1, a, bb[0], bb[1]);
          }
        }
        const int col = warp * 8 + (lane & 3) * 2;
        const int r = lane >> 2;
        *reinterpret_cast<float2*>(s_s + r * kLdS + col) =
            make_float2(c0[0] + c1[0], c0[1] + c1[1]);
        *reinterpret_cast<float2*>(s_s + (r + 8) * kLdS + col) =
            make_float2(c0[2] + c1[2], c0[3] + c1[3]);
      }
    } else {
      // lane = position; warp w: rows w, w + 4, w + 8, w + 12
      const T* krow = k_s + lane * ld;
      float dot[kRows / kWarps] = {};
      for (int d = 0; d < hd; d += 4) {
        const float4 kf = load4(krow + d);
#pragma unroll
        for (int i = 0; i < kRows / kWarps; ++i) {
          const float4 qf = load4(q_s + (warp + i * kWarps) * ld + d);
          dot[i] += qf.x * kf.x + qf.y * kf.y + qf.z * kf.z + qf.w * kf.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows / kWarps; ++i) {
        s_s[(warp + i * kWarps) * kLdS + lane] = dot[i];
      }
    }
    __syncthreads();

    // online softmax: a warp per row, a lane per position.  The tile's
    // first position is below end, so the new max is finite.
    {
      const int pos = t0 + lane;
      const bool ok = pos < end;
      for (int r = warp; r < kRows; r += kWarps) {
        const float s = ok ? s_s[r * kLdS + lane] * p.scale : kNegInf;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float e = ok ? expf(s - m_new) : 0.f;
        if constexpr (kMma) {
          // e = hi + lo to ~2^-17: the PV product keeps f32's accuracy
          __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
          const __nv_bfloat16 hi = __float2bfloat16(e);
          p_hi[r * kLdS + lane] = hi;
          p_hi[kRows * kLdS + r * kLdS + lane] =
              __float2bfloat16(e - __bfloat162float(hi));
        } else {
          reinterpret_cast<float*>(smem + L.p)[r * kLdS + lane] = e;
        }
        const float sum = warp_sum(e);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * rescale + P V
    if constexpr (kMma) {
      const int r = lane >> 2;
      const float cr0 = c_s[r];
      const float cr1 = c_s[r + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc_mma[j][n][0] *= cr0;
          acc_mma[j][n][1] *= cr0;
          acc_mma[j][n][2] *= cr1;
          acc_mma[j][n][3] *= cr1;
        }
      const __nv_bfloat16* p_hi =
          reinterpret_cast<const __nv_bfloat16*>(smem + L.p);
      const __nv_bfloat16* p_lo = p_hi + kRows * kLdS;
      for (int kk = 0; kk < kTile && t0 + kk < end; kk += 16) {
        uint32_t a_hi[4], a_lo[4];
        const int at = (lane & 15) * kLdS + kk + (lane >> 4) * 8;
        ldsm_x4(a_hi, p_hi + at);
        ldsm_x4(a_lo, p_lo + at);
        const T* vb = v_s + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                      (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pair = warp + j * kWarps;     // columns [16 pair, +16)
          if (pair * 16 < hd) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vb + pair * 16);
            mma_bf16(acc_mma[j][0], a_hi, bv[0], bv[1]);
            mma_bf16(acc_mma[j][1], a_hi, bv[2], bv[3]);
            mma_bf16(acc_mma[j][0], a_lo, bv[0], bv[1]);
            mma_bf16(acc_mma[j][1], a_lo, bv[2], bv[3]);
          }
        }
      }
    } else {
      const float* p_s = reinterpret_cast<const float*>(smem + L.p);
      const int npos = min(kTile, end - t0);
#pragma unroll
      for (int j = 0; j < kMaxItems; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / n4;
        if (i < kRows * n4 && r < rows) {
          const int col = (i % n4) * 4;
          const float corr = c_s[r];
          float4 a = acc_fma[j];
          a.x *= corr;
          a.y *= corr;
          a.z *= corr;
          a.w *= corr;
          for (int pp = 0; pp < npos; ++pp) {
            const float w = p_s[r * kLdS + pp];
            const float4 vf = load4(v_s + pp * ld + col);
            a.x += w * vf.x;
            a.y += w * vf.y;
            a.z += w * vf.z;
            a.w += w * vf.w;
          }
          acc_fma[j] = a;
        }
      }
    }
    __syncthreads();   // readers of this stage and of s/p are done
  }

  // the partial state of this split
  const size_t prow = ((size_t)bh * p.n_splits + split) * p.G + g0;
  if (tid < rows) {
    p.m[prow + tid] = m_s[tid];
    p.l[prow + tid] = l_s[tid];
  }
  float* acc = p.acc + prow * hd;
  if constexpr (kMma) {
    const int r = lane >> 2;
    const int c = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pair = warp + j * kWarps;
      if (pair * 16 < hd) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = pair * 16 + n * 8 + c;
          if (r < rows) {
            *reinterpret_cast<float2*>(acc + (size_t)r * hd + col) =
                make_float2(acc_mma[j][n][0], acc_mma[j][n][1]);
          }
          if (r + 8 < rows) {
            *reinterpret_cast<float2*>(acc + (size_t)(r + 8) * hd + col) =
                make_float2(acc_mma[j][n][2], acc_mma[j][n][3]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / n4;
      if (i < kRows * n4 && r < rows) {
        *reinterpret_cast<float4*>(acc + (size_t)r * hd + (i % n4) * 4) =
            acc_fma[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the merge kernel's body: block = one query row (b, h, g)
// ---------------------------------------------------------------------------

// block-wide max (kMax) or sum of one value per thread of kMergeThreads
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  const int warp = threadIdx.x / 32;
  __syncthreads();               // red is free: its last readers are done
  if (threadIdx.x % 32 == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kMergeThreads / 32; ++w) {
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  }
  return x;
}

// The splits of a row are shared among thread groups: each of the
// kMergeThreads / (hd / 4) groups covers every column in float4s and
// sums every groups-th split; the groups' sums then meet in shared memory.
// kAll (the merge-only entry): read all n_splits partials, with no lane
// length (p.lengths unused), where an empty partial has m = -inf and
// weight exp(-inf - M) = 0; a row whose partials are all empty gives
// zeros (its denominator is 0).
template <typename T, bool kAll = false>
__device__ __forceinline__ void merge_body(const Params& p) {
  __shared__ float4 part[kMergeThreads];
  __shared__ float red[kMergeThreads / 32];
  const int row = blockIdx.x;               // (b * KV + h) * G + g
  const int g = row % p.G;
  const int bh = row / p.G;
  int live = p.n_splits;
  if constexpr (!kAll) {
    const int len = lane_length(p, bh / p.KV);
    live = (len + p.per_split - 1) / p.per_split;     // splits below len
    live = live < p.n_splits ? live : p.n_splits;
  }
  const size_t first = (size_t)bh * p.n_splits * p.G + g;
  const float* m = p.m + first;             // split s at m[s * G]
  const float* l = p.l + first;
  // the split kernel's partials are complete past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int tid = threadIdx.x;
  float x = kNegInf;
  for (int s = tid; s < live; s += kMergeThreads) {
    x = fmaxf(x, m[(size_t)s * p.G]);
  }
  const float M = block_reduce<true>(x, red);
  x = 0.f;
  for (int s = tid; s < live; s += kMergeThreads) {
    x += expf(m[(size_t)s * p.G] - M) * l[(size_t)s * p.G];
  }
  const float denom = block_reduce<false>(x, red);
  // length 0 (or, for kAll, every partial empty): zeros
  const float inv = kAll ? (denom > 0.f ? 1.f / denom : 0.f)
                         : (live > 0 ? 1.f / denom : 0.f);

  const int ncol = p.hd / 4;
  const int groups = kMergeThreads / ncol;
  const int col = tid % ncol;
  const int grp = tid / ncol;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < groups) {
    const float* acc = p.acc + first * p.hd + col * 4;
    const size_t step = (size_t)p.G * p.hd;
#pragma unroll 4
    for (int s = grp; s < live; s += groups) {
      const float w = expf(m[(size_t)s * p.G] - M);
      const float4 v = *reinterpret_cast<const float4*>(acc + s * step);
      a.x += w * v.x;
      a.y += w * v.y;
      a.z += w * v.z;
      a.w += w * v.w;
    }
  }
  part[tid] = a;
  __syncthreads();
  if (tid < ncol) {
    for (int i = 1; i < groups; ++i) {
      const float4 v = part[tid + i * ncol];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    T* out = static_cast<T*>(p.out) + (size_t)row * p.hd + tid * 4;
    store(out, a.x * inv);
    store(out + 1, a.y * inv);
    store(out + 2, a.z * inv);
    store(out + 3, a.w * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The split and merge launches of one call, on one stream.  split_kernel
// needs layout(...).total bytes of dynamic shared memory; *configured is
// the most that kernel has been allowed so far, raised only when a call
// needs more, so that a launch captured into a CUDA graph later issues no
// attribute call.
template <typename SplitKernel, typename MergeKernel>
int launch_pair(SplitKernel split_kernel, MergeKernel merge_kernel,
                size_t* configured, const Params& p, int B, int elem,
                cudaStream_t stream) {
  if (B <= 0 || p.KV <= 0 || p.G <= 0 || p.hd % 16 || p.hd <= 0 ||
      p.hd > kMaxHeadDim || p.per_split <= 0 || p.n_splits <= 0 ||
      p.n_splits > 65535 ||
      (long long)p.per_split * p.n_splits < p.n_positions) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = layout(p.hd, elem, stages_for(p.per_split)).total;
  if (smem > *configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *configured = smem;
  }
  const int tiles_g = (p.G + kRows - 1) / kRows;
  split_kernel<<<dim3(B * p.KV * tiles_g, p.n_splits), kThreads, smem,
                 stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the merge is a programmatic dependent launch: its blocks may start
  // before the split grid ends, and wait in griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.KV * p.G);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, merge_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace decode_split
