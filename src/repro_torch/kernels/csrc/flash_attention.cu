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
//   Scores and the online softmax (m, l, acc) are f32.  A row with no
//   valid key writes zeros (the dense oracle would give the mean of V; no
//   caller asks for such a row).
//
// What bounds it on an H100.  A call moves (2 H + 2 KV) * S * hd elements
// and does 4 * H * hd flops per (query, key) pair the mask allows.  At the
// main path's short shapes, bytes: the 128-token recurrentgemma prefill
// (H 16, KV 1, hd 256) moves 1.1 MB (0.66 us at 3.35 TB/s) for 0.68 GFLOP
// (0.69 us at 989 TFLOP/s, so the two nearly meet) and the qwen2 chunk (64
// queries at offset 64 against 240 keys, H 12, KV 2, hd 128) 0.64 MB
// (0.19 us); in practice both are bound by latency, a few dependent tiles
// a block.  At 4096 tokens with the 2048 window, operations: 103 GFLOP
// against 33.6 MB, 0.104 ms on the tensor cores.
//
// The design (kernels/flash_attention.py tile_plan picks the shapes):
//   * bf16: one block of 4 warps per (batch, KV head, tile of 64 / split
//     packed query rows), a row being (position, one of the G heads), so
//     one K/V tile serves every head of its group and G = 16 x one
//     position fills a warp's m16 rows.  The rows come in groups of 16,
//     and the keys of each group are split over `split` warps (1 or 4)
//     that merge their partial (m, l, O) in shared memory at the end: few
//     rows (a 128-token prefill, a 64-token chunk) still give every SM
//     four warps, and many rows share each K/V tile over four groups.
//     S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 operands from
//     ldmatrix, V through ldmatrix.trans; f32 accumulators in registers).
//     The online softmax works on the accumulator fragments with quad
//     shuffles: no score tile in shared memory and no barrier between the
//     scores and PV.  Each probability enters PV as a pair of bf16 values,
//     hi + lo, which keep it to ~2^-17, as the decode kernels
//     do: with hi alone an output ulp flips often enough to reach 1.6e-2
//     of the 2e-2 gate.  Q, K and V stay bf16 in shared memory (rows
//     padded by 16 bytes: ldmatrix is free of bank conflicts); K/V tiles
//     come by 16-byte cp.async in two stages, the next tile in flight
//     while this one is computed, keys outside the block's range
//     zero-filled.  At hd 256 a warp's 16 x 256 output is 128 f32
//     registers a thread, so Q's fragments are read from shared memory at
//     each k-step there; at hd <= 128 they stay in registers.  Blocks of
//     the latest positions (the most keys) are scheduled first.
//     Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
//     9, CUDA-graph replay): 0.0095 ms at the 128-token prefill (the first
//     design 0.0645, SDPA 0.0185), 0.0060 ms at the qwen2 chunk (0.0376;
//     SDPA 0.0162), 0.556 ms at 4096 tokens (6.03; SDPA 1.069).  At 4096
//     it reaches 19 % of the tensor cores' rate: every operand passes
//     through ldmatrix (Q too at hd 256), 255 registers leave two blocks
//     an SM, and hi + lo makes PV two products; wgmma with operands in
//     shared memory is the next step.
//   * f32: the first design, kept for exactness (TF32 would break the
//     1e-4 tolerance): 64 query rows a block, 32-key tiles, f32 FMAs on
//     the CUDA cores out of shared memory, a warp per row for the softmax.
//   * Both: key tiles wholly outside the causal / window range of a block
//     are never loaded (the TPU kernel's @pl.when(relevant)); ragged edges
//     (Sq, Skv not multiples of the tiles) are masked here, where the TPU
//     kernel asserts divisibility.
//
// Built by repro_torch/kernels/flash_attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry point takes the plan's split and
// derives the key tile, stages, grid and shared memory from it as tile_plan
// does (chip_smoke.py holds the traced grid to the plan's), returns the
// CUDA error of the launch (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90_mma.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;   // elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Strides qs, ks, vs, os;
  int KV, G, Sq, Skv;
  int causal, window, q_offset;   // window <= 0: none
  float scale;
};

// keys [kmin, kmax] that query positions [plo, phi] (before the offset)
// may see; empty when kmax < kmin
__device__ __forceinline__ void key_range(const Args& a, int plo, int phi,
                                          int& kmin, int& kmax) {
  kmin = a.window > 0 ? max(0, a.q_offset + plo - a.window + 1) : 0;
  kmax = a.causal ? min(a.Skv - 1, a.q_offset + phi) : a.Skv - 1;
}

__device__ __forceinline__ bool key_ok(const Args& a, int key, int qpos) {
  return key < a.Skv && (!a.causal || key <= qpos) &&
         (a.window <= 0 || key > qpos - a.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaWarps = 4;

// Keys one warp takes from each key tile at head dim hd, when the keys of
// a 16-row group are split over `split` warps (tile_plan's rule).  A
// tile holds split * warp_keys keys.
__host__ __device__ constexpr int warp_keys(int hd, int split) {
  return split == 1 ? (hd <= 128 ? 64 : 32) : 16;
}

// shared memory of a bf16 block: the query tile and `stages` K and V tiles
// (rows of hd + 8 bf16 values) while it walks the keys; the split's f32
// partial outputs and (m, l) when it merges them
__host__ __device__ constexpr size_t mma_smem(int hd, int split,
                                             int stages) {
  const size_t rows = 64 / split;
  const size_t bk = (size_t)split * warp_keys(hd, split);
  const size_t walk = (rows + 2 * stages * bk) * (hd + 8) * sizeof(bf16);
  const size_t merge =
      split > 1 ? (64 * (size_t)(hd + 4) + 2 * 64) * sizeof(float) : 0;
  return walk > merge ? walk : merge;
}

// A block of 4 warps holds 64 / KS packed query rows: 4 / KS groups of 16
// rows, the keys of each group split over KS warps.  Warp (group, slice)
// takes keys [slice * BNW, slice * BNW + BNW) of every key tile.
template <int HD, int KS>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_attention_mma(const Args a, int ntq, int stages) {
  constexpr int BM = 64 / KS;          // packed query rows per block
  constexpr int BNW = warp_keys(HD, KS);
  constexpr int BN = KS * BNW;         // keys per tile
  constexpr int LD = HD + 8;           // smem row stride, elements
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kChunks = HD / 8;      // 16-byte chunks per row
  constexpr int NB = BNW / 8;          // n8 blocks of a warp's scores
  constexpr int DB = HD / 8;           // n8 blocks of the output
  constexpr bool kQRegs = HD <= 128;   // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BM * LD;
  bf16* v_s = k_s + stages * BN * LD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = warp / KS;           // row group
  const int sl = warp % KS;            // key slice
  const int tile = ntq - 1 - (int)(blockIdx.x % ntq);   // latest first
  const int bh = blockIdx.x / ntq;
  const int b = bh / a.KV;
  const int h = bh % a.KV;
  const int G = a.G;
  const int live = a.Sq * G;   // packed row R -> (position R / G, head R % G)
  const int r0 = tile * BM;
  int kmin, kmax;
  key_range(a, r0 / G, (min(r0 + BM, live) - 1) / G, kmin, kmax);
  const int t_lo = kmin / BN;
  const int ntiles = kmax >= kmin ? kmax / BN - t_lo + 1 : 0;

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b +
                   (long long)h * G * a.qs.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;

  // K/V rows [t * BN, t * BN + BN) into stage st; keys outside
  // [kmin, kmax] are zero-filled (never read from memory)
  auto load_kv = [&](int t, int st) {
    bf16* kd = k_s + st * BN * LD;
    bf16* vd = v_s + st * BN * LD;
    for (int c = tid; c < BN * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int key = t * BN + r;
      const bool ok = key >= kmin && key <= kmax;
      cp_async16(kd + r * LD + col, kg + (ok ? key * a.ks.s + col : 0), ok);
      cp_async16(vd + r * LD + col, vg + (ok ? key * a.vs.s + col : 0), ok);
    }
  };

  if (ntiles > 0) {
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int R = r0 + r;
      const bool ok = R < live;
      cp_async16(q_s + r * LD + col,
                 qg + (ok ? (R % G) * a.qs.h + (long long)(R / G) * a.qs.s +
                                col
                          : 0),
                 ok);
    }
    load_kv(t_lo, 0);
  }
  cp_async_commit();

  // this warp's rows: wr0 .. wr0 + 15; this thread's: ra and ra + 8
  const int wr0 = r0 + grp * 16;
  const bool warp_live = wr0 < live;
  const int wlo = a.q_offset + wr0 / G;
  const int whi = a.q_offset + (min(wr0 + 15, live - 1)) / G;
  const int ra = wr0 + lane / 4;
  const int qpos[2] = {a.q_offset + ra / G, a.q_offset + (ra + 8) / G};
  const float sl2 = a.scale * kLog2e;

  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's columns; summed over the quad
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  const bf16* q_row = q_s + (grp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  // ldmatrix lane offsets: K rows (non-transposed) and V rows (transposed)
  const int k_off = (sl * BNW + (lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (sl * BNW + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    (lane >> 4) * 8;

  for (int i = 0; i < ntiles; ++i) {
    const int st = stages > 1 ? (i & 1) : 0;
    if (i + 1 < ntiles) {
      load_kv(t_lo + i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_row + kk * 16);
      }
    }
    const int k0 = (t_lo + i) * BN + sl * BNW;   // this warp's first key
    // keys none of this warp's rows may see are skipped
    const bool skip = !warp_live || (a.causal && k0 > whi) ||
                      (a.window > 0 && k0 + BNW - 1 <= wlo - a.window);
    if (!skip) {
      const bf16* kt = k_s + st * BN * LD + k_off;
      const bf16* vt = v_s + st * BN * LD + v_off;
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t af[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) af[x] = qf[kk][x];
        } else {
          ldsm_x4(af, q_row + kk * 16);
        }
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + n * 8 * LD + kk * 16);
          mma_bf16(s[n], af, kb[0], kb[1]);
          mma_bf16(s[n + 1], af, kb[2], kb[3]);
        }
      }

      // scale into log2 units; mask only where the keys cross an edge
      const bool edge = k0 + BNW > a.Skv ||
                        (a.causal && k0 + BNW - 1 > wlo) ||
                        (a.window > 0 && k0 <= whi - a.window);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= sl2;
          if (edge &&
              !key_ok(a, k0 + n * 8 + 2 * (lane & 3) + (e & 1), qpos[e >> 1])) {
            s[n][e] = -INFINITY;
          }
        }
      }

      // online softmax on the fragments: rows ra (e = 0, 1), ra + 8 (2, 3)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float base[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        // a row with no valid key so far keeps p = 0 (not NaN)
        base[j] = mx[j] == -INFINITY ? 0.f : mx[j];
        const float alpha = exp2f(m[j] - base[j]);
        m[j] = mx[j];
        l[j] *= alpha;
#pragma unroll
        for (int d = 0; d < DB; ++d) {
          o[d][2 * j] *= alpha;
          o[d][2 * j + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f(s[n][e] - base[e >> 1]);
          l[e >> 1] += s[n][e];
        }
      }

      // O += P V: the score fragments of keys [16 ks, 16 ks + 16) are the
      // A operand; V through ldmatrix.trans is the col-major B operand
#pragma unroll
      for (int ks = 0; ks < BNW / 16; ++ks) {
        const float p[8] = {s[2 * ks][0],     s[2 * ks][1],
                            s[2 * ks][2],     s[2 * ks][3],
                            s[2 * ks + 1][0], s[2 * ks + 1][1],
                            s[2 * ks + 1][2], s[2 * ks + 1][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ph[x] = pack_bf16(p[2 * x], p[2 * x + 1]);
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ph[x]));
          pl[x] = pack_bf16(p[2 * x] - hi.x, p[2 * x + 1] - hi.y);
        }
#pragma unroll
        for (int d = 0; d < DB; d += 2) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + ks * 16 * LD + d * 8);
          mma_bf16(o[d], ph, vb[0], vb[1]);
          mma_bf16(o[d + 1], ph, vb[2], vb[3]);
          mma_bf16(o[d], pl, vb[0], vb[1]);
          mma_bf16(o[d + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  bf16* og = static_cast<bf16*>(a.out) + b * a.os.b +
             (long long)h * G * a.os.h;

  if constexpr (KS == 1) {
    // normalise, stage the warp's 16 rows in its own rows of q_s (bf16),
    // then 16-byte stores; a row with no valid key has l = 0: zeros
    if (!warp_live) return;
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                          l[1] > 0.f ? 1.f / l[1] : 0.f};
    bf16* stage = q_s + grp * 16 * LD;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      bf16* dst = stage + (lane / 4) * LD + d * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(dst + 8 * LD) =
          pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int R = wr0 + r;
      if (R < live) {
        *reinterpret_cast<uint4*>(og + (R % G) * a.os.h +
                                  (long long)(R / G) * a.os.s + col) =
            *reinterpret_cast<const uint4*>(stage + r * LD + col);
      }
    }
  } else {
    // merge the KS slices of each row: slice s weighs its partial output
    // by exp2(m_s - M) / L, M the largest m_s and L = sum_s exp2(m_s - M)
    // l_s, in f32 through shared memory (the K/V tiles are free now); the
    // slices are summed in order, so a call is deterministic
    constexpr int LDP = HD + 4;
    float* part = reinterpret_cast<float*>(smem);   // [KS][BM][LDP]
    float* m_sh = part + KS * BM * LDP;             // [KS][BM]
    float* l_sh = m_sh + KS * BM;
    const int row = grp * 16 + lane / 4;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        m_sh[sl * BM + row + 8 * j] = m[j];
        l_sh[sl * BM + row + 8 * j] = l[j];
      }
    }
    __syncthreads();
    float f[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row + 8 * j;
      float M = -INFINITY;
#pragma unroll
      for (int x = 0; x < KS; ++x) M = fmaxf(M, m_sh[x * BM + r]);
      const float Mb = M == -INFINITY ? 0.f : M;
      float L = 0.f;
#pragma unroll
      for (int x = 0; x < KS; ++x) {
        L += exp2f(m_sh[x * BM + r] - Mb) * l_sh[x * BM + r];
      }
      f[j] = L > 0.f ? exp2f(m[j] - Mb) / L : 0.f;
    }
    float* mine = part + sl * BM * LDP;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      float* dst = mine + row * LDP + d * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst) =
          make_float2(o[d][0] * f[0], o[d][1] * f[0]);
      *reinterpret_cast<float2*>(dst + 8 * LDP) =
          make_float2(o[d][2] * f[1], o[d][3] * f[1]);
    }
    __syncthreads();
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int R = r0 + r;
      if (R >= live) continue;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int x = 0; x < KS; ++x) {
        const float* src = part + (x * BM + r) * LDP + col;
        const float4 lo4 = *reinterpret_cast<const float4*>(src);
        const float4 hi4 = *reinterpret_cast<const float4*>(src + 4);
        acc[0] += lo4.x;
        acc[1] += lo4.y;
        acc[2] += lo4.z;
        acc[3] += lo4.w;
        acc[4] += hi4.x;
        acc[5] += hi4.y;
        acc[6] += hi4.z;
        acc[7] += hi4.w;
      }
      const uint4 u = {pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                       pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7])};
      *reinterpret_cast<uint4*>(og + (R % G) * a.os.h +
                                (long long)(R / G) * a.os.s + col) = u;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows (position x head) per block
constexpr int kBK = 32;     // keys per tile
constexpr int kLP = kBK + 1;

// Shared memory (f32): the query tile, one K and one V tile (rows padded
// to hd + 1), the tile's scores / probabilities, and the running max,
// denominator and rescale factor of each row.
__host__ __device__ constexpr size_t fma_smem(int hd) {
  return ((size_t)(kRows + 2 * kBK) * (hd + 1) + (size_t)kRows * kLP +
          3 * kRows) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fma(const Args a, int BQ, int nqt) {
  constexpr int LD = HD + 1;
  constexpr int PARTS = HD / 4;   // 16-byte chunks per row
  constexpr int TD = HD / 16;     // output dims per thread
  extern __shared__ float smem_f[];
  float* q_s = smem_f;
  float* k_s = q_s + kRows * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  float* m_s = p_s + kRows * kLP;
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int G = a.G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;
  const int b = bh / a.KV;
  const int h = bh % a.KV;
  const int q0 = qt * BQ;
  const int nq = min(BQ, a.Sq - q0);   // query positions in this tile
  const int live = nq * G;             // rows r < live are real; r -> (r / G, r % G)

  for (int c = tid; c < kRows * PARTS; c += kThreads) {
    const int r = c / PARTS;
    const int part = c % PARTS;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) {
      f = *reinterpret_cast<const float4*>(
          q + b * a.qs.b + (long long)(h * G + r % G) * a.qs.h +
          (long long)(q0 + r / G) * a.qs.s + part * 4);
    }
    float* dst = q_s + r * LD + part * 4;
    dst[0] = f.x;
    dst[1] = f.y;
    dst[2] = f.z;
    dst[3] = f.w;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // keys any row of this tile may see; tiles outside are skipped
  int kmin, kmax;
  key_range(a, q0, q0 + nq - 1, kmin, kmax);
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
      float4 fk = make_float4(0.f, 0.f, 0.f, 0.f), fv = fk;
      if (key >= kmin && key <= kmax) {
        fk = *reinterpret_cast<const float4*>(k + b * a.ks.b + h * a.ks.h +
                                              key * a.ks.s + part * 4);
        fv = *reinterpret_cast<const float4*>(v + b * a.vs.b + h * a.vs.h +
                                              key * a.vs.s + part * 4);
      }
      float* kd = k_s + r * LD + part * 4;
      float* vd = v_s + r * LD + part * 4;
      kd[0] = fk.x;
      kd[1] = fk.y;
      kd[2] = fk.z;
      kd[3] = fk.w;
      vd[0] = fv.x;
      vd[1] = fv.y;
      vd[2] = fv.z;
      vd[3] = fv.w;
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
      const int qpos = a.q_offset + q0 + r / G;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + cg + 16 * j;
        const bool ok = r < live && key_ok(a, key, qpos);
        p_s[r * kLP + cg + 16 * j] = ok ? sc[i][j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row, a lane per key
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float s = p_s[r * kLP + lane];
      const bool ok = s > 0.5f * kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(ok ? s : kNegInf));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
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
    float* dst = static_cast<float*>(a.out) + b * a.os.b +
                 (long long)(h * G + r % G) * a.os.h +
                 (long long)(q0 + r / G) * a.os.s + cg;
#pragma unroll
    for (int j = 0; j < TD; ++j) dst[16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit once, at its first launch,
// to the most any of its launches takes: a launch captured into a CUDA
// graph later then issues no attribute call
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t most, bool* configured) {
  if (*configured || most <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  *configured = e == cudaSuccess;
  return e;
}

// the tile plan of split KS: 64 / KS packed rows a block, one stage when
// every key fits one tile (kernels/flash_attention.py mma_plan)
template <int HD, int KS>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  constexpr int BM = 64 / KS;
  const long long ntq = ((long long)a.Sq * a.G + BM - 1) / BM;
  const long long blocks = (long long)B * a.KV * ntq;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int stages = a.Skv > KS * warp_keys(HD, KS) ? 2 : 1;
  const cudaError_t e = allow_smem(flash_attention_mma<HD, KS>,
                                   mma_smem(HD, KS, 2), &configured);
  if (e != cudaSuccess) return (int)e;
  flash_attention_mma<HD, KS>
      <<<(unsigned)blocks, kMmaWarps * 32, mma_smem(HD, KS, stages),
         stream>>>(a, (int)ntq, stages);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fma(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  const int BQ = kRows / a.G;
  const int nqt = (a.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)B * a.KV * nqt;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      allow_smem(flash_attention_fma<HD>, fma_smem(HD), &configured);
  if (e != cudaSuccess) return (int)e;
  flash_attention_fma<HD>
      <<<(unsigned)blocks, kThreads, fma_smem(HD), stream>>>(a, BQ, nqt);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_split(const Args& a, int B, int split, cudaStream_t s) {
  switch (split) {
    case 1: return launch_mma<HD, 1>(a, B, s);
    case 4: return launch_mma<HD, 4>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; strides in elements, (batch, head,
// position) for each of q, k, v, out; window <= 0 means none.  split is
// the wrapper's tile plan: 1 or 4 warps over each 16-row group's keys in
// bf16, 1 in f32 (the CUDA-core kernel has one plan); the call refuses any
// other.  Returns the launch's cudaError_t.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* out, long long qsb,
                          long long qsh, long long qss, long long ksb,
                          long long ksh, long long kss, long long vsb,
                          long long vsh, long long vss, long long osb,
                          long long osh, long long oss, int B, int H, int KV,
                          int Sq, int Skv, int hd, int causal, int window,
                          int q_offset, float scale, int split,
                          void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || H / KV > kRows || Sq <= 0 || Skv < 0 ||
      (hd != 64 && hd != 128 && hd != 256) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, out, {qsb, qsh, qss}, {ksb, ksh, kss},
               {vsb, vsh, vss}, {osb, osh, oss}, KV, H / KV, Sq, Skv, causal,
               window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (split != 1) return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 64: return launch_fma<64>(a, B, s);
      case 128: return launch_fma<128>(a, B, s);
      default: return launch_fma<256>(a, B, s);
    }
  }
  switch (hd) {
    case 64: return dispatch_split<64>(a, B, split, s);
    case 128: return dispatch_split<128>(a, B, split, s);
    default: return dispatch_split<256>(a, B, split, s);
  }
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
