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
// against 33.6 MB, 0.104 ms on the tensor cores.  In f32 the bytes double
// and f32-exact products go at 495 / 3 = 165 TFLOP/s through 3xTF32, not
// at the CUDA cores' 67: the f32 128-token recurrentgemma prefill moves
// 4.5 MB (1.33 us) for 0.135 GFLOP (0.82 us at 165 TFLOP/s), bytes; the
// reference's bench shape (S 512, H 4, KV 2, hd 64) 1.6 MB (0.47 us) for
// 0.134 GFLOP (0.82 us), operations; the 4 x 143-token MoE forwards
// operations (15 us at 67 TFLOP/s, 6.1 at 165).  Latency bounds all of
// them in practice, as in bf16.
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
//   * f32: the bf16 kernel's frame (packed 16-row groups, the plan's
//     key split over 1 or 4 warps with the f32 merge, latest blocks
//     first, the online softmax on the fragments in log2 units, K/V by
//     cp.async in two stages, key tiles outside the range never loaded)
//     with each product on mma.sync m16n8k8 in tf32 three times: an f32
//     x = hi + lo, both rounded by cvt.rna, and a * b = hi * hi + hi * lo
//     + lo * hi with f32 accumulators.  The dropped lo * lo and the
//     rounding of lo leave ~2^-22 relative a product (the CPU mirror
//     shows 6.7e-7 to 2.2e-6 against the f32 oracle); one TF32 product
//     alone (~2^-11) misses the 1e-4 gate by 8-14x.  Q is split once, as
//     it is loaded, into hi and lo tiles (every warp reads it at every
//     key tile); K, V and P are split at each fragment load: at split 4,
//     the plan of every short main-path shape, each K/V element is split
//     once either way, and a split as the tile lands would add a store,
//     a load and a barrier a tile and double the K/V shared memory (no
//     two-stage hd 256 plan then fits the card; a variant built so was
//     slower at every shape that fits, S 512 0.0272 against 0.0183 ms
//     on an NVIDIA H100 80GB HBM3 at 700.00 W).  ldmatrix
//     is b16 only, so fragments are 32-bit shared loads, paired where
//     the layout allows: a k8 step takes its columns in the order (2u,
//     2u + 1) for lane u of a quad, so Q's and K's a0 / a2 and b0 / b1
//     are one 8-byte load (rows of hd + 8 floats: a half-warp's eight
//     rows x four lanes cover the 32 banks once), and P V takes its keys
//     the same way, so the score accumulators are the A operand as they
//     stand and V's b0 / b1 are rows 2u and 2u + 1 at column g (rows of
//     hd + 4 floats: banks 8u + g, free of conflicts).  The tiles are
//     twice bf16's bytes, so a warp takes the most keys (up to 64) whose
//     two stages leave room for a second block on the SM: 64 / 16 keys
//     at hd 64 (split 1 / 4), 16 / 8 at 128; at hd 256 no two-stage plan
//     leaves room for two, and a warp takes 16 / 8 (202 / 168 KB).  Q's
//     hi and lo fragments are read from shared memory at each k-step at
//     every hd (in registers they would take hd of them a thread; at hd
//     256 the warp's 16 x 256 output already takes 128); ptxas reports
//     124-246 registers and no spill.  Measured on an NVIDIA H100 80GB
//     HBM3 at 700.00 W (chip_smoke.py phase 9 and 22b,
//     tools/turns.py; CUDA-graph replay): 0.0212 ms at the f32
//     128-token prefill (the first design 0.0634, SDPA 0.0428), 0.0183
//     ms at the reference's bench shape (0.0981; SDPA 0.0569), 0.0722 ms
//     at the 4 x 143-token MoE forwards (0.1194; SDPA 0.2184) and 0.0054
//     ms at each of the default serve path's calls (0.0153 and 0.0095;
//     SDPA 0.0312 and 0.0266): 0.5-14 % of the bound, short walks bound
//     by latency as in bf16.
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
constexpr int kMaxGroup = 64;   // query heads per KV head (MAX_GROUP)

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
// f32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// Keys one warp of the f32 kernel takes from each key tile (tile_plan's
// rule): the most, up to 64, whose two stages leave room for a second
// block on the SM, else the most that fit one block.
__host__ __device__ constexpr int tf32_warp_keys(int hd, int split) {
  return split == 1 ? (hd == 64 ? 64 : 16) : (hd == 64 ? 16 : 8);
}

// shared memory of an f32 block: the query tile as tf32 hi and lo (rows
// of hd + 8 floats) and `stages` K tiles (rows of hd + 8) and V tiles
// (hd + 4) while it walks the keys; the split's partial outputs and
// (m, l) when it merges them
__host__ __device__ constexpr size_t tf32_smem(int hd, int split,
                                              int stages) {
  const size_t rows = 64 / split;
  const size_t bk = (size_t)split * tf32_warp_keys(hd, split);
  const size_t kv = stages * bk * (2 * hd + 12);
  const size_t walk = (2 * rows * (hd + 8) + kv) * sizeof(float);
  const size_t merge =
      split > 1 ? (64 * (size_t)(hd + 4) + 2 * 64) * sizeof(float) : 0;
  return walk > merge ? walk : merge;
}

// The bf16 kernel's frame with f32 operands: each product is three tf32
// MMAs, hi * hi + hi * lo + lo * hi.  A thread's fragments are 8-byte
// loads where it can: the k8 step's columns are taken in the order
// (2u, 2u + 1) for lane u of a quad, so a0 / a2 (and b0 / b1 of K) are
// one float2; for P V the keys are taken the same way, which makes the
// score accumulators (keys 2u, 2u + 1) the A operand as they stand.
template <int HD, int KS>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_attention_tf32(const Args a, int ntq, int stages) {
  constexpr int BM = 64 / KS;          // packed query rows per block
  constexpr int BNW = tf32_warp_keys(HD, KS);
  constexpr int BN = KS * BNW;         // keys per tile
  constexpr int LDK = HD + 8;          // Q and K rows, floats
  constexpr int LDV = HD + 4;          // V rows, floats
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kChunks = HD / 4;      // 16-byte chunks per row
  constexpr int NB = BNW / 8;          // n8 blocks of a warp's scores
  constexpr int DB = HD / 8;           // n8 blocks of the output
  extern __shared__ __align__(16) unsigned char smem[];
  float* qh_s = reinterpret_cast<float*>(smem);
  float* ql_s = qh_s + BM * LDK;
  float* k_s = ql_s + BM * LDK;
  float* v_s = k_s + stages * BN * LDK;

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

  // four values as tf32 hi and lo
  auto split4 = [](const float4 v, float* hi, float* lo) {
    uint4 hi4, lo4;
    split_tf32(v.x, hi4.x, lo4.x);
    split_tf32(v.y, hi4.y, lo4.y);
    split_tf32(v.z, hi4.z, lo4.z);
    split_tf32(v.w, hi4.w, lo4.w);
    *reinterpret_cast<uint4*>(hi) = hi4;
    *reinterpret_cast<uint4*>(lo) = lo4;
  };

  const float* qg = static_cast<const float*>(a.q) + b * a.qs.b +
                    (long long)h * G * a.qs.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks.b +
                    h * a.ks.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.vs.b +
                    h * a.vs.h;

  // K/V rows [t * BN, t * BN + BN) into stage st; keys outside
  // [kmin, kmax] are zero-filled (never read from memory)
  auto load_kv = [&](int t, int st) {
    float* kd = k_s + st * BN * LDK;
    float* vd = v_s + st * BN * LDV;
    for (int c = tid; c < BN * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const int key = t * BN + r;
      const bool ok = key >= kmin && key <= kmax;
      cp_async16(kd + r * LDK + col, kg + (ok ? key * a.ks.s + col : 0), ok);
      cp_async16(vd + r * LDV + col, vg + (ok ? key * a.vs.s + col : 0), ok);
    }
  };

  if (ntiles > 0) {
    load_kv(t_lo, 0);
    // Q is split once, as it lands: every warp reads it at every tile
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const int R = r0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (R < live) {
        x = *reinterpret_cast<const float4*>(
            qg + (R % G) * a.qs.h + (long long)(R / G) * a.qs.s + col);
      }
      split4(x, qh_s + r * LDK + col, ql_s + r * LDK + col);
    }
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
  const int u2 = 2 * (lane & 3);

  float o[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's columns; summed over the quad
  // fragment offsets: Q rows g and g + 8 and K row g at column 2u; V rows
  // 2u and 2u + 1 at column g (g = lane / 4, u = lane % 4)
  const int q_off = (grp * 16 + lane / 4) * LDK + u2;
  const int k_off = (sl * BNW + lane / 4) * LDK + u2;
  const int v_off = (sl * BNW + u2) * LDV + lane / 4;

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
    const int k0 = (t_lo + i) * BN + sl * BNW;   // this warp's first key
    // keys none of this warp's rows may see are skipped
    const bool skip = !warp_live || (a.causal && k0 > whi) ||
                      (a.window > 0 && k0 + BNW - 1 <= wlo - a.window);
    if (!skip) {
      const float* kt = k_s + st * BN * LDK + k_off;
      const float* vt = v_s + st * BN * LDV + v_off;
      // hi * hi, and the two cross terms apart: two short chains
      float s[NB][4], c[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = c[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float2 h0 = *reinterpret_cast<const float2*>(qh_s + q_off +
                                                           kk * 8);
        const float2 h1 = *reinterpret_cast<const float2*>(
            qh_s + q_off + 8 * LDK + kk * 8);
        const float2 l0 = *reinterpret_cast<const float2*>(ql_s + q_off +
                                                           kk * 8);
        const float2 l1 = *reinterpret_cast<const float2*>(
            ql_s + q_off + 8 * LDK + kk * 8);
        const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                __float_as_uint(h0.y), __float_as_uint(h1.y)};
        const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              kt + n * 8 * LDK + kk * 8);
          uint32_t bh[2], bl[2];
          split_tf32(kv.x, bh[0], bl[0]);
          split_tf32(kv.y, bh[1], bl[1]);
          mma_tf32(s[n], ah, bh);
          mma_tf32(c[n], ah, bl);
          mma_tf32(c[n], al, bh);
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
          s[n][e] = (s[n][e] + c[n][e]) * sl2;
          if (edge && !key_ok(a, k0 + n * 8 + u2 + (e & 1), qpos[e >> 1])) {
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

      // O += P V over keys [8 n, 8 n + 8): the thread's scores of keys
      // 2u, 2u + 1 are a0 / a2 (row ra) and a1 / a3 (row ra + 8); V's
      // rows 2u and 2u + 1 are b0 and b1
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t ph[4], pl[4];
        split_tf32(s[n][0], ph[0], pl[0]);
        split_tf32(s[n][2], ph[1], pl[1]);
        split_tf32(s[n][1], ph[2], pl[2]);
        split_tf32(s[n][3], ph[3], pl[3]);
        const float* vn = vt + n * 8 * LDV;
#pragma unroll
        for (int d = 0; d < DB; ++d) {
          uint32_t bh[2], bl[2];
          split_tf32(vn[d * 8], bh[0], bl[0]);
          split_tf32(vn[LDV + d * 8], bh[1], bl[1]);
          mma_tf32(o[d], pl, bh);
          mma_tf32(o[d], ph, bl);
          mma_tf32(o[d], ph, bh);
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
  float* og = static_cast<float*>(a.out) + b * a.os.b +
              (long long)h * G * a.os.h;

  if constexpr (KS == 1) {
    // normalise, stage the warp's 16 rows in its own rows of qh_s, then
    // 16-byte stores; a row with no valid key has l = 0: zeros
    if (!warp_live) return;
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                          l[1] > 0.f ? 1.f / l[1] : 0.f};
    float* stage = qh_s + grp * 16 * LDK;
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      float* dst = stage + (lane / 4) * LDK + d * 8 + u2;
      *reinterpret_cast<float2*>(dst) =
          make_float2(o[d][0] * inv[0], o[d][1] * inv[0]);
      *reinterpret_cast<float2*>(dst + 8 * LDK) =
          make_float2(o[d][2] * inv[1], o[d][3] * inv[1]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * kChunks; c += 32) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const int R = wr0 + r;
      if (R < live) {
        *reinterpret_cast<float4*>(og + (R % G) * a.os.h +
                                   (long long)(R / G) * a.os.s + col) =
            *reinterpret_cast<const float4*>(stage + r * LDK + col);
      }
    }
  } else {
    // merge the KS slices of each row as the bf16 kernel does
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
      float* dst = mine + row * LDP + d * 8 + u2;
      *reinterpret_cast<float2*>(dst) =
          make_float2(o[d][0] * f[0], o[d][1] * f[0]);
      *reinterpret_cast<float2*>(dst + 8 * LDP) =
          make_float2(o[d][2] * f[1], o[d][3] * f[1]);
    }
    __syncthreads();
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const int R = r0 + r;
      if (R >= live) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int x = 0; x < KS; ++x) {
        const float4 p =
            *reinterpret_cast<const float4*>(part + (x * BM + r) * LDP + col);
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
      *reinterpret_cast<float4*>(og + (R % G) * a.os.h +
                                 (long long)(R / G) * a.os.s + col) = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit once, at its first launch,
// to the most any of its launches takes: a launch captured into a CUDA
// graph later then issues no attribute call.  A refusal is returned and
// cleared, so the next launch's cudaGetLastError does not report it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t most, bool* configured) {
  if (*configured || most <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  *configured = e == cudaSuccess;
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// the tile plan of split KS: 64 / KS packed rows a block, one stage when
// every key fits one tile (kernels/flash_attention.py mma_plan)
template <bool F32, int HD, int KS>
int launch(const Args& a, int B, cudaStream_t stream) {
  static bool configured = false;
  constexpr int BM = 64 / KS;
  constexpr int BN = KS * (F32 ? tf32_warp_keys(HD, KS) : warp_keys(HD, KS));
  constexpr auto smem = F32 ? tf32_smem : mma_smem;
  const auto kernel =
      F32 ? flash_attention_tf32<HD, KS> : flash_attention_mma<HD, KS>;
  const long long ntq = ((long long)a.Sq * a.G + BM - 1) / BM;
  const long long blocks = (long long)B * a.KV * ntq;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int stages = a.Skv > BN ? 2 : 1;
  const cudaError_t e = allow_smem(kernel, smem(HD, KS, 2), &configured);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kMmaWarps * 32, smem(HD, KS, stages),
           stream>>>(a, (int)ntq, stages);
  return (int)cudaGetLastError();
}

template <bool F32, int HD>
int dispatch_split(const Args& a, int B, int split, cudaStream_t s) {
  switch (split) {
    case 1: return launch<F32, HD, 1>(a, B, s);
    case 4: return launch<F32, HD, 4>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool F32>
int dispatch_hd(const Args& a, int B, int hd, int split, cudaStream_t s) {
  switch (hd) {
    case 64: return dispatch_split<F32, 64>(a, B, split, s);
    case 128: return dispatch_split<F32, 128>(a, B, split, s);
    default: return dispatch_split<F32, 256>(a, B, split, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; strides in elements, (batch, head,
// position) for each of q, k, v, out; window <= 0 means none.  split is
// the wrapper's tile plan: 1 or 4 warps over each 16-row group's keys; the
// call refuses any other.  Returns the launch's cudaError_t.
int repro_flash_attention(int dtype, const void* q, const void* k,
                          const void* v, void* out, long long qsb,
                          long long qsh, long long qss, long long ksb,
                          long long ksh, long long kss, long long vsb,
                          long long vsh, long long vss, long long osb,
                          long long osh, long long oss, int B, int H, int KV,
                          int Sq, int Skv, int hd, int causal, int window,
                          int q_offset, float scale, int split,
                          void* stream) {
  if (B <= 0 || KV <= 0 || H % KV || H / KV > kMaxGroup || Sq <= 0 ||
      Skv < 0 || (hd != 64 && hd != 128 && hd != 256) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, out, {qsb, qsh, qss}, {ksb, ksh, kss},
               {vsb, vsh, vss}, {osb, osh, oss}, KV, H / KV, Sq, Skv, causal,
               window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_hd<true>(a, B, hd, split, s)
                    : dispatch_hd<false>(a, B, hd, split, s);
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
