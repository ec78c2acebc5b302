// Flash decode for Hopper (sm_90a): one query token per lane against a
// dense per-lane KV cache.
//
// Replaces the TPU kernel decode_attention.py:_decode_kernel
// (src/repro/kernels/decode_attention.py, pl.pallas_call at line 110).
// It computes what that kernel computes, not a block-by-block copy:
//   q (B, H, hd); k/v caches (B, KV, S, hd); lengths (B,) int32;
//   out (B, H, hd) in q's dtype.  Lane b attends the first
//   min(lengths[b], S) positions of its cache; positions past that are
//   never read.  Softmax in f32.  A lane of length 0 writes zeros, as the
//   TPU kernel does.  The serving engine's ring buffers need nothing more:
//   RoPE is applied when a position is written, so the order of the W slots
//   does not matter, and a ring that has wrapped has all W slots valid.
//
// What bounds it on an H100: the bytes of K/V it must read,
//   2 * sum_b min(len_b, S) * KV * hd * sizeof(dtype),
// at 3.35 TB/s; its arithmetic (4 * sum_b len_b * H * hd flops) is far
// below the tensor cores' rate.  At the serving path's shapes (4 slots, one
// KV head, 16 query heads, hd 256, up to 2048 positions) that is 0.2 to
// 2.5 us, so in practice a call is bound by latency: two launches, one
// round trip to device memory, and the serial steps of one block.
//
// What this design does about that (decode_split.cuh has the kernels): the
// first version ran one block per (lane, KV head), 4 blocks on 132 SMs,
// each walking its cache tile after tile (~15 us a tile).  Now each lane's
// cache is split across blocks: a split kernel with one block per
// (lane, KV head, 16 query heads, split of per_split positions) writes
// partial (m, l, acc) states, and a merge kernel combines them.  The split
// plan comes from shapes only (kernels/decode_attention.py split_plan), so a
// call never reads the lengths on the host and can be captured in a CUDA
// graph; splits wholly past a lane's length return at once.  A split's K/V
// arrive by cp.async in bf16 (no f32 copy), and in bf16 the scores and PV
// run on the tensor cores (mma.sync m16n8k16: the G = 16 query heads of
// recurrentgemma fill the m16 rows).  f32 stays on FMAs.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 10,
// CUDA-graph replay): bf16 0.0079 ms at the dense round (4 slots, 160-slot
// rings; the first version 0.0771) and 0.0126 ms at four full 2048-slot
// rings (0.9315), below SDPA's 0.0142 and 0.0148 ms.  Variants timed
// against it in one run (bf16, round / 2048 rings): FMAs instead of
// mma.sync 0.0150 / 0.0215 ms; K/V by 16-byte vector loads staged through
// registers instead of cp.async 0.0085 / 0.0130 ms; the merge without
// programmatic dependent launch 0.0087 / 0.0133 ms.  Without it the
// profiler puts 5.2 us of a round call in the split kernel and 3.2 us in
// the merge; with it the merge's start overlaps the split's tail (its
// profiled time, counted from when its blocks start waiting, is then an
// upper bound).  What is left is latency: two dependent launches, and
// three dependent trips to memory a block.
//
// A ring cut along its positions over the "model" ranks of a mesh
// (models/attention.py decode) takes the two passes apart: each rank runs
// the split pass alone over its slice (repro_flash_decode_partials), the
// partials are all-gathered, and the merge pass alone combines every
// rank's (repro_decode_merge).
//
// Built by repro_torch/kernels/decode_attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry point launches both kernels,
// returns the CUDA error of the launches (0 on success) and never
// synchronises.

#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <typename T>
__global__ void __launch_bounds__(decode_split::kThreads)
flash_decode_split_kernel(const Params p) {
  decode_split::split_body<T, /*kPaged=*/false>(p);
}

template <typename T>
__global__ void __launch_bounds__(decode_split::kMergeThreads)
flash_decode_merge_kernel(const Params p) {
  decode_split::merge_body<T>(p);
}

// the split-only and merge-only passes of a ring cut over several ranks
template <typename T>
__global__ void __launch_bounds__(decode_split::kThreads)
flash_decode_partials_kernel(const Params p) {
  decode_split::split_body<T, /*kPaged=*/false, /*kEmpty=*/true>(p);
}

template <typename T>
__global__ void __launch_bounds__(decode_split::kMergeThreads)
decode_merge_all_kernel(const Params p) {
  decode_split::merge_body<T, /*kAll=*/true>(p);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  return decode_split::launch_pair(flash_decode_split_kernel<T>,
                                   flash_decode_merge_kernel<T>, &configured,
                                   p, B, sizeof(T), stream);
}

template <typename T>
int launch_partials(const Params& p, int B, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  return decode_split::launch_split(flash_decode_partials_kernel<T>,
                                    &configured, p, B, sizeof(T), stream);
}

template <typename T>
int launch_merge(const Params& p, int B, cudaStream_t stream) {
  if (B <= 0 || p.KV <= 0 || p.G <= 0 || p.hd % 16 || p.hd <= 0 ||
      p.hd > decode_split::kMaxHeadDim || p.n_splits <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  decode_merge_all_kernel<T>
      <<<dim3(B * p.KV * p.G), decode_split::kMergeThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ws: n_splits * B * H * (hd + 2)
// floats of partials.  Returns the launches' cudaError_t.
int repro_flash_decode(int dtype, const void* q, const void* k,
                       const void* v, const int* lengths, void* out,
                       float* ws, int B, int H, int KV, int S, int hd,
                       int per_split, int n_splits, float scale,
                       void* stream) {
  if (KV <= 0 || H % KV || S <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = lengths;
  p.out = out;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.n_positions = S;
  p.per_split = per_split;
  p.n_splits = n_splits;
  p.S = S;
  p.scale = scale;
  const size_t rows = (size_t)B * H * n_splits;
  p.acc = ws;
  p.m = ws + rows * hd;
  p.l = p.m + rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// The split pass alone, for one rank's slice of a ring cut along its
// positions: the partials of every (lane, KV head, split) into acc
// (B, KV, n_splits, G, hd), m and l (B, KV, n_splits, G), with an empty
// partial (m = -inf, l = 0, acc = 0) for each split at or past the lane's
// length.  Returns the launch's cudaError_t.
int repro_flash_decode_partials(int dtype, const void* q, const void* k,
                                const void* v, const int* lengths,
                                float* acc, float* m, float* l, int B, int H,
                                int KV, int S, int hd, int per_split,
                                int n_splits, float scale, void* stream) {
  if (KV <= 0 || H % KV || S <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = lengths;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.n_positions = S;
  p.per_split = per_split;
  p.n_splits = n_splits;
  p.S = S;
  p.scale = scale;
  p.acc = acc;
  p.m = m;
  p.l = l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_partials<float>(p, B, s);
  if (dtype == 1) return launch_partials<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// The merge pass alone over all n_splits partials of each query row
// (acc (B, KV, n_splits, G, hd), m and l (B, KV, n_splits, G): the
// gathered partials of every rank's slice), empty ones included; out
// (B, KV * G, hd) in dtype (0 = float32, 1 = bfloat16), zeros for a row
// whose partials are all empty.  Returns the launch's cudaError_t.
int repro_decode_merge(int dtype, const float* acc, const float* m,
                       const float* l, void* out, int B, int KV, int G,
                       int hd, int n_splits, void* stream) {
  Params p{};
  p.acc = const_cast<float*>(acc);
  p.m = const_cast<float*>(m);
  p.l = const_cast<float*>(l);
  p.out = out;
  p.KV = KV;
  p.G = G;
  p.hd = hd;
  p.n_splits = n_splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_merge<float>(p, B, s);
  if (dtype == 1) return launch_merge<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes one split block needs, so the wrapper can refuse
// shapes that do not fit before it launches.
long long repro_flash_decode_smem_bytes(int hd, int elem_bytes,
                                        int per_split) {
  return (long long)decode_split::layout(
             hd, elem_bytes, decode_split::stages_for(per_split))
      .total;
}

const char* repro_flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
