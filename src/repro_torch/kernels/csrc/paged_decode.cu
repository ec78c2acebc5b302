// Paged flash decode for Hopper (sm_90a): one query token per lane
// against a shared KV page pool.
//
// Replaces the TPU kernel decode_attention.py:_paged_decode_kernel
// (src/repro/kernels/decode_attention.py, pl.pallas_call at line 220).
// It computes what that kernel computes, not a block-by-block copy:
//   q (B, H, hd); k/v pools (P, KV, ps, hd); tables (B, W) int32;
//   lengths (B,) int32; out (B, H, hd) in q's dtype.
//   Page j of lane b is tables[b, j] clamped to [0, P-1].  Softmax in f32,
//   masked to min(lengths[b], W * ps); pages past that are never read.  A
//   lane of length 0 writes zeros.
//
// What bounds it on an H100: the bytes of K/V it must read,
//   2 * sum_b len_b * KV * hd * sizeof(dtype),
// at 3.35 TB/s (its arithmetic, 4 * sum_b len_b * H * hd flops, is far
// below the tensor cores' rate).  At the serving path's shapes (8 lanes of
// qwen2-1.5b, 2 KV heads, 6 query heads each, hd 128, up to 240 tokens)
// that is 0.2 us; at 8 lanes of 2048 tokens 2.5 us.  So a call is bound by
// latency: two launches, the block table's load, then the pages' loads.
//
// What this design does about that (decode_split.cuh has the kernels): the
// first version ran one block per (lane, KV head), 16 blocks on 132 SMs,
// each walking up to 15 pages in sequence.  Now each lane's pages are split
// across blocks: a split kernel with one block per (lane, KV head, 16
// query heads, run of per_split / ps pages) loads its own block-table
// entries, clamps them, brings its pages' K/V rows in by 16-byte cp.async
// and writes partial (m, l, acc) states; a merge kernel combines them.  The
// split plan comes from the table's shape only (kernels/decode_attention.py
// split_plan), so a call never reads the lengths on the host and can be
// captured in a CUDA graph; splits wholly past a lane's length return at
// once.  bf16 takes the tensor cores (mma.sync m16n8k16; qwen2's G = 6
// heads fill 6 of the 16 rows), f32 stays on FMAs.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2,
// CUDA-graph replay): bf16 0.0078 ms at the serve shape (the first
// version 0.0598) and 0.0143 ms at 8 lanes of 2048 tokens (0.4947), below
// SDPA's 0.0116 and 0.0149 ms.  Variants timed against it in one run, bf16
// at the serve shape / 8 x 2048 tokens: the same design on FMAs instead
// of mma.sync, 0.0110 / 0.0262 ms (G = 6 pads the m16 rows, yet the
// tensor cores pay); K/V by 16-byte vector loads staged through registers
// instead of cp.async, 0.0083 / 0.0240 ms (the staging takes 160 registers
// a thread against 72); the merge launched without programmatic
// dependent launch, 0.0087 / 0.0150 ms.  Without it the profiler puts
// 5.3 us of a serve-shape call in the split kernel and 3.25 us in the
// merge; with it the merge's start overlaps the split's tail (and the
// profiler's merge time, counted from when its blocks start waiting, is
// an upper bound).  What is left is latency: two dependent launches, and
// three or four dependent trips to memory a block.
//
// A windowed layer (models/attention.py paged_decode_attend) takes its own
// entry, repro_paged_decode_window, and its own pair of kernels,
// paged_window_split_kernel and paged_window_merge_kernel: the same body
// (kWindow) over the last `window` positions of each lane, first =
// max(0, len - window) to len.  The pages wholly before first are never
// read, and the first page's positions before first are never loaded; the
// split plan covers min(window, W * ps) positions, so a 1024-token window
// over a 3648-token table takes the splits of 1024 positions, not 3648.
//
// A pool cut over the data ranks of a mesh (models/attention.py
// paged_decode) takes the two passes apart: each rank runs the split pass
// alone over its block of pages (repro_paged_decode_partials, through a
// compacted table of the lane's pages in that block), the partials are
// all-gathered over the data ranks, and flash_decode.cu's merge pass alone
// (repro_decode_merge) combines every rank's.
//
// Built by repro_torch/kernels/decode_attention.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: each C entry point launches its kernels,
// returns the CUDA error of the launches (0 on success) and never
// synchronises.

#include "decode_split.cuh"

namespace {

using decode_split::Params;

template <typename T>
__global__ void __launch_bounds__(decode_split::kThreads)
paged_decode_split_kernel(const Params p) {
  decode_split::split_body<T, /*kPaged=*/true>(p);
}

template <typename T>
__global__ void __launch_bounds__(decode_split::kMergeThreads)
paged_decode_merge_kernel(const Params p) {
  decode_split::merge_body<T>(p);
}

// the split pass alone over one rank's block of a pool cut over the data
// ranks of a mesh (merged by flash_decode.cu's repro_decode_merge)
template <typename T>
__global__ void __launch_bounds__(decode_split::kThreads)
paged_decode_partials_kernel(const Params p) {
  decode_split::split_body<T, /*kPaged=*/true, /*kEmpty=*/true>(p);
}

// the windowed pair: each lane's last p.window positions
template <typename T>
__global__ void __launch_bounds__(decode_split::kThreads)
paged_window_split_kernel(const Params p) {
  decode_split::split_body<T, /*kPaged=*/true, /*kEmpty=*/false,
                           /*kWindow=*/true>(p);
}

template <typename T>
__global__ void __launch_bounds__(decode_split::kMergeThreads)
paged_window_merge_kernel(const Params p) {
  decode_split::merge_body<T, /*kAll=*/false, /*kWindow=*/true>(p);
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  return decode_split::launch_pair(paged_decode_split_kernel<T>,
                                   paged_decode_merge_kernel<T>, &configured,
                                   p, B, sizeof(T), stream);
}

template <typename T>
int launch_window(const Params& p, int B, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  return decode_split::launch_pair(paged_window_split_kernel<T>,
                                   paged_window_merge_kernel<T>, &configured,
                                   p, B, sizeof(T), stream);
}

template <typename T>
int launch_partials(const Params& p, int B, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  return decode_split::launch_split(paged_decode_partials_kernel<T>,
                                    &configured, p, B, sizeof(T), stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  ws: n_splits * B * H * (hd + 2)
// floats of partials.  Returns the launches' cudaError_t.
int repro_paged_decode(int dtype, const void* q, const void* k_pages,
                       const void* v_pages, const int* tables,
                       const int* lengths, void* out, float* ws, int B,
                       int H, int KV, int P, int ps, int hd, int W,
                       int per_split, int n_splits, float scale,
                       void* stream) {
  if (KV <= 0 || H % KV || P <= 0 || ps <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.lengths = lengths;
  p.tables = tables;
  p.out = out;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.n_positions = W * ps;
  p.per_split = per_split;
  p.n_splits = n_splits;
  p.P = P;
  p.ps = ps;
  p.W = W;
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

// repro_paged_decode over the last `window` (> 0) positions of each lane:
// the splits (per_split x n_splits) cover min(window, W * ps) positions
// from each lane's first, max(0, len - window).  Returns the launches'
// cudaError_t.
int repro_paged_decode_window(int dtype, const void* q, const void* k_pages,
                              const void* v_pages, const int* tables,
                              const int* lengths, void* out, float* ws,
                              int B, int H, int KV, int P, int ps, int hd,
                              int W, int window, int per_split, int n_splits,
                              float scale, void* stream) {
  if (KV <= 0 || H % KV || P <= 0 || ps <= 0 || W <= 0 || window <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.lengths = lengths;
  p.tables = tables;
  p.out = out;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.n_positions = W * ps;
  p.per_split = per_split;
  p.n_splits = n_splits;
  p.P = P;
  p.ps = ps;
  p.W = W;
  p.scale = scale;
  p.window = window;
  const size_t rows = (size_t)B * H * n_splits;
  p.acc = ws;
  p.m = ws + rows * hd;
  p.l = p.m + rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_window<float>(p, B, s);
  if (dtype == 1) return launch_window<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// The split pass alone, for one rank's block of a page pool cut over the
// data ranks of a mesh: tables (B, W) hold the lane's pages in this block
// as local ids in [0, P), in position order, and lengths (B,) the valid
// positions they hold.  Writes the partials of every (lane, KV head,
// split) into acc (B, KV, n_splits, G, hd), m and l (B, KV, n_splits, G),
// an empty partial (m = -inf, l = 0, acc = 0) for each split at or past
// the lane's length.  Returns the launch's cudaError_t.
int repro_paged_decode_partials(int dtype, const void* q, const void* k_pages,
                                const void* v_pages, const int* tables,
                                const int* lengths, float* acc, float* m,
                                float* l, int B, int H, int KV, int P,
                                int ps, int hd, int W, int per_split,
                                int n_splits, float scale, void* stream) {
  if (KV <= 0 || H % KV || P <= 0 || ps <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.lengths = lengths;
  p.tables = tables;
  p.KV = KV;
  p.G = H / KV;
  p.hd = hd;
  p.n_positions = W * ps;
  p.per_split = per_split;
  p.n_splits = n_splits;
  p.P = P;
  p.ps = ps;
  p.W = W;
  p.scale = scale;
  p.acc = acc;
  p.m = m;
  p.l = l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_partials<float>(p, B, s);
  if (dtype == 1) return launch_partials<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes one split block needs, so the wrapper can refuse
// shapes that do not fit before it launches.
long long repro_paged_decode_smem_bytes(int hd, int elem_bytes,
                                        int per_split) {
  return (long long)decode_split::layout(
             hd, elem_bytes, decode_split::stages_for(per_split))
      .total;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
