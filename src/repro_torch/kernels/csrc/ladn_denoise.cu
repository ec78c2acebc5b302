// Fused LADN reverse-diffusion chain for Hopper (sm_90a).
//
// Replaces the TPU kernel ladn_denoise.py:_denoise_kernel
// (src/repro/kernels/ladn_denoise.py, pl.pallas_call at line 104).
// It computes what that kernel computes, for G stacked agents at once:
//   x_I (G, T, A), s (G, T, S), noise (G, T, I, A), temb_w1 (G, I, H);
//   the LADN's first layer as w1x (G, A, H) and w1s (G, S, H), each with
//   its own agent stride (the wrapper passes row slices of the stacked
//   (G, A + 16 + S, H) weight, no copies), bias b1 (G, H), then
//   w2 (G, H, H), b2 (G, H), w3 (G, H, A), b3 (G, A); out x_0 (G, T, A);
//   all f32.
// For each row, s @ w1s + b1 is computed once, then the I steps run in
// order, step = 0..I-1 (i = I - step):
//   h   = relu(x @ w1x + s_contrib + temb_w1[step])
//   h   = relu(h @ w2 + b2)
//   eps = h @ w3 + b3
//   x   = c0 * (x - c1 * eps) + c2 * noise[step]
// with (c0, c1, c2) = (lambda_i^-1/2, beta_i / sqrt(1 - lambda_bar_i),
// noise scale, 0 at i = 1) folded on the host from the schedule, as the
// Pallas kernel folds them into immediates.  G = 1 is exactly the
// reference kernel's function; G > 1 equals G separate calls.
//
// What bounds it on an H100: nothing the data sheet counts.  At the main
// path's widths (A 20, S 22, H 20, I 5) a row needs ~13 kflop and moves
// ~0.8 kB, the agents' weights ~7 kB each: the bytes bound of a whole
// call is 0.05 us (act) to 0.3 us (update).  The call is bound by
// latency: one launch (chip_smoke.py phase 5 times repro_ladn_noop, an
// empty kernel of this library, as the floor: 0.86 us in a CUDA graph on
// an H100 80GB HBM3 at 700 W), one round of ~130 loads a lane, then I
// dependent steps of three dependent 20 x 20 matrix-vector products
// (~0.26 us a step at width 24: tools/turns.py sweeps I).
//
// What the design does about that: everything of a row stays in one
// warp's registers for the whole chain, and every width is known to the
// compiler.
//  * ladn_regs_kernel<W> (A, S, H <= W, W = 24 or 32): lane j
//    owns hidden unit j and action j.  Each width is padded to W inside
//    the kernel (lanes and rows past the width load nothing and hold
//    zeros; nothing is padded in memory).  The lane keeps column j of
//    w1x, w1s, w2 and w3, its temb_w1[:, j], its noise[:, j] and its
//    biases in registers, issuing every load before the first FMA, so a
//    row pays one memory latency.  The weights' (in, out) layout makes
//    column j strided, so these are 4-byte loads, each warp-wide load one
//    coalesced row of the matrix.  x and h reach every lane by
//    __shfl_sync (no shared memory, no __syncwarp); each product is W
//    unrolled shuffle + FMA pairs summed in four partial sums (k % 4),
//    which shortens the FMA chain from W to W / 4.  The order of that sum
//    differs from the plain version's k-order; tests/_torch_ladn_sums.py
//    mirrors it within 1e-5.  Two classes rather than one of 32: the
//    main path's 20-22 wide rows at W = 32 took 242 registers (8 warps an
//    SM, 1.2 waves at the update shape) and 32 shuffles a product; at
//    W = 24 they take 168 and 24, and the update shape ran 1.8x faster.
//    Every LAD-TS configuration (hidden 20) runs W = 24; narrower classes
//    would serve no configuration.
//  * ladn_smem_kernel<W> (W = 64 or 128): the same lane ownership in
//    strides of 32 (W / 32 units a lane), the weights staged once per
//    block in zero-padded shared memory, the same unrolled shuffle
//    broadcast and the same four partial sums.  No main path reaches it.
// One warp is one row; a block holds the plan's rows
// (repro_torch/kernels/ladn_denoise.py:plan) and the grid is (row tiles,
// agents).  Tensor cores are not used: a product is 20 x 20, and f32 at
// the 1e-4 tolerance would take three bf16 or TF32 passes (the hi/lo
// split of the decode and attention kernels) for 13 kflop a row.  The
// cost is the step's dependent latency, not instruction throughput, and an
// mma.sync chain adds latency (fragments, passes) without removing any.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry points return the CUDA error of
// the launch (0 on success) and never synchronise.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxSteps = 16;             // I
constexpr int kMaxRegsWidth = 32;         // the register kernel's widths
constexpr int kMaxRows = 4;               // warps (rows) a block
constexpr int kMaxSmem = 232448;          // an H100 block's shared memory
constexpr unsigned kFull = 0xffffffffu;

struct StepConsts {
  float c[kMaxSteps][3];
};

__host__ __device__ inline int pad32(int n) { return (n + 31) / 32 * 32; }

// Shared floats of ladn_smem_kernel: w1x, w2 and w3 zero-padded to
// multiples of 32, temb_w1, b1, b2, b3.
__host__ __device__ inline size_t smem_floats(int A, int H, int I) {
  const size_t Ap = pad32(A), Hp = pad32(H);
  return Ap * Hp + Hp * Hp + Hp * Ap + (size_t)I * Hp + 2 * Hp + Ap;
}

__device__ __forceinline__ float load(const float* p, bool ok) {
  return ok ? __ldg(p) : 0.f;
}

// sum over k < W of (v of lane k) * w[k]: four partial sums over
// k % 4, each in k-order, added as (p0 + p1) + (p2 + p3).
template <int W>
__device__ __forceinline__ float warp_matvec(float v, const float (&w)[W]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < W; ++k) {
    p[k & 3] = fmaf(__shfl_sync(kFull, v, k), w[k], p[k & 3]);
  }
  return (p[0] + p[1]) + (p[2] + p[3]);
}

template <int W>
__global__ void __launch_bounds__(kMaxRows * 32)
ladn_regs_kernel(const float* __restrict__ x_I, const float* __restrict__ s,
                 const float* __restrict__ noise,
                 const float* __restrict__ temb_w1,
                 const float* __restrict__ w1x,
                 const float* __restrict__ w1s, long long w1x_stride,
                 long long w1s_stride, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, int T, int A, int S, int H, int I,
                 const __grid_constant__ StepConsts consts) {
  const int g = blockIdx.y;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= T) return;                 // whole warps only
  const int j = threadIdx.x & 31;
  const bool hj = j < H, aj = j < A;
  const size_t r = (size_t)g * T + row;

  // every load of the row, before the first FMA
  const float* gw1x = w1x + g * w1x_stride;
  const float* gw1s = w1s + g * w1s_stride;
  const float* gw2 = w2 + (size_t)g * H * H;
  const float* gw3 = w3 + (size_t)g * H * A;
  float wx[W], ws[W], wh[W], wo[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    wx[k] = load(gw1x + k * H + j, k < A && hj);
    ws[k] = load(gw1s + k * H + j, k < S && hj);
    wh[k] = load(gw2 + k * H + j, k < H && hj);
    wo[k] = load(gw3 + k * A + j, k < H && aj);
  }
  // this lane's temb_w1[:, j] and noise[:, j], consumed from the front
  const float* gtemb = temb_w1 + (size_t)g * I * H;
  const float* nrow = noise + r * I * A;
  float tq[kMaxSteps], nq[kMaxSteps];
#pragma unroll
  for (int t = 0; t < kMaxSteps; ++t) {
    tq[t] = load(gtemb + t * H + j, t < I && hj);
    nq[t] = load(nrow + t * A + j, t < I && aj);
  }
  const float bias1 = load(b1 + (size_t)g * H + j, hj);
  const float bias2 = load(b2 + (size_t)g * H + j, hj);
  const float bias3 = load(b3 + (size_t)g * A + j, aj);
  const float sv = load(s + r * S + j, j < S);
  float x = load(x_I + r * A + j, aj);

  // step-invariant state contribution s @ w1s + b1
  const float sc = warp_matvec(sv, ws) + bias1;
#pragma unroll 1
  for (int step = 0; step < I; ++step) {
    const float h1 = fmaxf(warp_matvec(x, wx) + sc + tq[0], 0.f);
    const float h2 = fmaxf(warp_matvec(h1, wh) + bias2, 0.f);
    const float eps = warp_matvec(h2, wo) + bias3;
    x = consts.c[step][0] * (x - consts.c[step][1] * eps) +
        consts.c[step][2] * nq[0];
#pragma unroll
    for (int t = 0; t + 1 < kMaxSteps; ++t) {
      tq[t] = tq[t + 1];
      nq[t] = nq[t + 1];
    }
  }
  if (aj) out[r * A + j] = x;
}

// dst[Kp][Np] <- src[K][N], zero-padded, by the whole block, 32 loads in
// flight a thread (one at a time, each is a full memory latency)
__device__ void stage(float* dst, const float* __restrict__ src, int K,
                      int N, int Kp, int Np) {
  constexpr int kBatch = 32;
  const int n_all = Kp * Np;
  for (int i0 = threadIdx.x; i0 < n_all; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int k = i / Np, n = i - k * Np;
      v[b] = load(src + (size_t)k * N + n, i < n_all && k < K && n < N);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < n_all) dst[i] = v[b];
    }
  }
}

// y[u] (unit lane + 32u) = sum over k < Kp of v_k * w[k][unit], v_k held
// by lane k % 32 in v[k / 32]; w is Kp x Np, zero-padded; the same four
// partial sums over k % 4 as warp_matvec.  Eight k a pass: unrolling all
// 32 lets the compiler hoist 32 x U loads and spill at W = 128.
template <int U>
__device__ __forceinline__ void smem_matvec(const float (&v)[U],
                                            const float* w, int Kp, int Np,
                                            float (&y)[U]) {
  const int lane = threadIdx.x & 31;
  float p[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) p[u][0] = p[u][1] = p[u][2] = p[u][3] = 0.f;
#pragma unroll
  for (int m = 0; m < U; ++m) {
    if (32 * m >= Kp) break;
#pragma unroll 2
    for (int l0 = 0; l0 < 32; l0 += 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float vk = __shfl_sync(kFull, v[m], l0 + c);
        const float* wk = w + (32 * m + l0 + c) * Np + lane;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (32 * u < Np) p[u][c] = fmaf(vk, wk[32 * u], p[u][c]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) y[u] = (p[u][0] + p[u][1]) + (p[u][2] + p[u][3]);
}

template <int W>
__global__ void __launch_bounds__(kMaxRows * 32)
ladn_smem_kernel(const float* __restrict__ x_I, const float* __restrict__ s,
                 const float* __restrict__ noise,
                 const float* __restrict__ temb_w1,
                 const float* __restrict__ w1x,
                 const float* __restrict__ w1s, long long w1x_stride,
                 long long w1s_stride, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, int T, int A, int S, int H, int I,
                 const __grid_constant__ StepConsts consts) {
  constexpr int U = W / 32;
  extern __shared__ float smem[];
  const int g = blockIdx.y;
  const int Ap = pad32(A), Hp = pad32(H);
  float* sw1x = smem;                 // Ap x Hp
  float* sw2 = sw1x + Ap * Hp;        // Hp x Hp
  float* sw3 = sw2 + Hp * Hp;         // Hp x Ap
  float* stemb = sw3 + Hp * Ap;       // I x Hp
  float* sb1 = stemb + I * Hp;        // Hp
  float* sb2 = sb1 + Hp;              // Hp
  float* sb3 = sb2 + Hp;              // Ap
  stage(sw1x, w1x + g * w1x_stride, A, H, Ap, Hp);
  stage(sw2, w2 + (size_t)g * H * H, H, H, Hp, Hp);
  stage(sw3, w3 + (size_t)g * H * A, H, A, Hp, Ap);
  stage(stemb, temb_w1 + (size_t)g * I * H, I, H, I, Hp);
  stage(sb1, b1 + (size_t)g * H, 1, H, 1, Hp);
  stage(sb2, b2 + (size_t)g * H, 1, H, 1, Hp);
  stage(sb3, b3 + (size_t)g * A, 1, A, 1, Ap);
  __syncthreads();

  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= T) return;                 // no block barrier follows
  const int lane = threadIdx.x & 31;
  const size_t r = (size_t)g * T + row;

  float xr[U], sr[U], sc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lane + 32 * u;
    xr[u] = load(x_I + r * A + j, j < A);
    sr[u] = load(s + r * S + j, j < S);
  }
  // s @ w1s + b1, w1s read once from device memory
  {
    const float* gw1s = w1s + g * w1s_stride;
    float p[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) p[u][0] = p[u][1] = p[u][2] = p[u][3] = 0.f;
#pragma unroll
    for (int m = 0; m < U; ++m) {
      if (32 * m >= S) break;
#pragma unroll 4
      for (int l0 = 0; l0 < 32; l0 += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 32 * m + l0 + c;
          const float vk = __shfl_sync(kFull, sr[m], l0 + c);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = lane + 32 * u;
            p[u][c] =
                fmaf(vk, load(gw1s + (size_t)k * H + j, k < S && j < H),
                     p[u][c]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      sc[u] = ((p[u][0] + p[u][1]) + (p[u][2] + p[u][3])) +
              (j < Hp ? sb1[j] : 0.f);
    }
  }

  const float* nrow = noise + r * I * A;
  for (int step = 0; step < I; ++step) {
    float nz[U], h[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int a = lane + 32 * u;
      nz[u] = load(nrow + step * A + a, a < A);
    }
    smem_matvec<U>(xr, sw1x, Ap, Hp, y);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      h[u] = fmaxf(y[u] + sc[u] + (j < Hp ? stemb[step * Hp + j] : 0.f),
                   0.f);
    }
    smem_matvec<U>(h, sw2, Hp, Hp, y);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      h[u] = fmaxf(y[u] + (j < Hp ? sb2[j] : 0.f), 0.f);
    }
    smem_matvec<U>(h, sw3, Hp, Ap, y);
    const float c0 = consts.c[step][0];
    const float c1 = consts.c[step][1];
    const float c2 = consts.c[step][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int a = lane + 32 * u;
      const float eps = y[u] + (a < Ap ? sb3[a] : 0.f);
      xr[u] = c0 * (xr[u] - c1 * eps) + c2 * nz[u];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int a = lane + 32 * u;
    if (a < A) out[r * A + a] = xr[u];
  }
}

__global__ void ladn_noop_kernel() {}

// Raised once per instantiation, outside any graph capture's first use.
template <int W>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      ladn_smem_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return e;
}

bool valid_width(int width) {
  return width == 24 || width == 32 || width == 64 || width == 128;
}

size_t smem_bytes(int width, int A, int H, int I) {
  return width <= kMaxRegsWidth ? 0 : smem_floats(A, H, I) * sizeof(float);
}

}  // namespace

extern "C" {

// width (24 or 32: the register kernel; 64 or 128: the shared-
// memory kernel) and rows (warps a block, 1..4) are the plan's
// (repro_torch/kernels/ladn_denoise.py:plan); the grid and the shared
// memory follow from them.  w1x_stride and w1s_stride: floats from one
// agent's w1x (w1s) to the next; rows within an agent are H floats apart.
// consts: I rows of (c0, c1, c2) in host memory, copied into the launch's
// arguments.  Returns the launch's cudaError_t.
int repro_ladn_denoise(const float* x_I, const float* s, const float* noise,
                       const float* temb_w1, const float* w1x,
                       const float* w1s, long long w1x_stride,
                       long long w1s_stride, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const float* b3, float* out, int G, int T, int A,
                       int S, int H, int I, int width, int rows,
                       const float* consts, void* stream) {
  if (G <= 0 || G > 65535 || T <= 0 || I <= 0 || I > kMaxSteps || A <= 0 ||
      S <= 0 || H <= 0 || !valid_width(width) ||
      A > width || S > width || H > width || rows <= 0 ||
      rows > kMaxRows || w1x_stride < 0 || w1s_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  StepConsts c = {};
  for (int i = 0; i < I; ++i) {
    for (int k = 0; k < 3; ++k) c.c[i][k] = consts[i * 3 + k];
  }
  const dim3 grid((T + rows - 1) / rows, G);
  const dim3 block(rows * 32);
  const size_t smem = smem_bytes(width, A, H, I);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LADN_ARGS                                                    \
  x_I, s, noise, temb_w1, w1x, w1s, w1x_stride, w1s_stride, b1, w2, b2, w3, \
      b3, out, T, A, S, H, I, c
  switch (width) {
    case 24:
      ladn_regs_kernel<24><<<grid, block, 0, st>>>(REPRO_LADN_ARGS);
      break;
    case 32:
      ladn_regs_kernel<32><<<grid, block, 0, st>>>(REPRO_LADN_ARGS);
      break;
    case 64: {
      const cudaError_t e = allow_smem<64>();
      if (e != cudaSuccess) return (int)e;
      ladn_smem_kernel<64><<<grid, block, smem, st>>>(REPRO_LADN_ARGS);
      break;
    }
    default: {
      const cudaError_t e = allow_smem<128>();
      if (e != cudaSuccess) return (int)e;
      ladn_smem_kernel<128><<<grid, block, smem, st>>>(REPRO_LADN_ARGS);
    }
  }
#undef REPRO_LADN_ARGS
  return (int)cudaGetLastError();
}

// Dynamic shared-memory bytes of one block of the width's kernel.
long long repro_ladn_denoise_smem_bytes(int width, int A, int H, int I) {
  return (long long)smem_bytes(width, A, H, I);
}

// One empty kernel of one warp: the floor of a launch from this library.
int repro_ladn_noop(void* stream) {
  ladn_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* repro_ladn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
