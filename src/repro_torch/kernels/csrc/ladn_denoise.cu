// Fused LADN reverse-diffusion chain for Hopper (sm_90a).
//
// Replaces the TPU kernel ladn_denoise.py:_denoise_kernel
// (src/repro/kernels/ladn_denoise.py, pl.pallas_call at line 104).
// It computes what that kernel computes, for G stacked agents at once:
//   x_I (G, T, A), s (G, T, S), noise (G, T, I, A), temb_w1 (G, I, H);
//   the LADN's first layer split into w1x (G, A, H) and w1s (G, S, H)
//   with bias b1 (G, H), then w2 (G, H, H), b2 (G, H), w3 (G, H, A),
//   b3 (G, A); out x_0 (G, T, A); all f32.
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
// What bounds it on an H100: at the main path's widths (A 20, S 22,
// H 20, I 5) a row needs ~10 kflop and moves ~0.8 kB (its x, s, noise
// and output), so the f32 bound is a few microseconds at most for the
// whole call; the agents' weights (~7 kB each) are read once per block.
// Nothing here is large enough to be bound by bytes or flops: the call is
// bound by its latency (one launch, I dependent steps of three small
// matrix-vector products per row).
//
// What this design does about that: everything of one row stays on chip
// for the whole chain.  One block per (agent, tile of up to 4 rows)
// loads the agent's weights into shared memory once; one warp per row,
// lane j owning hidden unit j and action j (widths above 32 in strides
// of 32, up to 128); the row's vectors live in per-warp shared scratch
// and are read as broadcasts.  No TPU-style 128-lane padding and no
// row blocking: the TPU needed those for its VMEM tiles.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through ctypes: the C entry point returns the CUDA error of
// the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxSteps = 16;
constexpr int kMaxWidth = 128;            // A, S and H each
constexpr int kPerLane = kMaxWidth / 32;  // units one lane owns
constexpr int kMaxWarps = 4;              // rows per block

struct StepConsts {
  float c[kMaxSteps][3];
};

__host__ __device__ inline size_t weight_floats(int A, int S, int H, int I) {
  return (size_t)A * H + (size_t)S * H + (size_t)H * H + (size_t)H * A +
         (size_t)I * H + 2 * (size_t)H + (size_t)A;
}

__host__ __device__ inline size_t scratch_floats(int A, int S, int H) {
  return (size_t)A + H + (S > H ? S : H);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
ladn_denoise_kernel(const float* __restrict__ x_I,
                    const float* __restrict__ s,
                    const float* __restrict__ noise,
                    const float* __restrict__ temb_w1,
                    const float* __restrict__ w1x,
                    const float* __restrict__ w1s,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ w3,
                    const float* __restrict__ b3, float* __restrict__ out,
                    int T, int A, int S, int H, int I, StepConsts consts) {
  extern __shared__ float smem[];
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  float* sw1x = smem;               // A*H
  float* sw1s = sw1x + A * H;       // S*H
  float* sw2 = sw1s + S * H;        // H*H
  float* sw3 = sw2 + H * H;         // H*A
  float* stemb = sw3 + H * A;       // I*H
  float* sb1 = stemb + I * H;       // H
  float* sb2 = sb1 + H;             // H
  float* sb3 = sb2 + H;             // A
  float* scratch = sb3 + A;

  // this agent's weights, once per block
  {
    const float* gw1x = w1x + (size_t)g * A * H;
    const float* gw1s = w1s + (size_t)g * S * H;
    const float* gw2 = w2 + (size_t)g * H * H;
    const float* gw3 = w3 + (size_t)g * H * A;
    const float* gtemb = temb_w1 + (size_t)g * I * H;
    for (int k = tid; k < A * H; k += nthreads) sw1x[k] = gw1x[k];
    for (int k = tid; k < S * H; k += nthreads) sw1s[k] = gw1s[k];
    for (int k = tid; k < H * H; k += nthreads) sw2[k] = gw2[k];
    for (int k = tid; k < H * A; k += nthreads) sw3[k] = gw3[k];
    for (int k = tid; k < I * H; k += nthreads) stemb[k] = gtemb[k];
    for (int k = tid; k < H; k += nthreads) {
      sb1[k] = b1[(size_t)g * H + k];
      sb2[k] = b2[(size_t)g * H + k];
    }
    for (int k = tid; k < A; k += nthreads) sb3[k] = b3[(size_t)g * A + k];
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row = blockIdx.x * (nthreads / 32) + warp;
  if (row >= T) return;

  float* vx = scratch + (size_t)warp * scratch_floats(A, S, H);  // A
  float* vh = vx + A;                                             // H
  float* vs = vh + H;                  // S, then the second hidden layer

  const size_t r = (size_t)g * T + row;
  for (int k = lane; k < A; k += 32) vx[k] = x_I[r * A + k];
  for (int k = lane; k < S; k += 32) vs[k] = s[r * S + k];
  __syncwarp();

  // step-invariant state contribution s @ w1s + b1
  float sc[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int j = lane + 32 * m;
    float acc = 0.f;
    if (j < H) {
      for (int k = 0; k < S; ++k) acc = fmaf(vs[k], sw1s[k * H + j], acc);
      acc += sb1[j];
    }
    sc[m] = acc;
  }

  float xr[kPerLane];
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int a = lane + 32 * m;
    xr[m] = a < A ? vx[a] : 0.f;
  }

  const float* nrow = noise + r * (size_t)I * A;
  for (int step = 0; step < I; ++step) {
    const float c0 = consts.c[step][0];
    const float c1 = consts.c[step][1];
    const float c2 = consts.c[step][2];
    __syncwarp();   // vs (the s row, then last step's h2) is free again
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int j = lane + 32 * m;
      if (j < H) {
        float acc = 0.f;
        for (int k = 0; k < A; ++k) acc = fmaf(vx[k], sw1x[k * H + j], acc);
        vh[j] = fmaxf(acc + sc[m] + stemb[step * H + j], 0.f);
      }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int j = lane + 32 * m;
      if (j < H) {
        float acc = 0.f;
        for (int k = 0; k < H; ++k) acc = fmaf(vh[k], sw2[k * H + j], acc);
        vs[j] = fmaxf(acc + sb2[j], 0.f);
      }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int a = lane + 32 * m;
      if (a < A) {
        float acc = 0.f;
        for (int k = 0; k < H; ++k) acc = fmaf(vs[k], sw3[k * A + a], acc);
        const float eps = acc + sb3[a];
        xr[m] = c0 * (xr[m] - c1 * eps) + c2 * nrow[step * A + a];
      }
    }
    __syncwarp();   // every lane has read vx for this step
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int a = lane + 32 * m;
      if (a < A) vx[a] = xr[m];
    }
    __syncwarp();
  }

#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const int a = lane + 32 * m;
    if (a < A) out[r * A + a] = xr[m];
  }
}

size_t smem_bytes(int T, int A, int S, int H, int I) {
  const int warps = T < kMaxWarps ? T : kMaxWarps;
  return (weight_floats(A, S, H, I) + (size_t)warps * scratch_floats(A, S, H))
         * sizeof(float);
}

}  // namespace

extern "C" {

// consts: I rows of (c0, c1, c2) in host memory, copied into the launch's
// arguments.  Returns the launch's cudaError_t.
int repro_ladn_denoise(const float* x_I, const float* s, const float* noise,
                       const float* temb_w1, const float* w1x,
                       const float* w1s, const float* b1, const float* w2,
                       const float* b2, const float* w3, const float* b3,
                       float* out, int G, int T, int A, int S, int H, int I,
                       const float* consts, void* stream) {
  if (G <= 0 || T <= 0 || I <= 0 || I > kMaxSteps || A <= 0 || S <= 0 ||
      H <= 0 || A > kMaxWidth || S > kMaxWidth || H > kMaxWidth) {
    return (int)cudaErrorInvalidValue;
  }
  StepConsts c;
  for (int i = 0; i < I; ++i) {
    for (int j = 0; j < 3; ++j) c.c[i][j] = consts[i * 3 + j];
  }
  const int warps = T < kMaxWarps ? T : kMaxWarps;
  const size_t smem = smem_bytes(T, A, S, H, I);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ladn_denoise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + warps - 1) / warps, G);
  ladn_denoise_kernel<<<grid, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x_I, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3, out, T, A, S, H,
      I, c);
  return (int)cudaGetLastError();
}

// Shared-memory bytes one block needs, so the wrapper can refuse shapes
// that do not fit before it launches.
long long repro_ladn_denoise_smem_bytes(int T, int A, int S, int H, int I) {
  return (long long)smem_bytes(T, A, S, H, I);
}

const char* repro_ladn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
