// NAP exit decision, hand-written for Hopper.
//
// Replaces the TPU kernel `nap_exit` of src/repro/kernels/nap_exit/kernel.py
// (body `_kernel`): per node
//   dist2[i] = sum_f (x[i, f] - x_inf[i, f])^2
//   exit[i]  = active[i] && dist2[i] < ts2
// and per 8-node block blk_active = any(active && !exit).
//
// What bounds it on this card: memory traffic. It reads x and x_inf once
// (2 * n * F * 4 bytes) and does 3 flops per element pair, far below the
// card's ratio of flops to bytes.
//
// Design: one CUDA block per 8-node group, one thread per feature column of
// a 128-wide block; each thread loops over the feature blocks (coalesced
// loads), keeps its 8 partial sums in registers, and the block reduces them
// in a fixed tree (block_ell.cuh). The per-element terms and the reduction
// are those of the fused step, so on the same propagated rows and the same
// x_inf = c * s both kernels give bitwise equal distances and exit flags.
#include "block_ell.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(FB) nap_exit_kernel(
    const float* __restrict__ x, const float* __restrict__ x_inf,
    const int* __restrict__ active, float ts2, float* __restrict__ dist2,
    int* __restrict__ exit_flag, int* __restrict__ blk_active, int F) {
  __shared__ float red[RB][FB];
  const int blk = blockIdx.x;
  float d2[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) d2[r] = 0.0f;
  for (int fb = 0; fb < F / FB; ++fb) {
    const int f = fb * FB + threadIdx.x;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long i = static_cast<long long>(blk * RB + r) * F + f;
      const float diff = __fsub_rn(x[i], x_inf[i]);
      d2[r] = fmaf(diff, diff, d2[r]);
    }
  }
  reduce_rows(d2, red);
  if (threadIdx.x == 0) {
    for (int r = 0; r < RB; ++r) dist2[blk * RB + r] = red[r][0];
    blk_active[blk] = decide_exits(red, active, ts2, blk * RB, exit_flag);
  }
}

}  // namespace repro_torch

// x, x_inf (n, F) f32 with n % 8 == 0 and F % 128 == 0; active (n,) i32;
// ts2 the squared threshold. Outputs: dist2 (n,) f32, exit (n,) i32,
// blk_active (n / 8,) i32.
extern "C" int nap_exit_launch(const void* x, const void* x_inf,
                               const void* active, float ts2, void* dist2,
                               void* exit_flag, void* blk_active, int n,
                               int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    repro_torch::nap_exit_kernel<<<n / repro_torch::RB, repro_torch::FB, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(x_inf),
        static_cast<const int*>(active), ts2, static_cast<float*>(dist2),
        static_cast<int*>(exit_flag), static_cast<int*>(blk_active), F);
  }
  return static_cast<int>(cudaGetLastError());
}
