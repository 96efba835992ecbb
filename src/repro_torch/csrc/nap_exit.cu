// NAP exit decision, hand-written for Hopper.
//
// Replaces the TPU kernel `nap_exit` of src/repro/kernels/nap_exit/kernel.py
// (body `_kernel`): per node
//   dist2[i] = sum_f (x[i, f] - x_inf[i, f])^2
//   exit[i]  = active[i] && dist2[i] < ts2
// and per 8-node block blk_active = any(active && !exit).
//
// What bounds it on this card: memory traffic. It reads x and x_inf once
// (2 * n * F * 4 bytes, 2.1 MB on the serving path's 512 x 512) and does 3
// flops per element pair, far below the card's ratio of flops to bytes. At
// that size one launch and one round trip to memory set most of the time,
// so the design puts every load of a node in flight at once.
//
// Design: one warp per node, one block of 8 warps per 8-node group (so
// blk_active is one __syncthreads_or). Lane l reads columns 4l .. 4l+3 of
// each FB = 128-wide feature block of x and x_inf as float4, four feature
// blocks' loads (8 x 16 bytes a lane, the whole row at F = 512) issued
// before the first is used, and chains their terms per column in
// ascending block order (`dist_terms`); `row_sum` then sums the 128 column
// partials with shuffles in the fixed tree of block_ell.cuh. The fused
// step takes the same terms in the same order through the same two
// functions, so on the same propagated rows and the same x_inf = c * s
// both kernels give bitwise equal distances and exit flags.
#include "block_ell.cuh"

namespace repro_torch {

constexpr int EX_UNROLL = 4;  // feature blocks whose loads are in flight

__global__ void __launch_bounds__(RB * 32) nap_exit_kernel(
    const float* __restrict__ x, const float* __restrict__ x_inf,
    const int* __restrict__ active, float ts2, float* __restrict__ dist2,
    int* __restrict__ exit_flag, int* __restrict__ blk_active, int F) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * RB +
                        (threadIdx.x >> 5);
  const long long base = row * (F / 4) + lane;
  const float4* x4 = reinterpret_cast<const float4*>(x) + base;
  const float4* xi4 = reinterpret_cast<const float4*>(x_inf) + base;
  const int nfb = F / FB;
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  int fb = 0;
  for (; fb + EX_UNROLL <= nfb; fb += EX_UNROLL) {
    float4 a[EX_UNROLL], b[EX_UNROLL];
#pragma unroll
    for (int u = 0; u < EX_UNROLL; ++u) {
      a[u] = x4[(fb + u) * FB4];
      b[u] = xi4[(fb + u) * FB4];
    }
#pragma unroll
    for (int u = 0; u < EX_UNROLL; ++u) p = dist_terms(a[u], b[u], p);
  }
  for (; fb < nfb; ++fb) p = dist_terms(x4[fb * FB4], xi4[fb * FB4], p);
  const float d2 = row_sum(p);
  int still = 0;
  if (lane == 0) {
    dist2[row] = d2;
    still = decide_exit(d2, active, ts2, row, exit_flag);
  }
  still = __syncthreads_or(still);
  if (threadIdx.x == 0) blk_active[blockIdx.x] = still;
}

}  // namespace repro_torch

// x, x_inf (n, F) f32, 16-byte aligned, with n % 8 == 0 and F % 128 == 0;
// active (n,) i32; ts2 the squared threshold. Outputs: dist2 (n,) f32,
// exit (n,) i32, blk_active (n / 8,) i32.
extern "C" int nap_exit_launch(const void* x, const void* x_inf,
                               const void* active, float ts2, void* dist2,
                               void* exit_flag, void* blk_active, int n,
                               int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    repro_torch::nap_exit_kernel<<<n / repro_torch::RB,
                                   repro_torch::RB * 32, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(x_inf),
        static_cast<const int*>(active), ts2, static_cast<float*>(dist2),
        static_cast<int*>(exit_flag), static_cast<int*>(blk_active), F);
  }
  return static_cast<int>(cudaGetLastError());
}
