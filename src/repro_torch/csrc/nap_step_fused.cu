// Fused NAP step: block-ELL SpMM + exit decision in one kernel, for Hopper.
//
// Replaces the TPU kernel `nap_step_fused` of
// src/repro/kernels/nap_step/kernel.py (body `_kernel`): the SpMM of
// spmm_block_ell.cu, plus, on batch row blocks (rb < nb / 8),
//   d2[i]   = sum_f (out[i, f] - c_inf[i] * s_inf[f])^2
//   exit[i] = node_active[i] && d2[i] < ts2        (ts2 < 0 disables exits)
//   blk_still[rb] = any_i(node_active[i] && !exit[i]); 0 on other blocks.
//
// What bounds it on this card: memory traffic, as for the SpMM (tiles and
// x slabs); the distance adds only c (nb) and s (F) to what is read.
//
// Design: the TPU kernel carries the distance scratch across the feature
// blocks of its in-order grid. Hopper runs blocks in parallel and in no
// order, so this kernel launches ONE block per row block and loops over
// all feature blocks inside it: the per-row distance partials stay in
// registers and no cross-block reduction or atomic is needed. The
// stationary state x_inf = c * s is rebuilt in registers (never read from
// or written to device memory). The propagated values come from the same
// `accumulate_block` as the SpMM kernel, so `out` is bitwise equal to
// spmm_block_ell's, and the distance terms and their reduction match
// nap_exit.cu exactly, so exit flags equal the two-launch composition.
#include "block_ell.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(FB) nap_step_fused_kernel(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const float* __restrict__ x, const float* __restrict__ c_inf,
    const float* __restrict__ s_inf, const int* __restrict__ node_active,
    float ts2, float* __restrict__ out, int* __restrict__ exit_flag,
    int* __restrict__ blk_still, int tb, int F, int nb_rb) {
  __shared__ __align__(16) float tile_s[RB * CB];
  __shared__ float red[RB][FB];
  const int rb = blockIdx.x;
  const bool is_active = active[rb] != 0;
  const bool is_batch = rb < nb_rb;
  float c[RB];
  float d2[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    c[r] = 0.0f;
    d2[r] = 0.0f;
  }
  if (is_batch) {
#pragma unroll
    for (int r = 0; r < RB; ++r) c[r] = c_inf[rb * RB + r];
  }
  for (int fb = 0; fb < F / FB; ++fb) {
    const int f = fb * FB + threadIdx.x;
    float acc[RB];
    if (is_active) {
      accumulate_block(tiles, tile_col, valid, x, rb, tb, F, f, acc, tile_s);
    } else {
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      out[static_cast<long long>(rb * RB + r) * F + f] = acc[r];
    if (is_batch) {
      const float s = s_inf[f];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float diff = __fsub_rn(acc[r], __fmul_rn(c[r], s));
        d2[r] = fmaf(diff, diff, d2[r]);
      }
    }
  }
  if (!is_batch) {
    if (threadIdx.x == 0) blk_still[rb] = 0;
    return;  // the whole block leaves together: no barrier is skipped
  }
  reduce_rows(d2, red);
  if (threadIdx.x == 0)
    blk_still[rb] = decide_exits(red, node_active, ts2, rb * RB, exit_flag);
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32, F % 128 == 0; c_inf (nb,) f32; s_inf (F,)
// f32; node_active (nb,) i32 with nb % 8 == 0; ts2 the squared threshold.
// Outputs: out (n_rb * 8, F) f32, exit (nb,) i32, blk_still (n_rb,) i32.
extern "C" int nap_step_fused_launch(
    const void* tiles, const void* tile_col, const void* valid,
    const void* active, const void* x, const void* c_inf, const void* s_inf,
    const void* node_active, float ts2, void* out, void* exit_flag,
    void* blk_still, int n_rb, int tb, int F, int nb, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb > 0) {
    repro_torch::nap_step_fused_kernel<<<n_rb, repro_torch::FB, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
        static_cast<const int*>(valid), static_cast<const int*>(active),
        static_cast<const float*>(x), static_cast<const float*>(c_inf),
        static_cast<const float*>(s_inf), static_cast<const int*>(node_active),
        ts2, static_cast<float*>(out), static_cast<int*>(exit_flag),
        static_cast<int*>(blk_still), tb, F, nb / repro_torch::RB);
  }
  return static_cast<int>(cudaGetLastError());
}
