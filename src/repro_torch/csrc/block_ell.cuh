// Shared device code of the three NAP kernels (spmm_block_ell.cu,
// nap_step_fused.cu, nap_exit.cu).
//
// Geometry (must match repro_torch/kernels/spmm/__init__.py): an adjacency
// tile is RB x CB = 8 x 128 f32 coefficients; the fused step processes
// features in FB = 128-wide blocks, one CUDA thread per feature column.
//
// Bit-parity contract. A propagated value is, for each output element, the
// chain of fmaf over the valid slots ascending, then k ascending, from
// +0.0f. `accumulate_block` computes it densely (the fused step); the
// block-ELL SpMM kernel has its own zero-skipping code that runs the same
// chain without the terms whose coefficient is zero, which leaves every bit
// unchanged for finite x (spmm_block_ell.cu says why). Any change to one
// must keep that per-row order. `reduce_rows` is the ONLY code that sums a
// node's squared distance over threads: the fused step and the standalone
// exit kernel sum the same per-element terms in the same order, so their
// distances (and exit flags) are bitwise equal. Every floating-point
// operation is an explicit intrinsic (fmaf / __fmul_rn / __fsub_rn /
// __fadd_rn), so the compiler cannot contract or reorder them differently
// per kernel.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int RB = 8;    // rows per adjacency tile
constexpr int CB = 128;  // columns per adjacency tile
constexpr int FB = 128;  // feature block = threads per CUDA block

// One (RB x FB) output block of row block `rb`, feature column `f` of this
// thread: acc[r] = sum over valid slots t (ascending) and k (ascending) of
// tiles[rb, t, r, k] * x[tile_col[rb, t] * CB + k, f], as a chain of fmaf.
// Every thread of the block must call this (it synchronises on tile_s).
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const float* __restrict__ x, int rb,
    int tb, int F, int f, float (&acc)[RB], float* tile_s) {
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  for (int t = 0; t < tb; ++t) {
    const long long slot = static_cast<long long>(rb) * tb + t;
    if (valid[slot] == 0) continue;  // the same for every thread
    const float4* tile4 = reinterpret_cast<const float4*>(tiles + slot * RB * CB);
    __syncthreads();  // the previous tile is fully consumed
    float4* tile_s4 = reinterpret_cast<float4*>(tile_s);
    for (int i = threadIdx.x; i < RB * CB / 4; i += blockDim.x) tile_s4[i] = tile4[i];
    __syncthreads();
    const float* xb = x + static_cast<long long>(tile_col[slot]) * CB * F + f;
#pragma unroll 4
    for (int k = 0; k < CB; ++k) {
      const float xv = xb[static_cast<long long>(k) * F];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = fmaf(tile_s[r * CB + k], xv, acc[r]);
    }
  }
}

// Sum each row's per-thread partials over the FB threads of the block in a
// fixed tree order; the totals land in red[r][0]. Every thread must call it.
__device__ __forceinline__ void reduce_rows(const float (&part)[RB],
                                            float (*red)[FB]) {
#pragma unroll
  for (int r = 0; r < RB; ++r) red[r][threadIdx.x] = part[r];
  __syncthreads();
  for (int stride = FB / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
        red[r][threadIdx.x] = __fadd_rn(red[r][threadIdx.x], red[r][threadIdx.x + stride]);
    }
    __syncthreads();
  }
}

// Thread 0: exit flags of the block's RB nodes from their squared distances
// in red[r][0]; returns whether any node stays active.
__device__ __forceinline__ int decide_exits(float (*red)[FB],
                                            const int* __restrict__ node_active,
                                            float ts2, int row0,
                                            int* __restrict__ exit_flag) {
  int still = 0;
  for (int r = 0; r < RB; ++r) {
    const bool was_active = node_active[row0 + r] != 0;
    const bool exits = was_active && red[r][0] < ts2;
    exit_flag[row0 + r] = exits ? 1 : 0;
    still |= (was_active && !exits) ? 1 : 0;
  }
  return still;
}

}  // namespace repro_torch
