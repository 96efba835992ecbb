// Block-ELL SpMM with NAP row-block predication, hand-written for Hopper.
//
// Replaces the TPU kernel `spmm_block_ell` of
// src/repro/kernels/spmm/kernel.py (body `_kernel`):
//   out[rb*8 : +8] = sum_t [active[rb] && valid[rb,t]]
//                    tiles[rb,t] @ x[tile_col[rb,t]*128 : +128]
// with f32 accumulation; inactive row blocks are written as zeros.
//
// What bounds it on this card: memory traffic. Each active, valid tile
// costs 2*8*128 flops per feature but only ~2.4 of its 1,024 entries are
// non-zero on serving supports, so the work that must be done is tiny
// (2 * nnz * F flops) and the time goes to reading tiles (4 KB each) and
// the 128-row x slabs they name.
//
// Design: one CUDA block per (row block, 128-wide feature block), one
// thread per feature column. A loop over the tile slots in ascending order
// takes the place of the TPU's sequential grid axis; each valid tile is
// staged in shared memory once and broadcast to all threads, and each
// thread streams its x column (neighbouring threads on neighbouring
// addresses, so the loads coalesce). No atomics: every output element has
// one writer and a fixed fmaf order, so the result is deterministic and
// bitwise equal to the fused step's (see block_ell.cuh). Simple first; the
// zero-heavy dense tiles are left for a later change (PERF.md).
#include "block_ell.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(FB) spmm_block_ell_kernel(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const float* __restrict__ x, float* __restrict__ out, int tb, int F) {
  __shared__ __align__(16) float tile_s[RB * CB];
  const int rb = blockIdx.x;
  const int f = blockIdx.y * FB + threadIdx.x;
  float acc[RB];
  if (active[rb] != 0) {
    accumulate_block(tiles, tile_col, valid, x, rb, tb, F, f, acc, tile_s);
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    out[static_cast<long long>(rb * RB + r) * F + f] = acc[r];
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32 with F % 128 == 0; out (n_rb * 8, F) f32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int spmm_block_ell_launch(const void* tiles, const void* tile_col,
                                     const void* valid, const void* active,
                                     const void* x, void* out, int n_rb,
                                     int tb, int F, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb > 0) {
    const dim3 grid(n_rb, F / repro_torch::FB);
    repro_torch::spmm_block_ell_kernel<<<grid, repro_torch::FB, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
        static_cast<const int*>(valid), static_cast<const int*>(active),
        static_cast<const float*>(x), static_cast<float*>(out), tb, F);
  }
  return static_cast<int>(cudaGetLastError());
}
