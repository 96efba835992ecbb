// Block-ELL SpMM with NAP row-block predication, hand-written for Hopper:
// a zero-skipping kernel bound by the bytes of the tiles it reads.
//
// Replaces the TPU kernel `spmm_block_ell` of
// src/repro/kernels/spmm/kernel.py (body `_kernel`):
//   out[rb*8 : +8] = sum_t [active[rb] && valid[rb,t]]
//                    tiles[rb,t] @ x[tile_col[rb,t]*128 : +128]
// with f32 accumulation; inactive row blocks are written as zeros.
//
// What bounds it on this card: memory traffic. The packer's 8 x 128 tiles
// are nearly empty (about 2.4 non-zeros of 1,024 on serving supports), so
// the 2 * nnz * F flops are nothing and the time goes to reading each
// active tile (4 KB) once, the x rows its non-zeros name (x stays in the
// 50 MB L2) and writing the output. The dense MXU-shaped product of the
// TPU kernel would spend > 99% of its FMAs on zeros.
//
// Design: one block of 128 threads per (row block, 512 features); a thread
// owns 4 adjacent features (one float4 column) for all 8 rows, so at
// F <= 512 every tile is read from device memory exactly once. The valid
// slots of a row block are compacted (ballot + popc) into an ascending
// list, then taken NS = 4 at a time: each warp streams one whole tile
// into registers with coalesced 16-byte loads (8 loads in flight per lane;
// the scan order is free), finds its non-zeros with __ballot_sync
// and __popc, and the block writes them to shared memory as (value, x row)
// grouped by output row in (slot, k) order. Then each thread accumulates
// over the non-zeros only: one coalesced float4 read of an x row each,
// 4 reads issued before the first is used, while the next chunk's tiles
// are already loading into the registers the scan freed.
// Latency, not bandwidth, is what such a sparse kernel has to hide: chunks
// of four tiles (32 KB of shared memory, 128 registers a thread) let four
// blocks, 16 warps, share an SM, where eight-tile chunks allowed 12 warps
// and ran slower. A chunk holds at most 4 dense tiles, so every tile
// density fits.
//
// The body is `spmm_slab` of block_ell.cuh, which the fused step
// (nap_step_fused.cu) shares, so their `out` is bitwise equal. Non-finite
// x: a tile whose x block holds a NaN or Inf keeps its zero coefficients,
// so the result equals the dense product there too (0 * NaN = NaN, as in
// the TPU kernel); the kernel takes those flags (`x_bad`, one byte per
// 128-row block of x and slab of 512 features) and sets the same flags for
// its output (`out_bad`), which the NAP loop hands to the next step.
#include "block_ell.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(SP_THREADS, 4) spmm_block_ell_kernel(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const unsigned char* __restrict__ x_bad, const float* __restrict__ x,
    float* __restrict__ out, unsigned char* __restrict__ out_bad, int tb,
    int F, int n_xb, int n_ob) {
  extern __shared__ float4 sp_dyn[];
  float* e_val = reinterpret_cast<float*>(sp_dyn);      // kept entries
  int* e_row = reinterpret_cast<int*>(e_val + SP_CAP);  // their x rows
  __shared__ SlabShared sh;
  const int rb = blockIdx.x, y = blockIdx.y, F4 = F / 4;
  float4 acc[RB];
  spmm_slab(tiles, tile_col, valid, active,
            x_bad + static_cast<long long>(y) * n_xb, x, rb, y, tb, F4,
            e_val, e_row, sh, acc);
  store_slab(out, out_bad, acc, rb, y, F4, n_ob);
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32 with n_x % 128 == 0 and F % 128 == 0; x_bad
// (ceil(F / 512), n_x / 128) u8 the flags of x; out (n_rb * 8, F) f32 and
// out_bad (ceil(F / 512), ceil(n_rb / 16)) u8, zero on entry, receives the
// flags of out. tiles, x and out 16-byte aligned. Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int spmm_block_ell_launch(const void* tiles, const void* tile_col,
                                     const void* valid, const void* active,
                                     const void* x_bad, const void* x,
                                     void* out, void* out_bad, int n_rb,
                                     int tb, int F, int n_x, int device,
                                     void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spmm_block_ell_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SP_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb > 0) {
    const dim3 grid(n_rb, (F + SLAB - 1) / SLAB);
    spmm_block_ell_kernel<<<grid, SP_THREADS, SP_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
        static_cast<const int*>(valid), static_cast<const int*>(active),
        static_cast<const unsigned char*>(x_bad),
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<unsigned char*>(out_bad), tb, F, n_x / CB,
        (n_rb + CB / RB - 1) / (CB / RB));
  }
  return static_cast<int>(cudaGetLastError());
}
