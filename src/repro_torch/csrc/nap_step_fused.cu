// Fused NAP step: block-ELL SpMM + exit decision in one kernel, for Hopper.
//
// Replaces the TPU kernel `nap_step_fused` of
// src/repro/kernels/nap_step/kernel.py (body `_kernel`): the SpMM of
// spmm_block_ell.cu, plus, on batch row blocks (rb < nb / 8),
//   d2[i]   = sum_f (out[i, f] - c_inf[i] * s_inf[f])^2
//   exit[i] = node_active[i] && d2[i] < ts2        (ts2 < 0 disables exits)
//   blk_still[rb] = any_i(node_active[i] && !exit[i]); 0 on other blocks.
//
// What bounds it on this card: memory traffic, as for the SpMM (the active
// tiles and the x rows their non-zeros name); the distance adds only c
// (nb) and s (F) to what is read.
//
// Design: the TPU kernel carries the distance scratch across the feature
// blocks of its in-order grid. Hopper runs blocks in parallel and in no
// order, so this kernel launches ONE block per row block and loops over
// the 512-feature slabs inside it: the per-row distance partials stay in
// registers and no cross-block reduction or atomic is needed (at F <= 512,
// the serving shape, there is one slab and every tile is read once).
// Each slab is the SpMM's own zero-skipping `spmm_slab` (block_ell.cuh),
// so `out` and its non-finite flags are bitwise the SpMM's. The
// distance must equal the standalone exit kernel's bit for bit, which
// walks features in FB = 128-wide blocks, one thread per column: so the
// slab's (8 x 512) output is staged in shared memory (the entry lists'
// space, free by then) and each thread adds its columns' terms in that
// order, then `reduce_rows` sums them in nap_exit.cu's tree. The
// stationary state x_inf = c * s is rebuilt in registers (never read from
// or written to device memory).
#include "block_ell.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(SP_THREADS, 4) nap_step_fused_kernel(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const unsigned char* __restrict__ x_bad, const float* __restrict__ x,
    const float* __restrict__ c_inf, const float* __restrict__ s_inf,
    const int* __restrict__ node_active, float ts2, float* __restrict__ out,
    unsigned char* __restrict__ out_bad, int* __restrict__ exit_flag,
    int* __restrict__ blk_still, int tb, int F, int n_xb, int n_ob,
    int nb_rb) {
  static_assert(SP_THREADS == FB, "one thread per distance column");
  extern __shared__ float4 sp_dyn[];
  float* e_val = reinterpret_cast<float*>(sp_dyn);      // kept entries
  int* e_row = reinterpret_cast<int*>(e_val + SP_CAP);  // their x rows
  float* stage = e_val;  // a slab's (RB, SLAB) output, after the lists
  __shared__ SlabShared sh;
  __shared__ float red[RB][FB];
  const int rb = blockIdx.x, tid = threadIdx.x, F4 = F / 4;
  const bool is_batch = rb < nb_rb;  // the same for every thread
  float c[RB], d2[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    c[r] = is_batch ? c_inf[rb * RB + r] : 0.0f;
    d2[r] = 0.0f;
  }
  for (int y = 0; y * SLAB < F; ++y) {
    float4 acc[RB];
    spmm_slab(tiles, tile_col, valid, active,
              x_bad + static_cast<long long>(y) * n_xb, x, rb, y, tb, F4,
              e_val, e_row, sh, acc);
    store_slab(out, out_bad, acc, rb, y, F4, n_ob);
    if (!is_batch) continue;
    if (y * SP_THREADS + tid < F4) {
      float4* st4 = reinterpret_cast<float4*>(stage);
#pragma unroll
      for (int r = 0; r < RB; ++r) st4[r * SP_THREADS + tid] = acc[r];
    }
    __syncthreads();
    // nap_exit.cu's order: feature blocks ascending, column f = fb*FB + tid
    for (int j = 0; j < SLAB / FB && (y * SLAB + j * FB) < F; ++j) {
      const float s = s_inf[y * SLAB + j * FB + tid];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float diff =
            __fsub_rn(stage[r * SLAB + j * FB + tid], __fmul_rn(c[r], s));
        d2[r] = fmaf(diff, diff, d2[r]);
      }
    }
    __syncthreads();  // the stage is read before the next slab's lists
  }
  if (!is_batch) {
    if (tid == 0) blk_still[rb] = 0;
    return;  // the whole block leaves together: no barrier is skipped
  }
  reduce_rows(d2, red);
  if (tid == 0)
    blk_still[rb] = decide_exits(red, node_active, ts2, rb * RB, exit_flag);
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32 with n_x % 128 == 0 and F % 128 == 0; x_bad
// (ceil(F / 512), n_x / 128) u8 the flags of x; c_inf (nb,) f32; s_inf
// (F,) f32; node_active (nb,) i32 with nb % 8 == 0; ts2 the squared
// threshold. Outputs: out (n_rb * 8, F) f32, out_bad (ceil(F / 512),
// ceil(n_rb / 16)) u8 (zero on entry), exit (nb,) i32, blk_still (n_rb,)
// i32. tiles, x and out 16-byte aligned.
extern "C" int nap_step_fused_launch(
    const void* tiles, const void* tile_col, const void* valid,
    const void* active, const void* x_bad, const void* x, const void* c_inf,
    const void* s_inf, const void* node_active, float ts2, void* out,
    void* out_bad, void* exit_flag, void* blk_still, int n_rb, int tb, int F,
    int n_x, int nb, int device, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nap_step_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SP_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb > 0) {
    nap_step_fused_kernel<<<n_rb, SP_THREADS, SP_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
        static_cast<const int*>(valid), static_cast<const int*>(active),
        static_cast<const unsigned char*>(x_bad),
        static_cast<const float*>(x), static_cast<const float*>(c_inf),
        static_cast<const float*>(s_inf), static_cast<const int*>(node_active),
        ts2, static_cast<float*>(out), static_cast<unsigned char*>(out_bad),
        static_cast<int*>(exit_flag), static_cast<int*>(blk_still), tb, F,
        n_x / CB, (n_rb + CB / RB - 1) / (CB / RB), nb / RB);
  }
  return static_cast<int>(cudaGetLastError());
}
