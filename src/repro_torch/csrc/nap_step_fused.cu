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
// gives each node one warp, lane l on columns 4l .. 4l+3 of each FB =
// 128-wide feature block: so the slab's (8 x 512) output is staged in
// shared memory (the entry lists' space, free by then), each warp takes
// two rows and adds their terms in that order (`dist_terms`), and
// `row_sum` sums them in nap_exit.cu's tree. The
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
  static_assert(SP_THREADS / 32 * 2 == RB, "one warp per two rows");
  extern __shared__ float4 sp_dyn[];
  float* e_val = reinterpret_cast<float*>(sp_dyn);      // kept entries
  int* e_row = reinterpret_cast<int*>(e_val + SP_CAP);  // their x rows
  float4* stage = sp_dyn;  // a slab's (RB, SLAB) output, after the lists
  __shared__ SlabShared sh;
  const int rb = blockIdx.x, tid = threadIdx.x, F4 = F / 4;
  const int lane = tid & 31, r0 = 2 * (tid >> 5);  // this warp's two rows
  const bool is_batch = rb < nb_rb;  // the same for every thread
  const float4* s4 = reinterpret_cast<const float4*>(s_inf) + lane;
  float c[2];
  float4 p[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c[i] = is_batch ? c_inf[rb * RB + r0 + i] : 0.0f;
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int y = 0; y * SLAB < F; ++y) {
    float4 acc[RB];
    spmm_slab(tiles, tile_col, valid, active,
              x_bad + static_cast<long long>(y) * n_xb, x, rb, y, tb, F4,
              e_val, e_row, sh, acc);
    store_slab(out, out_bad, acc, rb, y, F4, n_ob);
    if (!is_batch) continue;
    if (y * SP_THREADS + tid < F4) {
#pragma unroll
      for (int r = 0; r < RB; ++r) stage[r * SP_THREADS + tid] = acc[r];
    }
    __syncthreads();
    // nap_exit.cu's order: feature blocks ascending, lane l on columns
    // 4l .. 4l+3 of each, x_inf = c * s rebuilt per element
    for (int j = 0; j < SLAB / FB && (y * SLAB + j * FB) < F; ++j) {
      const float4 s = s4[(y * SLAB + j * FB) / 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 xi = make_float4(
            __fmul_rn(c[i], s.x), __fmul_rn(c[i], s.y),
            __fmul_rn(c[i], s.z), __fmul_rn(c[i], s.w));
        p[i] = dist_terms(stage[(r0 + i) * SP_THREADS + j * FB4 + lane], xi,
                          p[i]);
      }
    }
    __syncthreads();  // the stage is read before the next slab's lists
  }
  if (!is_batch) {
    if (tid == 0) blk_still[rb] = 0;
    return;  // the whole block leaves together: no barrier is skipped
  }
  int still = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float d2 = row_sum(p[i]);
    if (lane == 0)
      still |= decide_exit(d2, node_active, ts2,
                           static_cast<long long>(rb) * RB + r0 + i,
                           exit_flag);
  }
  still = __syncthreads_or(still);
  if (tid == 0) blk_still[rb] = still;
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32 with n_x % 128 == 0 and F % 128 == 0; x_bad
// (ceil(F / 512), n_x / 128) u8 the flags of x; c_inf (nb,) f32; s_inf
// (F,) f32, 16-byte aligned; node_active (nb,) i32 with nb % 8 == 0; ts2
// the squared threshold. Outputs: out (n_rb * 8, F) f32, out_bad (ceil(F / 512),
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
