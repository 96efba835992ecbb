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
// Bit parity with the fused step (nap_step_fused.cu, which keeps the dense
// `accumulate_block` of block_ell.cuh): for each output element both run
// fmaf over the valid slots ascending, then k ascending, from +0.0f. This
// kernel drops the terms whose coefficient is +-0. For finite x such a
// term is fmaf(+-0, x, acc) = acc + (+-0), which equals acc bit for bit
// unless acc is -0; the chain starts at +0 and reaches -0 only if a
// non-zero product underflows to a negative zero, which the packer's
// coefficients (1/degree-sized) times feature values never do. So `out`
// is bitwise the fused step's. Where x holds NaN or Inf behind a zero
// coefficient the dense chain propagates it and this kernel does not
// (ROADMAP, queue C).
#include "block_ell.cuh"

namespace repro_torch {

constexpr int SP_THREADS = 128;
constexpr int SP_NS = 4;                   // tile slots per chunk
constexpr int SP_PAIRS = SP_NS * RB;       // (slot, row) pairs per chunk
constexpr int SP_PER_WARP = SP_PAIRS / (SP_THREADS / 32);
constexpr int SP_CAP = SP_NS * RB * CB;    // non-zeros one chunk can hold
constexpr int SP_FEATS = 4 * SP_THREADS;   // features per block
constexpr int SP_BATCH = 4;                // x rows read before use
constexpr size_t SP_SMEM = SP_CAP * (sizeof(float) + sizeof(int));
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

__device__ __forceinline__ int nonzeros(float4 v) {
  return (v.x != 0.0f) + (v.y != 0.0f) + (v.z != 0.0f) + (v.w != 0.0f);
}

// Chunk `ch` of the valid-slot list into registers: warp w streams slot w
// of the chunk row by row; lane l holds k = 4l .. 4l+3 of pair p = 8w + i
// (slot p / 8, row p % 8). Slots past the list read as zeros.
__device__ __forceinline__ void load_chunk(float4 (&v)[SP_PER_WARP],
                                           const float4* __restrict__ t4,
                                           long long slot0, const int* s_slot,
                                           int ch, int ns, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < SP_PER_WARP; ++i) {
    const int s = (warp * SP_PER_WARP + i) / RB, r = i % RB;
    v[i] = s < ns ? __ldcs(t4 + (slot0 + s_slot[ch + s]) * (RB * CB / 4) +
                           r * (CB / 4) + lane)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(SP_THREADS, 4) spmm_block_ell_kernel(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const float* __restrict__ x, float* __restrict__ out, int tb, int F) {
  extern __shared__ float4 sp_dyn[];
  float* e_val = reinterpret_cast<float*>(sp_dyn);      // non-zero values
  int* e_row = reinterpret_cast<int*>(e_val + SP_CAP);  // their x rows
  __shared__ int s_slot[SP_THREADS];   // valid slots of the window, ascending
  __shared__ int s_xblk[SP_THREADS];   // their tile_col
  __shared__ int s_cnt[SP_PAIRS];      // non-zeros per (slot, row) pair
  __shared__ int s_off[SP_PAIRS];      // where each pair's list starts
  __shared__ int s_rs[RB + 1];         // where each output row's list starts
  __shared__ int s_wcnt[SP_THREADS / 32];

  const int rb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int F4 = F / 4;
  const int c = blockIdx.y * SP_THREADS + tid;  // this thread's float4 column
  const bool has_col = c < F4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* t4 = reinterpret_cast<const float4*>(tiles);
  float4 acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (active[rb] != 0) {  // the same for every thread of the block
    const long long slot0 = static_cast<long long>(rb) * tb;
    for (int w0 = 0; w0 < tb; w0 += SP_THREADS) {
      // ---- the valid slots of [w0, w0 + 128), in ascending order
      const int t = w0 + tid;
      const bool ok = t < tb && valid[slot0 + t] != 0;
      const unsigned m = __ballot_sync(FULL_MASK, ok);
      if (lane == 0) s_wcnt[warp] = __popc(m);
      __syncthreads();
      int pos = __popc(m & lt), n_valid = 0;
#pragma unroll
      for (int w = 0; w < SP_THREADS / 32; ++w) {
        pos += w < warp ? s_wcnt[w] : 0;
        n_valid += s_wcnt[w];
      }
      if (ok) {
        s_slot[pos] = t;
        s_xblk[pos] = tile_col[slot0 + t];
      }
      __syncthreads();

      float4 v[SP_PER_WARP];
      if (n_valid > 0)
        load_chunk(v, t4, slot0, s_slot, 0, min(SP_NS, n_valid), warp, lane);
      for (int ch = 0; ch < n_valid; ch += SP_NS) {
        const int ns = min(SP_NS, n_valid - ch);
#pragma unroll
        for (int i = 0; i < SP_PER_WARP; ++i) {
          const int n = __reduce_add_sync(FULL_MASK, nonzeros(v[i]));
          if (lane == 0) s_cnt[warp * SP_PER_WARP + i] = n;
        }
        __syncthreads();
        // ---- offsets: output row r's list holds its pairs in slot order
        if (tid < RB) {
          int total = 0;
#pragma unroll
          for (int s = 0; s < SP_NS; ++s) total += s_cnt[s * RB + tid];
          int base = total;  // exclusive scan over the 8 rows
#pragma unroll
          for (int d = 1; d < RB; d <<= 1) {
            const int up = __shfl_up_sync(0xffu, base, d, RB);
            if (tid >= d) base += up;
          }
          base -= total;
          s_rs[tid] = base;
          if (tid == RB - 1) s_rs[RB] = base + total;
#pragma unroll
          for (int s = 0; s < SP_NS; ++s) {
            s_off[s * RB + tid] = base;
            base += s_cnt[s * RB + tid];
          }
        }
        __syncthreads();
        // ---- compact: each non-zero to its place, k ascending in a pair
#pragma unroll
        for (int i = 0; i < SP_PER_WARP; ++i) {
          const int p = warp * SP_PER_WARP + i, s = p / RB;
          const float4 vi = v[i];
          const unsigned mx = __ballot_sync(FULL_MASK, vi.x != 0.0f);
          const unsigned my = __ballot_sync(FULL_MASK, vi.y != 0.0f);
          const unsigned mz = __ballot_sync(FULL_MASK, vi.z != 0.0f);
          const unsigned mw = __ballot_sync(FULL_MASK, vi.w != 0.0f);
          if (s >= ns) continue;  // the same for the whole warp
          int e = s_off[p] + __popc(mx & lt) + __popc(my & lt) +
                  __popc(mz & lt) + __popc(mw & lt);
          const int xr = s_xblk[ch + s] * CB + 4 * lane;
          if (vi.x != 0.0f) { e_val[e] = vi.x; e_row[e] = xr; ++e; }
          if (vi.y != 0.0f) { e_val[e] = vi.y; e_row[e] = xr + 1; ++e; }
          if (vi.z != 0.0f) { e_val[e] = vi.z; e_row[e] = xr + 2; ++e; }
          if (vi.w != 0.0f) { e_val[e] = vi.w; e_row[e] = xr + 3; }
        }
        __syncthreads();
        // ---- the next chunk's tiles load while this one accumulates
        if (ch + SP_NS < n_valid)
          load_chunk(v, t4, slot0, s_slot, ch + SP_NS,
                     min(SP_NS, n_valid - ch - SP_NS), warp, lane);
        // ---- accumulate over the non-zeros only, row by row in (slot, k)
        // order; SP_BATCH x rows are read before the first is used
        if (has_col) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int end = s_rs[r + 1];
            for (int e0 = s_rs[r]; e0 < end; e0 += SP_BATCH) {
              float4 xv[SP_BATCH];
              float a[SP_BATCH];
#pragma unroll
              for (int u = 0; u < SP_BATCH; ++u) {
                const int e = min(e0 + u, end - 1);
                a[u] = e_val[e];
                xv[u] = x4[static_cast<long long>(e_row[e]) * F4 + c];
              }
#pragma unroll
              for (int u = 0; u < SP_BATCH; ++u)
                if (e0 + u < end) acc[r] = fma4(a[u], xv[u], acc[r]);
            }
          }
        }
        __syncthreads();  // the lists are consumed before the next chunk
      }
    }
  }
  if (has_col) {
    float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int r = 0; r < RB; ++r)
      o4[static_cast<long long>(rb * RB + r) * F4 + c] = acc[r];
  }
}

}  // namespace repro_torch

// tiles (n_rb, tb, 8, 128) f32; tile_col, valid (n_rb, tb) i32; active
// (n_rb,) i32; x (n_x, F) f32 with F % 128 == 0; out (n_rb * 8, F) f32;
// tiles, x and out 16-byte aligned. Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int spmm_block_ell_launch(const void* tiles, const void* tile_col,
                                     const void* valid, const void* active,
                                     const void* x, void* out, int n_rb,
                                     int tb, int F, int device, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spmm_block_ell_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SP_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb > 0) {
    const dim3 grid(n_rb, (F + SP_FEATS - 1) / SP_FEATS);
    spmm_block_ell_kernel<<<grid, SP_THREADS, SP_SMEM,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tiles), static_cast<const int*>(tile_col),
        static_cast<const int*>(valid), static_cast<const int*>(active),
        static_cast<const float*>(x), static_cast<float*>(out), tb, F);
  }
  return static_cast<int>(cudaGetLastError());
}
