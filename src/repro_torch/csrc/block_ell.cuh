// Shared device code of the three NAP kernels (spmm_block_ell.cu,
// nap_step_fused.cu, nap_exit.cu).
//
// Geometry (must match repro_torch/kernels/spmm/__init__.py): an adjacency
// tile is RB x CB = 8 x 128 f32 coefficients; a block of SP_THREADS = 128
// threads covers one row block and one slab of SLAB = 512 features (a
// float4 column per thread); the exit distance walks features in FB =
// 128-wide blocks, one warp per node and four columns per lane.
//
// Bit-parity contract. A propagated value is, for each output element, the
// chain of fmaf over the valid slots ascending, then k ascending, from
// +0.0f (the dense chain). `spmm_slab` is the ONLY code that computes it,
// for both the SpMM and the fused step, so their `out` is bitwise equal by
// construction. It drops the terms whose coefficient is +-0: for finite x
// such a term is fmaf(+-0, x, acc) = acc + (+-0), which equals acc bit for
// bit unless acc is -0; the chain starts at +0 and reaches -0 only if a
// non-zero product underflows to a negative zero, which the packer's
// coefficients (1/degree-sized) times feature values never do. Where x is
// NaN or Inf the dropped term is not neutral (0 * Inf = NaN), so a tile
// whose x block holds a non-finite value keeps every term: the caller
// passes one flag byte per (128-row block, slab) of x (`x_bad`), and each
// kernel sets the same flags for its own output (`store_slab`), which is
// the next step's x. The result then equals the dense chain everywhere.
//
// `row_sum` is the ONLY code that sums a node's squared distance: the
// fused step and the standalone exit kernel both give each node one warp,
// whose lane l adds the terms of columns 4l .. 4l+3 of every FB-wide
// feature block in ascending block order (`dist_terms`), and both reduce
// the 128 column partials in `row_sum`'s tree, so their distances (and
// exit flags) are bitwise equal. Every floating-point operation is an
// explicit intrinsic (fmaf / __fmul_rn / __fsub_rn / __fadd_rn), so the
// compiler cannot contract or reorder them differently per kernel.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int RB = 8;    // rows per adjacency tile
constexpr int CB = 128;  // columns per adjacency tile
constexpr int FB = 128;  // feature block of the exit distance

constexpr int SP_THREADS = 128;
constexpr int SP_NS = 4;                   // tile slots per chunk
constexpr int SP_PAIRS = SP_NS * RB;       // (slot, row) pairs per chunk
constexpr int SP_PER_WARP = SP_PAIRS / (SP_THREADS / 32);
constexpr int SP_CAP = SP_NS * RB * CB;    // entries one chunk can hold
constexpr int SLAB = 4 * SP_THREADS;       // features per slab
constexpr int SP_BATCH = 4;                // x rows read before use
constexpr size_t SP_SMEM = SP_CAP * (sizeof(float) + sizeof(int));
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int FB4 = FB / 4;               // float4 columns of a feature block

// Shared-memory bookkeeping of `spmm_slab` (the entry lists live in the
// caller's dynamic shared memory, SP_SMEM bytes).
struct SlabShared {
  int slot[SP_THREADS];   // valid slots of the window, ascending
  int xblk[SP_THREADS];   // their tile_col
  int bad[SP_THREADS];    // their x block holds a non-finite value
  int cnt[SP_PAIRS];      // entries per (slot, row) pair
  int off[SP_PAIRS];      // where each pair's list starts
  int rs[RB + 1];         // where each output row's list starts
  int wcnt[SP_THREADS / 32];
};

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
  return acc;
}

__device__ __forceinline__ bool finite4(float4 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
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

// One (RB x SLAB) block of the propagated features: acc[r] = out[rb * RB +
// r][4c .. 4c+3] for this thread's float4 column c = y * SP_THREADS + tid,
// zero where c >= F4 or the row block is inactive. x_bad points at slab y's
// flags (one byte per 128-row block of x). Every thread of the block must
// call it; it ends with the entry lists free (after a barrier) whenever it
// touched them.
//
// The valid slots of the row block are compacted (ballot + popc) into an
// ascending list, then taken SP_NS = 4 at a time: each warp streams one
// whole tile into registers with coalesced 16-byte loads, finds its
// non-zeros with __ballot_sync and __popc (every entry, where the tile's x
// block is flagged), and the block writes them to shared memory as (value,
// x row) grouped by output row in (slot, k) order. Then each thread
// accumulates over those entries only: one coalesced float4 read of an x
// row each, SP_BATCH reads issued before the first is used, while the next
// chunk's tiles are already loading into the registers the scan freed.
__device__ __forceinline__ void spmm_slab(
    const float* __restrict__ tiles, const int* __restrict__ tile_col,
    const int* __restrict__ valid, const int* __restrict__ active,
    const unsigned char* __restrict__ x_bad, const float* __restrict__ x,
    int rb, int y, int tb, int F4, float* e_val, int* e_row, SlabShared& sh,
    float4 (&acc)[RB]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int c = y * SP_THREADS + tid;
  const bool has_col = c < F4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* t4 = reinterpret_cast<const float4*>(tiles);
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active[rb] == 0) return;  // the same for every thread of the block

  const long long slot0 = static_cast<long long>(rb) * tb;
  for (int w0 = 0; w0 < tb; w0 += SP_THREADS) {
    // ---- the valid slots of [w0, w0 + 128), in ascending order, with the
    // flag of the x block each one names. tile_col is read beside `valid`,
    // so the flag read that depends on it overlaps the ballot's barrier.
    const int t = w0 + tid;
    const bool in = t < tb;
    const bool ok = in && valid[slot0 + t] != 0;
    const int xb = in ? tile_col[slot0 + t] : 0;
    const unsigned char f = ok ? x_bad[xb] : 0;
    const unsigned m = __ballot_sync(FULL_MASK, ok);
    if (lane == 0) sh.wcnt[warp] = __popc(m);
    __syncthreads();
    int pos = __popc(m & lt), n_valid = 0;
#pragma unroll
    for (int w = 0; w < SP_THREADS / 32; ++w) {
      pos += w < warp ? sh.wcnt[w] : 0;
      n_valid += sh.wcnt[w];
    }
    if (ok) {
      sh.slot[pos] = t;
      sh.xblk[pos] = xb;
      sh.bad[pos] = f;
    }
    __syncthreads();

    float4 v[SP_PER_WARP];
    if (n_valid > 0)
      load_chunk(v, t4, slot0, sh.slot, 0, min(SP_NS, n_valid), warp, lane);
    for (int ch = 0; ch < n_valid; ch += SP_NS) {
      const int ns = min(SP_NS, n_valid - ch);
      // warp w holds slot w of the chunk: keep all its entries if flagged
      const bool dense = warp < ns && sh.bad[ch + warp] != 0;
#pragma unroll
      for (int i = 0; i < SP_PER_WARP; ++i) {
        const float4 vi = v[i];
        const int mine = dense ? 4 : (vi.x != 0.0f) + (vi.y != 0.0f) +
                                         (vi.z != 0.0f) + (vi.w != 0.0f);
        const int n = __reduce_add_sync(FULL_MASK, mine);
        if (lane == 0) sh.cnt[warp * SP_PER_WARP + i] = n;
      }
      __syncthreads();
      // ---- offsets: output row r's list holds its pairs in slot order
      if (tid < RB) {
        int total = 0;
#pragma unroll
        for (int s = 0; s < SP_NS; ++s) total += sh.cnt[s * RB + tid];
        int base = total;  // exclusive scan over the 8 rows
#pragma unroll
        for (int d = 1; d < RB; d <<= 1) {
          const int up = __shfl_up_sync(0xffu, base, d, RB);
          if (tid >= d) base += up;
        }
        base -= total;
        sh.rs[tid] = base;
        if (tid == RB - 1) sh.rs[RB] = base + total;
#pragma unroll
        for (int s = 0; s < SP_NS; ++s) {
          sh.off[s * RB + tid] = base;
          base += sh.cnt[s * RB + tid];
        }
      }
      __syncthreads();
      // ---- compact: each kept entry to its place, k ascending in a pair
#pragma unroll
      for (int i = 0; i < SP_PER_WARP; ++i) {
        const int p = warp * SP_PER_WARP + i;
        const float4 vi = v[i];
        const bool kx = dense || vi.x != 0.0f, ky = dense || vi.y != 0.0f;
        const bool kz = dense || vi.z != 0.0f, kw = dense || vi.w != 0.0f;
        const unsigned mx = __ballot_sync(FULL_MASK, kx);
        const unsigned my = __ballot_sync(FULL_MASK, ky);
        const unsigned mz = __ballot_sync(FULL_MASK, kz);
        const unsigned mw = __ballot_sync(FULL_MASK, kw);
        if (warp >= ns) continue;  // the same for the whole warp
        int e = sh.off[p] + __popc(mx & lt) + __popc(my & lt) +
                __popc(mz & lt) + __popc(mw & lt);
        const int xr = sh.xblk[ch + warp] * CB + 4 * lane;
        if (kx) { e_val[e] = vi.x; e_row[e] = xr; ++e; }
        if (ky) { e_val[e] = vi.y; e_row[e] = xr + 1; ++e; }
        if (kz) { e_val[e] = vi.z; e_row[e] = xr + 2; ++e; }
        if (kw) { e_val[e] = vi.w; e_row[e] = xr + 3; }
      }
      __syncthreads();
      // ---- the next chunk's tiles load while this one accumulates
      if (ch + SP_NS < n_valid)
        load_chunk(v, t4, slot0, sh.slot, ch + SP_NS,
                   min(SP_NS, n_valid - ch - SP_NS), warp, lane);
      // ---- accumulate over the kept entries only, row by row in (slot,
      // k) order; SP_BATCH x rows are read before the first is used
      if (has_col) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int end = sh.rs[r + 1];
          for (int e0 = sh.rs[r]; e0 < end; e0 += SP_BATCH) {
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

// Writes this thread's column of the block's slab of `out` from acc, and
// sets the flag byte out_bad[y * n_ob + rb / 16] of its 128-row block
// (n_ob of them per slab) if a value is NaN or Inf; out_bad is zero on
// entry, and threads that set a byte all write 1 (no barrier needed).
__device__ __forceinline__ void store_slab(float* __restrict__ out,
                                           unsigned char* __restrict__ out_bad,
                                           const float4 (&acc)[RB], int rb,
                                           int y, int F4, int n_ob) {
  const int c = y * SP_THREADS + threadIdx.x;
  if (c >= F4) return;
  float4* o4 = reinterpret_cast<float4*>(out);
  bool bad = false;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    o4[static_cast<long long>(rb * RB + r) * F4 + c] = acc[r];
    bad |= !finite4(acc[r]);
  }
  if (bad) out_bad[static_cast<long long>(y) * n_ob + rb / (CB / RB)] = 1;
}

// One term of a node's squared distance per feature, added into this
// lane's column partials: acc.j = fmaf(d, d, acc.j) with d = x.j - xi.j.
// Chained over the FB-wide feature blocks in ascending order, each of the
// four components is the partial of one column 4 * lane + j of the block.
__device__ __forceinline__ float4 dist_terms(float4 x, float4 xi,
                                             float4 acc) {
  float d = __fsub_rn(x.x, xi.x);
  acc.x = fmaf(d, d, acc.x);
  d = __fsub_rn(x.y, xi.y);
  acc.y = fmaf(d, d, acc.y);
  d = __fsub_rn(x.z, xi.z);
  acc.z = fmaf(d, d, acc.z);
  d = __fsub_rn(x.w, xi.w);
  acc.w = fmaf(d, d, acc.w);
  return acc;
}

// The sum of one node's FB = 128 column partials, held by one warp (lane
// l holds columns 4l .. 4l+3, from `dist_terms`), in one fixed tree:
// stride 64, 32, ..., 1, each pair added as __fadd_rn(lower column,
// higher column). Strides 64 .. 4 pair column c = 4l + j with column c +
// 4k, which lane l + k holds in the same component (a shuffle down by
// k = 16 .. 1); strides 2 and 1 pair components inside lane 0. The total
// is valid in lane 0; every lane of the warp must call it.
__device__ __forceinline__ float row_sum(float4 p) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    p.x = __fadd_rn(p.x, __shfl_down_sync(FULL_MASK, p.x, k));
    p.y = __fadd_rn(p.y, __shfl_down_sync(FULL_MASK, p.y, k));
    p.z = __fadd_rn(p.z, __shfl_down_sync(FULL_MASK, p.z, k));
    p.w = __fadd_rn(p.w, __shfl_down_sync(FULL_MASK, p.w, k));
  }
  return __fadd_rn(__fadd_rn(p.x, p.z), __fadd_rn(p.y, p.w));
}

// Exit flag of node `row` from its squared distance d2: writes exit_flag[
// row] and returns whether the node stays active (was active, not exited).
__device__ __forceinline__ int decide_exit(float d2,
                                           const int* __restrict__ active,
                                           float ts2, long long row,
                                           int* __restrict__ exit_flag) {
  const bool was_active = active[row] != 0;
  const bool exits = was_active && d2 < ts2;
  exit_flag[row] = exits ? 1 : 0;
  return (was_active && !exits) ? 1 : 0;
}

}  // namespace repro_torch
