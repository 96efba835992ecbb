// Causal (optionally banded) online-softmax attention, hand-written for
// Hopper: bf16 operands on the tensor cores (wgmma), f32 operands on the
// CUDA cores.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (body `_kernel`): for each
// (batch, query head) and query position i,
//   s[j]  = (q[i] * scale) . k[j]            masked to -1e30 unless
//           j <= i and (window == 0 or j > i - window)   (when causal)
//   out[i] = sum_j softmax(s)[j] v[j]
// by the running max / sum / accumulator recurrence over key blocks, with
// the output acc / max(l, 1e-30) written in q's dtype. Key blocks that lie
// wholly above the diagonal or left of the band are skipped, as the TPU
// kernel's `relevant` test does.
//
// GQA/MQA: q is (B, Sq, H, hd) and k, v are (B, Sk, KV, hd) in the model's
// layout; query head h reads key/value head h / (H / KV) directly, so the
// K/V heads are never repeated in memory (the JAX wrapper repeats them).
//
// What bounds it on this card: operations. At recurrentgemma-9b's prefill
// (B 2, S 4096, 16 heads, hd 256, window 2048) the band holds ~6.3 M
// (query, key) pairs per head, 4 * hd flops each: ~206 GFLOP against
// ~0.15 GB of q, k, v and out, 0.21 ms at the bf16 tensor-core peak.
//
// The dtype picks one of two hand-written kernels (a dispatch, not a
// fallback: each launch that fails raises in the wrapper).
//
// bf16 (`fa_bf16_kernel`, the model path). A block takes 128 queries of
// one (batch, head): two consumer warpgroups of 64 query rows each, 256
// threads. Thread 0 loads Q once and streams the band's K and V tiles (BK
// keys x hd) with TMA (128-byte swizzle, 3-D tensor maps over (hd, heads,
// rows)) into a ring of shared-memory stages under mbarriers: "full" when
// a tile's bytes have landed, "empty" when all 256 threads are done with
// it, so later tiles load while the current one is multiplied. S = Q K^T
// is hd/16 wgmma m64n{BK}k16 with both operands in shared memory
// (K-major); the online softmax stays in f32 registers (exp2 with the
// scale folded in, the same -1e30 mask and max(l, 1e-30) division; the
// mask is computed only on blocks that cross the diagonal or the band
// edge, and a warpgroup skips a block wholly masked for its rows); P is
// rounded to bf16 in registers, where the accumulator layout of S is
// already the A-operand layout, and O += P V is BK/16 wgmma m64n{hd}k16
// with V read MN-major from the same swizzled tiles. `TcCfg` sets BK and
// the ring depth per head dim: at hd 256 the O accumulator alone is 128
// f32 registers a thread, so BK = 64, and Q (64 KB) with two K/V stages
// (128 KB) takes 192 KB of shared memory, one block per SM.
//
// f32 (`fa_f32_kernel`, for the f32 end-to-end gates; TF32 is not used):
// a block takes 64 queries x 64 keys at a time with 256 threads (16 x 16);
// thread (ty, tx) owns query rows 4ty..4ty+3, key columns tx + 16b of the
// score tile, and the 4-wide output column groups tx + 16g, 64
// accumulators at hd 256. Q (pre-scaled), K and V tiles are staged in
// shared memory with rows padded by 4 floats; f32 FMAs on the CUDA cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro_torch {

constexpr float FA_NEG_INF = -1.0e30f;

// ------------------------------------------------------------------ f32

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;

// rows x HD tile from `src` (row stride `ld` elements) into `dst` (row
// stride HD + 4 floats), times `mul`
template <int HD>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long ld, float* dst, float mul) {
  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < FA_BQ * V; e += FA_THREADS) {
    const int row = e / V, c = (e % V) * 4;
    float4 x = *reinterpret_cast<const float4*>(src + row * ld + c);
    x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    *reinterpret_cast<float4*>(dst + row * (HD + 4) + c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1) fa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
    int H, int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 4;        // padded smem row (floats)
  constexpr int PLD = FA_BK + 4;
  constexpr int NG = HD / 64;       // 4-wide column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + FA_BQ * LD;
  float* Vs = Ks + FA_BK * LD;
  float* Ps = Vs + FA_BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * FA_BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long q_ld = static_cast<long long>(H) * HD;
  const long long kv_ld = static_cast<long long>(KV) * HD;
  const float* qb = q + (static_cast<long long>(b) * Sq + q0) * q_ld + h * HD;
  const float* kb = k + static_cast<long long>(b) * Sk * kv_ld + kvh * HD;
  const float* vb = v + static_cast<long long>(b) * Sk * kv_ld + kvh * HD;

  float acc[4][NG * 4];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = FA_NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < NG * 4; ++e) acc[a][e] = 0.f;
  }
  stage<HD>(qb, q_ld, Qs, scale);

  const int nkb = Sk / FA_BK;
  const int kb_end = causal ? min(nkb - 1, (q0 + FA_BQ - 1) / FA_BK) : nkb - 1;
  for (int kbi = 0; kbi <= kb_end; ++kbi) {
    const int k0 = kbi * FA_BK;
    if (causal && window > 0 && k0 + FA_BK - 1 <= q0 - window) continue;
    __syncthreads();                 // previous tiles fully consumed
    stage<HD>(kb + k0 * kv_ld, kv_ld, Ks, 1.f);
    stage<HD>(vb + k0 * kv_ld, kv_ld, Vs, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (4 * ty + a) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(qa[a].x, kk[j].x, s[a][j]);
          s[a][j] = fmaf(qa[a].y, kk[j].y, s[a][j]);
          s[a][j] = fmaf(qa[a].z, kk[j].z, s[a][j]);
          s[a][j] = fmaf(qa[a].w, kk[j].w, s[a][j]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + 4 * ty + a;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (causal && (kpos > qpos || (window > 0 && kpos <= qpos - window)))
          s[a][j] = FA_NEG_INF;
        mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_new);
        rsum += p;
        Ps[(4 * ty + a) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[a] = l[a] * corr + rsum;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < NG * 4; ++e) acc[a][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = Ps[(4 * ty + a) * PLD + j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * LD + (tx + 16 * g) * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][4 * g + 0] = fmaf(p[a], vv.x, acc[a][4 * g + 0]);
          acc[a][4 * g + 1] = fmaf(p[a], vv.y, acc[a][4 * g + 1]);
          acc[a][4 * g + 2] = fmaf(p[a], vv.z, acc[a][4 * g + 2]);
          acc[a][4 * g + 3] = fmaf(p[a], vv.w, acc[a][4 * g + 3]);
        }
      }
    }
  }

  float* ob = out + (static_cast<long long>(b) * Sq + q0) * q_ld + h * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float4 x;
      x.x = acc[a][4 * g + 0] * inv;
      x.y = acc[a][4 * g + 1] * inv;
      x.z = acc[a][4 * g + 2] * inv;
      x.w = acc[a][4 * g + 3] * inv;
      *reinterpret_cast<float4*>(ob + (4 * ty + a) * q_ld + (tx + 16 * g) * 4) = x;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               float scale, cudaStream_t st) {
  if (Sq % FA_BQ || Sk % FA_BK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (FA_BQ * (HD + 4) + 2 * FA_BK * (HD + 4) +
                       FA_BQ * (FA_BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / FA_BQ, B * H);
  fa_f32_kernel<HD><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- bf16

constexpr int TC_BQ = 128;           // queries per block (2 warpgroups)
constexpr int TC_THREADS = 256;
constexpr int TC_QPANEL = 64 * 128;  // bytes of a 64-row x 64-bf16 Q panel
constexpr float LOG2E = 1.4426950408889634f;

// Keys per tile (BK) and K/V ring depth per head dim: the S accumulator
// (BK / 2 registers) and O (HD / 2) must fit in a thread's 255 registers,
// and Q plus the ring in 227 KB of shared memory.
template <int HD> struct TcCfg;
template <> struct TcCfg<64> { static constexpr int BK = 128, STAGES = 3; };
template <> struct TcCfg<128> { static constexpr int BK = 128, STAGES = 2; };
template <> struct TcCfg<256> { static constexpr int BK = 64, STAGES = 2; };

template <int HD>
struct TcSmem {
  static constexpr int BK = TcCfg<HD>::BK, STAGES = TcCfg<HD>::STAGES;
  static constexpr int PANELS = HD / 64;
  static constexpr int KV_PANEL = BK * 128;         // BK rows x 64 bf16
  static constexpr int Q_BYTES = TC_BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K (or V) tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers (q, full[], empty[]) + slack to align the base to 1024
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int N> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    wgmma_m64n64k16_ss(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_m64n64k16_rs(d, a, b);
  }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    wgmma_m64n128k16_ss(d, a, b, scale_d);
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_m64n128k16_rs(d, a, b);
  }
};
template <> struct Mma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_m64n256k16_rs(d, a, b);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of a wgmma m64nN tile, for thread t of a warpgroup:
// register 4i + e holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column
// 8i + 2 (t % 4) + e % 2.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1) fa_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int Sq, int Sk, int H, int KV, int causal, int window, float scale_log2) {
  using L = TcSmem<HD>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ uint8_t tc_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + L::Q_BYTES;
  uint8_t* Vs = Ks + STAGES * L::KV_BYTES;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * TC_BQ;
  const int nkb = Sk / BK;
  int kb_lo = 0, kb_hi = nkb - 1;
  if (causal) {
    kb_hi = min(nkb - 1, (q0 + TC_BQ - 1) / BK);
    const int kmin = q0 - window + 1;   // first key of the first query's band
    if (window > 0 && kmin > 0) kb_lo = kmin / BK;
  }
  const int n_tiles = kb_hi - kb_lo + 1;

  auto load_kv = [&](int stage, int kb) {
    mbar_expect_tx(&full[stage], 2 * L::KV_BYTES);
    const int row = b * Sk + kb * BK;
#pragma unroll
    for (int p = 0; p < L::PANELS; ++p) {
      tma_load_3d(Ks + stage * L::KV_BYTES + p * L::KV_PANEL, &tk,
                  &full[stage], p * 64, kvh, row);
      tma_load_3d(Vs + stage * L::KV_BYTES + p * L::KV_PANEL, &tv,
                  &full[stage], p * 64, kvh, row);
    }
  };
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, L::Q_BYTES);
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_load_3d(Qs + (g * L::PANELS + p) * TC_QPANEL, &tq, q_bar, p * 64,
                    h, b * Sq + q0 + 64 * g);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, kb_lo + s);
  }
  __syncwarp();

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
  const int qa = q0 + 64 * wg;                        // this warpgroup's rows
  const int row0 = qa + 16 * warp + lane / 4;         // and this thread's
  const uint8_t* Qw = Qs + wg * L::PANELS * TC_QPANEL;

  mbar_wait(q_bar, 0);
  __syncwarp();
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = (kb_lo + it) * BK;
    const bool skip = causal && (k0 > qa + 63 ||
                                 (window > 0 && k0 + BK - 1 <= qa - window));
    const bool masked = causal && (k0 + BK - 1 > qa ||
                                   (window > 0 && k0 <= qa + 63 - window));
    mbar_wait(&full[stage], parity);
    __syncwarp();
    if (!skip) {
      const uint8_t* Kt = Ks + stage * L::KV_BYTES;
      const uint8_t* Vt = Vs + stage * L::KV_BYTES;
      // S = Q K^T: hd / 16 steps of k16, 4 per 64-wide panel
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<BK>::ss(sc, sw128_desc(Qw + p * TC_QPANEL + kk * 32, 16, 1024),
                      sw128_desc(Kt + p * L::KV_PANEL + kk * 32, 16, 1024),
                      (p | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();

      // online softmax in the log2 domain
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[4 * i + e] * scale_log2;
          if (masked) {
            const int qpos = row0 + 8 * (e / 2);
            const int kpos = k0 + 8 * i + 2 * (lane % 4) + e % 2;
            if (kpos > qpos || (window > 0 && kpos <= qpos - window))
              s = FA_NEG_INF;
          }
          sc[4 * i + e] = s;
          mx[e / 2] = fmaxf(mx[e / 2], s);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = fast_exp2(sc[i] - m[(i % 4) / 2]);
        sc[i] = p;
        l[(i % 4) / 2] += p;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i % 4) / 2];
      // P (bf16) as the A operand: k-step kk takes S columns 16kk..16kk+15
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      // O += P V: V tile read MN-major, 16 keys (2 KB of a panel) per step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<HD>::rs(o, pa[kk],
                    sw128_desc(Vt + kk * 16 * 128, L::KV_PANEL, 1024));
      wgmma_commit();
      wgmma_wait_all();
    }
    mbar_arrive(&empty[stage]);
    if (tid == 0 && it + STAGES < n_tiles) {
      mbar_wait(&empty[stage], parity);   // every thread is done with it
      load_kv(stage, kb_lo + it + STAGES);
    }
    __syncwarp();
  }

  // out = O / max(l, 1e-30), rows row0 and row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const long long q_ld = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* orow = out + (static_cast<long long>(b) * Sq + row0 + 8 * r) * q_ld
                          + static_cast<long long>(h) * HD + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] * l[r], o[4 * i + 2 * r + 1] * l[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library need not link libcuda).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (hd, heads, rows) bf16 tensor at `ptr`, read in 64 x 1 x `box_rows`
// boxes with the 128-byte swizzle
static bool tile_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                     long long rows, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int H, int KV, int causal, int window,
                float scale, cudaStream_t st) {
  constexpr int BK = TcCfg<HD>::BK;
  if (Sq % TC_BQ || Sk % BK) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, HD, H, static_cast<long long>(B) * Sq, 64) ||
      !tile_map(&tk, k, HD, KV, static_cast<long long>(B) * Sk, BK) ||
      !tile_map(&tv, v, HD, KV, static_cast<long long>(B) * Sk, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = TcSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / TC_BQ, B * H);
  fa_bf16_kernel<HD><<<grid, TC_THREADS, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal,
      window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, int hd, int causal, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
#define FA_CASE(D)                                                           \
  case D:                                                                    \
    return BF16 ? launch_bf16<D>(q, k, v, out, B, Sq, Sk, H, KV, causal,     \
                                 window, scale, st)                          \
                : launch_f32<D>(q, k, v, out, B, Sq, Sk, H, KV, causal,      \
                                window, scale, st);
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// dtype (is_bf16: bfloat16 on the tensor cores, else float32 on the CUDA
// cores), contiguous, 16-byte aligned; Sq % 128 == 0, Sk % 128 == 0,
// H % KV == 0, hd in {64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int causal, int window, float scale,
                                      int is_bf16, int device, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<true>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal,
                                   window, scale, st)
                 : launch_hd<false>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                    causal, window, scale, st);
}
