// RWKV6 WKV recurrence, hand-written for Hopper.
//
// Replaces the TPU kernel `wkv6` of src/repro/kernels/wkv6/kernel.py (body
// `_kernel`): for each of the B x H independent (batch, head) rows, with a
// zero initial (hd, hd) state S and per-chunk (CHUNK = 16 steps) quantities
//   Lc[t]  = sum_{s<=t} logw[s]            (inclusive, per key channel c)
//   rp[t]  = r[t] * exp(Lc[t] - logw[t])   kd[s] = k[s] * exp(-Lc[s])
//   out[t] = sum_{s<t} (rp[t].kd[s]) v[s] + (r[t].(u*k[t])) v[t] + rp[t] S
//   S      = diag(exp(Lc[C-1])) S + sum_s (k[s] * exp(Lc[C-1] - Lc[s])) v[s]^T
// the chunked factorization of repro.nn.rwkv._wkv_chunked. The clamp
// logw >= -5 (applied by the caller) keeps exp(-Lc) <= e^80 inside f32;
// the only factor spanning more than a chunk is exp(Lc[C-1]) <= 1. It also
// writes the final state, which the serving prefill caches.
//
// What bounds it on this card: memory traffic. It reads r, k, v, logw
// once and writes out once (5 * B * H * T * hd * 4 bytes, ~420 MB at the
// rwkv6-3b prefill shape) against ~2 hd^2 f32 FMAs per step and head
// (0.09 ms of f32 FMAs at that shape: close behind the bytes).
//
// Design: one block per (batch, head) walks the chunks in order; the
// per-head quantities (cumsum, decays, scores A) are computed once per
// chunk. Of the work of chunk c only the state update depends on the
// previous chunks, and it is a single fmaf per state entry once the
// chunk's increment is known. So the walk is a three-stage software
// pipeline with ONE barrier per step: step i
//   - prefetches chunk i+2 (cp.async, into rings of shared memory),
//   - builds chunk i's decays: the cumsum of logw over the 16 steps in the
//     reference's order (serially), 3 expf per element,
//   - builds chunk i-1's 16 x 16 scores A (diagonal = the u bonus),
//   - applies chunk i-2: out = A v + rp S and S = diag(D) S + ks^T v.
// The three are independent within a step, so their latencies overlap.
// What limits such a kernel is the shared-memory bandwidth (128 bytes a
// cycle per SM) that feeds its FMAs, so every product is register-tiled:
// thread (ct, dt) holds the 4 x 4 state tile S[c][d] (c = ct + hd/4 * a,
// d = 4 dt + b) in registers, computes its tile of ks^T v and its channels'
// part of rp S for all 16 steps (one float4 of rp per 16 FMAs), and the
// parts are summed over the hd/4 lanes of a d-tile by a reduce-scatter of
// warp shuffles; A is computed split over the channels the same way. Two
// blocks (106 KB of shared memory each at hd 64) share an SM, so the 160
// heads of the rwkv6-3b prefill are all resident at once; the 28 SMs that
// hold two of them set the kernel's time (one head per SM takes about 60%
// of it). Splitting a head over a cluster of two blocks balanced the SMs
// but cost a cluster barrier per step, about as much as it gained, so a
// block keeps its head whole. Plain f32 FMAs
// (no tensor cores, no TF32) and expf (not the fast approximation), for
// parity with the f32 reference. Operands are read through strides: the
// (B, T, H, hd) layout of the model, or (BH, T, hd) with H = 1, with T of
// any length (steps past T read as zeros: k = 0 and logw = 0 leave the
// state unchanged).
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int WKV_C = 16;   // CHUNK
constexpr int WKV_RK = 3;   // ring slots of r, k and logw (chunks i .. i+2)
constexpr int WKV_V = 5;    // ring slots of v (chunks i-2 .. i+2)
constexpr int WKV_D = 3;    // slots of rp, ks, dtot (chunks i-2 .. i)
constexpr int WKV_TS = 20;  // row stride of the [channel][step] arrays
                            // (16 + 4: conflict-free float4 columns)

template <int HD>
struct WkvCfg {
  static constexpr int NCT = HD / 4;        // channel tiles (lanes summed)
  static constexpr int NT = HD * HD / 16;   // threads: one 4 x 4 state tile
  static constexpr int TPT = 256 / HD;      // steps a thread's decays cover
  static constexpr int NS2 = NT / 16;       // channel slices of A
  static constexpr int TPL = WKV_C / NCT;   // steps a lane ends with in out
  static constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
};

template <int HD>
struct WkvSmem {
  float r[WKV_RK][WKV_C][HD];      // raw chunks, as read ([step][channel])
  float k[WKV_RK][WKV_C][HD];
  float w[WKV_RK][WKV_C][HD];
  float v[WKV_V][WKV_C][HD];
  float rpT[WKV_D][HD][WKV_TS];    // r * exp(Lc - logw), [channel][step]
  float kdT[2][HD][WKV_TS];        // k * exp(-Lc)
  float rukT[2][HD][WKV_TS];       // r * u * k
  float ks[WKV_D][WKV_C][HD];      // k * exp(Lc[C-1] - Lc), [step][channel]
  float dtot[WKV_D][HD];           // exp(Lc[C-1])
  float AT[2][WKV_C][WKV_TS];      // scores, [s][t]
  float u[HD];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(unsigned mask, const float4& v,
                                            int m) {
  return make_float4(__shfl_xor_sync(mask, v.x, m),
                     __shfl_xor_sync(mask, v.y, m),
                     __shfl_xor_sync(mask, v.z, m),
                     __shfl_xor_sync(mask, v.w, m));
}

// Sums p[0 .. 2N) over the 2M lanes whose index differs in the bits below
// 2M, by halves: at each level a lane keeps the half its bit M selects (the
// upper one if set) and adds its partner's copy of it. Lane l ends with
// entries (l mod 2M) * (2N / 2M) + j of the sum in p[j], j < 2N / 2M.
template <int M, int N, unsigned MASK, typename V>
__device__ __forceinline__ void reduce_scatter(V* p, int lane) {
  if constexpr (M >= 1) {
    const bool hi = (lane & M) != 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const V keep = hi ? p[j + N] : p[j];
      const V give = hi ? p[j] : p[j + N];
      if constexpr (sizeof(V) == sizeof(float4))
        p[j] = add4(keep, shfl_xor4(MASK, give, M));
      else
        p[j] = keep + __shfl_xor_sync(MASK, give, M);
    }
    reduce_scatter<M / 2, N / 2, MASK>(p, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(WkvCfg<HD>::NT, 2) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, float* __restrict__ out,
    float* __restrict__ state, int H, int T, long long sB, long long sT,
    long long sH, int uB) {
  using K = WkvCfg<HD>;
  constexpr int C = WKV_C, NT = K::NT, NCT = K::NCT, NS2 = K::NS2;
  extern __shared__ float4 wkv_dyn[];
  WkvSmem<HD>& sm = *reinterpret_cast<WkvSmem<HD>*>(wkv_dyn);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const long long base = b * sB + h * sH;
  const int n_chunks = (T + C - 1) / C;
  for (int c = tid; c < HD; c += NT) sm.u[c] = u[(b * uB + h) * HD + c];

  // ---- chunk j's r, k, logw, v into their ring slots, 16 bytes a piece;
  // steps past T are zero-filled
  auto prefetch = [&](int j) {
    for (int e = tid; e < C * HD / 4; e += NT) {
      const int t = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
      const int step = j * C + t;
      const bool in = step < T;
      const long long g = base + static_cast<long long>(in ? step : 0) * sT + c4;
      cp_async16(&sm.r[j % WKV_RK][t][c4], r + g, in);
      cp_async16(&sm.k[j % WKV_RK][t][c4], k + g, in);
      cp_async16(&sm.w[j % WKV_RK][t][c4], logw + g, in);
      cp_async16(&sm.v[j % WKV_V][t][c4], v + g, in);
    }
  };

  // state role: channel tile ct (channels ct + NCT * a), value tile dt
  // (columns 4 dt + b); the NCT lanes of one dt are adjacent
  const int ct = tid % NCT, dt = tid / NCT;
  float4 S[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) S[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  prefetch(0);
  cp_async_commit();
  if (1 < n_chunks) prefetch(1);
  cp_async_commit();
  for (int i = 0; i < n_chunks + 2; ++i) {
    cp_async_wait1();  // chunk i has landed (this thread's pieces)
    __syncthreads();   // ... everyone's; and step i-1 is complete
    if (i + 2 < n_chunks) prefetch(i + 2);
    cp_async_commit();  // (an empty group keeps the count)

    // ---- stage 1, chunk i: decays. Thread (c, tq) sums logw of channel c
    // serially from step 0 (the reference's order) and keeps steps
    // t = tq * TPT .. + TPT - 1.
    if (i < n_chunks) {
      const int ri = i % WKV_RK, di = i % WKV_D, ki = i % 2;
      const int c = tid % HD, t0 = (tid / HD) * K::TPT;
      float L[K::TPT], lw[K::TPT], Lt = 0.f;
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const float ws = sm.w[ri][s][c];
        Lt += ws;
#pragma unroll
        for (int j = 0; j < K::TPT; ++j) {
          if (s == t0 + j) {
            L[j] = Lt;
            lw[j] = ws;
          }
        }
      }
      const float uc = sm.u[c];
#pragma unroll
      for (int j4 = 0; j4 < K::TPT; j4 += 4) {
        float rp[4], kd[4], ru[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj, t = t0 + j;
          const float rv = sm.r[ri][t][c], kv = sm.k[ri][t][c];
          rp[jj] = rv * expf(L[j] - lw[j]);
          kd[jj] = kv * expf(-L[j]);
          ru[jj] = rv * uc * kv;
          sm.ks[di][t][c] = kv * expf(Lt - L[j]);
        }
        const int t = t0 + j4;
        *reinterpret_cast<float4*>(&sm.rpT[di][c][t]) =
            make_float4(rp[0], rp[1], rp[2], rp[3]);
        *reinterpret_cast<float4*>(&sm.kdT[ki][c][t]) =
            make_float4(kd[0], kd[1], kd[2], kd[3]);
        *reinterpret_cast<float4*>(&sm.rukT[ki][c][t]) =
            make_float4(ru[0], ru[1], ru[2], ru[3]);
      }
      if (t0 == 0) sm.dtot[di][c] = expf(Lt);
    }

    // ---- stage 2, chunk i-1: A[t][s] = rp[t].kd[s] below the diagonal,
    // sum_c r u k on it, 0 above. Thread (slice, tile): the 4 x 4 tile
    // (t0.., s0..) over channels slice + NS2 * a; summed over the NS2
    // adjacent lanes of a tile.
    if (i >= 1 && i <= n_chunks) {
      const int j = i - 1, di = j % WKV_D, ki = j % 2;
      const int slice = tid % NS2, tile = tid / NS2;
      const int t0 = (tile / 4) * 4, s0 = (tile % 4) * 4;
      float acc[16];  // acc[4 tt + e] = A[t0 + tt][s0 + e]
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll
      for (int a = 0; a < HD / NS2; ++a) {
        const int c = slice + NS2 * a;
        const float4 x = *reinterpret_cast<const float4*>(&sm.rpT[di][c][t0]);
        const float4 y = *reinterpret_cast<const float4*>(&sm.kdT[ki][c][s0]);
        const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * tt + e] = fmaf(xs[tt], ys[e], acc[4 * tt + e]);
      }
      if (t0 == s0) {  // the diagonal tile: the u bonus, zeros above
        float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int a = 0; a < HD / NS2; ++a) {
          const int c = slice + NS2 * a;
          dg = add4(dg, *reinterpret_cast<const float4*>(&sm.rukT[ki][c][t0]));
        }
        const float ds[4] = {dg.x, dg.y, dg.z, dg.w};
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * tt + e] = e < tt ? acc[4 * tt + e] : e == tt ? ds[tt] : 0.f;
      } else if (s0 > t0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      }
      // sum over the NS2 slices: lane `slice` ends with entries
      // slice * (16 / NS2) + jj of the tile
      reduce_scatter<NS2 / 2, 8, K::MASK>(acc, slice);
#pragma unroll
      for (int jj = 0; jj < 16 / NS2; ++jj) {
        const int f = slice * (16 / NS2) + jj;
        sm.AT[ki][s0 + f % 4][t0 + f / 4] = acc[jj];
      }
    }

    // ---- stage 3, chunk i-2: out = A v + rp S, then S = diag(D) S + ks^T v
    if (i >= 2) {
      const int j = i - 2, vi = j % WKV_V, di = j % WKV_D, ai = j % 2;
      // P[t] = this tile's part of rp[t] . S[:, 4dt..] (+ its share of A v)
      float4 P[C];
#pragma unroll
      for (int t = 0; t < C; ++t) P[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = ct + NCT * a;
#pragma unroll
        for (int t4 = 0; t4 < C; t4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&sm.rpT[di][c][t4]);
          fma4(P[t4], x.x, S[a]);
          fma4(P[t4 + 1], x.y, S[a]);
          fma4(P[t4 + 2], x.z, S[a]);
          fma4(P[t4 + 3], x.w, S[a]);
        }
      }
#pragma unroll
      for (int m = 0; m < C / NCT; ++m) {  // A[t][s] v[s], s = ct + NCT m
        const int s = ct + NCT * m;
        const float4 vs = *reinterpret_cast<const float4*>(&sm.v[vi][s][4 * dt]);
#pragma unroll
        for (int t4 = 0; t4 < C; t4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&sm.AT[ai][s][t4]);
          fma4(P[t4], x.x, vs);
          fma4(P[t4 + 1], x.y, vs);
          fma4(P[t4 + 2], x.z, vs);
          fma4(P[t4 + 3], x.w, vs);
        }
      }
      reduce_scatter<NCT / 2, C / 2, K::MASK>(P, ct);
#pragma unroll
      for (int jj = 0; jj < K::TPL; ++jj) {
        const int step = j * C + ct * K::TPL + jj;
        if (step < T)
          *reinterpret_cast<float4*>(
              &out[base + static_cast<long long>(step) * sT + 4 * dt]) = P[jj];
      }
      // S[c][d] = S[c][d] * D[c] + sum_s ks[s][c] v[s][d]
      float4 inc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) inc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < C; ++s) {
        const float4 vs = *reinterpret_cast<const float4*>(&sm.v[vi][s][4 * dt]);
#pragma unroll
        for (int a = 0; a < 4; ++a) fma4(inc[a], sm.ks[di][s][ct + NCT * a], vs);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float dc = sm.dtot[di][ct + NCT * a];
        S[a].x = fmaf(S[a].x, dc, inc[a].x);
        S[a].y = fmaf(S[a].y, dc, inc[a].y);
        S[a].z = fmaf(S[a].z, dc, inc[a].z);
        S[a].w = fmaf(S[a].w, dc, inc[a].w);
      }
    }
  }
  // final state, state[bh][c][d]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = ct + NCT * a;
    *reinterpret_cast<float4*>(
        &state[(static_cast<long long>(bh) * HD + c) * HD + 4 * dt]) = S[a];
  }
}

template <int HD>
int launch_wkv6(const float* r, const float* k, const float* v,
                const float* lw, const float* u, float* out, float* state,
                int B, int H, int T, long long sB, long long sT, long long sH,
                int uB, cudaStream_t st) {
  constexpr size_t smem = sizeof(WkvSmem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<HD><<<B * H, WkvCfg<HD>::NT, smem, st>>>(
      r, k, v, lw, u, out, state, H, T, sB, sT, sH, uB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// r, k, v, logw and out: element (b, t, h, c) at b * sB + t * sT + h * sH
// + c (floats), 16-byte aligned rows; u row (b * uB + h), hd floats; state
// (B * H, hd, hd) f32 written. Any T >= 0; hd in {16, 32, 64}. Launches on
// `stream` without synchronising; returns the CUDA error code.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, void* out,
                           void* state, int B, int H, int T, int hd,
                           long long sB, long long sT, long long sH, int uB,
                           int device, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * H == 0) return 0;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  auto* of = static_cast<float*>(out);
  auto* sf = static_cast<float*>(state);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_wkv6<16>(rf, kf, vf, lf, uf, of, sf, B, H, T, sB, sT, sH,
                             uB, st);
    case 32:
      return launch_wkv6<32>(rf, kf, vf, lf, uf, of, sf, B, H, T, sB, sT, sH,
                             uB, st);
    case 64:
      return launch_wkv6<64>(rf, kf, vf, lf, uf, of, sf, B, H, T, sB, sT, sH,
                             uB, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
