// RWKV6 WKV recurrence, hand-written for Hopper.
//
// Replaces the TPU kernel `wkv6` of src/repro/kernels/wkv6/kernel.py (body
// `_kernel`): for each of BH independent (batch, head) rows, with a zero
// initial (hd, hd) state S and per-chunk (CHUNK = 16 steps) quantities
//   Lc[t]  = sum_{s<=t} logw[s]            (inclusive, per key channel c)
//   rp[t]  = r[t] * exp(Lc[t] - logw[t])   kd[s] = k[s] * exp(-Lc[s])
//   out[t] = sum_{s<t} (rp[t].kd[s]) v[s] + (r[t].(u*k[t])) v[t] + rp[t] S
//   S      = diag(exp(Lc[C-1])) S + sum_s (k[s] * exp(Lc[C-1] - Lc[s])) v[s]^T
// the chunked factorization of repro.nn.rwkv._wkv_chunked. The clamp
// logw >= -5 (applied by the caller) keeps exp(-Lc) <= e^80 inside f32.
// It also writes the final state, which the serving prefill caches.
//
// What bounds it on this card: memory traffic. It reads r, k, v, logw
// once and writes out once (5 * BH * T * hd * 4 bytes, ~420 MB at the
// rwkv6-3b prefill shape) against ~16 flops per element, below the card's
// ratio of flops to bytes.
//
// Design: the TPU kernel carries S in VMEM across an in-order grid axis;
// CUDA blocks run in no order, so one block walks all chunks of its row in
// a loop and keeps S in shared memory. The recurrence is independent per
// value column d (out[:, d] and S[:, d] need only column d), so each block
// owns DV = 16 value columns of one row: BH * hd / 16 blocks (640 at
// BH = 160, hd = 64) fill the 132 SMs where one block per row would not.
// Each block recomputes the chunk's (C, C) score matrix A for its slice.
// 256 threads = C (time step t) x DV (value column d); plain f32 FMAs
// (no tensor cores), expf (not the fast approximation) for parity with
// the f32 reference.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int WKV_C = 16;    // CHUNK
constexpr int WKV_DV = 16;   // value columns per block
constexpr int WKV_THREADS = WKV_C * WKV_DV;

template <int HD>
__global__ void __launch_bounds__(WKV_THREADS) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, float* __restrict__ out,
    float* __restrict__ state, int T) {
  constexpr int C = WKV_C, DV = WKV_DV, NSL = HD / DV;
  __shared__ float rs[C][HD];        // r
  __shared__ float kr[C][HD];        // k
  __shared__ float ru[C][HD];        // r * u
  __shared__ float Lc[C][HD];        // logw, then its inclusive cumsum
  __shared__ float rp[C][HD + 1];    // r * exp(Lc - logw)
  __shared__ float kd[C][HD + 1];    // k * exp(-Lc)
  __shared__ float ks[C][HD + 1];    // k * exp(Lc[C-1] - Lc)
  __shared__ float vs[C][DV];        // this block's value columns
  __shared__ float A[C][C + 1];      // scores, diagonal = bonus term
  __shared__ float S[HD][DV];        // state slice S[:, d0:d0+DV]
  __shared__ float Dtot[HD];         // exp(Lc[C-1])

  const int bh = blockIdx.x / NSL;
  const int d0 = (blockIdx.x % NSL) * DV;
  const int tid = threadIdx.x;
  const int ty = tid / DV, tx = tid % DV;
  const long long row0 = static_cast<long long>(bh) * T;
  const float uc = tid < HD ? u[static_cast<long long>(bh) * HD + tid] : 0.f;

  for (int c = ty; c < HD; c += C) S[c][tx] = 0.f;

  for (int c0 = 0; c0 < T; c0 += C) {
    // 1. stage the chunk
    for (int e = tid; e < C * HD; e += WKV_THREADS) {
      const int t = e / HD, c = e % HD;
      const long long i = (row0 + c0 + t) * HD + c;
      rs[t][c] = r[i];
      kr[t][c] = k[i];
      Lc[t][c] = logw[i];
    }
    vs[ty][tx] = v[(row0 + c0 + ty) * HD + d0 + tx];
    __syncthreads();
    // 2. per key channel: cumulative log decay and the decayed r / k
    if (tid < HD) {
      const int c = tid;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Lc[t][c];
        acc += lw;
        Lc[t][c] = acc;
        rp[t][c] = rs[t][c] * expf(acc - lw);
        kd[t][c] = kr[t][c] * expf(-acc);
        ru[t][c] = rs[t][c] * uc;
      }
      Dtot[c] = expf(acc);
      for (int t = 0; t < C; ++t) ks[t][c] = kr[t][c] * expf(acc - Lc[t][c]);
    }
    __syncthreads();
    // 3. A[t][s] = rp[t].kd[s] below the diagonal, (r*u)[t].k[t] on it
    {
      const int t = ty, s = tx;
      float a = 0.f;
      if (s < t) {
#pragma unroll 16
        for (int c = 0; c < HD; ++c) a = fmaf(rp[t][c], kd[s][c], a);
      } else if (s == t) {
#pragma unroll 16
        for (int c = 0; c < HD; ++c) a = fmaf(ru[t][c], kr[t][c], a);
      }
      A[t][s] = a;
    }
    __syncthreads();
    // 4. out[t][d] = sum_{s<=t} A[t][s] v[s][d] + rp[t] . S[:, d]
    {
      const int t = ty, d = tx;
      float o = 0.f;
      for (int s = 0; s <= t; ++s) o = fmaf(A[t][s], vs[s][d], o);
      float o2 = 0.f;
#pragma unroll 16
      for (int c = 0; c < HD; ++c) o2 = fmaf(rp[t][c], S[c][d], o2);
      out[(row0 + c0 + t) * HD + d0 + d] = o + o2;
    }
    __syncthreads();
    // 5. S[c][d] = S[c][d] * Dtot[c] + sum_s ks[s][c] v[s][d]
    for (int c = ty; c < HD; c += C) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < C; ++s) acc = fmaf(ks[s][c], vs[s][tx], acc);
      S[c][tx] = fmaf(S[c][tx], Dtot[c], acc);
    }
    __syncthreads();
  }
  for (int c = ty; c < HD; c += C)
    state[(static_cast<long long>(bh) * HD + c) * HD + d0 + tx] = S[c][tx];
}

}  // namespace repro_torch

// r, k, v, logw (BH, T, hd) f32 with T % 16 == 0; u (BH, hd) f32.
// Outputs: out (BH, T, hd) f32, state (BH, hd, hd) f32. hd in {16, 32, 64}.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, void* out,
                           void* state, int BH, int T, int hd, int device,
                           void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T % WKV_C != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return 0;
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lf = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  auto* of = static_cast<float*>(out);
  auto* sf = static_cast<float*>(state);
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = BH * (hd / WKV_DV);
  switch (hd) {
    case 16:
      wkv6_kernel<16><<<blocks, WKV_THREADS, 0, st>>>(rf, kf, vf, lf, uf, of,
                                                      sf, T);
      break;
    case 32:
      wkv6_kernel<32><<<blocks, WKV_THREADS, 0, st>>>(rf, kf, vf, lf, uf, of,
                                                      sf, T);
      break;
    case 64:
      wkv6_kernel<64><<<blocks, WKV_THREADS, 0, st>>>(rf, kf, vf, lf, uf, of,
                                                      sf, T);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
