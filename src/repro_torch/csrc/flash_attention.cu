// Causal (optionally banded) online-softmax attention, hand-written for
// Hopper.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (body `_kernel`): for each
// (batch, query head) and query position i,
//   s[j]  = (q[i] * scale) . k[j]            masked to -1e30 unless
//           j <= i and (window == 0 or j > i - window)   (when causal)
//   out[i] = sum_j softmax(s)[j] v[j]
// by the running max / sum / accumulator recurrence over key blocks, in
// f32, with the output acc / max(l, 1e-30) written in q's dtype. Key
// blocks that lie wholly above the diagonal or left of the band are
// skipped, as the TPU kernel's `relevant` test does.
//
// GQA/MQA: q is (B, Sq, H, hd) and k, v are (B, Sk, KV, hd) in the model's
// layout; query head h reads key/value head h / (H / KV) directly, so the
// K/V heads are never repeated in memory (the JAX wrapper repeats them).
//
// What bounds it on this card: operations. At recurrentgemma-9b's prefill
// (B 2, S 4096, 16 heads, hd 256, window 2048) the band holds ~6.3 M
// (query, key) pairs per head, 4 * hd flops each: ~206 GFLOP against
// ~0.15 GB of q, k, v and out. This first version runs f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not the tensor cores.
//
// Design: hd 256 makes a 128-query f32 accumulator (128 KB) too large for
// one block's registers, so a block takes BQ = 64 queries and BK = 64 keys
// at a time with 256 threads (16 x 16). Thread (ty, tx) owns query rows
// 4ty..4ty+3; in the score tile it owns key columns tx + 16b (b < 4), in
// the accumulator the 4-wide column groups tx + 16g (g < hd / 64), so
// each holds 4 * hd / 16 accumulators (64 at hd 256) in registers. Q (pre-
// scaled), K and V tiles are staged in shared memory as f32 with rows
// padded by 4 floats (conflict-free 16-byte reads); 217 KB at hd 256, one
// block per SM. Row max and row sum reduce over the 16 threads of a row
// with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;
constexpr float FA_NEG_INF = -1.0e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

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
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src,
                                      long long ld, float* dst, float mul) {
  constexpr int V = HD / 8;
  for (int e = threadIdx.x; e < FA_BQ * V; e += FA_THREADS) {
    const int row = e / V, c = (e % V) * 8;
    float x[8];
    load8(src + row * ld + c, x);
    float* d = dst + row * (HD + 4) + c;
    *reinterpret_cast<float4*>(d) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
    *reinterpret_cast<float4*>(d + 4) =
        make_float4(x[4] * mul, x[5] * mul, x[6] * mul, x[7] * mul);
  }
}

__device__ __forceinline__ void store4(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* x) {
  __nv_bfloat16 h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __float2bfloat16(x[e]);
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KV, int causal,
    int window, float scale) {
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
  const T* qb = q + (static_cast<long long>(b) * Sq + q0) * q_ld + h * HD;
  const T* kb = k + static_cast<long long>(b) * Sk * kv_ld + kvh * HD;
  const T* vb = v + static_cast<long long>(b) * Sk * kv_ld + kvh * HD;

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

  T* ob = out + (static_cast<long long>(b) * Sq + q0) * q_ld + h * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[a][4 * g + e] * inv;
      store4(ob + (4 * ty + a) * q_ld + (tx + 16 * g) * 4, x);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int window, float scale,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (FA_BQ * (HD + 4) + 2 * FA_BK * (HD + 4) +
                       FA_BQ * (FA_BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / FA_BQ, B * H);
  flash_attention_kernel<T, HD><<<grid, FA_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, int hd, int causal, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                            scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                            scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd), all of one
// dtype (is_bf16: bfloat16, else float32), contiguous, 16-byte aligned;
// Sq % 64 == 0 == Sk % 64, H % KV == 0, hd in {64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int KV, int hd,
                                      int causal, int window, float scale,
                                      int is_bf16, int device, void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Sq % FA_BQ || Sk % FA_BK || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV,
                                            hd, causal, window, scale, st)
                 : launch_hd<float>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                    causal, window, scale, st);
}
