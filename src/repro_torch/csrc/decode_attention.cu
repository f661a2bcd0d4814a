// Flash-decode for Hopper (sm_90a): one query token per sequence against a
// heads-major KV cache, f32 or bf16 in, f32 math.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel, body _kernel): the G = H / Hkv query heads of a kv
// group share every cache row they stream, the cache is read in its
// storage dtype, and keys at or past kv_len are never read.  It also takes
// the model decode path's optional sliding window and softcap
// (src/repro/models/attention.py:197-200), so no dense layer needs a
// second path on the card.
//
// What bounds it here: each cache byte in [kv_begin, kv_len) is read
// once and the arithmetic is ~2*G flops per byte, so it is bound by
// memory bandwidth.  Design: B*Hkv alone fills few of the 132 SMs, so the
// key range is split across CTAs (flash-decoding): the partial kernel
// runs one CTA of 4 warps per (b, kv head, split); each warp streams its
// keys four rows at a time (each lane holding D/32 elements of a row, so
// a row is one coalesced read), keeps a per-warp online softmax for all G
// heads, and the CTA merges its warps into one partial (max, sum, acc)
// in f32 scratch.  The combine kernel merges the splits of each query
// head and writes the output in the query's dtype.
#include "common.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;  // cache rows in flight per warp

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int S, int kv_begin, int kv_len, int chunk,
                      int n_split, float softcap, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  const int bkv = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s0 = kv_begin + split * chunk;
  const int s1 = min(kv_len, s0 + chunk);

  // query rows b*H + kvh*G + g == bkv*G + g
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) load_row<T, E>(q + ((size_t)bkv * G + g) * D + lane * E, qr[g]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = k + (size_t)bkv * S * D + lane * E;
  const T* vb = v + (size_t)bkv * S * D + lane * E;
  for (int base = s0 + warp * kUnroll; base < s1; base += kWarps * kUnroll) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u < s1) {
        load_row<T, E>(kb + (size_t)(base + u) * D, kr[u]);
        load_row<T, E>(vb + (size_t)(base + u) * D, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u >= s1) break;  // warp-uniform
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kr[u][e], d);
        dot[g] = d;
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o2);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = dot[g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const float m_new = fmaxf(m[g], x);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(x - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e] * alpha);
      }
    }
  }

  // merge the warps of this CTA into one partial per query head
  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - M);  // 0 for a warp that saw no key
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    const size_t row = ((size_t)bkv * G + g) * n_split + split;
    part_acc[row * D + d] = A;
    if (d == 0) {
      part_ml[2 * row] = M;
      part_ml[2 * row + 1] = L;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ o, int D,
                                      int n_split) {
  const size_t row = blockIdx.x;  // b*H + h
  const float* ml = part_ml + row * n_split * 2;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(ml[2 * s] - M);
      L += ml[2 * s + 1] * f;
      A += part_acc[(row * n_split + s) * D + d] * f;
    }
    o[row * D + d] = from_float<T>(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o, float* part_acc,
                          float* part_ml, int B, int H, int Hkv, int S, int kv_begin, int kv_len,
                          int chunk, int n_split, float softcap, float scale,
                          cudaStream_t stream) {
  const dim3 grid(B * Hkv, n_split);
  decode_partial_kernel<T, D, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_acc,
      part_ml, S, kv_begin, kv_len, chunk, n_split, softcap, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, 128, 0, stream>>>(part_acc, part_ml, static_cast<T*>(o), D,
                                                      n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_groups(int G, const void* q, const void* k, const void* v, void* o,
                            float* pa, float* pml, int B, int H, int Hkv, int S, int kv_begin,
                            int kv_len, int chunk, int n_split, float softcap, float scale,
                            cudaStream_t st) {
  switch (G) {
    case 1:
      return launch_decode<T, D, 1>(q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk, n_split, softcap, scale, st);
    case 2:
      return launch_decode<T, D, 2>(q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk, n_split, softcap, scale, st);
    case 8:
      return launch_decode<T, D, 8>(q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk, n_split, softcap, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_decode(int D, int G, const void* q, const void* k, const void* v, void* o,
                            float* pa, float* pml, int B, int H, int Hkv, int S, int kv_begin,
                            int kv_len, int chunk, int n_split, float softcap, float scale,
                            cudaStream_t st) {
  switch (D) {
    case 128:
      return dispatch_groups<T, 128>(G, q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk, n_split, softcap, scale, st);
    case 256:
      return dispatch_groups<T, 256>(G, q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk, n_split, softcap, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q [B,H,D], k/v [B,Hkv,S,D] (heads-major cache), o [B,H,D], all contiguous,
// one dtype.  Keys [kv_begin, kv_len) are attended (kv_begin > 0 is the
// sliding window), cut into n_split chunks of `chunk` keys; part_acc
// [B*H, n_split, D] and part_ml [B*H, n_split, 2] are f32 scratch.
// softcap <= 0 means none.  Returns the CUDA error code (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* o,
                                      void* part_acc, void* part_ml, int B, int H, int Hkv, int S,
                                      int D, int dtype, int kv_begin, int kv_len, int chunk,
                                      int n_split, float softcap, float scale, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  const int G = H / Hkv;
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch_decode<float>(D, G, q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len, chunk,
                                 n_split, softcap, scale, st);
  else if (dtype == kBFloat16)
    err = dispatch_decode<__nv_bfloat16>(D, G, q, k, v, o, pa, pml, B, H, Hkv, S, kv_begin, kv_len,
                                         chunk, n_split, softcap, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
