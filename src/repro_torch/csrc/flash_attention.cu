// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, body _kernel): causal or not, GQA (kv head
// (bh % H) / G), q positions right-aligned by Sk - Sq, optional sliding
// window, optional softcap applied before the mask, online softmax with
// the finite -2**30 mask and an l == 0 guard.
//
// What bounds it here: at the serving slice's prefill shapes (B=8, H=16,
// Hkv=8, S=512, d=128) the work is ~8.6 GFLOP against ~50 MB of q/k/v/o,
// so on the card's tensor cores it would be bound by the bytes; this
// first kernel does its products with f32 FMAs instead, so it is bound by
// the FMA rate and by shared-memory traffic.  Design: one CTA of 256
// threads per (b*h, 64-row q tile); the TPU's sequential kv grid axis
// becomes a loop inside the CTA over kv tiles that stream through shared
// memory, with the loop bounded per q tile by the causal diagonal and the
// window (instead of issuing masked blocks and skipping them).  Each
// thread owns a 4 x (BK/16) patch of the logits and a 4 x (D/16) patch of
// the output accumulator in registers; rows are tr + 16*i and logit
// columns tc + 16*j so shared-memory reads are conflict-free.  Ragged
// Sq/Sk tails are zero-filled and masked, so no length need divide the
// tile.  Tensor-core (mma/wgmma) products are later work.
#include "common.cuh"

#include <math.h>

namespace repro {
namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kThreads = 256;  // 16 x 16 thread grid over the tile

template <int D> struct FlashTile;
template <> struct FlashTile<128> { static constexpr int BK = 32; };
template <> struct FlashTile<256> { static constexpr int BK = 16; };

template <int D>
constexpr size_t flash_smem_bytes() {
  constexpr int BK = FlashTile<D>::BK;
  return sizeof(float) * (size_t)(kBQ * (D + 4) + BK * (D + 4) + BK * D + kBQ * (BK + 4));
}

// Copy `rows` rows of a [*, D] T-matrix starting at row `r0` (of `n` valid
// rows) into an f32 shared tile with row stride `stride`; rows past `n`
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int rows, int n,
                                          float* dst, int stride) {
  constexpr int VN = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = D / VN;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VN;
    float tmp[VN];
    if (r0 + r < n) {
      load_row<T, VN>(src + (size_t)(r0 + r) * D + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(&dst[r * stride + c + e]) =
          make_float4(tmp[e], tmp[e + 1], tmp[e + 2], tmp[e + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int Hkv, int Sq, int Sk, int causal, int window,
                 float softcap, float scale) {
  constexpr int BK = FlashTile<D>::BK;
  constexpr int QS = D + 4;    // padded row stride of the Q and K tiles
  constexpr int PS = BK + 4;   // padded row stride of the P tile
  constexpr int JN = BK / 16;  // logit columns per thread
  constexpr int JD = D / 64;   // float4 output column groups per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;                    // [BK][QS]
  float* Vs = Ks + BK * QS;                     // [BK][D]
  float* Ps = Vs + BK * D;                      // [kBQ][PS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int G = H / Hkv;
  const int kvh = b * Hkv + (bh % H) / G;
  const int q0 = blockIdx.x * kBQ;
  const int off = Sk - Sq;  // right alignment of the q positions
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvh * Sk * D;
  const T* vb = v + (size_t)kvh * Sk * D;

  load_tile<T, D>(qb, q0, kBQ, Sq, Qs, QS);

  // kv range this q tile can see.  A causal tile holding a row at a
  // negative position (Sq > Sk) has fully masked rows, which average all
  // of V as the reference does, so it walks every key.
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + kBQ, Sq) - 1 + off;
  int k_begin = 0, k_end = Sk;
  if (!(causal && q_lo < 0)) {
    if (causal) k_end = min(Sk, q_hi + 1);
    if (window > 0) k_begin = max(0, q_lo - window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  float m[4], l[4], acc[4][4 * JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * JD; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kb, kt, BK, Sk, Ks, QS);
    load_tile<T, D>(vb, kt, BK, Sk, Vs, D);
    __syncthreads();

    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[4], kv[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(tr + 16 * i) * QS + dd]);
#pragma unroll
      for (int j = 0; j < JN; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tc + 16 * j) * QS + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int kpos = kt + tc + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = true;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && qpos < kpos + window;
        x = keep ? x : kNegInf;
        if (kpos >= Sk) x = -INFINITY;  // padding past the sequence: no key at all
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * JD; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < JN; ++j) Ps[(tr + 16 * i) * PS + tc + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(tr + 16 * i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jd = 0; jd < JD; ++jd) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[(c + cc) * D + tc * 4 + 64 * jd]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = f4get(pv[i], cc);
            acc[i][4 * jd + 0] = fmaf(p, vv.x, acc[i][4 * jd + 0]);
            acc[i][4 * jd + 1] = fmaf(p, vv.y, acc[i][4 * jd + 1]);
            acc[i][4 * jd + 2] = fmaf(p, vv.z, acc[i][4 * jd + 2]);
            acc[i][4 * jd + 3] = fmaf(p, vv.w, acc[i][4 * jd + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* dst = o + ((size_t)bh * Sq + row) * D + tc * 4;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd)
      store4(dst + 64 * jd, acc[i][4 * jd] / den, acc[i][4 * jd + 1] / den,
             acc[i][4 * jd + 2] / den, acc[i][4 * jd + 3] / den);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                         float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), H, Hkv,
                                           Sq, Sk, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int D, const void* q, const void* k, const void* v, void* o, int B,
                           int H, int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                           float scale, cudaStream_t stream) {
  switch (D) {
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q [B,H,Sq,D], k/v [B,Hkv,Sk,D], o [B,H,Sq,D], all contiguous, one dtype.
// window <= 0 means none; softcap <= 0 means none.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int H, int Hkv, int Sq, int Sk, int D, int dtype, int causal,
                                     int window, float softcap, float scale, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = dispatch_flash<float>(D, q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, softcap, scale, s);
  else if (dtype == kBFloat16)
    err = dispatch_flash<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, softcap,
                                        scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
