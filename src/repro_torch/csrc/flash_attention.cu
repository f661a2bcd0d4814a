// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 with FMAs.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, body _kernel): causal or not, GQA (kv head
// (bh % H) / G), q positions right-aligned by Sk - Sq, optional sliding
// window, optional softcap applied before the mask, online softmax with
// the finite -2**30 mask and an l == 0 guard.
//
// What bounds it here: at the serving slice's prefill shapes (B=8, H=16,
// Hkv=8, S=512, d=128, bf16) the work is ~8.6 GFLOP against ~50 MB of
// q/k/v/o, so on the tensor cores it is bound by the bytes (~15 us).
//
// bf16 (flash_fwd_mma_kernel): one CTA of one warpgroup (4 warps) per
// (b*h, 64-row q tile), the tiles with the longest causal kv range issued
// first across all heads (the q tile is the grid's slow axis).  Q stays in bf16 in shared memory; K and V stream through a
// two-stage ring of bf16 tiles filled by cp.async, so tile t+1 loads while
// tile t is multiplied.  S = Q K^T runs as wgmma m64nBKk16 with both
// operands in shared memory (K-major) and O += P V as wgmma m64nDk16 with
// P in registers and V in shared memory (MN-major), f32 accumulators in
// registers.  S never leaves registers: each warp holds 16 rows of it, the
// online softmax works on those fragments with shuffles across the 4
// lanes that share a row, and they become P V's A operand once P is
// rounded to bf16.  Tiles are stored in the 128-byte swizzle that wgmma's
// descriptors name.  Masks are applied only on tiles that straddle the
// diagonal, the window edge or the end of the keys.  The two q heads of a
// GQA group each load their K/V tiles (the second load hits L2): a CTA of
// two warpgroups sharing the tiles would need ~150 registers for each of
// 256 threads, so one such CTA would fit on an SM where two of these fit.
//
// f32 (flash_fwd_kernel): the FMA body, kept so that f32 inputs are
// computed in full f32: one CTA of 256 threads per (b*h, 64-row q tile),
// each thread owning a 4 x (BK/16) patch of the logits and a 4 x (D/16)
// patch of the output; K and V widened to f32 in shared memory.
//
// Both bound the kv loop per q tile by the causal diagonal and the window
// (instead of issuing masked blocks and skipping them), and zero-fill and
// mask ragged Sq/Sk tails, so no length need divide a tile.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

#include <type_traits>

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

// The kv range [begin, end) that a q tile of rows [q0, q0 + BQ) can see,
// with begin rounded down to a multiple of BK.  A causal tile holding a
// row at a negative position (Sq > Sk) has fully masked rows, which
// average all of V as the reference does, so it walks every key.
template <int BQ, int BK>
__device__ __forceinline__ void kv_range(int q0, int Sq, int Sk, int causal, int window,
                                         int& begin, int& end) {
  const int off = Sk - Sq;
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, Sq) - 1 + off;
  begin = 0;
  end = Sk;
  if (!(causal && q_lo < 0)) {
    if (causal) end = min(Sk, q_hi + 1);
    if (window > 0) begin = max(0, q_lo - window + 1);
  }
  begin = (begin / BK) * BK;
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

  int k_begin, k_end;
  kv_range<kBQ, BK>(q0, Sq, Sk, causal, window, k_begin, k_end);

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

// ---------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------
constexpr int kMmaBQ = 64;         // q rows per CTA, 16 per warp
constexpr int kMmaThreads = 128;   // 4 warps

template <int D> struct FlashMma;
template <> struct FlashMma<128> { static constexpr int BK = 64; };
template <> struct FlashMma<256> { static constexpr int BK = 32; };

// Q [kMmaBQ][D], then two stages of K [BK][D] and two of V [BK][D], bf16
// in the sw128 layout, and 1 KB to align the first tile to 1024 bytes
template <int D>
constexpr size_t flash_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kMmaBQ * D + 4 * FlashMma<D>::BK * D) + 1024;
}

// S (+)= Q K^T over 16 of the head dim, for BK keys
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 8][4], uint64_t dq, uint64_t dk,
                                         int scale_d) {
  if constexpr (BK == 64) wgmma_m64n64k16_ss(s, dq, dk, scale_d);
  else wgmma_m64n32k16_ss(s, dq, dk, scale_d);
}
// O += P V over 16 keys, for D output columns
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4], const uint32_t (&p)[4],
                                         uint64_t dv) {
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, p, dv, 1);
  else wgmma_m64n256k16_rs(o, p, dv, 1);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                     float scale) {
  constexpr int BK = FlashMma<D>::BK;
  constexpr int NB = BK / 8;  // 8-key column blocks of the logits
  constexpr int ND = D / 8;   // 8-wide column blocks of the output
  using bf16 = __nv_bfloat16;

  extern __shared__ uint4 smem_u4[];
  char* raw = reinterpret_cast<char*>(smem_u4);
  raw += (1024 - (smem_addr(raw) & 1023)) & 1023;  // the 128-byte swizzle's atoms
  bf16* Qs = reinterpret_cast<bf16*>(raw);         // [kMmaBQ][D]
  bf16* Ks = Qs + kMmaBQ * D;                      // [2][BK][D]
  bf16* Vs = Ks + 2 * BK * D;                      // [2][BK][D]

  // the grid's slow axis walks the q tiles backwards, so that the tiles
  // with the longest causal kv ranges are issued first across all heads
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int G = H / Hkv;
  const int kvh = b * Hkv + (bh % H) / G;
  const int q0 = qt * kMmaBQ;
  const int off = Sk - Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)kvh * Sk * D;
  const bf16* vb = v + (size_t)kvh * Sk * D;

  int k_begin, k_end;
  kv_range<kMmaBQ, BK>(q0, Sq, Sk, causal, window, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_tile_sw128<kMmaBQ, D, kMmaThreads>(Qs, qb, D, q0, kMmaBQ, Sq);
  cp_async_commit();
  load_tile_sw128<BK, D, kMmaThreads>(Ks, kb, D, k_begin, BK, Sk);
  load_tile_sw128<BK, D, kMmaThreads>(Vs, vb, D, k_begin, BK, Sk);
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int qpos0 = q0 + warp * 16 + g + off;
  const int qpos1 = qpos0 + 8;
  const int q_hi = min(q0 + kMmaBQ, Sq) - 1 + off;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * BK;
    if (it + 1 < n_tiles) {  // the next tile loads while this one is multiplied
      const int st = (it + 1) & 1;
      load_tile_sw128<BK, D, kMmaThreads>(Ks + st * BK * D, kb, D, kt + BK, BK, Sk);
      load_tile_sw128<BK, D, kMmaThreads>(Vs + st * BK * D, vb, D, kt + BK, BK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the group just issued has landed
    fence_async_smem();
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * BK * D;
    const bf16* Vt = Vs + (it & 1) * BK * D;

    // S = Q K^T: both K-major; a 16-wide step of the head dim is 32 bytes
    // into the 128-byte rows of a 64-column block
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = (kk / 4) * 64, e = (kk % 4) * 16;
      wgmma_qk<BK>(s, wgmma_desc(Qs + c * kMmaBQ + e, 16, 1024),
                   wgmma_desc(Kt + c * BK + e, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, softcap, then the masks where this tile needs them
    const bool full = kt + BK <= Sk && (!causal || q0 + off >= kt + BK - 1) &&
                      (window <= 0 || q_hi < kt + window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (!full) {
          const int qpos = e < 2 ? qpos0 : qpos1;
          const int kpos = kt + j * 8 + 2 * t + (e & 1);
          bool keep = true;
          if (causal) keep = keep && qpos >= kpos;
          if (window > 0) keep = keep && qpos < kpos + window;
          x = keep ? x : kNegInf;
          if (kpos >= Sk) x = -INFINITY;  // padding past the sequence: no key at all
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];  // this lane's share of the row sum; summed over the quad at the end
    }
    // P, rounded to bf16: the logits' fragments of key blocks 2kk, 2kk+1
    // are the A fragment of P V's 16-key step kk
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(s[j][e] - m[e / 2]);
        l[e / 2] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0]; acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1]; acc[j][3] *= alpha[1];
    }

    // O += P V: V is MN-major (the head dim contiguous); a 16-key step is
    // 16 rows of 128 bytes, 64-column blocks lie BK rows apart
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk], wgmma_desc(Vt + kk * 16 * 64, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // this stage is refilled by the next iteration's loads
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    bf16* dst = o + ((size_t)bh * Sq + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------
// launch: bf16 on the tensor cores, f32 on the FMA body
// ---------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Sk, int causal, int window, float softcap,
                         float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t smem = flash_mma_smem_bytes<D>();
    auto kernel = flash_fwd_mma_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (Sq + kMmaBQ - 1) / kMmaBQ);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, Hkv, Sq, Sk, causal, window, softcap, scale);
  } else {
    const size_t smem = flash_smem_bytes<D>();
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, Hkv, Sq, Sk, causal, window, softcap, scale);
  }
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
