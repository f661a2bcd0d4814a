// Mamba2 SSD chunked scan for Hopper (sm_90a): bf16 inputs on the tensor
// cores, f32 inputs with FMAs; f32 math and an f32 state in both.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU kernel,
// body _kernel).  Per chunk of `chunk` time steps, for one sequence b and
// one head h (dA = dt * A, cs its inclusive cumsum over the chunk, X = x*dt):
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) X_j     intra-chunk
//         + exp(cs_i) C_i . S^T                               inter-chunk
//   S     = exp(cs_end) S + sum_j exp(cs_end - cs_j) X_j B_j^T  state carry
// with the f32 state S [P, N] starting at zero.  Unlike the TPU kernel it
// also writes the final state (prefill hands it to decode) and writes y in
// the caller's out dtype (the model adds D*x in f32 before one cast).
//
// What bounds it here: at the serving slice's shape (B=8, L=512, H=80,
// P=64, N=128, bf16 in, f32 out) it must move ~150 MB (x, dt, B, C in; y
// and the state out) against ~27 GFLOP, so on the tensor cores it is bound
// by the bytes (~45 us at 3.35 TB/s).
//
// bf16 (ssd_cb_kernel, then ssd_scan_mma_kernel): Bm and Cm are shared by
// all heads of a sequence, so G = C B^T is computed once per (b, chunk) by
// a first kernel, on the tensor cores from the exact bf16 operands, into an
// f32 scratch [B, n_chunks, chunk, chunk] that the wrapper allocates (only
// the 64 x 64 blocks on and below the diagonal are written or read).  The
// scan then runs one CTA of 4 warps per (b, h), looping over its chunks.
// Each of its three other products keeps the exact bf16 tensor on one side
// and folds dt and the decays into the f32 side, which is split into a
// bf16 high part and the bf16 rounding of the rest (about 16 bits of
// mantissa), so each costs two mma.sync.m16n8k16 with f32 accumulators:
//   (G . exp(cs_i - cs_j) . dt_j) X       the f32 side built in registers
//                                         from G, the exact side x;
//   C S^T                                 S split into bf16 hi/lo tiles in
//                                         shared memory once per chunk;
//   (x . dt_j exp(cs_end - cs_j))^T B     the state update, accumulated in
//                                         f32 registers that carry S.
// x is read in place from [B, L, H, P] at stride H*P per step, once per
// chunk, and stays in shared memory as bf16; the 64-row C sub-tiles and
// then the B sub-tiles of the chunk stream through a two-stage ring
// filled by cp.async, so the next sub-tile loads while the current one is
// multiplied.  At chunk 128 a CTA takes ~82 KB of shared memory, so two
// fit on an SM.
//
// f32 (ssd_scan_kernel): the FMA body, kept so that f32 inputs are
// computed in full f32.  One CTA of 256 threads per (b, h) loops over its
// chunks and keeps the state (transposed, [N][P]) in shared memory; each
// chunk is walked in 64-row sub-tiles: for every query sub-tile, the C
// tile stays while the B and X tiles of the key sub-tiles at or before it
// stream through, as in flash attention.
//
// In both, the decay exp(cs_i - cs_j) is computed only where i >= j (above
// the diagonal it overflows, and a mask applied as a product would turn
// inf * 0 into NaN), and steps at or past L are read as dt = 0,
// x = B = C = 0: they neither decay nor add to the state and write no y,
// so L need not divide the chunk.
#include "common.cuh"
#include "mma.cuh"

#include <math.h>

#include <type_traits>

namespace repro {
namespace {

constexpr int kBT = 64;        // rows of a sub-tile of a chunk
constexpr int kThreads = 256;  // a 16 x 16 thread grid over a 64 x 64 tile

// Shared-memory layout, in floats.  Row strides are padded by 4 so that
// the 16-byte reads of a quarter warp fall on distinct banks.
template <int P, int N>
struct SsdSmem {
  static constexpr int NS = N + 4;    // C and B tiles: [kBT][NS]
  static constexpr int PS = P + 4;    // X tile [kBT][PS], state^T [N][PS]
  static constexpr int AS = kBT + 4;  // masked C B^T tile [kBT][AS]
  static constexpr int kC = 0;
  static constexpr int kB = kC + kBT * NS;
  static constexpr int kX = kB + kBT * NS;
  static constexpr int kAtt = kX + kBT * PS;
  static constexpr int kS = kAtt + kBT * AS;
  static constexpr int kCs = kS + N * PS;  // then `chunk` floats of cs
};

template <int P, int N>
size_t ssd_smem_bytes(int chunk) {
  return sizeof(float) * ((size_t)SsdSmem<P, N>::kCs + chunk);
}

// Rows t0 .. t0+kBT-1 of a [*, N] matrix of T whose rows lie `row_stride`
// elements apart, into an f32 tile with row stride `stride`.  Rows at or
// past L are zero.
template <typename T, int W>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, size_t row_stride, int t0,
                                          int L, float* dst, int stride) {
  constexpr int VN = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = W / VN;
  for (int i = threadIdx.x; i < kBT * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VN;
    float tmp[VN];
    if (t0 + r < L) {
      load_row<T, VN>(src + (size_t)(t0 + r) * row_stride + c, tmp);
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

// Scale row r of the X tile (loaded from x) by dt of its step and, for the
// state update, by exp(cs_end - cs_r).  Rows at or past L are already zero.
template <int P>
__device__ __forceinline__ void scale_x(float* Xs, const float* __restrict__ dt, size_t dt_stride,
                                        int t0, int L, const float* cs, int r0, bool to_end,
                                        float cs_end) {
  constexpr int PS = P + 4;
  for (int i = threadIdx.x; i < kBT * (P / 4); i += kThreads) {
    const int r = i / (P / 4);
    const int c = (i % (P / 4)) * 4;
    if (t0 + r >= L) continue;
    float s = dt[(size_t)(t0 + r) * dt_stride];
    if (to_end) s *= expf(cs_end - cs[r0 + r]);
    float4* p = reinterpret_cast<float4*>(&Xs[r * PS + c]);
    float4 v = *p;
    v.x *= s; v.y *= s; v.z *= s; v.w *= s;
    *p = v;
  }
}

template <typename T, typename O, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm, O* __restrict__ y,
                float* __restrict__ state_out, int L, int H, int chunk) {
  using S = SsdSmem<P, N>;
  static_assert(P == 64, "the 16 x 16 thread grid gives each thread 4 of 64 columns");
  static_assert(N % 16 == 0, "state rows are split 16 ways");
  constexpr int NS = S::NS, PS = S::PS, AS = S::AS;
  constexpr int NA = N / 16;  // state rows per thread

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Cs = smem + S::kC;
  float* Bs = smem + S::kB;
  float* Xs = smem + S::kX;
  float* Att = smem + S::kAtt;
  float* St = smem + S::kS;   // state transposed: St[n * PS + p] = S[p][n]
  float* cs = smem + S::kCs;  // cumsum of dA over the current chunk

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float a = A[h];

  const size_t xrow = (size_t)H * P;  // elements between time steps of x and y
  const T* xb = x + (size_t)b * L * xrow + (size_t)h * P;
  const float* dtb = dt + (size_t)b * L * H + h;
  const T* Bb = Bm + (size_t)b * L * N;
  const T* Cb = Cm + (size_t)b * L * N;
  O* yb = y + (size_t)b * L * xrow + (size_t)h * P;

  for (int i = tid; i < N * PS; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < L; c0 += chunk) {
    // inclusive cumsum of dA over the chunk, in f32, by one warp
    if (warp == 0) {
      float carry = 0.f;
      for (int k0 = 0; k0 < chunk; k0 += 32) {
        const int t = c0 + k0 + lane;
        float v = t < L ? dtb[(size_t)t * H] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        cs[k0 + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const int nsub = chunk / kBT;

    // ---- y over each query sub-tile of the chunk ----
    for (int qi = 0; qi < nsub; ++qi) {
      const int q0 = c0 + qi * kBT;
      if (q0 >= L) break;  // uniform across the CTA
      load_rows<T, N>(Cb, N, q0, L, Cs, NS);
      __syncthreads();

      // inter-chunk: acc[i][e] = exp(cs_row) * sum_n C[row][n] S[4tc+e][n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(&Cs[(tr + 16 * i) * NS + n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = *reinterpret_cast<const float4*>(&St[(n + k) * PS + 4 * tc]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float c = f4get(cv[i], k);
            acc[i][0] = fmaf(c, sv[k].x, acc[i][0]);
            acc[i][1] = fmaf(c, sv[k].y, acc[i][1]);
            acc[i][2] = fmaf(c, sv[k].z, acc[i][2]);
            acc[i][3] = fmaf(c, sv[k].w, acc[i][3]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = expf(cs[qi * kBT + tr + 16 * i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= d;
      }

      // intra-chunk: key sub-tiles at or before the query sub-tile
      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = c0 + kj * kBT;
        load_rows<T, N>(Bb, N, k0, L, Bs, NS);
        load_rows<T, P>(xb, xrow, k0, L, Xs, PS);
        __syncthreads();
        scale_x<P>(Xs, dtb, H, k0, L, cs, kj * kBT, false, 0.f);

        // Att[i][j] = (C_i . B_j) exp(cs_i - cs_j) where i >= j, else 0;
        // thread (tr, tc) owns rows tr + 16*ii and columns tc + 16*jj
        float at[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) at[ii][jj] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cv[ii] = *reinterpret_cast<const float4*>(&Cs[(tr + 16 * ii) * NS + n]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = *reinterpret_cast<const float4*>(&Bs[(tc + 16 * jj) * NS + n]);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float s = at[ii][jj];
              s = fmaf(cv[ii].x, bv[jj].x, s);
              s = fmaf(cv[ii].y, bv[jj].y, s);
              s = fmaf(cv[ii].z, bv[jj].z, s);
              s = fmaf(cv[ii].w, bv[jj].w, s);
              at[ii][jj] = s;
            }
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int qr = qi * kBT + tr + 16 * ii;  // rows within the chunk
            const int kr = kj * kBT + tc + 16 * jj;
            Att[(tr + 16 * ii) * AS + tc + 16 * jj] =
                qr >= kr ? at[ii][jj] * expf(cs[qr] - cs[kr]) : 0.f;
          }
        __syncthreads();

        // acc[i][e] += sum_j Att[row][j] X[j][4tc+e]
#pragma unroll 2
        for (int j = 0; j < kBT; j += 4) {
          float4 av[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&Att[(tr + 16 * i) * AS + j]);
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = *reinterpret_cast<const float4*>(&Xs[(j + k) * PS + 4 * tc]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float p = f4get(av[i], k);
              acc[i][0] = fmaf(p, xv[k].x, acc[i][0]);
              acc[i][1] = fmaf(p, xv[k].y, acc[i][1]);
              acc[i][2] = fmaf(p, xv[k].z, acc[i][2]);
              acc[i][3] = fmaf(p, xv[k].w, acc[i][3]);
            }
        }
        __syncthreads();  // before the next tiles overwrite B, X and Att
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q0 + tr + 16 * i;
        if (t < L) store4(yb + (size_t)t * xrow + 4 * tc, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }

    // ---- state carry: S = exp(cs_end) S + sum_j exp(cs_end - cs_j) X_j B_j^T ----
    // thread (tr, tc) owns state rows n = tr + 16*r, columns p = 4tc .. 4tc+3
    const float cs_end = cs[chunk - 1];  // steps past L add 0 to the cumsum
    const float d_end = expf(cs_end);
    float st[NA][4];
#pragma unroll
    for (int r = 0; r < NA; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(&St[(tr + 16 * r) * PS + 4 * tc]);
      st[r][0] = v.x * d_end; st[r][1] = v.y * d_end; st[r][2] = v.z * d_end; st[r][3] = v.w * d_end;
    }
    for (int kj = 0; kj < nsub; ++kj) {
      const int k0 = c0 + kj * kBT;
      if (k0 >= L) break;
      load_rows<T, N>(Bb, N, k0, L, Bs, NS);
      load_rows<T, P>(xb, xrow, k0, L, Xs, PS);
      __syncthreads();
      scale_x<P>(Xs, dtb, H, k0, L, cs, kj * kBT, true, cs_end);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBT; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * PS + 4 * tc]);
#pragma unroll
        for (int r = 0; r < NA; ++r) {
          const float bv = Bs[j * NS + tr + 16 * r];
          st[r][0] = fmaf(bv, xv.x, st[r][0]);
          st[r][1] = fmaf(bv, xv.y, st[r][1]);
          st[r][2] = fmaf(bv, xv.z, st[r][2]);
          st[r][3] = fmaf(bv, xv.w, st[r][3]);
        }
      }
      __syncthreads();  // before the next tiles overwrite B and X
    }
#pragma unroll
    for (int r = 0; r < NA; ++r)
      *reinterpret_cast<float4*>(&St[(tr + 16 * r) * PS + 4 * tc]) =
          make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    __syncthreads();
  }

  // the final state, [B, H, P, N] f32
  float* so = state_out + (size_t)bh * P * N;
  for (int i = tid; i < P * N; i += kThreads) so[i] = St[(i % N) * PS + i / N];
}

// ---------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of a 64-row sub-tile each
using bf16 = __nv_bfloat16;

// The lower-triangular 64 x 64 blocks (qi, kj), kj <= qi, of one chunk are
// numbered qi * (qi + 1) / 2 + kj.
__device__ __forceinline__ void block_pair(int p, int& qi, int& kj) {
  qi = 0;
  while ((qi + 1) * (qi + 2) / 2 <= p) ++qi;
  kj = p - qi * (qi + 1) / 2;
}

// G[b, c, i, j] = C_i . B_j over the 64 x 64 block (qi, kj) of chunk c, in
// f32 from the bf16 operands; grid (blocks per chunk, n_chunks, B).
template <int N>
__global__ void __launch_bounds__(kMmaThreads)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb,
              int L, int chunk) {
  __shared__ __align__(16) bf16 Cs[kBT * N];
  __shared__ __align__(16) bf16 Bs[kBT * N];
  int qi, kj;
  block_pair(blockIdx.x, qi, kj);
  const int c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  load_tile_sw128<kBT, N, kMmaThreads>(Cs, Cm + (size_t)b * L * N, N, c0 + qi * kBT, kBT, L);
  load_tile_sw128<kBT, N, kMmaThreads>(Bs, Bm + (size_t)b * L * N, N, c0 + kj * kBT, kBT, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[kBT / 8][4];
#pragma unroll
  for (int j = 0; j < kBT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Cs + sw128<kBT>(warp * 16 + lane % 16, ks * 16 + (lane / 16) * 8));
#pragma unroll
    for (int j = 0; j < kBT / 8; j += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, Bs + sw128<kBT>(j * 8 + lane % 8 + (lane / 16) * 8,
                                  ks * 16 + ((lane / 8) % 2) * 8));
      mma_bf16(acc[j], a, bb[0], bb[1]);
      mma_bf16(acc[j + 1], a, bb[2], bb[3]);
    }
  }
  const int n_chunks = gridDim.y;
  float* dst = cb + ((size_t)b * n_chunks + c) * chunk * chunk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qi * kBT + warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j)
      *reinterpret_cast<float2*>(dst + (size_t)i * chunk + kj * kBT + j * 8 + 2 * t) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// Shared memory of the scan, in bytes: x of the chunk [chunk][P] bf16, a
// two-stage ring of 64-row sub-tiles [kBT][N] bf16 (C, then B), the state
// split into bf16 high and low parts [P][N] each, then cs, dt and the
// state-update weights of the chunk in f32.
template <int P, int N>
struct SsdMmaSmem {
  __host__ __device__ static size_t ring(int chunk) { return sizeof(bf16) * (size_t)chunk * P; }
  __host__ __device__ static size_t s_hi(int chunk) {
    return ring(chunk) + sizeof(bf16) * 2 * kBT * N;
  }
  __host__ __device__ static size_t s_lo(int chunk) { return s_hi(chunk) + sizeof(bf16) * P * N; }
  __host__ __device__ static size_t cs(int chunk) { return s_lo(chunk) + sizeof(bf16) * P * N; }
  __host__ __device__ static size_t bytes(int chunk) {
    return cs(chunk) + 3 * sizeof(float) * (size_t)chunk;
  }
};

template <typename O, int P, int N>
__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ cb,
                    O* __restrict__ y, float* __restrict__ state_out, int L, int H, int chunk) {
  using S = SsdMmaSmem<P, N>;
  static_assert(P == 4 * 16, "each of the 4 warps owns 16 of the state's P rows");
  constexpr int NP = P / 8;  // 8-wide column blocks of y
  constexpr int NN = N / 8;  // 8-wide column blocks of the state

  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [chunk][P], from offset 0
  bf16* ring = reinterpret_cast<bf16*>(smem + S::ring(chunk));
  bf16* s_hi = reinterpret_cast<bf16*>(smem + S::s_hi(chunk));
  bf16* s_lo = reinterpret_cast<bf16*>(smem + S::s_lo(chunk));
  float* cs = reinterpret_cast<float*>(smem + S::cs(chunk));  // cumsum of dA over the chunk
  float* dts = cs + chunk;                                     // dt, 0 past L
  float* ws = dts + chunk;                                     // dt_j exp(cs_end - cs_j)

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float a = A[h];
  const int nsub = chunk / kBT;
  const int n_chunks = (L + chunk - 1) / chunk;

  const size_t xrow = (size_t)H * P;  // elements between time steps of x and y
  const bf16* xb = x + (size_t)b * L * xrow + (size_t)h * P;
  const float* dtb = dt + (size_t)b * L * H + h;
  const bf16* Bb = Bm + (size_t)b * L * N;
  const bf16* Cb = Cm + (size_t)b * L * N;
  O* yb = y + (size_t)b * L * xrow + (size_t)h * P;

  // the state, as the f32 accumulators of its update: this thread holds
  // rows p = 16 warp + g (+ 8) and columns n = 8 j + 2t (+ 1)
  float st[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk;
    const int nq = min(nsub, (L - c0 + kBT - 1) / kBT);  // sub-tiles holding a step < L
    const float* G = cb + ((size_t)b * n_chunks + c) * chunk * chunk;

    // x of the chunk, and the first C sub-tile
    load_tile_sw128<kBT, P, kMmaThreads>(xs, xb, xrow, c0, nq * kBT, L);
    load_tile_sw128<kBT, N, kMmaThreads>(ring, Cb, N, c0, kBT, L);
    cp_async_commit();

    // inclusive cumsum of dA over the chunk, in f32, by one warp; the dt
    // of 128 steps are loaded together before they are summed in order
    if (warp == 0) {
      float carry = 0.f;
      for (int k0 = 0; k0 < chunk; k0 += 128) {
        float d[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tt = c0 + k0 + 32 * r + lane;
          d[r] = k0 + 32 * r < chunk && tt < L ? dtb[(size_t)tt * H] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (k0 + 32 * r >= chunk) break;
          float v = d[r] * a;
#pragma unroll
          for (int o2 = 1; o2 < 32; o2 <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, o2);
            if (lane >= o2) v += u;
          }
          v += carry;
          cs[k0 + 32 * r + lane] = v;
          dts[k0 + 32 * r + lane] = d[r];
          carry = __shfl_sync(0xffffffffu, v, 31);
        }
      }
    }
    __syncthreads();
    const float cs_end = cs[chunk - 1];  // steps past L add 0 to the cumsum
    for (int i = threadIdx.x; i < chunk; i += kMmaThreads)
      ws[i] = dts[i] * expf(cs_end - cs[i]);

    // tiles u = 0 .. nq-1 are C sub-tiles (y of query sub-tile u), then
    // u = nq .. 2nq-1 the B sub-tiles of the state update
    const int n_tiles = 2 * nq;
    for (int u = 0; u < n_tiles; ++u) {
      if (u + 1 < n_tiles) {
        const int v = u + 1;
        const bf16* src = v < nq ? Cb : Bb;
        load_tile_sw128<kBT, N, kMmaThreads>(ring + (v & 1) * kBT * N, src, N,
                                             c0 + (v < nq ? v : v - nq) * kBT, kBT, L);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* tile = ring + (u & 1) * kBT * N;

      if (u < nq) {
        // ---- y of query sub-tile qi: rows i0, i1 of the chunk ----
        const int qi = u;
        const int i0 = qi * kBT + warp * 16 + g, i1 = i0 + 8;
        float acc[NP][4];
#pragma unroll
        for (int j = 0; j < NP; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        if (c > 0) {  // inter-chunk: exp(cs_i) C_i . S^T, S as hi + lo
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t af[4];
            ldsm_x4(af, tile + sw128<kBT>(warp * 16 + lane % 16, ks * 16 + (lane / 16) * 8));
#pragma unroll
            for (int j = 0; j < NP; j += 2) {
              const int off = sw128<kBT>(j * 8 + lane % 8 + (lane / 16) * 8,
                                     ks * 16 + ((lane / 8) % 2) * 8);
              uint32_t bh4[4], bl4[4];
              ldsm_x4(bh4, s_hi + off);
              ldsm_x4(bl4, s_lo + off);
              mma_bf16(acc[j], af, bh4[0], bh4[1]);
              mma_bf16(acc[j + 1], af, bh4[2], bh4[3]);
              mma_bf16(acc[j], af, bl4[0], bl4[1]);
              mma_bf16(acc[j + 1], af, bl4[2], bl4[3]);
            }
          }
          const float e0 = expf(cs[i0]), e1 = expf(cs[i1]);
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            acc[j][0] *= e0; acc[j][1] *= e0;
            acc[j][2] *= e1; acc[j][3] *= e1;
          }
        }
        // intra-chunk: key sub-tiles at or before qi; on the diagonal the
        // 16-key steps past the warp's rows are wholly masked
        for (int kj = 0; kj <= qi; ++kj) {
          const int ks_end = kj == qi ? warp + 1 : kBT / 16;
          // A fragment word q of 16-key step ks: row i0 or i1 (q & 1),
          // columns j0 + 8 (q >> 1) and the next; the block's G values are
          // loaded first, so that their loads overlap
          float2 gv[kBT / 16][4];
#pragma unroll
          for (int ks = 0; ks < kBT / 16; ++ks)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = kj * kBT + ks * 16 + 2 * t + (q >> 1) * 8;
              gv[ks][q] = ks < ks_end ? *reinterpret_cast<const float2*>(
                                            G + (size_t)((q & 1) ? i1 : i0) * chunk + j)
                                      : make_float2(0.f, 0.f);
            }
#pragma unroll
          for (int ks = 0; ks < kBT / 16; ++ks) {
            if (ks >= ks_end) break;
            const int j0 = kj * kBT + ks * 16 + 2 * t;  // columns j0, j0+1, j0+8, j0+9
            uint32_t mhi[4], mlo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = (q & 1) ? i1 : i0;
              const int j = j0 + (q >> 1) * 8;
              const float m0 = i >= j ? gv[ks][q].x * expf(cs[i] - cs[j]) * dts[j] : 0.f;
              const float m1 =
                  i >= j + 1 ? gv[ks][q].y * expf(cs[i] - cs[j + 1]) * dts[j + 1] : 0.f;
              split_bf16(m0, m1, mhi[q], mlo[q]);
            }
#pragma unroll
            for (int j = 0; j < NP; j += 2) {
              uint32_t bx[4];
              ldsm_x4_t(bx, xs + sw128<kBT>(kj * kBT + ks * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                        j * 8 + (lane / 16) * 8));
              mma_bf16(acc[j], mhi, bx[0], bx[1]);
              mma_bf16(acc[j + 1], mhi, bx[2], bx[3]);
              mma_bf16(acc[j], mlo, bx[0], bx[1]);
              mma_bf16(acc[j + 1], mlo, bx[2], bx[3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tt = c0 + (r ? i1 : i0);
          if (tt >= L) continue;
          O* dst = yb + (size_t)tt * xrow + 2 * t;
#pragma unroll
          for (int j = 0; j < NP; ++j) store2(dst + j * 8, acc[j][2 * r], acc[j][2 * r + 1]);
        }
      } else {
        // ---- state update over key sub-tile kj: S += (x w)^T B ----
        const int kj = u - nq;
        if (kj == 0) {
          const float d_end = expf(cs_end);
#pragma unroll
          for (int j = 0; j < NN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[j][e] *= d_end;
        }
#pragma unroll
        for (int ks = 0; ks < kBT / 16; ++ks) {
          const int jr = kj * kBT + ks * 16;  // first step of this 16-step slice
          uint32_t ax[4], ahi[4], alo[4];
          // x^T fragment: rows p = 16 warp .., columns j = jr ..
          ldsm_x4_t(ax, xs + sw128<kBT>(jr + lane % 8 + (lane / 16) * 8,
                                        warp * 16 + ((lane / 8) % 2) * 8));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = jr + 2 * t + (q >> 1) * 8;
            const float2 f = unpack_bf16(ax[q]);
            split_bf16(f.x * ws[j], f.y * ws[j + 1], ahi[q], alo[q]);
          }
#pragma unroll
          for (int j = 0; j < NN; j += 2) {
            uint32_t bb[4];
            ldsm_x4_t(bb, tile + sw128<kBT>(ks * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                            j * 8 + (lane / 16) * 8));
            mma_bf16(st[j], ahi, bb[0], bb[1]);
            mma_bf16(st[j + 1], ahi, bb[2], bb[3]);
            mma_bf16(st[j], alo, bb[0], bb[1]);
            mma_bf16(st[j + 1], alo, bb[2], bb[3]);
          }
        }
      }
      __syncthreads();  // this stage is refilled two tiles on
    }

    // the state as bf16 hi + lo for the next chunk's C S^T (read after the
    // next chunk's first barrier)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = warp * 16 + g + 8 * r;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        uint32_t hi, lo;
        split_bf16(st[j][2 * r], st[j][2 * r + 1], hi, lo);
        const int off = sw128<kBT>(p, j * 8) + 2 * t;
        *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
      }
    }
  }

  // the final state, [B, H, P, N] f32
  float* so = state_out + (size_t)bh * P * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < NN; ++j)
      *reinterpret_cast<float2*>(so + (size_t)p * N + j * 8 + 2 * t) =
          make_float2(st[j][2 * r], st[j][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------
// launch: bf16 on the tensor cores, f32 on the FMA body
// ---------------------------------------------------------------------
template <typename T, typename O, int P, int N>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* state, void* cb, int B, int L, int H,
                       int chunk, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (cb == nullptr) return cudaErrorInvalidValue;
    const int n_chunks = (L + chunk - 1) / chunk;
    const int nsub = chunk / kBT;
    ssd_cb_kernel<N><<<dim3(nsub * (nsub + 1) / 2, n_chunks, B), kMmaThreads, 0, stream>>>(
        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<float*>(cb), L,
        chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = SsdMmaSmem<P, N>::bytes(chunk);
    auto kernel = ssd_scan_mma_kernel<O, P, N>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * H, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const float*>(cb),
        static_cast<O*>(y), static_cast<float*>(state), L, H, chunk);
  } else {
    const size_t smem = ssd_smem_bytes<P, N>(chunk);
    auto kernel = ssd_scan_kernel<T, O, P, N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<B * H, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<O*>(y),
        static_cast<float*>(state), L, H, chunk);
  }
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch_shape(int P, int N, const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, void* y, void* state, void* cb, int B,
                           int L, int H, int chunk, cudaStream_t stream) {
  if (P == 64 && N == 128)  // mamba2-2.7b
    return launch_ssd<T, O, 64, 128>(x, dt, A, Bm, Cm, y, state, cb, B, L, H, chunk, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_out(int out_dtype, int P, int N, const void* x, const void* dt,
                         const void* A, const void* Bm, const void* Cm, void* y, void* state,
                         void* cb, int B, int L, int H, int chunk, cudaStream_t stream) {
  if (out_dtype == kFloat32)
    return dispatch_shape<T, float>(P, N, x, dt, A, Bm, Cm, y, state, cb, B, L, H, chunk, stream);
  if (out_dtype == kBFloat16)
    return dispatch_shape<T, bf16>(P, N, x, dt, A, Bm, Cm, y, state, cb, B, L, H, chunk, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// x [B,L,H,P] and Bm, Cm [B,L,N] of one dtype; dt [B,L,H] and A [H] f32;
// y [B,L,H,P] of out_dtype; state [B,H,P,N] f32; all contiguous.  chunk is
// a positive multiple of 64.  cb is an f32 scratch of B * ceil(L / chunk) *
// chunk * chunk elements for bf16 inputs (unused, may be null, for f32).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, void* state, void* cb, int B, int L, int H,
                              int P, int N, int chunk, int dtype, int out_dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chunk <= 0 || chunk % kBT)
    err = cudaErrorInvalidValue;
  else if (dtype == kFloat32)
    err = dispatch_out<float>(out_dtype, P, N, x, dt, A, Bm, Cm, y, state, cb, B, L, H, chunk, s);
  else if (dtype == kBFloat16)
    err = dispatch_out<bf16>(out_dtype, P, N, x, dt, A, Bm, Cm, y, state, cb, B, L, H, chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
