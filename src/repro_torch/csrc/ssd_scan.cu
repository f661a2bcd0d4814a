// Mamba2 SSD chunked scan for Hopper (sm_90a), f32 or bf16 in, f32 math.
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
// and the state out) against ~27 GFLOP, so on the tensor cores it would be
// bound by the bytes (~45 us at 3.35 TB/s).  This first kernel does its
// products with f32 FMAs from shared memory instead, so it is bound by the
// FMA rate and shared-memory traffic.  Design: the TPU grid (B*H, L/chunk)
// walks chunks in order with the state in VMEM; here one CTA of 256
// threads per (b, h) loops over its chunks itself and keeps the state
// (transposed, [N][P]) in shared memory.  A 128-step chunk in f32 does not
// fit beside its B and C tiles, so each chunk is walked in 64-row
// sub-tiles: for every query sub-tile, the C tile stays while the B and X
// tiles of the key sub-tiles at or before it stream through, as in flash
// attention.  x is read in place from [B, L, H, P] at stride H*P per step;
// B and C are shared by all heads of a sequence, and CTAs of one sequence
// are neighbours in the grid, so those reads hit L2.  The decay
// exp(cs_i - cs_j) is computed only where i >= j (above the diagonal it
// overflows, and a mask applied as a product would turn inf * 0 into NaN).
// Steps at or past L are read as dt = 0, x = B = C = 0: they neither decay
// nor add to the state and write no y, so L need not divide the chunk.
// Tensor-core (mma/wgmma) products are later work.
#include "common.cuh"

#include <math.h>

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

template <typename T, typename O, int P, int N>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, void* y, void* state, int B, int L, int H, int chunk,
                       cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes<P, N>(chunk);
  auto kernel = ssd_scan_kernel<T, O, P, N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<O*>(y),
      static_cast<float*>(state), L, H, chunk);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t dispatch_shape(int P, int N, const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, void* y, void* state, int B, int L,
                           int H, int chunk, cudaStream_t stream) {
  if (P == 64 && N == 128)  // mamba2-2.7b
    return launch_ssd<T, O, 64, 128>(x, dt, A, Bm, Cm, y, state, B, L, H, chunk, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_out(int out_dtype, int P, int N, const void* x, const void* dt,
                         const void* A, const void* Bm, const void* Cm, void* y, void* state,
                         int B, int L, int H, int chunk, cudaStream_t stream) {
  if (out_dtype == kFloat32)
    return dispatch_shape<T, float>(P, N, x, dt, A, Bm, Cm, y, state, B, L, H, chunk, stream);
  if (out_dtype == kBFloat16)
    return dispatch_shape<T, __nv_bfloat16>(P, N, x, dt, A, Bm, Cm, y, state, B, L, H, chunk,
                                            stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// x [B,L,H,P] and Bm, Cm [B,L,N] of one dtype; dt [B,L,H] and A [H] f32;
// y [B,L,H,P] of out_dtype; state [B,H,P,N] f32; all contiguous.  chunk is
// a positive multiple of 64.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, void* state, int B, int L, int H, int P,
                              int N, int chunk, int dtype, int out_dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chunk <= 0 || chunk % kBT)
    err = cudaErrorInvalidValue;
  else if (dtype == kFloat32)
    err = dispatch_out<float>(out_dtype, P, N, x, dt, A, Bm, Cm, y, state, B, L, H, chunk, s);
  else if (dtype == kBFloat16)
    err = dispatch_out<__nv_bfloat16>(out_dtype, P, N, x, dt, A, Bm, Cm, y, state, B, L, H,
                                      chunk, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
