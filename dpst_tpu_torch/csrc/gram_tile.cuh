// The masked-Gram tiles of csrc/gram.cu, shared with csrc/block12.cu:
//   forward   G_k[i][j] += sum_p F[i][p] * round_T(F[j][p] * round_T(m2_k[p]))
//   backward  dF[c][p]   = sum_{k, c'} S_k[c][c'] * round_T(F[c'][p] * round_T(m2_k[p]))
// F in the compute dtype T; the mask in T or in fp32 (M), rounded to T
// before the product (a no-op for M = T); fp32 accumulation. 64 x 64
// output tiles with a depth of 32: bf16 on the tensor cores through
// nvcuda::wmma (16x16x16, fp32 accumulators), fp32 on the CUDA cores.
#pragma once

#include <mma.h>

#include "dpst_common.cuh"

// Internal linkage: each translation unit that includes this header gets
// its own kernels (no device-code linking between the sources).
namespace {
namespace gram {

using dpst::from_f;
using dpst::to_f;

constexpr int TM = 64;   // output tile rows
constexpr int TN = 64;   // output tile columns
constexpr int TK = 32;   // reduction depth per stage
constexpr int NT = 128;  // threads per block (4 warps)

template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int A = 1, B = 4;
};
template <>
struct Pad<__nv_bfloat16> {  // wmma wants ld % 8 == 0 and 32-byte rows
  static constexpr int A = 8, B = 8;
};

constexpr int LDC = TN + 4;

// C tile (TM x TN, fp32) += A tile (TM x TK) . B tile (TK x TN).
template <typename T>
struct TileMma;

template <>
struct TileMma<float> {
  static constexpr int LDA = TK + Pad<float>::A, LDB = TN + Pad<float>::B;
  float acc[8][4];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  // thread (ty, tx) owns rows ty + 8i and columns tx + 16j
  __device__ void step(const float* as, const float* bs) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[(ty + 8 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* cs) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty + 8 * i) * LDC + tx + 16 * j] = acc[i][j];
  }
};

template <>
struct TileMma<__nv_bfloat16> {
  static constexpr int LDA = TK + Pad<__nv_bfloat16>::A;
  static constexpr int LDB = TN + Pad<__nv_bfloat16>::B;
  // warp w owns the 32x32 quarter (w / 2, w % 2): 2x2 fragments of 16x16
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }
  __device__ void step(const __nv_bfloat16* as, const __nv_bfloat16* bs) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32, wr = w / 2, wc = w % 2;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wr * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * LDB + wc * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* cs) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32, wr = w / 2, wc = w % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  }
};

// F as the kernels read it: the tap itself, or relu(z + b) of the raw conv
// output rounded to T, with z + b formed in fp32.
template <typename T, bool RELU>
__device__ __forceinline__ T load_f(const T* __restrict__ f,
                                    const T* __restrict__ bias, int c,
                                    size_t idx) {
  if constexpr (RELU)
    return from_f<T>(fmaxf(to_f(f[idx]) + to_f(bias[c]), 0.0f));
  else
    return f[idx];
}

// round_T(F_j * round_T(m)): the weighted operand. For a mask in T the
// inner rounding is exact (a T value widened to fp32 and rounded back).
template <typename T, typename M>
__device__ __forceinline__ T weigh(T fj, M m) {
  return from_f<T>(to_f(fj) * to_f(from_f<T>(to_f(m))));
}

// Forward tile: o[(i0.., j0..)] = sum over p in [pb, pe) of
// F[i][p] * round_T(F[j][p] * m[p]), with row i of F at f + i * ldf and the
// class's mask at m. o is a (C, C) fp32 plane.
template <typename T, bool RELU, typename M>
__device__ __forceinline__ void gram_fwd_tile(const T* __restrict__ f, size_t ldf,
                                              const T* __restrict__ bias,
                                              const M* __restrict__ m,
                                              float* __restrict__ o, int C,
                                              int i0, int j0, int pb, int pe) {
  constexpr int LDA = TileMma<T>::LDA, LDB = TileMma<T>::LDB;
  __shared__ __align__(128) T as[TM * LDA];
  __shared__ __align__(128) T bs[TK * LDB];
  __shared__ __align__(128) float cs[TM * LDC];
  const T zero = from_f<T>(0.0f);

  TileMma<T> mma;
  mma.init();
  for (int p0 = pb; p0 < pe; p0 += TK) {
    // A = rows i0.. of F
    for (int e = threadIdx.x; e < TM * TK; e += NT) {
      const int r = e / TK, kk = e % TK, i = i0 + r, p = p0 + kk;
      as[r * LDA + kk] =
          (i < C && p < pe) ? load_f<T, RELU>(f, bias, i, i * ldf + p) : zero;
    }
    // B[kk][c] = F[j0 + c][p] * m[p] rounded to T (p = p0 + kk): rows
    // j0.. of the weighted operand, transposed
    for (int e = threadIdx.x; e < TN * TK; e += NT) {
      const int c = e / TK, kk = e % TK, j = j0 + c, p = p0 + kk;
      T val = zero;
      if (j < C && p < pe)
        val = weigh<T, M>(load_f<T, RELU>(f, bias, j, j * ldf + p), m[p]);
      bs[kk * LDB + c] = val;
    }
    __syncthreads();
    mma.step(as, bs);
    __syncthreads();
  }
  mma.store(cs);
  __syncthreads();
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, c = e % TN, i = i0 + r, j = j0 + c;
    if (i < C && j < C) o[static_cast<size_t>(i) * C + j] = cs[r * LDC + c];
  }
}

// Backward tile (p tile p0, channel tile c0): acc[c][p] = sum over r =
// (k, c') of S[k][c][c'] * round_T(F[c'][p] * m2[k][p]), F (C, P) and m2
// (K, P) contiguous, S (K, C, C) in T. epi(idx, acc) stores it, idx =
// c * P + p.
template <typename T, typename M, typename Epi>
__device__ __forceinline__ void gram_bwd_tile(const T* __restrict__ f,
                                              const M* __restrict__ m2,
                                              const T* __restrict__ s, Epi epi,
                                              int C, int P, int K, int p0,
                                              int c0) {
  constexpr int LDA = TileMma<T>::LDA, LDB = TileMma<T>::LDB;
  __shared__ __align__(128) T as[TM * LDA];
  __shared__ __align__(128) T bs[TK * LDB];
  __shared__ __align__(128) float cs[TM * LDC];

  const int R = K * C;
  const T zero = from_f<T>(0.0f);

  TileMma<T> mma;
  mma.init();
  for (int r0 = 0; r0 < R; r0 += TK) {
    // A[rr][kk] = S[k][c0 + rr][c'] with (k, c') = divmod(r0 + kk, C)
    for (int e = threadIdx.x; e < TM * TK; e += NT) {
      const int rr = e / TK, kk = e % TK, c = c0 + rr, r = r0 + kk;
      T val = zero;
      if (c < C && r < R)
        val = s[(static_cast<size_t>(r / C) * C + c) * C + (r % C)];
      as[rr * LDA + kk] = val;
    }
    // B[kk][pp] = F[c'][p] * m2[k][p], rounded to T
    for (int e = threadIdx.x; e < TK * TN; e += NT) {
      const int kk = e / TN, pp = e % TN, r = r0 + kk, p = p0 + pp;
      T val = zero;
      if (r < R && p < P)
        val = weigh<T, M>(f[static_cast<size_t>(r % C) * P + p],
                          m2[static_cast<size_t>(r / C) * P + p]);
      bs[kk * LDB + pp] = val;
    }
    __syncthreads();
    mma.step(as, bs);
    __syncthreads();
  }
  mma.store(cs);
  __syncthreads();
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int rr = e / TN, pp = e % TN, c = c0 + rr, p = p0 + pp;
    if (c < C && p < P)
      epi(static_cast<size_t>(c) * P + p, cs[rr * LDC + pp]);
  }
}

// Sum per-split partials in a fixed order: out[i] = (init ? 0 : out[i]) +
// work[0][i] + work[1][i] + ... (deterministic). The body of each source's
// own reduce kernel, so that a profile books each under its caller.
__device__ __forceinline__ void reduce_body(const float* __restrict__ work,
                                            float* __restrict__ out,
                                            int splits, long long n, int init) {
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = init ? 0.0f : out[idx];
    for (int sp = 0; sp < splits; ++sp) s += work[sp * n + idx];
    out[idx] = s;
  }
}

}  // namespace gram
}  // namespace
