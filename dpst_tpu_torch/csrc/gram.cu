// Masked Gram matrices, forward and backward, for any channel count C and
// any class count K.
//
// Replaces the TPU kernels dpst_tpu/ops/gram_stream.py:_fwd_kernel
// (launched by _gram_fwd_call) and :_bwd_kernel (launched by
// _gram_raw_bwd), and computes the function of
// dpst_tpu/ops/losses.py:_grams_raw_flat and its analytic VJP:
//   forward   G_k = F . (F * m2_k)^T          f (C, P), m2 (K, P) -> (K, C, C)
//   backward  dF  = sum_k S_k . (F * m2_k)     S_k = dG_k + dG_k^T  -> (C, P)
// The weighted operand F * m2_k is rounded to the compute dtype (as the
// JAX package forms it), every product accumulates in fp32, G is fp32 and
// dF is stored in the compute dtype.
//
// What bounds it on the H100: operations at the deep layers (2*K*C*C*P
// with C up to 512) and bytes at conv1_1 (C = 64, P = 262144 at 512^2,
// where the tap is read once for 2*64 operations per element). The design
// keeps the (P, K*C) weighted block out of device memory: each block forms
// its tile of F * m2_k in shared memory while it loads F. bf16 tiles run on
// the tensor cores through warp-level mma (nvcuda::wmma, 16x16x16, fp32
// accumulators); fp32 tiles run on the CUDA cores (fp32 has no exact
// tensor-core path: TF32 would drop mantissa bits). Tiles are 64x64 with a
// depth of 32; wgmma, TMA and pipelining are left for later work.
//
// The forward reduces over P, which is up to 262144 at 512^2, so P is
// split across blocks. Each split writes its own fp32 partial and a second
// kernel sums the partials in a fixed order: no float atomics, so a rerun
// gives bit-identical Grams.
#include <mma.h>

#include "dpst_common.cuh"

namespace {

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

// Forward: block (tile, k, split) computes the (i0, j0) tile of G_k over
// the pixels [split * chunk, min(P, (split + 1) * chunk)).
template <typename T>
__global__ void __launch_bounds__(NT)
gram_fwd_kernel(const T* __restrict__ f, const T* __restrict__ m2,
                float* __restrict__ out, int C, int P, int K, int chunk) {
  constexpr int LDA = TileMma<T>::LDA, LDB = TileMma<T>::LDB;
  __shared__ __align__(128) T as[TM * LDA];
  __shared__ __align__(128) T bs[TK * LDB];
  __shared__ __align__(128) float cs[TM * LDC];

  const int tiles = (C + TN - 1) / TN;
  const int i0 = (blockIdx.x / tiles) * TM, j0 = (blockIdx.x % tiles) * TN;
  const int k = blockIdx.y, split = blockIdx.z;
  const int pb = split * chunk;
  const int pe = min(P, pb + chunk);
  const T* mk = m2 + static_cast<size_t>(k) * P;
  const T zero = from_f<T>(0.0f);

  TileMma<T> mma;
  mma.init();
  for (int p0 = pb; p0 < pe; p0 += TK) {
    // A = rows i0.. of F
    for (int e = threadIdx.x; e < TM * TK; e += NT) {
      const int r = e / TK, kk = e % TK, i = i0 + r, p = p0 + kk;
      as[r * LDA + kk] = (i < C && p < pe) ? f[static_cast<size_t>(i) * P + p] : zero;
    }
    // B[kk][c] = F[j0 + c][p] * m2_k[p] rounded to T (p = p0 + kk): rows
    // j0.. of the weighted operand, transposed
    for (int e = threadIdx.x; e < TN * TK; e += NT) {
      const int c = e / TK, kk = e % TK, j = j0 + c, p = p0 + kk;
      T val = zero;
      if (j < C && p < pe)
        val = from_f<T>(to_f(f[static_cast<size_t>(j) * P + p]) * to_f(mk[p]));
      bs[kk * LDB + c] = val;
    }
    __syncthreads();
    mma.step(as, bs);
    __syncthreads();
  }
  mma.store(cs);
  __syncthreads();
  float* o = out + (static_cast<size_t>(split) * K + k) * C * C;
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, c = e % TN, i = i0 + r, j = j0 + c;
    if (i < C && j < C) o[static_cast<size_t>(i) * C + j] = cs[r * LDC + c];
  }
}

// Sum the per-split partials in a fixed order (deterministic).
__global__ void gram_reduce_kernel(const float* __restrict__ work,
                                   float* __restrict__ out, int splits,
                                   long long n) {
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += work[sp * n + idx];
    out[idx] = s;
  }
}

// Backward: block (p tile, c tile) computes dF[c0.., p0..] =
// sum over r = (k, c') of S[k][c][c'] * (F[c'][p] * m2[k][p]).
template <typename T>
__global__ void __launch_bounds__(NT)
gram_bwd_kernel(const T* __restrict__ f, const T* __restrict__ m2,
                const T* __restrict__ s, T* __restrict__ out, int C, int P,
                int K) {
  constexpr int LDA = TileMma<T>::LDA, LDB = TileMma<T>::LDB;
  __shared__ __align__(128) T as[TM * LDA];
  __shared__ __align__(128) T bs[TK * LDB];
  __shared__ __align__(128) float cs[TM * LDC];

  const int p0 = blockIdx.x * TN, c0 = blockIdx.y * TM;
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
        val = from_f<T>(to_f(f[static_cast<size_t>(r % C) * P + p]) *
                        to_f(m2[static_cast<size_t>(r / C) * P + p]));
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
      out[static_cast<size_t>(c) * P + p] = from_f<T>(cs[rr * LDC + pp]);
  }
}

template <typename T>
void launch_fwd(const void* f, const void* m2, float* work, float* out, int C,
                int P, int K, int splits, int chunk, cudaStream_t st) {
  const int tiles = (C + TN - 1) / TN;
  const dim3 grid(tiles * tiles, K, splits);
  float* dst = splits == 1 ? out : work;
  gram_fwd_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(f),
                                          static_cast<const T*>(m2), dst, C, P,
                                          K, chunk);
  if (splits > 1) {
    const long long n = static_cast<long long>(K) * C * C;
    gram_reduce_kernel<<<dpst::grid_for(n, 256, 132 * 16), 256, 0, st>>>(
        work, out, splits, n);
  }
}

template <typename T>
void launch_bwd(const void* f, const void* m2, const void* s, void* out,
                int C, int P, int K, cudaStream_t st) {
  const dim3 grid((P + TN - 1) / TN, (C + TM - 1) / TM);
  gram_bwd_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(m2),
      static_cast<const T*>(s), static_cast<T*>(out), C, P, K);
}

}  // namespace

// work: (splits, K, C, C) fp32 scratch, unused when splits == 1;
// out: (K, C, C) fp32. Each split covers `chunk` pixels (a multiple of 32).
extern "C" int dpst_gram_fwd(const void* f, const void* m2, void* work,
                             void* out, int C, int P, int K, int splits,
                             int chunk, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == DPST_DTYPE_F32)
    launch_fwd<float>(f, m2, w, o, C, P, K, splits, chunk, st);
  else if (dtype == DPST_DTYPE_BF16)
    launch_fwd<__nv_bfloat16>(f, m2, w, o, C, P, K, splits, chunk, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// s: (K, C, C) symmetrized cotangent in the compute dtype; out: (C, P).
extern "C" int dpst_gram_bwd(const void* f, const void* m2, const void* s,
                             void* out, int C, int P, int K, int dtype,
                             void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DPST_DTYPE_F32)
    launch_bwd<float>(f, m2, s, out, C, P, K, st);
  else if (dtype == DPST_DTYPE_BF16)
    launch_bwd<__nv_bfloat16>(f, m2, s, out, C, P, K, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
