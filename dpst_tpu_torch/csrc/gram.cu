// Masked Gram matrices, forward and backward, for any channel count C and
// any class count K, in variants that share their tiles:
//
// gram_fwd / gram_bwd replace the TPU kernels
// dpst_tpu/ops/gram_stream.py:_fwd_kernel (launched by _gram_fwd_call) and
// :_bwd_kernel (launched by _gram_raw_bwd), and compute the function of
// dpst_tpu/ops/losses.py:_grams_raw_flat and its analytic VJP:
//   forward   G_k = F . (F * m2_k)^T          f (C, P), m2 (K, P) -> (K, C, C)
//   backward  dF  = sum_k S_k . (F * m2_k)     S_k = dG_k + dG_k^T  -> (C, P)
// The weighted operand F * m2_k is rounded to the compute dtype (as the
// JAX package forms it), every product accumulates in fp32, G is fp32 and
// dF is stored in the compute dtype.
//
// gram_relu_fwd / gram_relu_bwd replace the TPU kernels
// dpst_tpu/ops/gram_s2d.py:_fwd_kernel2 and :_bwd_kernel2 (v2, launched by
// _gram_s2d2_raw) and :_fwd_kernel and :_bwd_kernel (v1, _gram_s2d_raw),
// which take the RAW block-1 conv output z (no bias) and the bias b:
//   forward   F = round(max(z + b, 0)) (z + b in fp32), then G_k as above
//   backward  dz = relu'(z + b) * sum_k (S_k . F) * m2_k
// with relu' = 1 above 0, 0.5 at exactly 0 and 0 below (the subgradient of
// jnp.maximum), the sum over k in fp32 in class order, and one rounding at
// the end. The s2d parity grid, the 128-lane diagonal blocks and the mask
// lane packing of the TPU kernels are layout devices and are not carried:
// z is the (C, P) NCHW plane of the raw conv output, the masks the (K, P)
// m2 stack, and any C is accepted (the TPU's v2 hard-codes C = 64). The
// forward is gram_fwd with a bias+ReLU prologue where F enters shared
// memory; the backward forms (S_k . F) per class, then scales by m2_k and
// relu' in fp32.
//
// gram_wbwd replaces the TPU kernels dpst_tpu/ops/gram_pallas.py:_bwd_kernel
// (launched by _bwd_call) and dpst_tpu/ops/gram_stream.py:_bwd_kernel,
// which weight by m2_k after the product instead of before it:
//   backward  dF = sum_k (S_k . F) * m2_k
// with each class's product in fp32, scaled by m2_k in fp32, summed in
// class order and rounded once. In fp32 it is gram_relu_bwd's body with the
// bias+ReLU prologue and the relu' epilogue switched off. The forward of
// those routes (gram_pallas.py:_fwd_kernel, gram_stream.py:_fwd_kernel)
// rounds F * m2_k to the compute dtype and accumulates in fp32: gram_fwd's
// function, up to the transpose of each G_k, which the wrapper takes.
//
// What bounds them on the H100: operations at the deep layers (2*K*C*C*P
// with C up to 512) and bytes at conv1_1 (C = 64, P = 262144 at 512^2 and
// 1048576 at 1024^2, where the tap is read once for 2*64 operations per
// element: at 1024^2, K = 4, bf16 the forward must read 143 MB, 0.043 ms,
// against 34 GFLOP, 0.035 ms; the backward moves 277 MB, 0.083 ms). The
// design keeps the (P, K*C) weighted block, and for the relu variants the
// cooked tap, out of device memory: each block forms its tiles in shared
// memory while it loads them. bf16 tiles run on the tensor cores through
// warp-level mma (nvcuda::wmma, 16x16x16, fp32 accumulators); fp32 tiles
// run on the CUDA cores (fp32 has no exact tensor-core path: TF32 would
// drop mantissa bits). Tiles are 64x64 with a depth of 32, without
// pipelining. The forward tile and the backward tile of gram_bwd live in
// gram_tile.cuh, shared with block12.cu.
//
// All five in bf16 run other bodies, written for Hopper (gram_wgmma.cuh):
// wgmma tiles fed by a cp.async ring, F read once for all K classes. The
// forwards form the weighted operand in registers (gram_relu_fwd cooks
// relu(z + b) in shared memory first); gram_bwd weights before its one
// product, gram_wbwd walks the classes outer and folds each class's
// product, weighted, into a second accumulator; gram_relu_bwd (launched
// from gram_relu_bwd.cu) runs gram_wbwd's body with a cook of each z chunk
// where it lands and relu' before the store, or, at C <= 64 and at most
// gram90::RMAXK classes, gram_relu_bwd64_body (the cotangent resident, a
// tile's class products two at a time, raw z tiles kept in flight by each
// of four warpgroups on its own).
// They need P % 8 == 0 (16-byte rows; the wrapper pads P with zero
// columns), the backwards take the cotangent as the (C, K * Cp) matrix A
// described at dpst_gram_bwd, and the forwards' split chunk is a multiple
// of 128. Their fp32 bodies are the tiles above.
//
// A batch of B pairs (f (B, C, P), m2 (B, K, P), the JAX package's vmapped
// pallas_call) is one launch of each kernel with the pair an index of its
// grid: the forward's pairs are the Hopper body's bands (fband = C P,
// mband = K P) and its split partials (B, splits, K, C, C) are summed per
// pair; the backwards take pair strides (the bodies' PAIRS instances; one
// pair runs the one-pair instances) and their split partials are
// split-major, (splits, B, C, P), so that one reduction over B C P
// elements serves every pair. The fp32 tiles take the pair from
// blockIdx.z. gram_wbwd's batch instance lives in gram_wbwd_pairs.cu. The
// caller's plans (ops/gram_stream.fwd_plan, bwd_plan, gram_pallas.
// wbwd_plan, gram_s2d.relu_bwd_plan) split each pair's reduction as one
// pair's plan does, so a pair's sums round in a batch as they do alone;
// B changes only the blocks that walk a pair's p tiles.
//
// The forward reduces over P, which is 1048576 at 1024^2, so P is split
// across blocks. Each split writes its own fp32 partial and a second
// kernel sums the partials in a fixed order: no float atomics, so a rerun
// gives bit-identical Grams. Offsets into (C, P), (K, P) and the split
// workspace are 64-bit (C * P is 2^26 at 1024^2 and grows 16x by 4096^2).
#include "gram_tile.cuh"
#include "gram_wgmma.cuh"

namespace {

using dpst::from_f;
using dpst::to_f;
using gram::LDC;
using gram::NT;
using gram::TileMma;
using gram::TK;
using gram::TM;
using gram::TN;
using gram::load_f;

// Forward: block (tile, k, z = pair * splits + split) computes the
// (i0, j0) tile of the pair's G_k over the pixels [split * chunk, min(P,
// (split + 1) * chunk)) into out[z][k]: f (B, C, P) and m2 (B, K, P).
template <typename T, bool RELU>
__device__ __forceinline__ void gram_fwd_block(const T* __restrict__ f,
                                               const T* __restrict__ bias,
                                               const T* __restrict__ m2,
                                               float* __restrict__ out, int C,
                                               int P, int K, int splits,
                                               int chunk) {
  const int tiles = (C + TN - 1) / TN;
  const int i0 = (blockIdx.x / tiles) * TM, j0 = (blockIdx.x % tiles) * TN;
  const int k = blockIdx.y, pair = blockIdx.z / splits;
  const int split = blockIdx.z - pair * splits;
  const int pb = split * chunk;
  const int pe = min(P, pb + chunk);
  gram::gram_fwd_tile<T, RELU, T>(
      f + static_cast<size_t>(pair) * C * P, static_cast<size_t>(P), bias,
      m2 + (static_cast<size_t>(pair) * K + k) * P,
      out + (static_cast<size_t>(blockIdx.z) * K + k) * C * C, C, i0, j0, pb,
      pe);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_fwd_kernel(const T* __restrict__ f, const T* __restrict__ m2,
                float* __restrict__ out, int C, int P, int K, int splits,
                int chunk) {
  gram_fwd_block<T, false>(f, nullptr, m2, out, C, P, K, splits, chunk);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_relu_fwd_kernel(const T* __restrict__ z, const T* __restrict__ bias,
                     const T* __restrict__ m2, float* __restrict__ out, int C,
                     int P, int K, int splits, int chunk) {
  gram_fwd_block<T, true>(z, bias, m2, out, C, P, K, splits, chunk);
}

// Sum the per-split partials of each pair in a fixed order
// (deterministic): out[b][i] = work[b][0][i] + work[b][1][i] + ..., n
// elements a pair.
__global__ void gram_reduce_kernel(const float* __restrict__ work,
                                   float* __restrict__ out, int splits,
                                   long long n, int pairs) {
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < pairs * n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = idx / n, i = idx - b * n;
    const float* w = work + b * splits * n + i;
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += w[sp * n];
    out[idx] = s;
  }
}

// Backward: block (p tile, c tile) computes dF[c0.., p0..] =
// sum over r = (k, c') of S[k][c][c'] * (F[c'][p] * m2[k][p]), rounded once.
template <typename T>
struct StoreRound {
  T* out;
  __device__ __forceinline__ void operator()(size_t idx, float acc) const {
    out[idx] = from_f<T>(acc);
  }
};

// Grid (p tiles, c tiles, pairs): f, out (B, C, P), m2 (B, K, P), s (B,
// K, C, C).
template <typename T>
__global__ void __launch_bounds__(NT)
gram_bwd_kernel(const T* __restrict__ f, const T* __restrict__ m2,
                const T* __restrict__ s, T* __restrict__ out, int C, int P,
                int K) {
  const size_t b = blockIdx.z, cp = static_cast<size_t>(C) * P;
  gram::gram_bwd_tile<T, T>(f + b * cp, m2 + b * K * P, s + b * K * C * C,
                            StoreRound<T>{out + b * cp}, C, P, K,
                            blockIdx.x * TN, blockIdx.y * TM);
}

// Class-weighted backward: block (p tile, c tile, pair) computes
// out[c0.., p0..] = sum_k m2_k[p] * (S_k . F)[c][p] of its pair (f, out
// (B, C, P), m2 (B, K, P), s (B, K, C, C); the bias is shared). Each class's product
// is accumulated on the tiles, then scaled by m2_k and summed in fp32 on
// the output tile, which each thread holds PER values of. With RELU, F =
// relu(z + b) rounded to T and the sum is multiplied by relu'(z + b)
// (gram_relu_bwd); without, F is the tap itself (gram_wbwd).
template <typename T, bool RELU>
__device__ __forceinline__ void gram_cls_bwd_tile(const T* __restrict__ z,
                                                  const T* __restrict__ bias,
                                                  const T* __restrict__ m2,
                                                  const T* __restrict__ s,
                                                  T* __restrict__ out, int C,
                                                  int P, int K) {
  constexpr int LDA = TileMma<T>::LDA, LDB = TileMma<T>::LDB;
  constexpr int PER = TM * TN / NT;
  __shared__ __align__(128) T as[TM * LDA];
  __shared__ __align__(128) T bs[TK * LDB];
  __shared__ __align__(128) float cs[TM * LDC];

  const int p0 = blockIdx.x * TN, c0 = blockIdx.y * TM;
  const size_t pair = blockIdx.z, cp = static_cast<size_t>(C) * P;
  z += pair * cp;
  m2 += pair * K * P;
  s += pair * K * C * C;
  out += pair * cp;
  const T zero = from_f<T>(0.0f);
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;

  TileMma<T> mma;
  for (int k = 0; k < K; ++k) {
    const T* sk = s + static_cast<size_t>(k) * C * C;
    mma.init();
    for (int j0 = 0; j0 < C; j0 += TK) {
      // A[rr][kk] = S_k[c0 + rr][j0 + kk]
      for (int e = threadIdx.x; e < TM * TK; e += NT) {
        const int rr = e / TK, kk = e % TK, c = c0 + rr, j = j0 + kk;
        as[rr * LDA + kk] =
            (c < C && j < C) ? sk[static_cast<size_t>(c) * C + j] : zero;
      }
      // B[kk][pp] = F[j0 + kk][p0 + pp]
      for (int e = threadIdx.x; e < TK * TN; e += NT) {
        const int kk = e / TN, pp = e % TN, j = j0 + kk, p = p0 + pp;
        bs[kk * LDB + pp] =
            (j < C && p < P)
                ? load_f<T, RELU>(z, bias, j, static_cast<size_t>(j) * P + p)
                : zero;
      }
      __syncthreads();
      mma.step(as, bs);
      __syncthreads();
    }
    mma.store(cs);
    __syncthreads();
    const T* mk = m2 + static_cast<size_t>(k) * P;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NT, rr = e / TN, pp = e % TN;
      const int p = p0 + pp;
      if (p < P)  // rounded product, then rounded sum: no fma contraction
        acc[i] = __fadd_rn(acc[i], __fmul_rn(cs[rr * LDC + pp], to_f(mk[p])));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * NT, rr = e / TN, pp = e % TN;
    const int c = c0 + rr, p = p0 + pp;
    if (c < C && p < P) {
      const size_t idx = static_cast<size_t>(c) * P + p;
      if constexpr (RELU) {
        const float x = to_f(z[idx]) + to_f(bias[c]);
        const float d = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
        out[idx] = from_f<T>(acc[i] * d);
      } else {
        out[idx] = from_f<T>(acc[i]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_relu_bwd_kernel(const T* __restrict__ z, const T* __restrict__ bias,
                     const T* __restrict__ m2, const T* __restrict__ s,
                     T* __restrict__ out, int C, int P, int K) {
  gram_cls_bwd_tile<T, true>(z, bias, m2, s, out, C, P, K);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gram_wbwd_kernel(const T* __restrict__ f, const T* __restrict__ m2,
                 const T* __restrict__ s, T* __restrict__ out, int C, int P,
                 int K) {
  gram_cls_bwd_tile<T, false>(f, nullptr, m2, s, out, C, P, K);
}

// The fixed-order sum of the forward's split partials work (B, splits, K,
// C, C) into out (B, K, C, C).
void reduce_fwd(const float* work, float* out, int C, int K, int B,
                int splits, cudaStream_t st) {
  const long long n = static_cast<long long>(K) * C * C;
  gram_reduce_kernel<<<dpst::grid_for(B * n, 256, 132 * 16), 256, 0, st>>>(
      work, out, splits, n, B);
}

template <typename T, bool RELU>
void launch_fwd(const void* f, const void* bias, const void* m2, float* work,
                float* out, int C, int P, int K, int B, int splits, int chunk,
                cudaStream_t st) {
  const int tiles = (C + TN - 1) / TN;
  const dim3 grid(tiles * tiles, K, B * splits);
  float* dst = splits == 1 ? out : work;
  const T* ft = static_cast<const T*>(f);
  const T* mt = static_cast<const T*>(m2);
  if constexpr (RELU)
    gram_relu_fwd_kernel<T><<<grid, NT, 0, st>>>(
        ft, static_cast<const T*>(bias), mt, dst, C, P, K, splits, chunk);
  else
    gram_fwd_kernel<T><<<grid, NT, 0, st>>>(ft, mt, dst, C, P, K, splits,
                                            chunk);
  if (splits > 1) reduce_fwd(work, out, C, K, B, splits, st);
}

template <typename T>
void launch_bwd(const void* f, const void* m2, const void* s, void* out,
                int C, int P, int K, int B, cudaStream_t st) {
  const dim3 grid((P + TN - 1) / TN, (C + TM - 1) / TM, B);
  gram_bwd_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(m2),
      static_cast<const T*>(s), static_cast<T*>(out), C, P, K);
}

// The bf16 forward on the Hopper body (gram_wgmma.cuh), one band of P pixels.
__global__ void __launch_bounds__(gram90::NT)
gram_fwd_wgmma_kernel(gram90::FwdArgs a) {
  gram90::gram_fwd_body(a);
}

// The same body with the bias+ReLU prologue: a.f is the raw tap z.
__global__ void __launch_bounds__(gram90::NT)
gram_relu_fwd_wgmma_kernel(gram90::FwdArgs a) {
  gram90::gram_fwd_body<true>(a);
}

// bf16 forward on the Hopper body (RELU: gram_relu_fwd, f the raw tap z
// and bias its b): class groups of gram90::KG, the B pairs as the body's
// bands (f (B, C, P), m2 (B, K, P)), then the fixed-order sum of each
// pair's split partials. PC: the (P, C) form (gram_pc.cu) on f (B, P, C)
// in memory, C % 8 == 0, with m2 (B, K, P8), P8 = P rounded up to 8.
template <bool RELU, bool PC>
cudaError_t launch_fwd_wgmma(const void* f, const void* bias, const void* m2,
                             float* work, float* out, int C, int P, int K,
                             int B, int splits, int chunk, cudaStream_t st) {
  const int P8 = (P + 7) & ~7;
  if ((PC ? C : P) % 8 != 0 || P < 1 ||
      chunk % (gram90::BK * gram90::FWD_HALVES) != 0 ||
      (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const void* kern =
      PC ? gram_pc::fwd_kernel(RELU)
         : reinterpret_cast<const void*>(RELU ? gram_relu_fwd_wgmma_kernel
                                              : gram_fwd_wgmma_kernel);
  const size_t smem = gram90::fwd_smem();
  static size_t allowed[64] = {};  // one record for each variant
  cudaError_t err = hopper::allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = (C + 63) / 64;
  const dim3 grid(tiles * tiles, (K + gram90::KG - 1) / gram90::KG,
                  B * splits);
  gram90::FwdArgs args{static_cast<const __nv_bfloat16*>(f),
                       static_cast<const __nv_bfloat16*>(m2),
                       splits == 1 ? out : work, PC ? C : P, P8,
                       static_cast<long long>(C) * P,
                       static_cast<long long>(K) * P8, C, P8, K,
                       splits, chunk,
                       static_cast<const __nv_bfloat16*>(bias)};
  if (PC) args.prows = P;
  err = gram90::launch(kern, grid, gram90::NT, smem, st, args);
  if (err != cudaSuccess) return err;
  if (splits > 1) reduce_fwd(work, out, C, K, B, splits, st);
  return cudaGetLastError();
}

// The bf16 backward on the Hopper body (gram_wgmma.cuh), one band of P
// pixels, dF rounded once; PAIRS: the instance of a batch of pairs.
template <int N, bool PAIRS = false>
__global__ void __launch_bounds__(gram90::NT)
gram_bwd_wgmma_kernel(gram90::BwdArgs a) {
  gram90::gram_bwd_body<N, gram90::BwdRound, PAIRS>(a, gram90::BwdRound{});
}

// bf16 backward on the Hopper body: c tiles of N rows; `groups` blocks
// share the p tiles of each c tile of each of the B pairs, `splits` cut
// the reduction (then work holds the fp32 partials (splits, B, C, P),
// summed in a fixed order and rounded by gram_bwd_reduce_kernel). One
// pair runs the body's one-pair instance, B > 1 its PAIRS instance. PC:
// the (P, C) form (gram_pc.cu), f and out (B, P, C) in memory, m2 (B, K,
// P8), the partials (splits, B, P, C).
template <int N, bool PAIRS, bool PC>
cudaError_t launch_bwd_wgmma_n(const void* f, const void* m2, const void* a,
                               float* work, void* out, int C, int P, int K,
                               int B, int groups, int splits,
                               cudaStream_t st) {
  const int P8 = (P + 7) & ~7;
  const int nit = (C + 63) / 64 * K;
  const int ipb = (nit + splits - 1) / splits;
  if (groups < 1 || groups > (P + 63) / 64 || splits < 1 ||
      (splits - 1) * ipb >= nit || (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const void* kern =
      PC ? gram_pc::bwd_kernel(N, PAIRS)
         : reinterpret_cast<const void*>(gram_bwd_wgmma_kernel<N, PAIRS>);
  const size_t smem = gram90::bwd_smem<N>();
  static size_t allowed[64] = {};  // one record for each instance
  cudaError_t err = hopper::allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (C + N - 1) / N, B * splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const int ptiles = (P + 63) / 64;
  const long long cp = static_cast<long long>(C) * P;
  const gram90::BwdArgs args{static_cast<const __nv_bfloat16*>(f),
                             static_cast<const __nv_bfloat16*>(m2),
                             static_cast<const __nv_bfloat16*>(a), o,
                             splits > 1 ? work : nullptr, PC ? C : P, P8, 0,
                             0, P, ptiles, ptiles, C, K, ipb, cp,
                             static_cast<long long>(K) * P8,
                             static_cast<long long>(C) * K * ((C + 7) & ~7),
                             B};
  err = gram90::launch(kern, grid, gram90::NT, smem, st, args);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = B * cp;
    gram90::gram_bwd_reduce_kernel<<<dpst::grid_for(n, 256, 132 * 16), 256, 0,
                                     st>>>(work, o, splits, n);
  }
  return cudaGetLastError();
}

template <bool PC>
cudaError_t launch_bwd_wgmma(const void* f, const void* m2, const void* a,
                             float* work, void* out, int C, int P, int K,
                             int B, int tile, int groups, int splits,
                             cudaStream_t st) {
  if ((PC ? C : P) % 8 != 0 || P < 1) return cudaErrorInvalidValue;
  if (tile == 64)
    return (B > 1 ? launch_bwd_wgmma_n<64, true, PC>
                  : launch_bwd_wgmma_n<64, false, PC>)(
        f, m2, a, work, out, C, P, K, B, groups, splits, st);
  if (tile == 128)
    return (B > 1 ? launch_bwd_wgmma_n<128, true, PC>
                  : launch_bwd_wgmma_n<128, false, PC>)(
        f, m2, a, work, out, C, P, K, B, groups, splits, st);
  return cudaErrorInvalidValue;
}

template <typename T>
void launch_wbwd(const void* f, const void* m2, const void* s, void* out,
                 int C, int P, int K, int B, cudaStream_t st) {
  const dim3 grid((P + TN - 1) / TN, (C + TM - 1) / TM, B);
  gram_wbwd_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(m2),
      static_cast<const T*>(s), static_cast<T*>(out), C, P, K);
}

// The bf16 weighted-after backward on its Hopper body (gram_wgmma.cuh).
template <int N>
__global__ void __launch_bounds__(gram90::WNT, 1)
gram_wbwd_wgmma_kernel(gram90::WbwdArgs a) {
  gram90::gram_wbwd_body<N, gram90::WSTAGES>(a);
}

// Its split partials (whole classes each), summed in split order and
// rounded once.
__global__ void gram_wbwd_reduce_kernel(const float* __restrict__ work,
                                        __nv_bfloat16* __restrict__ out,
                                        int splits, long long n) {
  gram90::reduce_round(work, out, splits, n);
}

// bf16 weighted-after backward: c tiles of N rows; `groups` blocks share
// the 128-pixel p tiles of each c tile of each of the B pairs; `splits`
// cut the classes into ranges of ceil(K / splits), each non-empty (then
// work holds the fp32 partials (splits, B, C, P)). The (C, P) form runs
// one pair here (B > 1: gram_wbwd_pairs.cu); PC, the (P, C) form
// (gram_pc_wbwd.cu) on f and out (B, P, C) in memory and m2 (B, K, P8),
// any B (its PAIRS instance for B > 1).
template <int N, bool PC>
cudaError_t launch_wbwd_wgmma_n(const void* f, const void* m2, const void* a,
                                float* work, void* out, int C, int P, int K,
                                int B, int groups, int splits,
                                cudaStream_t st) {
  const int P8 = (P + 7) & ~7;
  const int ptiles = (P + gram90::WPIX - 1) / gram90::WPIX;
  const int kps = splits < 1 ? 0 : (K + splits - 1) / splits;
  if (C > gram90::WMAXC || groups < 1 || groups > ptiles || splits < 1 ||
      (splits - 1) * kps >= K || (splits > 1 && work == nullptr) ||
      (!PC && B != 1))
    return cudaErrorInvalidValue;
  const void* kern =
      PC ? gram_pc::wbwd_kernel(N, B > 1)
         : reinterpret_cast<const void*>(gram_wbwd_wgmma_kernel<N>);
  const size_t smem = gram90::wbwd_smem<N, gram90::WSTAGES>(C);
  static size_t allowed[2][64] = {};  // one record for each kernel
  cudaError_t err = hopper::allow_smem(kern, smem, allowed[B > 1]);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (C + N - 1) / N, B * splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const gram90::WbwdArgs args{static_cast<const __nv_bfloat16*>(f),
                              static_cast<const __nv_bfloat16*>(m2),
                              static_cast<const __nv_bfloat16*>(a), o,
                              splits > 1 ? work : nullptr, PC ? C : P, P8,
                              C, P, K, kps, static_cast<long long>(C) * P,
                              static_cast<long long>(K) * P8,
                              static_cast<long long>(C) * K * ((C + 7) & ~7),
                              B};
  err = gram90::launch(kern, grid, gram90::WNT, smem, st, args);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = static_cast<long long>(B) * C * P;
    gram_wbwd_reduce_kernel<<<dpst::grid_for(n, 256, 132 * 16), 256, 0, st>>>(
        work, o, splits, n);
  }
  return cudaGetLastError();
}

template <bool PC>
cudaError_t launch_wbwd_wgmma(const void* f, const void* m2, const void* a,
                              float* work, void* out, int C, int P, int K,
                              int B, int tile, int groups, int splits,
                              cudaStream_t st) {
  if ((PC ? C : P) % 8 != 0 || P < 1) return cudaErrorInvalidValue;
  if (tile == 64)
    return launch_wbwd_wgmma_n<64, PC>(f, m2, a, work, out, C, P, K, B,
                                       groups, splits, st);
  if (tile == 128)
    return launch_wbwd_wgmma_n<128, PC>(f, m2, a, work, out, C, P, K, B,
                                        groups, splits, st);
  return cudaErrorInvalidValue;
}

template <typename T>
void launch_relu_bwd(const void* z, const void* bias, const void* m2,
                     const void* s, void* out, int C, int P, int K, int B,
                     cudaStream_t st) {
  const dim3 grid((P + TN - 1) / TN, (C + TM - 1) / TM, B);
  gram_relu_bwd_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const T*>(z), static_cast<const T*>(bias),
      static_cast<const T*>(m2), static_cast<const T*>(s),
      static_cast<T*>(out), C, P, K);
}

}  // namespace

// The bf16 bias+ReLU backward and its resources, in gram_relu_bwd.cu (a
// translation unit of its own, so that gram_wbwd's kernels here compile as
// they did without it).
extern "C" int dpst_gram_relu_bwd_bf16(const void* z, const void* bias,
                                       const void* m2, const void* s,
                                       void* work, void* out, int C, int P,
                                       int K, int B, int tile, int groups,
                                       int splits, int pc, void* stream);
extern "C" int dpst_gram_relu_bwd_attrs(int which, int* out);
// gram_wbwd's bf16 batch of B > 1 pairs, in gram_wbwd_pairs.cu.
extern "C" int dpst_gram_wbwd_pairs_bf16(const void* f, const void* m2,
                                         const void* a, void* work, void* out,
                                         int C, int P, int K, int B, int tile,
                                         int groups, int splits,
                                         void* stream);

// B pairs in one launch (the pair an index of the grid): f (B, C, P), m2
// (B, K, P); work: (B, splits, K, C, C) fp32 scratch, unused when splits
// == 1; out: (B, K, C, C) fp32. Each split covers `chunk` pixels: a
// multiple of 32 in fp32; in bf16 a multiple of 128, with P % 8 == 0.
// pc = 1 (bf16 only): the (P, C) form, f (B, P, C) in memory (the tap of a
// channels_last activation) with C % 8 == 0, any P, m2 (B, K, P8) with P8
// = P rounded up to 8 and the pad zero, the chunk that of a P8 plan.
extern "C" int dpst_gram_fwd(const void* f, const void* m2, void* work,
                             void* out, int C, int P, int K, int B,
                             int splits, int chunk, int dtype, int pc,
                             void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (B < 1 || splits < 1 || B * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == DPST_DTYPE_F32 && !pc)
    launch_fwd<float, false>(f, nullptr, m2, w, o, C, P, K, B, splits, chunk,
                             st);
  else if (dtype == DPST_DTYPE_BF16)
    return static_cast<int>(
        (pc ? launch_fwd_wgmma<false, true> : launch_fwd_wgmma<false, false>)(
            f, nullptr, m2, w, o, C, P, K, B, splits, chunk, st));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// B pairs in one launch: f and out (B, C, P), dF in the compute dtype;
// m2 (B, K, P). s is the symmetrized cotangent of each pair: in fp32 the
// (B, K, C, C) stacks S; in bf16 the matrices A (B, C, K * Cp) with
// A[b][c][k * Cp + c'] = S_bk[c][c'], Cp = C rounded up to a multiple of 8
// and the padding zero, and P % 8 == 0. tile, groups, splits and work
// serve bf16 only: c tiles of `tile` (64 or 128) rows; `groups` (1 <=
// groups <= ceil(P / 64)) blocks walk the 64-pixel tiles of each c tile of
// each pair; `splits` > 1 cuts the reduction over (k, c') into that many
// ranges of ceil(ceil(C / 64) * K / splits) items, each non-empty, whose
// fp32 partials go to work (splits, B, C, P). pc = 1 (bf16 only): the (P,
// C) form, f, out and work's partials (.., P, C) in memory, m2 (B, K, P8),
// as for dpst_gram_fwd.
extern "C" int dpst_gram_bwd(const void* f, const void* m2, const void* s,
                             void* work, void* out, int C, int P, int K,
                             int B, int tile, int groups, int splits,
                             int dtype, int pc, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (B < 1 || splits < 1 || B * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DPST_DTYPE_F32 && !pc)
    launch_bwd<float>(f, m2, s, out, C, P, K, B, st);
  else if (dtype == DPST_DTYPE_BF16)
    return static_cast<int>(
        (pc ? launch_bwd_wgmma<true> : launch_bwd_wgmma<false>)(
            f, m2, s, static_cast<float*>(work), out, C, P, K, B, tile,
            groups, splits, st));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// z: (B, C, P) raw conv output, bias: (C,) shared by the pairs, both in
// the compute dtype; m2, work, out and pc as for dpst_gram_fwd (in bf16:
// the Hopper body, P % 8 == 0 and chunk a multiple of 128).
extern "C" int dpst_gram_relu_fwd(const void* z, const void* bias,
                                  const void* m2, void* work, void* out,
                                  int C, int P, int K, int B, int splits,
                                  int chunk, int dtype, int pc,
                                  void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (B < 1 || splits < 1 || B * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  if (dtype == DPST_DTYPE_F32 && !pc)
    launch_fwd<float, true>(z, bias, m2, w, o, C, P, K, B, splits, chunk,
                            st);
  else if (dtype == DPST_DTYPE_BF16)
    return static_cast<int>(
        (pc ? launch_fwd_wgmma<true, true> : launch_fwd_wgmma<true, false>)(
            z, bias, m2, w, o, C, P, K, B, splits, chunk, st));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// B pairs in one launch: z (B, C, P) raw conv output, bias (C,) shared,
// m2 (B, K, P), in the compute dtype; out: dz (B, C, P). s, tile, groups
// and splits as for dpst_gram_wbwd, s and work with the pairs' axis as for
// dpst_gram_bwd (in bf16 the matrices A, P % 8 == 0, C <= 512, work
// (splits, B, C, P)); in bf16 with C <= 64, K <= 8 and splits == 1 the
// tile is 64 and `groups` blocks of each pair walk its p tiles of
// gram90::RPIX pixels. pc = 1 (bf16 only): the (P, C) form, z, out and
// work's partials (.., P, C) in memory, m2 (B, K, P8), as for
// dpst_gram_fwd.
extern "C" int dpst_gram_relu_bwd(const void* z, const void* bias,
                                  const void* m2, const void* s, void* work,
                                  void* out, int C, int P, int K, int B,
                                  int tile, int groups, int splits, int dtype,
                                  int pc, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (B < 1 || splits < 1 || B * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DPST_DTYPE_F32 && !pc)
    launch_relu_bwd<float>(z, bias, m2, s, out, C, P, K, B, st);
  else if (dtype == DPST_DTYPE_BF16)
    return dpst_gram_relu_bwd_bf16(z, bias, m2, s, work, out, C, P, K, B,
                                   tile, groups, splits, pc, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// B pairs in one launch: f (B, C, P) taps, m2 (B, K, P), in the compute
// dtype; out: dF (B, C, P) = sum_k (S_bk . F_b) * m2_bk, each class's
// product in fp32, weighted after the product. s is the symmetrized
// cotangent: in fp32 the (B, K, C, C) stacks; in bf16 the matrices A of
// dpst_gram_bwd (B, C, K * Cp), with P % 8 == 0 and C <= 512. tile,
// groups, splits and work serve bf16 only: c tiles of `tile` (64 or 128)
// rows; `groups` (1 <= groups <= ceil(P / 128)) blocks walk the 128-pixel
// tiles of each c tile of each pair; `splits` > 1 cuts the classes into
// that many ranges of ceil(K / splits), each non-empty, whose fp32
// partials go to work (splits, B, C, P). One pair runs the one-pair
// instance here, B > 1 the batch instance of gram_wbwd_pairs.cu. pc = 1
// (bf16 only): the (P, C) form, f, out and work's partials (.., P, C) in
// memory, m2 (B, K, P8), as for dpst_gram_fwd, any B here.
extern "C" int dpst_gram_wbwd(const void* f, const void* m2, const void* s,
                              void* work, void* out, int C, int P, int K,
                              int B, int tile, int groups, int splits,
                              int dtype, int pc, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (B < 1 || splits < 1 || B * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == DPST_DTYPE_F32 && !pc)
    launch_wbwd<float>(f, m2, s, out, C, P, K, B, st);
  else if (dtype == DPST_DTYPE_BF16 && pc)
    return static_cast<int>(launch_wbwd_wgmma<true>(
        f, m2, s, w, out, C, P, K, B, tile, groups, splits, st));
  else if (dtype == DPST_DTYPE_BF16 && B > 1)
    return dpst_gram_wbwd_pairs_bf16(f, m2, s, work, out, C, P, K, B, tile,
                                     groups, splits, stream);
  else if (dtype == DPST_DTYPE_BF16)
    return static_cast<int>(launch_wbwd_wgmma<false>(
        f, m2, s, w, out, C, P, K, 1, tile, groups, splits, st));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Resources of the Hopper bodies, for the record: which = 0 gram_fwd, 1
// gram_bwd with 64-row c tiles, 2 with 128-row c tiles, 3 gram_relu_fwd,
// 4 gram_wbwd with 64-row c tiles (its shared memory at C = 64), 5 with
// 128-row c tiles (at C = 512, the most it takes), 6 gram_relu_bwd's own
// body at C <= 64 (its shared memory at K = 4), 7 gram_relu_bwd on
// gram_wbwd's body with 128-row c tiles (at C = 512).
// out: registers a thread, local memory bytes a thread (spills and stack),
// dynamic shared memory bytes a block, resident blocks an SM.
extern "C" int dpst_gram_wgmma_attrs(int which, int* out) {
  cudaGetLastError();  // clear an error left by an earlier call
  size_t smem = 0;
  int threads = gram90::NT;
  const void* fn = nullptr;
  if (which == 0) {
    fn = reinterpret_cast<const void*>(gram_fwd_wgmma_kernel);
    smem = gram90::fwd_smem();
  } else if (which == 1) {
    fn = reinterpret_cast<const void*>(gram_bwd_wgmma_kernel<64>);
    smem = gram90::bwd_smem<64>();
  } else if (which == 2) {
    fn = reinterpret_cast<const void*>(gram_bwd_wgmma_kernel<128>);
    smem = gram90::bwd_smem<128>();
  } else if (which == 3) {
    fn = reinterpret_cast<const void*>(gram_relu_fwd_wgmma_kernel);
    smem = gram90::fwd_smem();
  } else if (which == 4) {
    fn = reinterpret_cast<const void*>(gram_wbwd_wgmma_kernel<64>);
    smem = gram90::wbwd_smem<64, gram90::WSTAGES>(64);
    threads = gram90::WNT;
  } else if (which == 5) {
    fn = reinterpret_cast<const void*>(gram_wbwd_wgmma_kernel<128>);
    smem = gram90::wbwd_smem<128, gram90::WSTAGES>(gram90::WMAXC);
    threads = gram90::WNT;
  } else if (which == 6 || which == 7) {
    return dpst_gram_relu_bwd_attrs(which, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return gram90::record_attrs(fn, smem, threads, out);
}

