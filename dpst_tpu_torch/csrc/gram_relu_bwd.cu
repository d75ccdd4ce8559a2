// The bf16 bias+ReLU masked-Gram backward, gram_relu_bwd (entry point
// dpst_gram_relu_bwd in gram.cu, which keeps the fp32 tile), on the Hopper
// bodies of gram_wgmma.cuh:
//   dz = round( relu'(z + b) * sum_k (S_k . F) * m2_k ),  F = round(max(z + b, 0))
// with z + b in fp32, each class's product in fp32 folded in class order
// (tot = tot + prod * m2_k), relu' = 1 above 0, 1/2 at 0 and 0 below.
// It replaces the TPU kernels dpst_tpu/ops/gram_s2d.py:_bwd_kernel2 (v2)
// and :_bwd_kernel (v1).
//
// At C <= 64, K <= gram90::RMAXK and one split (conv1_1, the only tap that
// takes it on the main paths) it runs gram_relu_bwd64_body, bound by bytes
// (z in, dz out: 0.083 ms at C = 64, P = 2^20, K = 4); otherwise
// gram_wbwd_body with its bias+ReLU steps (C <= 512), on gram_wbwd's plan.
// The kernels live in a translation unit of their own, so that gram_wbwd's
// kernels in gram.cu compile as they do without them (in one unit with
// them, gram_wbwd's 64-row kernel compiled to other registers).
#include "gram_wgmma.cuh"

namespace {

// The bias+ReLU backward on gram_wbwd's body (a.f the raw tap z); PAIRS:
// the instance of a batch of pairs (one pair runs the one-pair instance,
// register for register the body without a batch).
template <int N, bool PAIRS = false>
__global__ void __launch_bounds__(gram90::WNT, 1)
gram_relu_bwd_wgmma_kernel(gram90::ReluBwdArgs a) {
  gram90::gram_wbwd_body<N, gram90::WSTAGES, true, gram90::ReluBwdArgs,
                         PAIRS>(a);
}

// The bias+ReLU backward at C <= 64 on its own body.
template <bool PAIRS = false>
__global__ void __launch_bounds__(gram90::RWG * gram90::NT, 1)
gram_relu_bwd64_wgmma_kernel(gram90::ReluBwdArgs a) {
  gram90::gram_relu_bwd64_body<gram90::RNS, gram90::RWG, PAIRS>(a);
}

// Split partials (whole classes each, relu' applied), summed in split
// order and rounded once.
__global__ void relu_bwd_reduce_kernel(const float* __restrict__ work,
                                       __nv_bfloat16* __restrict__ out,
                                       int splits, long long n) {
  gram90::reduce_round(work, out, splits, n);
}

// gram_wbwd's body with the bias+ReLU steps: c tiles of N rows, `groups`
// blocks on the 128-pixel p tiles of each c tile of each of args.pairs
// pairs, `splits` ranges of ceil(K / splits) whole classes (then work
// holds the fp32 partials (splits, pairs, C, P)).
template <int N, bool PAIRS>
cudaError_t launch_wbwd_body(const gram90::ReluBwdArgs& args, int groups,
                             int splits, cudaStream_t st) {
  const int C = args.C, P = args.P, K = args.K, kps = args.kps;
  const int ptiles = (P + gram90::WPIX - 1) / gram90::WPIX;
  if (C > gram90::WMAXC || groups < 1 || groups > ptiles || kps < 1 ||
      (splits - 1) * kps >= K || (splits > 1 && args.work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = gram90::wbwd_smem<N, gram90::WSTAGES>(C);
  static size_t allowed[64] = {};  // one record for each instance
  cudaError_t err = hopper::allow_smem(gram_relu_bwd_wgmma_kernel<N, PAIRS>,
                                       smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (C + N - 1) / N, args.pairs * splits);
  gram_relu_bwd_wgmma_kernel<N, PAIRS><<<grid, gram90::WNT, smem, st>>>(args);
  if (splits > 1) {
    const long long n = static_cast<long long>(args.pairs) * C * P;
    relu_bwd_reduce_kernel<<<dpst::grid_for(n, 256, 132 * 16), 256, 0, st>>>(
        args.work, args.out, splits, n);
  }
  return cudaGetLastError();
}

// gram_relu_bwd64_body: `groups` blocks a pair, at most one an SM, on
// the RPIX-pixel p tiles of each of args.pairs pairs.
template <bool PAIRS>
cudaError_t launch_body64(const gram90::ReluBwdArgs& args, int groups,
                          cudaStream_t st) {
  const int ptiles = (args.P + gram90::RPIX - 1) / gram90::RPIX;
  if (args.K < 1 || groups < 1 || groups > ptiles)
    return cudaErrorInvalidValue;
  const size_t smem = gram90::relu_bwd64_smem(args.K);
  static size_t allowed[64] = {};
  cudaError_t err = hopper::allow_smem(gram_relu_bwd64_wgmma_kernel<PAIRS>,
                                       smem, allowed);
  if (err != cudaSuccess) return err;
  gram_relu_bwd64_wgmma_kernel<PAIRS>
      <<<dim3(groups, args.pairs), gram90::RWG * gram90::NT, smem, st>>>(
          args);
  return cudaGetLastError();
}

}  // namespace

// dpst_gram_relu_bwd in bf16, B pairs in one launch: z (B, C, P) raw conv
// output, bias (C,) shared, m2 (B, K, P), a the cotangent matrices of
// dpst_gram_bwd (B, C, K * Cp), P % 8 == 0; tile, groups and splits from
// ops/gram_s2d.py:relu_bwd_plan (at C <= 64, K <= 8 and one split the tile
// is 64 and gram_relu_bwd64_body runs).
extern "C" int dpst_gram_relu_bwd_bf16(const void* z, const void* bias,
                                       const void* m2, const void* a,
                                       void* work, void* out, int C, int P,
                                       int K, int B, int tile, int groups,
                                       int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 8 != 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const gram90::ReluBwdArgs args{
      {static_cast<const __nv_bfloat16*>(z),
       static_cast<const __nv_bfloat16*>(m2),
       static_cast<const __nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(out),
       splits > 1 ? static_cast<float*>(work) : nullptr, P, P, C, P, K,
       (K + splits - 1) / splits, static_cast<long long>(C) * P,
       static_cast<long long>(K) * P,
       static_cast<long long>(C) * K * ((C + 7) & ~7), B},
      static_cast<const __nv_bfloat16*>(bias)};
  cudaError_t err = cudaErrorInvalidValue;
  const bool pairs = B > 1;
  if (tile == 64 && splits == 1 && C <= 64 && K <= gram90::RMAXK)
    err = pairs ? launch_body64<true>(args, groups, st)
                : launch_body64<false>(args, groups, st);
  else if (tile == 64)
    err = pairs ? launch_wbwd_body<64, true>(args, groups, splits, st)
                : launch_wbwd_body<64, false>(args, groups, splits, st);
  else if (tile == 128)
    err = pairs ? launch_wbwd_body<128, true>(args, groups, splits, st)
                : launch_wbwd_body<128, false>(args, groups, splits, st);
  return static_cast<int>(err);
}

// dpst_gram_wgmma_attrs for which = 6 (gram_relu_bwd64_body, its shared
// memory at K = 4) and 7 (gram_wbwd's body with 128-row c tiles, at C =
// 512).
extern "C" int dpst_gram_relu_bwd_attrs(int which, int* out) {
  if (which == 6)
    return gram90::record_attrs(
        reinterpret_cast<const void*>(gram_relu_bwd64_wgmma_kernel<false>),
        gram90::relu_bwd64_smem(4), gram90::RWG * gram90::NT, out);
  if (which == 7)
    return gram90::record_attrs(
        reinterpret_cast<const void*>(gram_relu_bwd_wgmma_kernel<128>),
        gram90::wbwd_smem<128, gram90::WSTAGES>(gram90::WMAXC), gram90::WNT,
        out);
  return static_cast<int>(cudaErrorInvalidValue);
}
