// gram_wbwd (entry point dpst_gram_wbwd in gram.cu) on a batch of B > 1
// pairs in bf16: one launch of the weighted-after Hopper body
// gram_wbwd_body (gram_wgmma.cuh) in its PAIRS instance, the pair an
// index of the grid, z = pair * splits + split. It replaces the TPU
// kernel dpst_tpu/ops/gram_pallas.py:_bwd_kernel (and gram_stream.py:
// _bwd_kernel) as jax.vmap runs it, with the pair a grid dimension of the
// pallas_call:
//   dF_b = round( sum_k (S_bk . F_b) * m2_bk )
// each class's product in fp32, weighted after the product and folded in
// class order. Its bound is gram_wbwd's, B times over: operations
// (2 K C^2 P a pair) at the deep taps, bytes at conv1_1. The batch cuts
// each pair's classes as one pair's plan does (ops/gram_pallas.wbwd_plan:
// B sets only the blocks that walk a pair's p tiles), so that a pair's dF
// rounds in a batch as it does alone.
//
// The one-pair launch keeps the one-pair instance in gram.cu: a pair's
// offsets cost a batch instance registers (PR 12 measured this on the
// bias+ReLU backward's C <= 64 body), and this translation unit of its own
// leaves gram.cu's kernels compiled as they were. Split partials go to
// work (splits, B, C, P), split-major, and one fixed-order reduction over
// B C P elements sums each pair's splits in split order and rounds once:
// a pair's sum has the order of its one-pair launch.
#include "gram_wgmma.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(gram90::WNT, 1)
gram_wbwd_pairs_kernel(gram90::WbwdArgs a) {
  gram90::gram_wbwd_body<N, gram90::WSTAGES, false, gram90::WbwdArgs, true>(
      a);
}

__global__ void gram_wbwd_pairs_reduce_kernel(const float* __restrict__ work,
                                              __nv_bfloat16* __restrict__ out,
                                              int splits, long long n) {
  gram90::reduce_round(work, out, splits, n);
}

// c tiles of N rows; `groups` blocks share the 128-pixel p tiles of each
// c tile of each pair; `splits` cut the classes into ranges of kps.
template <int N>
cudaError_t launch_pairs(const gram90::WbwdArgs& args, int groups, int splits,
                         cudaStream_t st) {
  const int C = args.C, P = args.P, K = args.K, kps = args.kps;
  const int ptiles = (P + gram90::WPIX - 1) / gram90::WPIX;
  if (C > gram90::WMAXC || groups < 1 || groups > ptiles || kps < 1 ||
      (splits - 1) * kps >= K || (splits > 1 && args.work == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = gram90::wbwd_smem<N, gram90::WSTAGES>(C);
  static size_t allowed[64] = {};  // one record for each N
  cudaError_t err =
      hopper::allow_smem(gram_wbwd_pairs_kernel<N>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(groups, (C + N - 1) / N, args.pairs * splits);
  gram_wbwd_pairs_kernel<N><<<grid, gram90::WNT, smem, st>>>(args);
  if (splits > 1) {
    const long long n = static_cast<long long>(args.pairs) * C * P;
    gram_wbwd_pairs_reduce_kernel<<<dpst::grid_for(n, 256, 132 * 16), 256, 0,
                                    st>>>(args.work, args.out, splits, n);
  }
  return cudaGetLastError();
}

}  // namespace

// f and out (B, C, P), m2 (B, K, P), a the cotangent matrices (B, C, K *
// Cp) of dpst_gram_bwd, P % 8 == 0, C <= 512; work (splits, B, C, P) fp32
// when splits > 1.
extern "C" int dpst_gram_wbwd_pairs_bf16(const void* f, const void* m2,
                                         const void* a, void* work, void* out,
                                         int C, int P, int K, int B, int tile,
                                         int groups, int splits,
                                         void* stream) {
  if (P % 8 != 0 || splits < 1 || B < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const gram90::WbwdArgs args{
      static_cast<const __nv_bfloat16*>(f),
      static_cast<const __nv_bfloat16*>(m2),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(work) : nullptr, P, P, C, P, K,
      (K + splits - 1) / splits, static_cast<long long>(C) * P,
      static_cast<long long>(K) * P,
      static_cast<long long>(C) * K * ((C + 7) & ~7), B};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tile == 64) err = launch_pairs<64>(args, groups, splits, st);
  if (tile == 128) err = launch_pairs<128>(args, groups, splits, st);
  return static_cast<int>(err);
}
