// The (P, C) forms of the bf16 masked-Gram backwards that weight by m2
// after the product: gram_wbwd and gram_relu_bwd (entry points
// dpst_gram_wbwd in gram.cu and dpst_gram_relu_bwd in gram.cu /
// gram_relu_bwd.cu, with pc = 1) on a tap that lies as a channels_last
// activation holds it, f or z (B, P, C) in memory:
//   gram_wbwd      dF = round( sum_k (S_k . F) * m2_k )
//   gram_relu_bwd  dz = round( relu'(z + b) * sum_k (S_k . F) * m2_k ),
//                  F = round(max(z + b, 0)), z + b in fp32
// each class's product in fp32, weighted after the product and folded in
// class order, as their (C, P) twins compute them: the Hopper bodies of
// gram_wgmma.cuh in their PC instances (gram_wbwd_body; at C <= 64 and K
// <= gram90::RMAXK with one split, gram_relu_bwd64_body). They replace the
// same TPU kernels (dpst_tpu/ops/gram_pallas.py:_bwd_kernel and
// gram_stream.py:_bwd_kernel; gram_s2d.py:_bwd_kernel2 and :_bwd_kernel).
// gram_pc.cu says why the form exists.
//
// dF and dz are written (B, P, C) in memory, so that autograd hands the
// bias+ReLU backward a channels_last cotangent; the masks are (B, K, P8)
// rows, P8 = P rounded up to 8, and the plans (ops/gram_pallas.wbwd_plan,
// ops/gram_s2d.relu_bwd_plan) the (C, P) form's at P8. Split partials are
// (splits, B, P, C), summed in split order and rounded once. Only the
// kernels live here; their twins' launch code (gram.cu's gram_wbwd,
// gram_relu_bwd.cu's), templated on PC, launches them through the handles
// below.
#include "gram_wgmma.cuh"

namespace {

template <int N, bool PAIRS = false>
__global__ void __launch_bounds__(gram90::WNT, 1)
gram_wbwd_pc_wgmma_kernel(gram90::WbwdArgs a) {
  gram90::gram_wbwd_body<N, gram90::WSTAGES, false, gram90::WbwdArgs, PAIRS,
                         true>(a);
}

template <int N, bool PAIRS = false>
__global__ void __launch_bounds__(gram90::WNT, 1)
gram_relu_bwd_pc_wgmma_kernel(gram90::ReluBwdArgs a) {
  gram90::gram_wbwd_body<N, gram90::WSTAGES, true, gram90::ReluBwdArgs,
                         PAIRS, true>(a);
}

template <bool PAIRS = false>
__global__ void __launch_bounds__(gram90::RWG * gram90::NT, 1)
gram_relu_bwd64_pc_wgmma_kernel(gram90::ReluBwdArgs a) {
  gram90::gram_relu_bwd64_body<gram90::RNS, gram90::RWG, PAIRS, true>(a);
}

template <typename Kern>
const void* handle(Kern* kern) {
  return reinterpret_cast<const void*>(kern);
}

}  // namespace

namespace gram_pc {

const void* wbwd_kernel(int n, bool pairs) {
  if (n == 64)
    return pairs ? handle(gram_wbwd_pc_wgmma_kernel<64, true>)
                 : handle(gram_wbwd_pc_wgmma_kernel<64, false>);
  return pairs ? handle(gram_wbwd_pc_wgmma_kernel<128, true>)
               : handle(gram_wbwd_pc_wgmma_kernel<128, false>);
}

const void* relu_bwd_kernel(int n, bool pairs) {
  if (n == 64)
    return pairs ? handle(gram_relu_bwd_pc_wgmma_kernel<64, true>)
                 : handle(gram_relu_bwd_pc_wgmma_kernel<64, false>);
  return pairs ? handle(gram_relu_bwd_pc_wgmma_kernel<128, true>)
               : handle(gram_relu_bwd_pc_wgmma_kernel<128, false>);
}

const void* relu_bwd64_kernel(bool pairs) {
  return pairs ? handle(gram_relu_bwd64_pc_wgmma_kernel<true>)
               : handle(gram_relu_bwd64_pc_wgmma_kernel<false>);
}

}  // namespace gram_pc
