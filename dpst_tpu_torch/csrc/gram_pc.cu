// The (P, C) forms of the bf16 masked-Gram forward and backward: gram_fwd,
// gram_relu_fwd and gram_bwd (entry points dpst_gram_fwd, dpst_gram_relu_fwd
// and dpst_gram_bwd in gram.cu, with pc = 1) on a tap that lies as a
// channels_last activation holds it, f (B, P, C) in memory, P rows of C
// channels:
//   forward   G_k = F . round(F * m2_k)^T in fp32   (gram_relu_fwd: F =
//             round(max(z + b, 0)), z + b in fp32)
//   backward  dF  = round( sum_{k,c'} S_k[c][c'] * round(F[c'][p] * m2_k) )
// the same functions, in the same summation order, as the (C, P) forms:
// they run the Hopper bodies of gram_wgmma.cuh in their PC instances (see
// there), which read each tile through the other orientation of its wgmma
// operand. They replace the same TPU kernels as their (C, P) twins
// (dpst_tpu/ops/gram_stream.py:_fwd_kernel and :_bwd_kernel, and
// dpst_tpu/ops/gram_s2d.py:_fwd_kernel2 and :_fwd_kernel), whose taps are
// NHWC on the TPU too.
//
// Why a form of their own: cuDNN's bf16 kernels on the H100 are NHWC, so a
// VGG that keeps its activations NCHW pays a transpose of every conv's
// input and output both ways. With the activations channels_last, a tap
// reaches these kernels as (B, C, P) with stride 1 on C; copying it to (C,
// P) would move the transposes into ATen copies and keep the copies alive
// for the backward. So the forms read it where it lies, and the backward
// writes dF in the same order.
//
// The masks stay (B, K, P8) rows, P8 = P rounded up to 8 (the wrapper pads
// them with zeros); the plans (ops/gram_stream.fwd_plan, bwd_plan) are the
// (C, P) form's at P8. dF is (B, P, C) in memory; a backward's split
// partials are (splits, B, P, C), summed in split order and rounded once.
// Only the kernels live here, in a translation unit of their own, so that
// gram.cu's compile as they did without them; gram.cu launches them (its
// launch code templated on PC) through the handles below.
#include "gram_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(gram90::NT)
gram_fwd_pc_wgmma_kernel(gram90::FwdArgs a) {
  gram90::gram_fwd_body<false, true>(a);
}

__global__ void __launch_bounds__(gram90::NT)
gram_relu_fwd_pc_wgmma_kernel(gram90::FwdArgs a) {
  gram90::gram_fwd_body<true, true>(a);
}

template <int N, bool PAIRS = false>
__global__ void __launch_bounds__(gram90::NT)
gram_bwd_pc_wgmma_kernel(gram90::BwdArgs a) {
  gram90::gram_bwd_body<N, gram90::BwdRound, PAIRS, true>(
      a, gram90::BwdRound{});
}

template <typename Kern>
const void* handle(Kern* kern) {
  return reinterpret_cast<const void*>(kern);
}

}  // namespace

namespace gram_pc {

const void* fwd_kernel(bool relu) {
  return relu ? handle(gram_relu_fwd_pc_wgmma_kernel)
              : handle(gram_fwd_pc_wgmma_kernel);
}

const void* bwd_kernel(int n, bool pairs) {
  if (n == 64)
    return pairs ? handle(gram_bwd_pc_wgmma_kernel<64, true>)
                 : handle(gram_bwd_pc_wgmma_kernel<64, false>);
  return pairs ? handle(gram_bwd_pc_wgmma_kernel<128, true>)
               : handle(gram_bwd_pc_wgmma_kernel<128, false>);
}

}  // namespace gram_pc
