// 3x3 SAME convolution of one image, stride 1, no bias:
//   y[co, h, w] = sum_{dy, dx, ci} x[ci, h + dy - 1, w + dx - 1] * wt[co, ci, dy, dx]
// x (Cin, H, W), wt (Cout, Cin, 3, 3) OIHW and y (Cout, H, W), all in the
// compute dtype, zero padding outside the image, fp32 accumulation and one
// rounding of each output to the compute dtype.
//
// Replaces the TPU kernel dpst_tpu/ops/conv_pallas.py:_conv3x3_kernel
// (launched by _conv3x3_padded). As there, one kernel serves both
// directions: the input gradient is conv3x3(g, flip_transpose(wt)) with
// flip_transpose(wt)[ci, co, dy, dx] = wt[co, ci, 2 - dy, 2 - dx]. The TPU
// kernel's one idea is kept: the input slab of a tile, with a one-pixel
// halo, enters fast memory once and all nine shifted taps read it there.
// The tile, an implicit GEMM, lives in conv3x3_tile.cuh (shared with
// block12.cu, which changes only its epilogue); here each fp32 sum is
// rounded once to the compute dtype (conv::EpiRound).
//
// What bounds it on the H100: operations. At the VGG-19 shapes of a 512^2
// image the layers do 2 * 9 * Cin * Cout * P = 4.8 to 19.3 GFLOP each on
// 7 to 67 MB of bf16 data, above the card's 295 bf16 operations a byte.
// bf16 tiles run on the tensor cores through warp-level mma (nvcuda::wmma),
// fp32 on the CUDA cores with fmaf (fp32 has no exact tensor-core path:
// TF32 would drop mantissa bits). No split over K and no atomics: each
// output is summed by one thread or one fragment in a fixed order, so a
// rerun is bit-identical. wgmma, TMA and a pipeline of stages are left for
// later work.
#include "conv3x3_tile.cuh"

// x: (Cin, H, W), wt: (Cout, Cin, 3, 3), y: (Cout, H, W), one dtype.
extern "C" int dpst_conv3x3(const void* x, const void* wt, void* y, int Cin,
                            int Cout, int H, int W, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DPST_DTYPE_F32)
    return conv::launch<float>(x, wt, conv::EpiRound<float>{static_cast<float*>(y)},
                               Cin, Cout, H, W, st);
  if (dtype == DPST_DTYPE_BF16)
    return conv::launch<__nv_bfloat16>(
        x, wt, conv::EpiRound<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y)}, Cin,
        Cout, H, W, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
