// The batch instance of dpst_conv3x3's bf16 body (conv3x3.cu) on N tiles
// of 8 to 64 channels: B > 1 images in one launch, the image an index of
// the grid (z = pair * splits + split), as the JAX package's vmapped
// dpst_tpu/ops/conv_pallas.py:_conv3x3_kernel takes the pair as a grid
// dimension. A source of its own, so that it compiles in parallel with
// the one-image instances and leaves them as they were.
#include "conv3x3_tile.cuh"

int conv3x3_bf16_pairs(const void* x, const void* wp, void* y, void* work,
                       int Cin, int Cout, int H, int W, int bn, int splits,
                       int cps, int B, cudaStream_t st) {
  return conv90::launch<true>(
      x, wp, conv::EpiRound<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y)},
      static_cast<float*>(work), Cin, Cout, H, W, bn, splits, cps, B, st,
      conv90::Widths<8, 16, 24, 32, 40, 48, 56, 64>{});
}
