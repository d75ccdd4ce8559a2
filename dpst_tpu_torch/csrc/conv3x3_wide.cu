// The bf16 body of dpst_conv3x3 (conv3x3.cu) on N tiles of 72 to 128
// output channels, in a source of its own so that the two halves of its
// instances compile in parallel.
#include "conv3x3_tile.cuh"

int conv3x3_bf16_wide(const void* x, const void* wp, void* y, void* work,
                      int Cin, int Cout, int H, int W, int bn, int splits,
                      int cps, cudaStream_t st) {
  return conv90::launch<false>(
      x, wp, conv::EpiRound<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y)},
      static_cast<float*>(work), Cin, Cout, H, W, bn, splits, cps, 1, st,
      conv90::Widths<72, 80, 88, 96, 104, 112, 120, 128>{});
}

int conv3x3_bf16_wide_attrs(int cps, int* out) {
  return conv90::attrs<128, false, conv::EpiRound<__nv_bfloat16>>(cps, out);
}
