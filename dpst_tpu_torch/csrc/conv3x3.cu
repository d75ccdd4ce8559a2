// 3x3 SAME convolution of a batch of B images, stride 1, no bias:
//   y[b, co, h, w] = sum_{dy, dx, ci} x[b, ci, h + dy - 1, w + dx - 1] * w[co, ci, dy, dx]
// x (B, Cin, H, W) and y (B, Cout, H, W) in the compute dtype, the weights packed
// as (9, Cout, Cinp) (ops/conv_cuda.pack_weights), zero padding outside
// the image, fp32 accumulation and one rounding of each output to the
// compute dtype.
//
// Replaces the TPU kernel dpst_tpu/ops/conv_pallas.py:_conv3x3_kernel
// (launched by _conv3x3_padded). As there, one kernel serves both
// directions: the input gradient is conv3x3(g, flip_transpose(w)) with
// flip_transpose(w)[ci, co, dy, dx] = w[co, ci, 2 - dy, 2 - dx], packed
// once per run like the forward weights. The TPU kernel's one idea is
// kept: the input slab of a tile, with a one-pixel halo, enters fast
// memory once and all nine shifted taps read it there. The bodies live in
// headers shared with block12.cu, which changes only the epilogue: bf16 in
// conv3x3_wgmma.cuh (wgmma on a cp.async ring; its note gives the bound,
// operations at 2 * 9 * Cin * Cout * P, and what each part of the design
// does about it), fp32 in conv3x3_tile.cuh (CUDA cores, fmaf: fp32 has no
// exact tensor-core path). Here each fp32 sum is rounded once to the
// compute dtype (conv::EpiRound). In bf16 the caller's plan
// (ops/conv_cuda.conv_plan) may split Cin into fp32 partials, summed in a
// fixed order: no atomics, so a rerun is bit-identical. A batch (the JAX
// package's vmapped pallas_call) is one launch with the image an index of
// the grid; in bf16 B > 1 takes the body's batch instance, compiled in
// conv3x3_pairs.cu and conv3x3_pairs_wide.cu, and one image the
// one-image instance, as before the batch.
#include "conv3x3_tile.cuh"

// The bf16 body on N tiles of 72 to 128 channels, compiled in
// conv3x3_wide.cu (the build runs one nvcc a source, in parallel), and
// the batch instances of both halves.
int conv3x3_bf16_wide(const void* x, const void* wp, void* y, void* work,
                      int Cin, int Cout, int H, int W, int bn, int splits,
                      int cps, cudaStream_t st);
int conv3x3_bf16_wide_attrs(int cps, int* out);
int conv3x3_bf16_pairs(const void* x, const void* wp, void* y, void* work,
                       int Cin, int Cout, int H, int W, int bn, int splits,
                       int cps, int B, cudaStream_t st);
int conv3x3_bf16_pairs_wide(const void* x, const void* wp, void* y,
                            void* work, int Cin, int Cout, int H, int W,
                            int bn, int splits, int cps, int B,
                            cudaStream_t st);

// x: (B, Cin, H, W), wp: (9, Cout, Cinp), y: (B, Cout, H, W), one dtype.
// bf16 only: N tiles of bn output channels (a multiple of 8 up to 128),
// `splits` ranges of `cps` chunks of 64 input channels, each non-empty,
// and work (B, splits, Cout, H, W) fp32 when splits > 1; fp32 ignores the
// four.
extern "C" int dpst_conv3x3(const void* x, const void* wp, void* y, void* work,
                            int Cin, int Cout, int H, int W, int B, int bn,
                            int splits, int cps, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DPST_DTYPE_F32)
    return conv::launch<float, conv::EpiRound<float>, conv90::Widths<>>(
        x, wp, conv::EpiRound<float>{static_cast<float*>(y)}, Cin, Cout, H, W,
        st, B);
  if (dtype == DPST_DTYPE_BF16 && B > 1)
    return (bn > 64 ? conv3x3_bf16_pairs_wide : conv3x3_bf16_pairs)(
        x, wp, y, work, Cin, Cout, H, W, bn, splits, cps, B, st);
  if (dtype == DPST_DTYPE_BF16 && bn > 64)
    return conv3x3_bf16_wide(x, wp, y, work, Cin, Cout, H, W, bn, splits, cps,
                             st);
  if (dtype == DPST_DTYPE_BF16)
    return conv90::launch<false>(
        x, wp, conv::EpiRound<__nv_bfloat16>{static_cast<__nv_bfloat16*>(y)},
        static_cast<float*>(work), Cin, Cout, H, W, bn, splits, cps, 1, st,
        conv90::Widths<8, 16, 24, 32, 40, 48, 56, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resources of the bf16 body for N tiles of bn channels (8, 64 or 128)
// summing cps chunks a block (at bn <= 64 one chunk and more take two
// bodies), for the record: registers a thread, local memory bytes a
// thread, dynamic shared memory bytes a block, resident blocks an SM.
extern "C" int dpst_conv3x3_attrs(int bn, int cps, int* out) {
  cudaGetLastError();  // clear an error left by an earlier call
  using Epi = conv::EpiRound<__nv_bfloat16>;
  if (bn == 8) return conv90::attrs<8, false, Epi>(cps, out);
  if (bn == 64) return conv90::attrs<64, false, Epi>(cps, out);
  if (bn == 128) return conv3x3_bf16_wide_attrs(cps, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
