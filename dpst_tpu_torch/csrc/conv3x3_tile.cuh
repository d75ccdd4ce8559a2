// The 3x3 SAME convolution of csrc/conv3x3.cu, shared with csrc/block12.cu:
//   y[co, h, w] = sum_{dy, dx, ci} x[ci, h + dy - 1, w + dx - 1] * w[co, ci, dy, dx]
// x (Cin, H, W) in the compute dtype T and the weights packed as (9, Cout,
// Cinp), wp[3 dy + dx][co][ci] = w[co, ci, dy, dx] with Cinp = Cin rounded
// up to 8 and zero padded (ops/conv_cuda.pack_weights); zero padding
// outside the image, fp32 accumulation. What happens to each fp32 sum is
// the epilogue's, a template parameter, so one implicit GEMM serves:
//   EpiRound<T>      y = round_T(acc)                       (conv3x3)
//   EpiF32           y = acc, fp32                          (block12's input gradients)
//   EpiBiasRelu<T>   y = round_T(max(acc + b[co], 0)), or 0 on a row outside
//                    the image                              (block12's forward convs)
// Each epilogue stores one output (operator()) or 8 consecutive outputs of
// one row (store8, 16-byte aligned).
//
// bf16 runs the Hopper body of conv3x3_wgmma.cuh (conv::launch dispatches
// to it). fp32 runs the tile below on the CUDA cores with fmaf (TF32 would
// drop mantissa bits): M = a tile of 64 output channels, N = a tile of 8 x
// 16 output pixels, K = 9 x a chunk of 32 input channels; for each chunk
// the block stages the (8 + 2) x (16 + 2) slab of those channels (zeros
// outside the image and past Cin) and the chunk's weights of its 64 output
// channels in shared memory, then runs the nine taps over them. Each output
// is summed by one thread in a fixed order: a rerun is bit-identical.
// Offsets into the planes are 64-bit.
#pragma once

#include "conv3x3_wgmma.cuh"
#include "dpst_common.cuh"

// Internal linkage: each translation unit that includes this header gets
// its own kernels (no device-code linking between the sources).
namespace {
namespace conv {

using dpst::from_f;

constexpr int TM = 64;               // output channels per block
constexpr int TH = 8;                // output rows per block
constexpr int TW = 16;               // output columns per block
constexpr int TN = TH * TW;          // output pixels per block
constexpr int CK = 32;               // input channels per stage
constexpr int NT = 128;              // threads per block (4 warps)
constexpr int SW = TW + 2;           // slab columns (with the halo)
constexpr int SPIX = (TH + 2) * SW;  // slab pixels
// Shared-memory strides of the fp32 tile: slab elements per pixel and
// weight elements per (tap, output channel) row; odd, so that a warp's
// reads fall in distinct banks.
constexpr int LDS = 33, LDA = 33;
constexpr int SMEM_BYTES = (SPIX * LDS + 9 * TM * LDA) * 4;

// 8 fp32 values to y[0..8) (16-byte aligned): rounded to bf16 in one
// 16-byte store, or two 16-byte stores in fp32.
__device__ __forceinline__ void put8(__nv_bfloat16* y, const float (&v)[8]) {
  __nv_bfloat162 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(y) = *reinterpret_cast<const uint4*>(r);
}
__device__ __forceinline__ void put8(float* y, const float (&v)[8]) {
  *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(y + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// y = round_T(acc): the conv3x3 kernel's own store.
template <typename T>
struct EpiRound {
  T* y;
  __device__ __forceinline__ void operator()(size_t idx, int, int, float acc) const {
    y[idx] = from_f<T>(acc);
  }
  __device__ __forceinline__ void store8(size_t idx, int, int,
                                         const float (&v)[8]) const {
    put8(y + idx, v);
  }
};

// y = acc in fp32, no rounding.
struct EpiF32 {
  float* y;
  __device__ __forceinline__ void operator()(size_t idx, int, int, float acc) const {
    y[idx] = acc;
  }
  __device__ __forceinline__ void store8(size_t idx, int, int,
                                         const float (&v)[8]) const {
    put8(y + idx, v);
  }
};

// Row h of a stack of bands: band h / R, row h % R of it, which is global
// row b * tb - halo + h % R of an image of Hg rows in nb bands, b = (band0
// + h / R) mod nb (a stack of a batch's bands runs on into the next pair's
// first band; band0 < nb and a stack holds at most nb bands).
struct BandRows {
  int R, tb, halo, Hg, band0, nb;
  __device__ __forceinline__ bool inside(int h) const {
    int b = band0 + h / R;
    if (b >= nb) b -= nb;
    const int g = b * tb - halo + h % R;
    return g >= 0 && g < Hg;
  }
};

// y = round_T(max(acc + b[co], 0)) with the bias added in fp32, or 0 where
// the row lies outside the global image (relu(b) need not be 0 there).
template <typename T>
struct EpiBiasRelu {
  T* y;
  const float* bias;
  BandRows rows;
  __device__ __forceinline__ void operator()(size_t idx, int co, int h,
                                             float acc) const {
    y[idx] = rows.inside(h) ? from_f<T>(fmaxf(acc + bias[co], 0.0f)) : from_f<T>(0.0f);
  }
  __device__ __forceinline__ void store8(size_t idx, int co, int h,
                                         const float (&v)[8]) const {
    const bool in = rows.inside(h);
    const float b = bias[co];
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = in ? fmaxf(v[i] + b, 0.0f) : 0.0f;
    put8(y + idx, r);
  }
};

// Stage input channels [ci0, ci0 + CK): slab[pix][c] = x[ci0 + c] at the
// slab pixel pix (origin (h0 - 1, w0 - 1)), ws[tap][m][c] =
// wp[tap][co0 + m][ci0 + c]; zeros outside the image, past Cin and past
// Cout.
__device__ __forceinline__ void load_stage(const float* __restrict__ x,
                                           const float* __restrict__ wp,
                                           float* __restrict__ slab,
                                           float* __restrict__ ws, int Cin,
                                           int Cout, int H, int W, int ci0,
                                           int co0, int h0, int w0) {
  const size_t hw = static_cast<size_t>(H) * W;
  const int cinp = (Cin + 7) & ~7;
  for (int e = threadIdx.x; e < CK * SPIX; e += NT) {
    const int c = e / SPIX, pix = e % SPIX;
    const int ci = ci0 + c, h = h0 - 1 + pix / SW, w = w0 - 1 + pix % SW;
    float v = 0.0f;
    if (ci < Cin && h >= 0 && h < H && w >= 0 && w < W)
      v = x[static_cast<size_t>(ci) * hw + static_cast<size_t>(h) * W + w];
    slab[pix * LDS + c] = v;
  }
  for (int e = threadIdx.x; e < 9 * TM * CK; e += NT) {
    const int c = e % CK, rem = e / CK;
    const int m = rem % TM, tap = rem / TM, co = co0 + m, ci = ci0 + c;
    float v = 0.0f;
    if (co < Cout && ci < Cin)
      v = wp[(static_cast<size_t>(tap) * Cout + co) * cinp + ci];
    ws[(tap * TM + m) * LDA + c] = v;
  }
}

// The fp32 tile: thread (ty, tx) owns output channels co0 + ty + 8i and
// pixels (h0 + j, w0 + tx), i, j in [0, 8), of the image blockIdx.z of a
// batch (x (B, Cin, H, W), the outputs at its (Cout, H, W) planes).
template <typename Epi>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wp,
               Epi epi, int Cin, int Cout, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem);
  float* ws = slab + SPIX * LDS;

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TM;
  const size_t hw = static_cast<size_t>(H) * W;
  x += blockIdx.z * Cin * hw;
  const size_t ob = blockIdx.z * Cout * hw;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    load_stage(x, wp, slab, ws, Cin, Cout, H, W, ci0, co0, h0, w0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* wa = ws + (tap * TM + ty) * LDA;
      const float* xb = slab + (dy * SW + tx + dx) * LDS;
#pragma unroll 4
      for (int c = 0; c < CK; ++c) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = wa[i * 8 * LDA + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = xb[j * SW * LDS + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  const int w = w0 + tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = h0 + j;
      if (co < Cout && h < H && w < W)
        epi(ob + static_cast<size_t>(co) * hw + static_cast<size_t>(h) * W + w,
            co, h, acc[i][j]);
    }
  }
}

// Launch on `st` with one split; returns cudaGetLastError() after the
// launch (or the error of the opt-in to more than 48 KB of shared memory).
// bf16 takes the Hopper body's one-image instance on N tiles of
// conv90::width(Cout) channels, which must be among `Widths`; fp32 takes
// `pairs` images, one a grid index.
template <typename T, typename Epi, typename Widths>
int launch(const void* x, const void* wp, Epi epi, int Cin, int Cout, int H,
           int W, cudaStream_t st, int pairs = 1) {
  if constexpr (sizeof(T) == 2) {
    return conv90::launch<false>(x, wp, epi, nullptr, Cin, Cout, H, W,
                                 conv90::width(Cout), 1,
                                 (Cin + conv90::BK - 1) / conv90::BK, pairs,
                                 st, Widths{});
  } else {
    if (pairs < 1 || pairs > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    static size_t allowed[64] = {};
    const cudaError_t err = hopper::allow_smem(conv3x3_kernel<Epi>,
                                               SMEM_BYTES, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                    (Cout + TM - 1) / TM, pairs);
    conv3x3_kernel<Epi><<<grid, NT, SMEM_BYTES, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp), epi, Cin,
        Cout, H, W);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace conv
}  // namespace
