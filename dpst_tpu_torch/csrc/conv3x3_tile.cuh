// The 3x3 SAME convolution tile of csrc/conv3x3.cu, shared with
// csrc/block12.cu:
//   y[co, h, w] = sum_{dy, dx, ci} x[ci, h + dy - 1, w + dx - 1] * wt[co, ci, dy, dx]
// x (Cin, H, W) and wt (Cout, Cin, 3, 3) OIHW in the compute dtype T, zero
// padding outside the image, fp32 accumulation. What happens to each fp32
// sum is the epilogue's, a template parameter, so one implicit GEMM serves:
//   EpiRound<T>      y = round_T(acc)                       (conv3x3)
//   EpiF32           y = acc, fp32                          (block12's input gradients)
//   EpiBiasRelu<T>   y = round_T(max(acc + b[co], 0)), or 0 on a row outside
//                    the image                              (block12's forward convs)
//
// Design (see conv3x3.cu for what bounds it): M = a tile of 64 output
// channels, N = a tile of 8 x 16 output pixels, K = 9 x a chunk of 32 input
// channels; for each chunk the block stages the (8 + 2) x (16 + 2) slab of
// those channels (zeros outside the image and past Cin) and the chunk's
// weights of its 64 output channels in shared memory, then runs the nine
// taps over them. bf16 tiles run on the tensor cores through nvcuda::wmma
// (16x16x16, fp32 accumulators), the slab pixel-major with 48 elements (96
// bytes) per pixel so that a fragment of 16 consecutive pixels starts on a
// 32-byte boundary at every tap shift; fp32 runs on the CUDA cores with
// fmaf. Each output is summed by one thread or one fragment in a fixed
// order: a rerun is bit-identical. Offsets into the planes are 64-bit.
#pragma once

#include <mma.h>

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
constexpr int LDC = TN + 4;          // fp32 staging of the bf16 output tile

// Shared-memory strides: slab elements per pixel and weight elements per
// (tap, output channel) row.
template <typename T>
struct Lay;
template <>
struct Lay<__nv_bfloat16> {  // wmma: 32-byte aligned fragments, ld % 8 == 0
  static constexpr int LDS = 48, LDA = 40;
};
template <>
struct Lay<float> {  // odd strides: a warp's reads fall in distinct banks
  static constexpr int LDS = 33, LDA = 33;
};

template <typename T>
constexpr int smem_bytes() {
  return (SPIX * Lay<T>::LDS + 9 * TM * Lay<T>::LDA) * static_cast<int>(sizeof(T));
}
static_assert(TM * LDC * 4 <= smem_bytes<__nv_bfloat16>(),
              "the bf16 output staging reuses the stage buffers");

// y = round_T(acc): the conv3x3 kernel's own store.
template <typename T>
struct EpiRound {
  T* y;
  __device__ __forceinline__ void operator()(size_t idx, int, int, float acc) const {
    y[idx] = from_f<T>(acc);
  }
};

// y = acc in fp32, no rounding.
struct EpiF32 {
  float* y;
  __device__ __forceinline__ void operator()(size_t idx, int, int, float acc) const {
    y[idx] = acc;
  }
};

// Row h of a stack of bands: band h / R, row h % R of it, which is global
// row (band0 + h / R) * tb - halo + h % R of an image of Hg rows.
struct BandRows {
  int R, tb, halo, Hg, band0;
  __device__ __forceinline__ bool inside(int h) const {
    const int g = (band0 + h / R) * tb - halo + h % R;
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
};

// Stage input channels [ci0, ci0 + CK): slab[pix][c] = x[ci0 + c] at the
// slab pixel pix (origin (h0 - 1, w0 - 1)), ws[tap][m][c] =
// wt[co0 + m][ci0 + c][tap]; zeros outside the image, past Cin and past
// Cout.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ x,
                                           const T* __restrict__ wt,
                                           T* __restrict__ slab,
                                           T* __restrict__ ws, int Cin,
                                           int Cout, int H, int W, int ci0,
                                           int co0, int h0, int w0) {
  constexpr int LDS = Lay<T>::LDS, LDA = Lay<T>::LDA;
  const T zero = from_f<T>(0.0f);
  const size_t hw = static_cast<size_t>(H) * W;
  for (int e = threadIdx.x; e < CK * SPIX; e += NT) {
    const int c = e / SPIX, pix = e % SPIX;
    const int ci = ci0 + c, h = h0 - 1 + pix / SW, w = w0 - 1 + pix % SW;
    T v = zero;
    if (ci < Cin && h >= 0 && h < H && w >= 0 && w < W)
      v = x[static_cast<size_t>(ci) * hw + static_cast<size_t>(h) * W + w];
    slab[pix * LDS + c] = v;
  }
  for (int e = threadIdx.x; e < TM * CK * 9; e += NT) {
    const int m = e / (CK * 9), rem = e % (CK * 9);
    const int c = rem / 9, tap = rem % 9, co = co0 + m, ci = ci0 + c;
    T v = zero;
    if (co < Cout && ci < Cin)
      v = wt[(static_cast<size_t>(co) * Cin + ci) * 9 + tap];
    ws[(tap * TM + m) * LDA + c] = v;
  }
}

template <typename T, typename Epi>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wt, Epi epi,
               int Cin, int Cout, int H, int W) {
  constexpr int LDS = Lay<T>::LDS, LDA = Lay<T>::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);
  T* ws = slab + SPIX * LDS;

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TM;
  const size_t hw = static_cast<size_t>(H) * W;

  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    // warp (wr, wc) owns output channels wr * 32 + [0, 32) and tile rows
    // wc * 4 + [0, 4): 2 x 4 fragments, each 16 channels x one row of 16
    const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
      load_stage<T>(x, wt, slab, ws, Cin, Cout, H, W, ci0, co0, h0, w0);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                a[i], ws + (tap * TM + wr * 32 + i * 16) * LDA + kk, LDA);
          // B[k][n] = slab[(row + dy, n + dx)][kk + k]: column n of the
          // fragment is one slab pixel's channel vector
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(
                b[j], slab + ((wc * 4 + j + dy) * SW + dx) * LDS + kk, LDS);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    float* cs = reinterpret_cast<float*>(smem);  // (TM, LDC), stages done
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * LDC + (wc * 4 + j) * TW,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += NT) {
      const int m = e / TN, n = e % TN;
      const int co = co0 + m, h = h0 + n / TW, w = w0 + n % TW;
      if (co < Cout && h < H && w < W)
        epi(static_cast<size_t>(co) * hw + static_cast<size_t>(h) * W + w, co, h,
            cs[m * LDC + n]);
    }
  } else {
    // thread (ty, tx) owns output channels ty + 8i and pixels (row j,
    // column tx), i, j in [0, 8)
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
      load_stage<T>(x, wt, slab, ws, Cin, Cout, H, W, ci0, co0, h0, w0);
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
          epi(static_cast<size_t>(co) * hw + static_cast<size_t>(h) * W + w, co, h,
              acc[i][j]);
      }
    }
  }
}

// Launch on `st`; returns cudaGetLastError() after the launch (or the
// error of the one-time opt-in to more than 48 KB of shared memory).
template <typename T, typename Epi>
int launch(const void* x, const void* wt, Epi epi, int Cin, int Cout, int H,
           int W, cudaStream_t st) {
  constexpr int bytes = smem_bytes<T>();
  static bool ready = false;  // above 48 KB a kernel must opt in
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<T, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Cout + TM - 1) / TM);
  conv3x3_kernel<T, Epi><<<grid, NT, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), epi, Cin, Cout, H,
      W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv
}  // namespace
