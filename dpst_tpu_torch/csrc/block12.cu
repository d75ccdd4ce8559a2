// VGG-19 blocks 1-2 streamed in bands of rows: conv1_1 -> conv1_2 -> pool1
// -> conv2_1 -> conv2_2 -> pool2 with the masked Gram sums of conv1_1 and
// conv2_1, and the backward of all of it to the preprocessed image, without
// a block-1/2 activation at full resolution.
//
// Replaces the TPU kernels of dpst_tpu/ops/block12_pallas.py:
//   dpst_block12_fwd, save_res = 0   _fwd_kernel          (block12_fwd)
//   dpst_block12_fwd, save_res = 1   _fwd_res_kernel      (block12_fwd_res)
//   dpst_block12_bwd_deep            _bwd_deep_kernel     (block12_bwd, B2)
//   dpst_block12_bwd_shallow         _bwd_shallow_kernel  (block12_bwd, B1)
// and computes their functions with their rounding points:
//   * every forward conv sums in fp32, adds the bias in fp32, takes the
//     ReLU, zeroes the rows outside the global image and rounds once to the
//     compute dtype T; the image enters in fp32 and is rounded to T once;
//     rows outside the image are zero in preprocessed space;
//   * max pool is exact; avg pool is ((a + b) + c) + d rounded to T after
//     each add, then * 0.25;
//   * the Gram partials: G_k[i][j] = sum_p f[i][p] * round_T(round_T(m2_k[p])
//     * f[j][p]) over the band's own rows, fp32 sums, added to the result in
//     band order;
//   * the backward: the pool backward splits a max among tied maxima
//     (compare in fp32, q = dp / ties in fp32, one rounding after the
//     product) and multiplies by relu' = (a > 0); the input-gradient convs
//     keep fp32; the Gram cotangent sum_k round_T(dG_k + dG_k^T) .
//     round_T(round_T(m2_k) * f) is fp32; da = conv_T + gram in fp32, times
//     relu', rounded once; dp1 is rounded to T, dx stays fp32.
//
// Design. The TPU kernel holds a whole 32-row tile of all four layers in
// VMEM; one such tile at W = 4096 is 16 MB of conv1_1 activations against
// the H100's 227 KB of shared memory. So each entry point walks the image
// in bands of tb own rows with the TPU kernel's halo (8 rows at full
// resolution, 4 at half, 2 at quarter) and recomputes the halo as it does.
// The bands live in device memory, not on chip, so tb is not the TPU's 32:
// the wrapper picks it from the image shape (block12_pallas.band_rows: the
// tallest of 256, 128, 64, 32 that divides H with at most 2^20 own pixels a
// band), and every stage walks (tb + 16) / tb of the own rows, 1.0625 at
// 4096^2. A group of `group` consecutive bands is processed at once, each
// band's rows (own rows plus halo) stacked one band after another in a
// scratch the wrapper allocates for that group only (the launches then
// fill the card). For a group, each stage is one launch
// on the current stream: the band copies (gather with zero fill and a cast,
// scatter of the own rows; a warp a row, the source row found once a row,
// 16-byte vectors along W with a scalar tail, scalars where a row does not
// start on a 16-byte boundary), the 3x3 conv (conv::launch of
// conv3x3_tile.cuh: in bf16 the wgmma body of conv3x3_wgmma.cuh, conv1_1's
// 3 input channels as one K of 32; in fp32 the CUDA-core tile) with its
// bias+ReLU+row-mask epilogue (forward) or its fp32 epilogue (input
// gradients), on weights packed once per run
// (ops/block12_pallas.pack_weights), the 2x2 pool forward, the pool
// backward with relu', the Gram partials (in bf16 gram_fwd's Hopper body
// of gram_wgmma.cuh on each band's own rows, the group's m^2 rounded to
// bf16 once; in fp32 the gram_tile.cuh tile; P split within each band) and
// the Gram cotangent. In bf16 that is gram_bwd's Hopper body (wgmma on a
// cp.async ring, the weighted operand formed in registers, the cotangent
// as the (C, K * C) matrix of gram_stream.s_matrix), one split, with an
// epilogue that adds the fp32 conv term and multiplies by relu' before the
// one rounding; the masks are gathered already rounded to bf16, and it
// walks only the rows of each band that reach an own output row (Geom's
// dz_lo, dz_hi: tb + 2 of tb + 16, tb / 2 + 2 of tb / 2 + 8). In fp32 it
// is the gram_bwd tile of gram_tile.cuh on every row, with the same
// epilogue. A conv reading the
// stacked bands sees the next band's first row where the TPU kernel sees
// a zero pad: both only reach rows of the halo that the shrinking valid
// region drops before the own rows. The Gram partials go to one slot per
// (band, split) and are summed slot by slot in band order into the
// result: no float atomics, so a rerun is bit-identical.
//
// A batch of B pairs (the reference vmaps the whole loop, so its
// pallas_calls take the pair as a grid dimension) is one call of each
// entry point: the walk's unit is a (pair, band), B * H / tb of them
// pair-major, and a group is `group` consecutive units, which may run from
// one pair's last bands into the next pair's first. The scratch is one
// pair's, whatever B is. Each stage addresses its unit's pair: the band
// copies read and write the pair's planes, the conv epilogues take the
// band modulo H / tb, the Gram partials of a pair's units are summed into
// its own sums (from zero at its first band), and the Gram cotangent
// stage runs once for each pair the group holds, on its bands with its
// cotangent. A band's arithmetic and a pair's order of Gram partials are
// those of its one-pair launch, so each pair's outputs equal it bit for
// bit.
//
// What bounds it on the H100: operations. A 4096^2 forward does 2 * 9 * P
// * (3 * 64 + 64 * 64 + (64 * 128 + 128 * 128) / 4) = 3.2 TFLOP of convs
// (3.2 ms at the bf16 peak), the Grams 0.1 TFLOP; it reads 0.5 GB of image
// and masks. The recomputed halo adds 16 / tb of every stage's rows: 50 %
// at tb = 32, 6.25 % at the tb = 256 that 4096^2 takes, so the band height
// is the largest the scratch of one group allows. By stage, at 4096^2, K
// = 4, bf16: the convs by operations; the Gram cotangent by bytes (each
// walked pixel reads its tap, m^2 and fp32 conv term and writes dz: 520
// bytes at C = 64, 1032 at 128; 8.8 + 4.4 GB, 2.6 + 1.3 ms at tb = 256,
// against 0.55 + 0.56 TFLOP); the band copies and pools by bytes. The
// convs, Gram partials and Gram cotangent run on the tensor cores through
// wgmma (PERF.md has their times); the pools keep their first design, the
// halo is recomputed, and a fusion of the stages into one kernel is left
// for later work. Every offset that can pass 2^31 is 64-bit (a group's
// pixel indices fit an int) and every entry point returns
// cudaGetLastError() after its last launch, or the first error of an
// earlier one.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "conv3x3_tile.cuh"
#include "gram_tile.cuh"
#include "gram_wgmma.cuh"

namespace {

using dpst::from_f;
using dpst::to_f;

constexpr int TB_MIN = 32;        // own rows of a band divide by it
constexpr int HALO = 8;           // full-resolution halo rows on each side
constexpr int GRAM_CHUNK = 4096;  // pixels of a Gram split (a multiple of 128)
constexpr int EW_THREADS = 256;
constexpr int EW_BLOCKS = 132 * 16;

#define B12_TRY(expr)              \
  do {                             \
    const int rc_ = (expr);        \
    if (rc_ != 0) return rc_;      \
  } while (0)

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// One row of a band copy, n elements from s to d cast to To (s null: zeros),
// by the 32 lanes of a warp: 16-byte vectors of Ti (V elements) where both
// rows start on a vector boundary, then a scalar tail; rows that do not
// (rows of W/4 = 65 bf16 are 130 bytes, so most start off a boundary) go
// by scalars. The casts: none, or fp32 to bf16 rounded to nearest even.
template <typename Ti, typename To>
__device__ __forceinline__ void copy_row(const Ti* __restrict__ s,
                                         To* __restrict__ d, int n,
                                         int lane) {
  static_assert(std::is_same_v<Ti, To> ||
                    (std::is_same_v<Ti, float> &&
                     std::is_same_v<To, __nv_bfloat16>),
                "band copies keep the type or round fp32 to bf16");
  constexpr int V = 16 / sizeof(Ti);
  constexpr int DB = V * sizeof(To);  // bytes a lane stores a vector
  using Out = std::conditional_t<DB == 16, uint4, uint2>;
  int done = 0;
  if (reinterpret_cast<uintptr_t>(d) % DB == 0 &&
      reinterpret_cast<uintptr_t>(s) % 16 == 0) {
    const int nv = n / V;
    Out* dv = reinterpret_cast<Out*>(d);
    if (s == nullptr) {
      for (int i = lane; i < nv; i += 32) dv[i] = Out{};
    } else {
      const uint4* sv = reinterpret_cast<const uint4*>(s);
#pragma unroll 4
      for (int i = lane; i < nv; i += 32) {
        const uint4 x = sv[i];
        if constexpr (std::is_same_v<Ti, To>) {
          dv[i] = x;
        } else {
          float4 v;
          memcpy(&v, &x, 16);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          Out o;
          memcpy(&o.x, &lo, 4);
          memcpy(&o.y, &hi, 4);
          dv[i] = o;
        }
      }
    }
    done = nv * V;
  }
  for (int i = done + lane; i < n; i += 32)
    d[i] = s ? from_f<To>(to_f(s[i])) : from_f<To>(0.0f);
}

// The units of a batch's walk: unit u is band u % nb of pair u / nb (nb
// bands a pair, pair-major), and a group is NB consecutive units, which
// may run from one pair into the next. row0 is the first row of unit u's
// band in the pair-major (B * C, H, W) stack of a plane with C channels.
struct Unit {
  int pair, band;
  __device__ __host__ Unit(int u, int nb) : pair(u / nb), band(u - u / nb * nb) {}
  __device__ __host__ long long plane(int C, long long c) const {
    return static_cast<long long>(pair) * C + c;
  }
};

// dst (C, NB * R, W): row r of the stack's band b is row band * tb - halo
// + r of its unit's pair in src (B, C, Hs, W) (unit u0 + b of nb bands a
// pair), cast to To, or zero outside [0, Hs). A warp a row.
template <typename Ti, typename To>
__global__ void block12_gather_kernel(const Ti* __restrict__ src,
                                      To* __restrict__ dst, int C, int Hs,
                                      int W, int NB, int R, int tb, int halo,
                                      int u0, int nb) {
  const long long per = static_cast<long long>(NB) * R, rows = C * per;
  const int lane = threadIdx.x & 31;
  const long long nw = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long row = (blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x) >> 5;
       row < rows; row += nw) {
    const long long c = row / per;
    const int rr = static_cast<int>(row - c * per);
    const Unit un(u0 + rr / R, nb);
    const int g = un.band * tb - halo + rr % R;
    copy_row<Ti, To>(g >= 0 && g < Hs ? src + (un.plane(C, c) * Hs + g) * W
                                      : nullptr,
                     dst + row * W, W, lane);
  }
}

// dst (B, C, Hd, W): rows band * tb + [0, tb) of the pair of unit u0 + b =
// src (C, NB * R, W) rows b * R + halo + [0, tb), cast to To. A warp a
// row.
template <typename Ti, typename To>
__global__ void block12_scatter_kernel(const Ti* __restrict__ src,
                                       To* __restrict__ dst, int C, int Hd,
                                       int W, int NB, int R, int tb, int halo,
                                       int u0, int nb) {
  const long long per = static_cast<long long>(NB) * tb, rows = C * per;
  const int lane = threadIdx.x & 31;
  const long long nw = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long row = (blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x) >> 5;
       row < rows; row += nw) {
    const long long c = row / per;
    const int rr = static_cast<int>(row - c * per);
    const int b = rr / tb, r = rr - b * tb;
    const Unit un(u0 + b, nb);
    const long long srow = c * NB * R + static_cast<long long>(b) * R + halo + r;
    const long long drow = un.plane(C, c) * Hd +
                           static_cast<long long>(un.band) * tb + r;
    copy_row<Ti, To>(src + srow * W, dst + drow * W, W, lane);
  }
}

// 2x2/2 pool of x (C, H, W), H and W even -> y (C, H/2, W/2).
template <typename T, bool AVG>
__global__ void block12_pool_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    int C, int H, int W) {
  const int h2 = H / 2, w2 = W / 2;
  const long long total = static_cast<long long>(C) * h2 * w2;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % w2);
    const long long t = idx / w2;
    const int i = static_cast<int>(t % h2);
    const long long c = t / h2;
    const long long base = (c * H + 2 * i) * W + 2 * j;
    const float a = to_f(x[base]), b = to_f(x[base + 1]);
    const float cc = to_f(x[base + W]), d = to_f(x[base + W + 1]);
    if constexpr (AVG) {
      T s = from_f<T>(a + b);
      s = from_f<T>(to_f(s) + cc);
      s = from_f<T>(to_f(s) + d);
      y[idx] = from_f<T>(to_f(s) * 0.25f);
    } else {
      y[idx] = from_f<T>(fmaxf(fmaxf(a, b), fmaxf(cc, d)));
    }
  }
}

// Pool backward times relu': dz (C, H, W) from dp (C, H/2, W/2) and the
// pre-pool activation x (C, H, W), zero where x <= 0.
template <typename T, bool AVG>
__global__ void block12_pool_bwd_kernel(const T* __restrict__ dp,
                                        const T* __restrict__ x,
                                        T* __restrict__ dz, int C, int H,
                                        int W) {
  const int h2 = H / 2, w2 = W / 2;
  const long long total = static_cast<long long>(C) * h2 * w2;
  const T zero = from_f<T>(0.0f);
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % w2);
    const long long t = idx / w2;
    const int i = static_cast<int>(t % h2);
    const long long c = t / h2;
    const long long o[4] = {(c * H + 2 * i) * W + 2 * j,
                            (c * H + 2 * i) * W + 2 * j + 1,
                            (c * H + 2 * i + 1) * W + 2 * j,
                            (c * H + 2 * i + 1) * W + 2 * j + 1};
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = to_f(x[o[q]]);
    const float g = to_f(dp[idx]);
    float e[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    float qv;
    if constexpr (AVG) {
      qv = g * 0.25f;
    } else {
      const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = v[q] == m ? 1.0f : 0.0f;
      qv = g / (((e[0] + e[1]) + e[2]) + e[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dz[o[q]] = v[q] > 0.0f ? from_f<T>(qv * e[q]) : zero;
  }
}

// Gram partials of a group: block (tile, k, b * S + s) sums the pixels
// [s * chunk, min(P_b, (s + 1) * chunk)) of band b's own rows, P_b = tb * W,
// into work[((b * S + s) * K + k)]. f is the stacked (C, NB * R, W) tap,
// m the global (B, K, Hg, W) fp32 m^2, band b that of unit u0 + b.
template <typename T>
__global__ void __launch_bounds__(gram::NT)
block12_gram_kernel(const T* __restrict__ f, const float* __restrict__ m,
                    float* __restrict__ work, int C, int K, int W, int NB,
                    int R, int tb, int halo, int Hg, int u0, int nb, int S,
                    int chunk) {
  const int tiles = (C + gram::TN - 1) / gram::TN;
  const int i0 = (blockIdx.x / tiles) * gram::TM;
  const int j0 = (blockIdx.x % tiles) * gram::TN;
  const int k = blockIdx.y, b = blockIdx.z / S, s = blockIdx.z % S;
  const int pb = s * chunk;
  const int pe = min(tb * W, pb + chunk);
  const size_t ldf = static_cast<size_t>(NB) * R * W;
  const T* fb = f + (static_cast<size_t>(b) * R + halo) * W;
  const Unit un(u0 + b, nb);
  const float* mb = m + (static_cast<size_t>(un.plane(K, k)) * Hg +
                         static_cast<size_t>(un.band) * tb) * W;
  float* o = work + (static_cast<size_t>(blockIdx.z) * K + k) * C * C;
  gram::gram_fwd_tile<T, false, float>(fb, ldf, nullptr, mb, o, C, i0, j0, pb,
                                       pe);
}

// The group's own rows of the fp32 m^2 (B, K, Hg, W), band after band
// (unit u0 + b, nb bands a pair, tb rows each), rounded once to bf16: mb
// (K, NB * tb * W).
__global__ void block12_gram_mask_kernel(const float* __restrict__ m,
                                         __nv_bfloat16* __restrict__ mb,
                                         int K, int Hg, int W, int tb,
                                         int n, int u0, int nb) {
  const long long total = static_cast<long long>(K) * n;
  const int pb = tb * W;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(idx / n);
    const int q = static_cast<int>(idx - static_cast<long long>(k) * n);
    const int b = q / pb;
    const Unit un(u0 + b, nb);
    mb[idx] = from_f<__nv_bfloat16>(
        m[(un.plane(K, k) * Hg + static_cast<long long>(un.band) * tb) * W +
          (q - b * pb)]);
  }
}

// bf16 Gram partials on the Hopper body of gram_wgmma.cuh (gram_fwd's):
// band b of the group is the (C, tb * W) view of its own rows.
__global__ void __launch_bounds__(gram90::NT)
block12_gram_wgmma_kernel(gram90::FwdArgs a) {
  gram90::gram_fwd_body(a);
}

__global__ void block12_gram_reduce_kernel(const float* __restrict__ work,
                                           float* __restrict__ out,
                                           int splits, long long n, int init) {
  gram::reduce_body(work, out, splits, n, init);
}

// dz = round_T((t + gram) * (a > 0)): the Gram cotangent's epilogue adds the
// fp32 conv term t and applies relu' of the tap a itself.
template <typename T>
struct DzEpi {
  const float* t;
  const T* a;
  T* dz;
  __device__ __forceinline__ void operator()(size_t idx, float acc) const {
    dz[idx] = from_f<T>((t[idx] + acc) * (to_f(a[idx]) > 0.0f ? 1.0f : 0.0f));
  }
};

// DzEpi on the pixels [plo, phi) of each channel's P only: the pixels of
// one pair's bands in a group that runs into the next pair's.
template <typename T>
struct DzEpiRange {
  DzEpi<T> e;
  int P, plo, phi;
  __device__ __forceinline__ void operator()(size_t idx, float acc) const {
    const int p = static_cast<int>(idx % P);
    if (p >= plo && p < phi) e(idx, acc);
  }
};

// fp32: the gram_tile.cuh tile over the pixels [plo, phi) of the group
// (p tiles from tile0 on), with the cotangent s of their pair.
template <typename T>
__global__ void __launch_bounds__(gram::NT)
block12_gram_df_kernel(const T* __restrict__ a, const T* __restrict__ m,
                       const T* __restrict__ s, const float* __restrict__ t,
                       T* __restrict__ dz, int C, int P, int K, int tile0,
                       int plo, int phi) {
  gram::gram_bwd_tile<T, T>(a, m, s, DzEpiRange<T>{{t, a, dz}, P, plo, phi},
                            C, P, K, (tile0 + blockIdx.x) * gram::TN,
                            blockIdx.y * gram::TM);
}

// The same epilogue on gram_bwd's Hopper body: (t + acc) * (a > 0) in
// fp32, which the body rounds once to bf16.
struct BwdDz {
  static constexpr bool kReads = true;
  const float* t;
  const __nv_bfloat16* a;
  __device__ __forceinline__ float operator()(float acc, size_t idx) const {
    return (t[idx] + acc) * (to_f(a[idx]) > 0.0f ? 1.0f : 0.0f);
  }
};

// bf16: gram_bwd's body on the walked rows of each band of the group.
template <int N>
__global__ void __launch_bounds__(gram90::NT)
block12_gram_df_wgmma_kernel(gram90::BwdArgs args, BwdDz epi) {
  gram90::gram_bwd_body<N>(args, epi);
}

// --- launch helpers ----------------------------------------------------------

template <typename Ti, typename To>
int gather(const void* src, void* dst, int C, int Hs, int W, int NB, int R,
           int tb, int halo, int u0, int nb, cudaStream_t st) {
  const long long n = static_cast<long long>(C) * NB * R * 32;  // a warp a row
  block12_gather_kernel<Ti, To><<<dpst::grid_for(n, EW_THREADS, EW_BLOCKS),
                                  EW_THREADS, 0, st>>>(
      static_cast<const Ti*>(src), static_cast<To*>(dst), C, Hs, W, NB, R, tb,
      halo, u0, nb);
  return last_error();
}

template <typename Ti, typename To>
int scatter(const void* src, void* dst, int C, int Hd, int W, int NB, int R,
            int tb, int halo, int u0, int nb, cudaStream_t st) {
  const long long n = static_cast<long long>(C) * NB * tb * 32;
  block12_scatter_kernel<Ti, To><<<dpst::grid_for(n, EW_THREADS, EW_BLOCKS),
                                   EW_THREADS, 0, st>>>(
      static_cast<const Ti*>(src), static_cast<To*>(dst), C, Hd, W, NB, R, tb,
      halo, u0, nb);
  return last_error();
}

template <typename T>
int pool(const T* x, T* y, int C, int H, int W, bool avg, cudaStream_t st) {
  const long long n = static_cast<long long>(C) * (H / 2) * (W / 2);
  const int blocks = dpst::grid_for(n, EW_THREADS, EW_BLOCKS);
  if (avg)
    block12_pool_kernel<T, true><<<blocks, EW_THREADS, 0, st>>>(x, y, C, H, W);
  else
    block12_pool_kernel<T, false><<<blocks, EW_THREADS, 0, st>>>(x, y, C, H, W);
  return last_error();
}

template <typename T>
int pool_bwd(const T* dp, const T* x, T* dz, int C, int H, int W, bool avg,
             cudaStream_t st) {
  const long long n = static_cast<long long>(C) * (H / 2) * (W / 2);
  const int blocks = dpst::grid_for(n, EW_THREADS, EW_BLOCKS);
  if (avg)
    block12_pool_bwd_kernel<T, true><<<blocks, EW_THREADS, 0, st>>>(dp, x, dz, C,
                                                                    H, W);
  else
    block12_pool_bwd_kernel<T, false><<<blocks, EW_THREADS, 0, st>>>(dp, x, dz,
                                                                     C, H, W);
  return last_error();
}

// The output widths of block12's convs: 64 and 128, and 3 (the input
// gradient of conv1_1) on an N tile of 8.
using ConvWidths = conv90::Widths<8, 64, 128>;

// Forward conv of a stacked group with the bias+ReLU+row-mask epilogue; w
// packed (ops/conv_cuda.pack_weights), or for conv1_1 in bf16 (Cin = 3)
// packed as one K of 32 (pack_k27).
template <typename T>
int conv_fwd(const T* x, const void* w, const float* bias, T* y, int Cin,
             int Cout, int rows, int W, conv::BandRows br, cudaStream_t st) {
  const conv::EpiBiasRelu<T> epi{y, bias, br};
  if constexpr (sizeof(T) == 2) {
    if (Cin == 3) return conv90::launch_k27(x, w, epi, Cout, rows, W, st);
  }
  return conv::launch<T, conv::EpiBiasRelu<T>, ConvWidths>(x, w, epi, Cin,
                                                          Cout, rows, W, st);
}

// Input-gradient conv (flipped, transposed weights ft, packed) with fp32
// output.
template <typename T>
int conv_bwd(const T* dz, const void* ft, float* y, int Cin, int Cout,
             int rows, int W, cudaStream_t st) {
  return conv::launch<T, conv::EpiF32, ConvWidths>(dz, ft, conv::EpiF32{y},
                                                   Cin, Cout, rows, W, st);
}

int gram_splits(int p) { return (p + GRAM_CHUNK - 1) / GRAM_CHUNK; }

// Sums a group's Gram partial slots (S a unit, units u0 .. u0 + NB - 1) in
// unit order into out, the (B, n) Gram sums: each pair's run of units into
// its own sums, from zero at its first band. A pair's sum is then one fold
// of its bands' slots in band order, however the groups cut its bands.
int reduce_units(const float* work, float* out, long long n, int S, int u0,
                 int NB, int nb, cudaStream_t st) {
  for (int u = u0; u < u0 + NB;) {
    const Unit un(u, nb);
    const int end = std::min(u0 + NB, (un.pair + 1) * nb);
    block12_gram_reduce_kernel<<<dpst::grid_for(n, EW_THREADS, EW_BLOCKS),
                                 EW_THREADS, 0, st>>>(
        work + static_cast<long long>(u - u0) * S * n, out + un.pair * n,
        (end - u) * S, n, un.band == 0 ? 1 : 0);
    B12_TRY(last_error());
    u = end;
  }
  return 0;
}

// The Gram partials of a group into one slot per (band, split) of work,
// summed in band order into each unit's pair's sums in out (B, K, C, C).
// bf16 rounds the group's masks once (mb, K * NB * tb * W) and runs
// gram_fwd's Hopper body on each band's own rows; fp32 runs the
// gram_tile.cuh tile on the fp32 masks.
template <typename T>
int gram_partials(const T* f, const float* m, __nv_bfloat16* mb, float* work,
                  float* out, int C, int K, int W, int NB, int R, int tb,
                  int halo, int Hg, int u0, int nb, cudaStream_t st) {
  const int S = gram_splits(tb * W);
  if constexpr (sizeof(T) == 2) {
    const long long n = static_cast<long long>(NB) * tb * W;
    block12_gram_mask_kernel<<<dpst::grid_for(K * n, EW_THREADS, EW_BLOCKS),
                               EW_THREADS, 0, st>>>(
        m, mb, K, Hg, W, tb, static_cast<int>(n), u0, nb);
    B12_TRY(last_error());
    const size_t smem = gram90::fwd_smem();
    static size_t allowed[64] = {};
    B12_TRY(static_cast<int>(
        hopper::allow_smem(block12_gram_wgmma_kernel, smem, allowed)));
    const int tiles = (C + 63) / 64;
    const dim3 grid(tiles * tiles, (K + gram90::KG - 1) / gram90::KG, NB * S);
    const gram90::FwdArgs args{f + static_cast<size_t>(halo) * W, mb, work,
                               static_cast<long long>(NB) * R * W, n,
                               static_cast<long long>(R) * W,
                               static_cast<long long>(tb) * W, C, tb * W, K, S,
                               GRAM_CHUNK};
    block12_gram_wgmma_kernel<<<grid, gram90::NT, smem, st>>>(args);
  } else {
    const int tiles = (C + gram::TN - 1) / gram::TN;
    const dim3 grid(tiles * tiles, K, NB * S);
    block12_gram_kernel<T><<<grid, gram::NT, 0, st>>>(
        f, m, work, C, K, W, NB, R, tb, halo, Hg, u0, nb, S, GRAM_CHUNK);
  }
  B12_TRY(last_error());
  return reduce_units(work, out, static_cast<long long>(K) * C * C, S, u0,
                      NB, nb, st);
}

// The bf16 Gram cotangent's walk: c tiles of `tile` rows, `groups` blocks
// a c tile sharing the p tiles (64 pixels) of [pb, pe) in each of the NB
// bands of R rows of W pixels, pb and pe the band's rows [lo, hi) widened
// to 16-byte boundaries; one split (the epilogue needs the whole sum). As
// ops/block12_pallas.gram_dz_plan.
struct DfPlan {
  int tile, groups, splits, pb, pe, tpb, ptiles;
};

DfPlan df_plan(int C, int NB, int R, int W, int lo, int hi) {
  (void)R;
  DfPlan p;
  p.tile = C <= 64 ? 64 : 128;
  p.splits = 1;  // the epilogue needs the whole sum: no split partials
  p.pb = lo * W / 8 * 8;
  p.pe = (hi * W + 7) / 8 * 8;
  p.tpb = (p.pe - p.pb + 63) / 64;
  p.ptiles = NB * p.tpb;
  // resident blocks an SM by shared memory: 67 KB at 64 rows, 100 KB at 128
  const int slots = 132 * (p.tile == 64 ? 3 : 2);
  const int ctiles = (C + p.tile - 1) / p.tile;
  p.groups = std::min(p.ptiles, std::max(1, slots / ctiles));
  return p;
}

template <int N>
int gram_df_wgmma(const __nv_bfloat16* a, const __nv_bfloat16* m,
                  const __nv_bfloat16* s, const float* t, __nv_bfloat16* dz,
                  int C, int K, long long ld, int band, const DfPlan& pl,
                  cudaStream_t st) {
  const size_t smem = gram90::bwd_smem<N>();
  static size_t allowed[64] = {};
  B12_TRY(static_cast<int>(
      hopper::allow_smem(block12_gram_df_wgmma_kernel<N>, smem, allowed)));
  const gram90::BwdArgs args{a, m, s, dz, nullptr, ld, ld, band, pl.pb,
                             pl.pe, pl.tpb, pl.ptiles, C, K,
                             (C + 63) / 64 * K};
  block12_gram_df_wgmma_kernel<N>
      <<<dim3(pl.groups, (C + N - 1) / N, 1), gram90::NT, smem, st>>>(
          args, BwdDz{t, a});
  return last_error();
}

// The Gram cotangent stage of a stacked group: a (C, NB * R, W) tap, m (K,
// NB * R, W) rounded m^2, t (C, NB * R, W) fp32 conv term -> dz = round_T((t
// + sum_k S_k . round_T(m2_k * a)) * (a > 0)), band b with the cotangent of
// its unit's pair (unit u0 + b, nb bands a pair; s the pairs' cotangents,
// sp elements apart). bf16: s is the (C, K * Cp) matrix of
// gram_stream.s_matrix, and only rows [lo, hi) of each band are written
// (the others keep what they held); fp32: s is the (K, C, C) stack and
// every row is written. One launch a pair whose bands the group holds.
template <typename T>
int gram_df(const T* a, const T* m, const T* s, const float* t, T* dz, int C,
            int K, int NB, int R, int W, int lo, int hi, int u0, int nb,
            long long sp, cudaStream_t st) {
  const long long P = static_cast<long long>(NB) * R * W;
  const long long band = static_cast<long long>(R) * W;
  for (int u = u0; u < u0 + NB;) {
    const Unit un(u, nb);
    const int end = std::min(u0 + NB, (un.pair + 1) * nb);
    const T* sk = s + un.pair * sp;
    if constexpr (sizeof(T) == 2) {
      const long long off = (u - u0) * band;
      const DfPlan pl = df_plan(C, end - u, R, W, lo, hi);
      B12_TRY(pl.tile == 64
                  ? gram_df_wgmma<64>(a + off, m + off, sk, t + off, dz + off,
                                      C, K, P, static_cast<int>(band), pl, st)
                  : gram_df_wgmma<128>(a + off, m + off, sk, t + off,
                                       dz + off, C, K, P,
                                       static_cast<int>(band), pl, st));
    } else {
      const int plo = static_cast<int>((u - u0) * band);
      const int phi = static_cast<int>((end - u0) * band);
      const int tile0 = plo / gram::TN;
      const dim3 grid((phi + gram::TN - 1) / gram::TN - tile0,
                      (C + gram::TM - 1) / gram::TM);
      block12_gram_df_kernel<T><<<grid, gram::NT, 0, st>>>(
          a, m, sk, t, dz, C, static_cast<int>(P), K, tile0, plo, phi);
      B12_TRY(last_error());
    }
    u = end;
  }
  return 0;
}

// --- scratch -----------------------------------------------------------------

// Carves a scratch region into 256-byte aligned buffers; with base ==
// nullptr it only counts the bytes.
struct Carve {
  unsigned char* base;
  size_t used = 0;
  template <typename U>
  U* take(long long n) {
    const size_t at = used;
    used += (static_cast<size_t>(n) * sizeof(U) + 255) / 256 * 256;
    return base ? reinterpret_cast<U*>(base + at) : nullptr;
  }
};

// K classes, B pairs of H x W images in nb() bands of tb own rows each
// (block12_pallas.band_rows), walked NB units (pair, band) a group.
struct Geom {
  int K, H, W, NB, tb, B = 1;
  int nb() const { return H / tb; }
  int units() const { return B * nb(); }
  int R0() const { return tb + 2 * HALO; }
  int R1() const { return R0() / 2; }
  int R2() const { return R0() / 4; }
  long long P0() const { return static_cast<long long>(NB) * R0() * W; }
  long long P1() const { return static_cast<long long>(NB) * R1() * (W / 2); }
  long long P2() const { return static_cast<long long>(NB) * R2() * (W / 4); }
  // Rows [dz_lo, dz_hi) of a band whose Gram cotangent reaches an own
  // output row (the 3x3 input-gradient conv after it reads one row past
  // each side): dz11 on the shallow backward's bands of R0 rows, dz21 on
  // the deep backward's of R1 (block12_pallas.dz_rows).
  int dz_lo(bool deep) const { return (deep ? HALO / 2 : HALO) - 1; }
  int dz_hi(bool deep) const {
    return deep ? HALO / 2 + tb / 2 + 1 : HALO + tb + 1;
  }
};

template <typename T>
struct FwdScratch {
  T *xe, *a11, *a12, *p1, *a21, *a22, *p2;
  float* work;
  __nv_bfloat16* mb = nullptr;  // bf16: a group's masks (conv1_1 size)
  FwdScratch(Carve& cv, const Geom& g) {
    xe = cv.take<T>(3 * g.P0());
    a11 = cv.take<T>(64 * g.P0());
    a12 = cv.take<T>(64 * g.P0());
    p1 = cv.take<T>(64 * g.P1());
    a21 = cv.take<T>(128 * g.P1());
    a22 = cv.take<T>(128 * g.P1());
    p2 = cv.take<T>(128 * g.P2());
    const long long w1 = static_cast<long long>(g.NB) * gram_splits(g.tb * g.W) * g.K * 64 * 64;
    const long long w2 = static_cast<long long>(g.NB) * gram_splits(g.tb / 2 * (g.W / 2)) *
                         g.K * 128 * 128;
    work = cv.take<float>(w1 > w2 ? w1 : w2);
    if (sizeof(T) == 2)
      mb = cv.take<__nv_bfloat16>(static_cast<long long>(g.K) * g.NB * g.tb * g.W);
  }
};

template <typename T>
struct DeepScratch {
  T *a21, *a22, *dp2, *dz, *m2;
  float* t;
  DeepScratch(Carve& cv, const Geom& g) {
    a21 = cv.take<T>(128 * g.P1());
    a22 = cv.take<T>(128 * g.P1());
    dp2 = cv.take<T>(128 * g.P2());
    dz = cv.take<T>(128 * g.P1());       // dz22, then dz21
    m2 = cv.take<T>(g.K * g.P1());       // m^2 rounded to T
    t = cv.take<float>(128 * g.P1());    // conv2_2's input gradient, then dp1
  }
};

template <typename T>
struct ShallowScratch {
  T *a11, *dp1, *a12, *dz, *m1;
  float* t;
  ShallowScratch(Carve& cv, const Geom& g) {
    a11 = cv.take<T>(64 * g.P0());
    dp1 = cv.take<T>(64 * g.P1());
    a12 = cv.take<T>(64 * g.P0());
    dz = cv.take<T>(64 * g.P0());        // dz12, then dz11
    m1 = cv.take<T>(g.K * g.P0());       // m^2 rounded to T
    t = cv.take<float>(64 * g.P0());     // conv1_2's input gradient, then dx
  }
};

// --- the three passes --------------------------------------------------------

// Elements of one pair's Gram cotangent as the stage reads it: bf16 the
// (C, K * Cp) matrix of gram_stream.s_matrix, fp32 the (K, C, C) stack.
template <typename T>
long long s_elems(int C, int K) {
  return sizeof(T) == 2 ? static_cast<long long>(C) * K * ((C + 7) / 8 * 8)
                        : static_cast<long long>(K) * C * C;
}

template <typename T>
int run_fwd(const float* x, const float* m1, const float* m2,
            const void* const* w, const float* const* b, float* g1, float* g2,
            T* p2, T* a11, T* a21, T* a22, void* scratch, const Geom& g,
            bool avg, bool save_res, cudaStream_t st) {
  Carve cv{static_cast<unsigned char*>(scratch)};
  FwdScratch<T> s(cv, g);
  const int H = g.H, W = g.W, tb = g.tb, K = g.K, nb = g.nb();
  const int R0 = g.R0(), R1 = g.R1(), R2 = g.R2();
  for (int u0 = 0; u0 < g.units(); u0 += g.NB) {
    const int NB = std::min(g.NB, g.units() - u0);
    const conv::BandRows rows0{R0, tb, HALO, H, u0 % nb, nb};
    const conv::BandRows rows1{R1, tb / 2, HALO / 2, H / 2, u0 % nb, nb};
    B12_TRY((gather<float, T>(x, s.xe, 3, H, W, NB, R0, tb, HALO, u0, nb, st)));
    B12_TRY(conv_fwd<T>(s.xe, w[0], b[0], s.a11, 3, 64, NB * R0, W, rows0, st));
    B12_TRY(conv_fwd<T>(s.a11, w[1], b[1], s.a12, 64, 64, NB * R0, W, rows0, st));
    B12_TRY(pool<T>(s.a12, s.p1, 64, NB * R0, W, avg, st));
    B12_TRY(conv_fwd<T>(s.p1, w[2], b[2], s.a21, 64, 128, NB * R1, W / 2, rows1, st));
    B12_TRY(conv_fwd<T>(s.a21, w[3], b[3], s.a22, 128, 128, NB * R1, W / 2, rows1, st));
    B12_TRY(pool<T>(s.a22, s.p2, 128, NB * R1, W / 2, avg, st));
    B12_TRY((scatter<T, T>(s.p2, p2, 128, H / 4, W / 4, NB, R2, tb / 4, HALO / 4,
                           u0, nb, st)));
    B12_TRY(gram_partials<T>(s.a11, m1, s.mb, s.work, g1, 64, K, W, NB, R0, tb,
                             HALO, H, u0, nb, st));
    B12_TRY(gram_partials<T>(s.a21, m2, s.mb, s.work, g2, 128, K, W / 2, NB, R1,
                             tb / 2, HALO / 2, H / 2, u0, nb, st));
    if (save_res) {
      B12_TRY((scatter<T, T>(s.a11, a11, 64, H, W, NB, R0, tb, HALO, u0, nb, st)));
      B12_TRY((scatter<T, T>(s.a21, a21, 128, H / 2, W / 2, NB, R1, tb / 2,
                             HALO / 2, u0, nb, st)));
      B12_TRY((scatter<T, T>(s.a22, a22, 128, H / 2, W / 2, NB, R1, tb / 2,
                             HALO / 2, u0, nb, st)));
    }
  }
  return last_error();
}

template <typename T>
int run_bwd_deep(const T* a21, const T* a22, const T* dp2, const float* m2,
                 const T* s2, const void* ft21, const void* ft22, T* dp1,
                 void* scratch, const Geom& g, bool avg, cudaStream_t st) {
  Carve cv{static_cast<unsigned char*>(scratch)};
  DeepScratch<T> s(cv, g);
  const int H2 = g.H / 2, W2 = g.W / 2, tb2 = g.tb / 2, K = g.K, nb = g.nb();
  const int R1 = g.R1(), R2 = g.R2();
  for (int u0 = 0; u0 < g.units(); u0 += g.NB) {
    const int NB = std::min(g.NB, g.units() - u0);
    B12_TRY((gather<T, T>(a21, s.a21, 128, H2, W2, NB, R1, tb2, HALO / 2, u0, nb, st)));
    B12_TRY((gather<T, T>(a22, s.a22, 128, H2, W2, NB, R1, tb2, HALO / 2, u0, nb, st)));
    B12_TRY((gather<T, T>(dp2, s.dp2, 128, H2 / 2, W2 / 2, NB, R2, tb2 / 2,
                          HALO / 4, u0, nb, st)));
    B12_TRY((gather<float, T>(m2, s.m2, K, H2, W2, NB, R1, tb2, HALO / 2,
                              u0, nb, st)));
    B12_TRY(pool_bwd<T>(s.dp2, s.a22, s.dz, 128, NB * R1, W2, avg, st));
    B12_TRY(conv_bwd<T>(s.dz, ft22, s.t, 128, 128, NB * R1, W2, st));
    B12_TRY(gram_df<T>(s.a21, s.m2, s2, s.t, s.dz, 128, K, NB, R1, W2,
                       g.dz_lo(true), g.dz_hi(true), u0, nb, s_elems<T>(128, K),
                       st));
    B12_TRY(conv_bwd<T>(s.dz, ft21, s.t, 128, 64, NB * R1, W2, st));
    B12_TRY((scatter<float, T>(s.t, dp1, 64, H2, W2, NB, R1, tb2, HALO / 2,
                               u0, nb, st)));
  }
  return last_error();
}

template <typename T>
int run_bwd_shallow(const T* a11, const T* dp1, const float* m1, const T* s1,
                    const void* ft11, const void* ft12, const void* w12,
                    const float* b12, float* dx, void* scratch, const Geom& g,
                    bool avg, cudaStream_t st) {
  Carve cv{static_cast<unsigned char*>(scratch)};
  ShallowScratch<T> s(cv, g);
  const int H = g.H, W = g.W, tb = g.tb, K = g.K, nb = g.nb();
  const int R0 = g.R0(), R1 = g.R1();
  for (int u0 = 0; u0 < g.units(); u0 += g.NB) {
    const int NB = std::min(g.NB, g.units() - u0);
    const conv::BandRows rows0{R0, tb, HALO, H, u0 % nb, nb};
    B12_TRY((gather<T, T>(a11, s.a11, 64, H, W, NB, R0, tb, HALO, u0, nb, st)));
    B12_TRY((gather<T, T>(dp1, s.dp1, 64, H / 2, W / 2, NB, R1, tb / 2, HALO / 2,
                          u0, nb, st)));
    B12_TRY((gather<float, T>(m1, s.m1, K, H, W, NB, R0, tb, HALO, u0, nb, st)));
    B12_TRY(conv_fwd<T>(s.a11, w12, b12, s.a12, 64, 64, NB * R0, W, rows0, st));
    B12_TRY(pool_bwd<T>(s.dp1, s.a12, s.dz, 64, NB * R0, W, avg, st));
    B12_TRY(conv_bwd<T>(s.dz, ft12, s.t, 64, 64, NB * R0, W, st));
    B12_TRY(gram_df<T>(s.a11, s.m1, s1, s.t, s.dz, 64, K, NB, R0, W,
                       g.dz_lo(false), g.dz_hi(false), u0, nb,
                       s_elems<T>(64, K), st));
    B12_TRY(conv_bwd<T>(s.dz, ft11, s.t, 64, 3, NB * R0, W, st));
    B12_TRY((scatter<float, float>(s.t, dx, 3, H, W, NB, R0, tb, HALO, u0, nb, st)));
  }
  return last_error();
}

template <typename T>
void count_scratch(int which, Carve& cv, const Geom& g) {
  if (which == 0) {
    FwdScratch<T> s(cv, g);
  } else if (which == 1) {
    DeepScratch<T> s(cv, g);
  } else {
    ShallowScratch<T> s(cv, g);
  }
}

// H and tb multiples of TB_MIN, tb a divisor of H.
bool bad_geometry(int K, int H, int W, int group, int tb, int B = 1) {
  return K < 1 || H < TB_MIN || H % TB_MIN || tb < TB_MIN || tb % TB_MIN ||
         H % tb || W < 4 || W % 4 || group < 1 || B < 1 ||
         static_cast<long long>(B) * (H / tb) > (1 << 30);
}

// The walk of a launch: `group` units a group, at most a pair's H / tb.
Geom geom(int K, int H, int W, int group, int tb, int B = 1) {
  return Geom{K, H, W, group < H / tb ? group : H / tb, tb, B};
}

}  // namespace

// Bytes of scratch an entry point needs: which = 0 forward, 1 deep backward,
// 2 shallow backward; tb and dtype as for the entry points (0 for a
// geometry they refuse).
extern "C" size_t dpst_block12_scratch_bytes(int which, int K, int H, int W,
                                             int group, int tb, int dtype) {
  if (bad_geometry(K, H, W, group, tb)) return 0;
  const Geom g = geom(K, H, W, group, tb);
  Carve cv{nullptr};
  if (dtype == DPST_DTYPE_F32)
    count_scratch<float>(which, cv, g);
  else
    count_scratch<__nv_bfloat16>(which, cv, g);
  return cv.used;
}

// Bands of tb own rows (block12_pallas.band_rows: a multiple of 32 that
// divides H). A batch of B pairs: every image, mask and output below with a
// leading pair axis (x (B, 3, H, W), g1 (B, K, 64, 64), ...), the weights
// shared. The pipeline walks units (pair, band), pair-major, `group` of
// them a group of the scratch (at most H / tb, the scratch one pair's), so a
// group may run from one pair into the next; each stage addresses its
// unit's pair. Every band's arithmetic and each pair's Gram partial order
// are those of the pair's own launch: a pair's outputs are bit-equal to it.
//
// x (3, H, W) fp32 preprocessed image; m1 (K, H, W) and m2 (K, H/2, W/2)
// fp32 m^2; w11..w22 in the compute dtype, packed (9, Cout, Cinp) by
// ops/conv_cuda.pack_weights (w11 in bf16: (64, 32) by pack_k27),
// b11..b22 fp32; g1 (K, 64, 64) and g2 (K, 128, 128) fp32 Gram sums; p2
// (128, H/4, W/4); with save_res also a11 (64, H, W), a21 and a22 (128,
// H/2, W/2), else those may be null.
extern "C" int dpst_block12_fwd(const void* x, const void* m1, const void* m2,
                                const void* w11, const void* b11,
                                const void* w12, const void* b12,
                                const void* w21, const void* b21,
                                const void* w22, const void* b22, void* g1,
                                void* g2, void* p2, void* a11, void* a21,
                                void* a22, void* scratch, int K, int H, int W,
                                int group, int tb, int B, int avg,
                                int save_res, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (bad_geometry(K, H, W, group, tb, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom(K, H, W, group, tb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[4] = {w11, w12, w21, w22};
  const float* b[4] = {static_cast<const float*>(b11), static_cast<const float*>(b12),
                       static_cast<const float*>(b21), static_cast<const float*>(b22)};
  const float* xf = static_cast<const float*>(x);
  const float* m1f = static_cast<const float*>(m1);
  const float* m2f = static_cast<const float*>(m2);
  float* g1f = static_cast<float*>(g1);
  float* g2f = static_cast<float*>(g2);
  if (dtype == DPST_DTYPE_F32)
    return run_fwd<float>(xf, m1f, m2f, w, b, g1f, g2f, static_cast<float*>(p2),
                          static_cast<float*>(a11), static_cast<float*>(a21),
                          static_cast<float*>(a22), scratch, g, avg != 0,
                          save_res != 0, st);
  if (dtype == DPST_DTYPE_BF16)
    return run_fwd<__nv_bfloat16>(
        xf, m1f, m2f, w, b, g1f, g2f, static_cast<__nv_bfloat16*>(p2),
        static_cast<__nv_bfloat16*>(a11), static_cast<__nv_bfloat16*>(a21),
        static_cast<__nv_bfloat16*>(a22), scratch, g, avg != 0, save_res != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a21, a22 (128, H/2, W/2) and dp2 (128, H/4, W/4) in the compute dtype;
// m2 (K, H/2, W/2) fp32; s2 = round_T(dG2 + dG2^T), in fp32 the (K, 128,
// 128) stack, in bf16 the (128, K * 128) matrix of gram_stream.s_matrix; ft21
// and ft22, the flipped, transposed weights of conv2_1 and conv2_2 packed
// (9, 64, 128) and (9, 128, 128) (ops/conv_cuda.pack_grad_weights); dp1
// (64, H/2, W/2) in the compute dtype. A batch of B pairs as for
// dpst_block12_fwd (s2 too with a leading pair axis).
extern "C" int dpst_block12_bwd_deep(const void* a21, const void* a22,
                                     const void* dp2, const void* m2,
                                     const void* s2, const void* ft21,
                                     const void* ft22, void* dp1,
                                     void* scratch, int K, int H, int W,
                                     int group, int tb, int B, int avg,
                                     int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (bad_geometry(K, H, W, group, tb, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom(K, H, W, group, tb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m2f = static_cast<const float*>(m2);
  if (dtype == DPST_DTYPE_F32)
    return run_bwd_deep<float>(
        static_cast<const float*>(a21), static_cast<const float*>(a22),
        static_cast<const float*>(dp2), m2f, static_cast<const float*>(s2), ft21,
        ft22, static_cast<float*>(dp1), scratch, g, avg != 0, st);
  if (dtype == DPST_DTYPE_BF16)
    return run_bwd_deep<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a21), static_cast<const __nv_bfloat16*>(a22),
        static_cast<const __nv_bfloat16*>(dp2), m2f,
        static_cast<const __nv_bfloat16*>(s2), ft21, ft22,
        static_cast<__nv_bfloat16*>(dp1), scratch, g, avg != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a11 (64, H, W) and dp1 (64, H/2, W/2) in the compute dtype; m1 (K, H, W)
// fp32; s1 = round_T(dG1 + dG1^T), in fp32 the (K, 64, 64) stack, in bf16
// the (64, K * 64) matrix of gram_stream.s_matrix; ft11 and ft12, the
// flipped, transposed weights of conv1_1 and conv1_2 packed (9, 3, 64) and
// (9, 64, 64) (ops/conv_cuda.pack_grad_weights); w12 packed (9, 64, 64)
// and b12 (64,) fp32 to recompute conv1_2; dx (3, H, W) fp32. A batch of
// B pairs as for dpst_block12_fwd (s1 too with a leading pair axis).
extern "C" int dpst_block12_bwd_shallow(const void* a11, const void* dp1,
                                        const void* m1, const void* s1,
                                        const void* ft11, const void* ft12,
                                        const void* w12, const void* b12,
                                        void* dx, void* scratch, int K, int H,
                                        int W, int group, int tb, int B,
                                        int avg, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (bad_geometry(K, H, W, group, tb, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geom(K, H, W, group, tb, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m1f = static_cast<const float*>(m1);
  const float* b12f = static_cast<const float*>(b12);
  float* dxf = static_cast<float*>(dx);
  if (dtype == DPST_DTYPE_F32)
    return run_bwd_shallow<float>(
        static_cast<const float*>(a11), static_cast<const float*>(dp1), m1f,
        static_cast<const float*>(s1), ft11, ft12, w12, b12f, dxf, scratch, g,
        avg != 0, st);
  if (dtype == DPST_DTYPE_BF16)
    return run_bwd_shallow<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(a11), static_cast<const __nv_bfloat16*>(dp1),
        m1f, static_cast<const __nv_bfloat16*>(s1), ft11, ft12, w12, b12f, dxf,
        scratch, g, avg != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resources of block12's bf16 conv bodies, for the record: which = 0
// conv1_1 (K27, bias+ReLU), 1 conv1_2 (bias+ReLU, 64 output channels, one
// chunk), 2 conv2_2 (bias+ReLU, 128, two chunks), 3 the input gradient of
// conv2_1 (fp32 out, 64 output channels, two chunks), 4 that of conv1_1
// (N tile of 8, one chunk). out as dpst_conv3x3_attrs.
extern "C" int dpst_block12_conv_attrs(int which, int* out) {
  cudaGetLastError();  // clear an error left by an earlier call
  using Relu = conv::EpiBiasRelu<__nv_bfloat16>;
  if (which == 0) return conv90::attrs<64, true, Relu>(1, out);
  if (which == 1) return conv90::attrs<64, false, Relu>(1, out);
  if (which == 2) return conv90::attrs<128, false, Relu>(2, out);
  if (which == 3) return conv90::attrs<64, false, conv::EpiF32>(2, out);
  if (which == 4) return conv90::attrs<8, false, conv::EpiF32>(1, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward entry points' Gram cotangent stage alone, on one stacked
// group of NB bands of R rows: f (C, NB * R, W) tap and m (K, NB * R, W)
// m^2 rounded, both in the compute dtype; s as gram_df takes it; t (C, NB *
// R, W) fp32 -> dz (C, NB * R, W). bf16 writes rows [lo, hi) of each band
// (the stage's plan: dpst_block12_df_plan), fp32 every row.
extern "C" int dpst_block12_gram_dz(const void* f, const void* m,
                                    const void* s, const void* t, void* dz,
                                    int C, int K, int NB, int R, int W,
                                    int lo, int hi, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (C < 1 || K < 1 || NB < 1 || W < 1 || lo < 0 || hi > R || lo >= hi ||
      (static_cast<long long>(R) * W) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  if (dtype == DPST_DTYPE_F32)
    return gram_df<float>(static_cast<const float*>(f),
                          static_cast<const float*>(m),
                          static_cast<const float*>(s), tf,
                          static_cast<float*>(dz), C, K, NB, R, W, lo, hi, 0,
                          NB, 0, st);
  if (dtype == DPST_DTYPE_BF16)
    return gram_df<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(f),
        static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(s), tf,
        static_cast<__nv_bfloat16*>(dz), C, K, NB, R, W, lo, hi, 0, NB, 0,
        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 stage's plan at a group, for the record: out = (c tile rows,
// groups, splits, pb, pe, p tiles a band, p tiles).
extern "C" int dpst_block12_df_plan(int C, int NB, int R, int W, int lo,
                                    int hi, int* out) {
  const DfPlan p = df_plan(C, NB, R, W, lo, hi);
  const int v[7] = {p.tile, p.groups, p.splits, p.pb, p.pe, p.tpb, p.ptiles};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// Resources of the bf16 Gram cotangent kernel, for the record: which = 0
// with 64-row c tiles (conv1_1), 1 with 128 (conv2_1). out as
// dpst_gram_wgmma_attrs.
extern "C" int dpst_block12_df_attrs(int which, int* out) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      which == 0
          ? reinterpret_cast<const void*>(block12_gram_df_wgmma_kernel<64>)
          : reinterpret_cast<const void*>(block12_gram_df_wgmma_kernel<128>);
  const size_t smem = which == 0 ? gram90::bwd_smem<64>() : gram90::bwd_smem<128>();
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, gram90::NT,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}
