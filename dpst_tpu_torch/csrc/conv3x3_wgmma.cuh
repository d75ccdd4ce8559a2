// Hopper body of the bf16 3x3 SAME convolution, shared by csrc/conv3x3.cu
// and the conv stages of csrc/block12.cu (through conv::launch in
// conv3x3_tile.cuh, which keeps the fp32 CUDA-core tile):
//   y[co, h, w] = epi( sum_{tap, ci} x[ci, h + dy - 1, w + dx - 1] * wp[tap][co][ci] )
// x (Cin, H, W) NCHW planes in bf16 with zero padding outside the image,
// wp the weights packed as (9, Cout, Cinp) (tap = 3 dy + dx, Cinp = Cin
// rounded up to 8, zero padded; ops/conv_cuda.pack_weights), fp32 sums,
// and each sum handed once to the epilogue (conv3x3_tile.cuh).
//
// Replaces the TPU kernel dpst_tpu/ops/conv_pallas.py:_conv3x3_kernel
// (launched by _conv3x3_padded): nine tap matmuls over one staged slab with
// a one-pixel halo, fp32 accumulation, one rounding of each output. The
// input gradient is the same kernel on the packed flipped, transposed
// weights (ops/conv_cuda.pack_weights(flip_transpose_weights(w))).
//
// What bounds it on the H100: operations, 2 * 9 * Cin * Cout * P, against
// 989 TFLOP/s in bf16. At 512^2 the VGG layers do 4.8 to 19.3 GFLOP each
// on 7 to 67 MB, 70 to 1400 operations a byte of their own data: above
// the card's 295, so the tensor cores, fed from shared memory, set the
// pace, and the design keeps them busy (PERF.md has the times):
//   * wgmma (m64nNk16, fp32 accumulators in registers) with pixels as M:
//     a block is two warpgroups over an 8 x 32 pixel tile (each warpgroup
//     two M tiles of 64 pixels) and N = BN output channels (the next
//     multiple of 8 up to 128: block12's 64 -> 3 input gradient runs N =
//     8, not a padded 64).
//   * A, the pixels' channel vectors, comes from the slab through
//     ldmatrix, one row address per pixel, so each tap's one-pixel shift
//     costs nothing. The slab is pixel-major, one 128-byte row of 64
//     channels a pixel, its 16-byte chunks swizzled by the pixel index
//     (chunk ^ pixel % 8), so the eight rows of an ldmatrix, eight
//     consecutive pixels, fall in distinct banks at every shift.
//   * B, the weights of one tap for a chunk of 64 input channels (N rows
//     of 128 bytes), is read by wgmma from shared memory in the 128-byte
//     swizzled K-major layout. The packed layout makes each row one
//     16-byte cp.async per 8 channels; the OIHW gather at a stride of 9
//     elements is gone, and the packing runs once per run, not per call.
//   * A ring of WS = 5 weight slots, D = 3 items (chunk, tap) ahead, filled
//     by cp.async while wgmma runs. Each M tile's products are one commit
//     group and each warpgroup waits only for the group before the last
//     (wgmma.wait_group 1), so neither the refill of the A fragments nor
//     the barrier between items drains the tensor cores; a weight slot is
//     refilled only after both warpgroups are past the item that read it.
//   * The slab: NCHW has no 16-byte run of one pixel's channels, so it is
//     staged through registers, a thread a pixel (two for 84 threads), 8
//     channels a part: 8 loads of 2 bytes, each warp's along an image row,
//     packed and written as one 16-byte row chunk. Where a block sums more
//     than one chunk of Cin, the next chunk's slab goes to a second buffer
//     behind this chunk's taps: part t's loads at tap t, its store two
//     taps later (one at N tiles other than 64 and 128, where registers
//     are short). The packing is volatile asm, so that the loads are first
//     waited for at the store: packed where they were loaded, the wait for
//     a load's latency held every tap back. The first chunk's parts load
//     in groups (all 8 at once at BN = 128) before the first product.
//   * Reuse: each staged weight byte serves 256 pixels, 2 * 256 = 512
//     operations a byte; each block re-reads 9 * 64 * BN * 2 bytes of
//     weights from L2 per chunk (147 KB at BN = 128) against 2 * 256 * BN
//     * 576 operations (37.7 MFLOP), 256 operations a byte of weights,
//     plus the slab, 340 pixels * 128 bytes (43.5 KB), once per chunk.
//   * Occupancy: a block of one chunk at BN <= 64 (the 64-channel layers,
//     Cin = 64) holds one slab (85.5 KB of shared memory) and takes a body
//     without the next-chunk staging (MULTI = false); at BN = 64 it holds
//     to 128 registers a thread, so that two blocks share an SM and one's
//     slab staging and epilogue overlap the other's products. (A variant
//     that walked pixel tiles at one block an SM, its nine taps' weights
//     resident, ran slower on the H100; narrower N tiles spilled under the
//     128-register cap and run one block an SM.) Otherwise one block an SM
//     (170 KB at BN = 128).
//   * Filling 132 SMs: where the pixel x Cout grid is short (the 64^2 and
//     32^2 layers at 512^2), `splits` blocks share an output tile, each
//     over `cps` chunks of Cin, and write fp32 partials that a second
//     kernel sums in split order and hands to the epilogue once; no
//     atomics, so a rerun is bit-identical. The plan is
//     ops/conv_cuda.conv_plan.
//   * A batch of B images (the JAX package's vmapped pallas_call, a pair
//     axis in its grid) is one launch: z = pair * splits + split, the
//     PAIRS instance offsetting the block's input and output planes by its
//     pair (x (B, Cin, H, W), y (B, Cout, H, W), partials (B, splits,
//     Cout, H, W), each pair's splits summed in split order; conv_plan
//     gives a batch one image's splits, so an image rounds as alone). The
//     one-image
//     instance (PAIRS = false, block12's stages among its callers) has the
//     pair arithmetic compiled out, register for register as before.
//   * The epilogue stages the pixel-major accumulators in shared memory as
//     (channel, pixel) rows and stores along the pixels of each NCHW
//     plane, 8 pixels a thread: a 16-byte vector where W % 8 == 0.
//   * conv1_1 inside block12 (3 input channels, K27): its 27 (tap,
//     channel) pairs form one K of 32, staged as an im2col of the tile in
//     the slab's rows, against weights packed (Cout, 32)
//     (ops/conv_cuda.pack_k27): two k16 steps instead of nine taps of a
//     64-channel chunk holding 3.
// Kernel names contain conv3x3 (chip_smoke.kernel_group groups by name).
#pragma once

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

// Internal linkage: each translation unit that includes this header gets
// its own kernels.
namespace {
namespace conv90 {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;               // two warpgroups
constexpr int TH = 8;                 // output rows a block
constexpr int TW = 32;                // output columns a block
constexpr int TP = TH * TW;           // output pixels a block
constexpr int SW = TW + 2;            // slab columns (with the halo)
constexpr int SROWS = TH + 2;         // slab rows
constexpr int SPIX = SROWS * SW;      // slab pixels
constexpr int BK = 64;                // input channels a chunk
constexpr int SLAB_BYTES = SPIX * 128;
constexpr int WS = 5;                 // weight slots of the ring
constexpr int D = 3;                  // items whose weights load ahead
static_assert(WS == D + 2, "a slot is refilled two items after its read");
constexpr int PARTS = BK / 8;         // 16-byte chunk columns of a slab row
constexpr int LDP = TP + 4;           // epilogue staging row (fp32)

// Slabs a block of the ring body holds: two (the next chunk's is staged
// during this one's taps) when it sums more than one chunk, or when the
// epilogue's fp32 staging needs the room (BN > 64); else one (conv1_1's
// K27 blocks, two of which share an SM).
__host__ __device__ constexpr int slabs_for(int bn, int cps) {
  return cps > 1 || bn > 64 ? 2 : 1;
}
template <int BN>
constexpr int smem_bytes(int nslab) {
  return WS * BN * 128 + nslab * SLAB_BYTES + 1024;
}
static_assert(128 * LDP * 4 <= WS * 128 * 128 + 2 * SLAB_BYTES &&
                  64 * LDP * 4 <= WS * 64 * 128 + SLAB_BYTES,
              "the epilogue's staging fits the ring and the slabs");

// The N tiles a caller instantiates (each a kernel of its own).
template <int... N>
struct Widths {};

// N tile of a conv with Cout output channels: the next multiple of 8, at
// most 128.
inline int width(int cout) { return cout >= 128 ? 128 : (cout + 7) / 8 * 8; }

// d (64 x BN) += a (64 x 16, registers) . b (16 x BN at desc): one wgmma
// for BN = 64 or 128, else BN / 8 of m64n8k16 (the next 8 rows of B lie
// 1024 bytes further, 64 in the descriptor's address field).
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4],
                                    uint64_t desc) {
  if constexpr (BN == 128) {
    wgmma_128(d, a, desc);
  } else if constexpr (BN == 64) {
    wgmma_64(d, a, desc);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      wgmma_8(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3], a,
              desc + 64 * j);
  }
}

// The slab pixels this thread stages, pix = tid and tid + NT (< SPIX):
// slab pixel (r, j) is image pixel (h0 - 1 + r, w0 - 1 + j), at offset
// off in a plane, or -1 outside the image.
struct SlabPix {
  long long off[2];
};

__device__ __forceinline__ SlabPix slab_pixels(int H, int W, int h0, int w0) {
  SlabPix sp;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pix = static_cast<int>(threadIdx.x) + j * NT;
    const int h = h0 - 1 + pix / SW, w = w0 - 1 + pix % SW;
    sp.off[j] = pix < SPIX && h >= 0 && h < H && w >= 0 && w < W
                    ? static_cast<long long>(h) * W + w
                    : -1;
  }
  return sp;
}

// Part p of the slab of input channels [ci0, ci0 + BK): channels ci0 + 8p
// .. + 7 of this thread's pixels, loaded into v one bf16 a register (zero
// outside the image and past Cin) ...
__device__ __forceinline__ void load_part(uint32_t (&v)[2][8],
                                          const unsigned short* __restrict__ x,
                                          const SlabPix& sp, int Cin,
                                          size_t hw, int ci0, int p) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ci = ci0 + 8 * p + k;
      v[j][k] = sp.off[j] >= 0 && ci < Cin ? __ldg(x + ci * hw + sp.off[j]) : 0u;
    }
  }
}

// ... and stored as the 16-byte chunk p of each pixel's row, at chunk
// position p ^ (pixel % 8): a quarter warp's eight consecutive pixels
// write distinct banks. The channel pairs are packed here, in volatile asm
// that stays behind the asynchronous products issued before it, so that a
// load issued one tap earlier is first waited for here.
__device__ __forceinline__ void store_part(unsigned char* slab,
                                           const uint32_t (&v)[2][8], int p) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pix = static_cast<int>(threadIdx.x) + j * NT;
    if (pix < SPIX) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        asm volatile("prmt.b32 %0, %1, %2, 0x5410;\n"
                     : "=r"(w[k])
                     : "r"(v[j][2 * k]), "r"(v[j][2 * k + 1]));
      *reinterpret_cast<uint4*>(slab + pix * 128 + ((p ^ (pix & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// conv1_1's im2col tile (Cin = 3): the thread of output pixel (r, j) of
// the tile loads its k = 3 * tap + ci, x[ci][h0 + r + dy - 1][w0 + j + dx -
// 1] (tap = 3 dy + dx; zero outside the image), all 27 in flight at once,
// and writes them with 5 zeros as the first 64 bytes of the slab row of
// pixel (r + 1, j + 1), where the centre tap's A rows read them.
__device__ __forceinline__ void stage_im2col(unsigned char* slab,
                                             const unsigned short* __restrict__ x,
                                             int H, int W, size_t hw, int h0,
                                             int w0) {
  static_assert(NT == TP, "a thread a pixel");
  const int r = static_cast<int>(threadIdx.x) / TW;
  const int j = static_cast<int>(threadIdx.x) % TW;
  uint32_t v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int tap = k / 3, ci = k - 3 * tap, dy = tap / 3, dx = tap - 3 * dy;
    const int h = h0 + r + dy - 1, w = w0 + j + dx - 1;
    v[k] = k < 27 && h >= 0 && h < H && w >= 0 && w < W
               ? __ldg(x + ci * hw + static_cast<size_t>(h) * W + w)
               : 0u;
  }
  const int pix = (r + 1) * SW + j + 1;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<uint4*>(slab + pix * 128 + ((c ^ (pix & 7)) << 4)) =
        make_uint4(v[8 * c] | (v[8 * c + 1] << 16),
                   v[8 * c + 2] | (v[8 * c + 3] << 16),
                   v[8 * c + 4] | (v[8 * c + 5] << 16),
                   v[8 * c + 6] | (v[8 * c + 7] << 16));
}

// The accumulators as (channel, pixel) rows of cs (BN, LDP) fp32:
// acc[mt][4n + 2h + e] is channel 8n + 2t + e at tile pixel p = 128 wg +
// 64 mt + 16 w + g + 8h (= 32 row + column); a warp's writes fall in
// distinct banks (LDP % 32 == 4).
template <int BN>
__device__ __forceinline__ void stage_acc(float* cs,
                                          const float (&acc)[2][BN / 2]) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cs[(8 * n + 2 * t + e) * LDP + wg * 128 + mt * 64 + w * 16 + g +
             8 * h] = acc[mt][4 * n + 2 * h + e];
}

// The tile's outputs from cs: 8 pixels of one channel's row a thread,
// neighbouring threads along the row, 16-byte vectors where W % 8 == 0
// (then a group of 8 lies wholly inside or outside the image); to epi, at
// ob elements into its output (the pair's planes), or in fp32 to wk
// (Cout, H, W) when wk is not null.
template <int BN, typename Epi>
__device__ __forceinline__ void store_tile(const float* cs, const Epi& epi,
                                           float* wk, int Cout, int H, int W,
                                           int co0, int h0, int w0,
                                           size_t ob) {
  const size_t hw = static_cast<size_t>(H) * W;
  const bool vec = (W & 7) == 0;
  for (int e = threadIdx.x; e < BN * (TP / 8); e += NT) {
    const int r = e / (TP / 8), seg = e % (TP / 8);
    const int co = co0 + r, h = h0 + seg / (TW / 8);
    const int wc = w0 + (seg % (TW / 8)) * 8;
    if (co >= Cout || h >= H || wc >= W) continue;
    const float4 lo = *reinterpret_cast<const float4*>(cs + r * LDP + seg * 8);
    const float4 hi =
        *reinterpret_cast<const float4*>(cs + r * LDP + seg * 8 + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t idx = co * hw + static_cast<size_t>(h) * W + wc;
    if (wk != nullptr) {
      if (vec) {
        *reinterpret_cast<float4*>(wk + idx) = lo;
        *reinterpret_cast<float4*>(wk + idx + 4) = hi;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (wc + i < W) wk[idx + i] = v[i];
      }
    } else if (vec) {
      epi.store8(ob + idx, co, h, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (wc + i < W) epi(ob + idx + i, co, h, v[i]);
    }
  }
}

// The products of one item (one tap, 4 or 2 k16 steps) for both M tiles
// from the slab at sb (the tap's rows, ldmatrix) and the weights at desc.
// Each M tile's products are one commit group: the wait before the second
// lets only the item before's second tile run, whose A buffer it reuses.
template <int BN, int KS>
__device__ __forceinline__ void item_products(float (&acc)[2][BN / 2],
                                              uint32_t (&a)[2][KS][4],
                                              uint32_t sb, uint64_t desc,
                                              int tap) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31;
  // this thread's A rows: pixel (wg * 4 + w / 2 + 2 mt, 16 (w % 2) + lane
  // % 16) of the tile (warp w of warpgroup wg owns 16 pixels of a row)
  const int col = 16 * (w & 1) + (lane & 15);
  const int lr0 = wg * 4 + (w >> 1);
  const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt == 1) wgmma_wait<1>();
    const int spix = (lr0 + 2 * mt + dy) * SW + col + dx;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(a[mt][ks], sb + spix * 128 +
                                 (((2 * ks + (lane >> 4)) ^ (spix & 7)) << 4));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) mma<BN>(acc[mt], a[mt][ks], desc + 2 * ks);
    wgmma_commit();
  }
}

// The weights rows co0 .. co0 + BN of wp[tap][co][ci0 .. ci0 + 64) (cinp
// elements a row) into the 128-byte swizzled tile at sa, zeros past Cout
// and past the packed row.
template <int BN>
__device__ __forceinline__ void load_weights(uint32_t sa, const bf16* wp,
                                             int tap, int co0, int Cout,
                                             int ci0, int cinp) {
#pragma unroll
  for (int e = threadIdx.x; e < BN * 8; e += NT) {
    const int r = e >> 3, s = e & 7, co = co0 + r, ci = ci0 + s * 8;
    const bool v = co < Cout && ci < cinp;
    cp_async16(sa + swz(r, s),
               v ? wp + (static_cast<size_t>(tap) * Cout + co) * cinp + ci : wp,
               v);
  }
}

// Grid (ceil(H / TH) * ceil(W / TW), ceil(Cout / BN), pairs * splits).
// Block (pixel tile, channel tile, z = pair * splits + split) sums the
// chunks [split * cps, min(chunks, (split + 1) * cps)) of Cin (K27: the one
// K of 32) of its pair's image and hands each output to epi (at the pair's
// planes), or, with work, stores it in fp32 in work[z] (Cout, H, W) for
// conv3x3_split_reduce_kernel. wp is 16-byte aligned. MULTI: a block may
// sum more than one chunk (the next chunk's staging is compiled in); a
// block of one chunk at BN <= 64 takes the body without it, which at BN =
// 64 holds to 128 registers a thread, so that two blocks share an SM
// (narrower N tiles spilled there). PAIRS: the instance of a batch (one
// image: z = split, the pair arithmetic compiled out).
template <int BN, bool K27, bool MULTI, typename Epi, bool PAIRS = false>
__global__ void __launch_bounds__(NT, BN == 64 && !MULTI ? 2 : 1)
conv3x3_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                     Epi epi, float* __restrict__ work, int Cin, int Cout,
                     int H, int W, int cps, int splits) {
  constexpr int TAPS = K27 ? 1 : 9;
  // taps between a slab part's loads and its store: two at BN = 64 and 128
  // (the main paths' layers), else one
  constexpr int LOOK = BN == 128 || BN == 64 ? 2 : 1;
  static_assert(TAPS != 9 || PARTS == 8, "8 parts staged behind 9 taps");
  constexpr int KS = K27 ? 2 : 4;      // k16 steps an item
  constexpr int SLOT = BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* slabs = sm + WS * SLOT;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int cinp = K27 ? 32 : (Cin + 7) & ~7;
  const int chunks = K27 ? 1 : (Cin + BK - 1) / BK;
  const int split = PAIRS ? blockIdx.z % splits : blockIdx.z;
  const int cb = split * cps;
  const int nch = max(0, min(chunks, cb + cps) - cb);
  const int total = nch * TAPS;
  const size_t hw = static_cast<size_t>(H) * W;
  if constexpr (PAIRS)
    xs += static_cast<size_t>(blockIdx.z / splits) * Cin * hw;
  const SlabPix sp = slab_pixels(H, W, h0, w0);

  // item it = (chunk cb + it / TAPS, tap): its weights into slot it % WS
  auto load_w = [&](int it) {
    const int c = it / TAPS;
    load_weights<BN>(smem_addr(sm + (it % WS) * SLOT), wp, it - c * TAPS,
                     co0, Cout, (cb + c) * BK, cinp);
  };
#pragma unroll
  for (int it = 0; it < D; ++it) {
    if (it < total) load_w(it);
    cp_async_commit();
  }
  // chunk 0's slab, G parts' loads in flight at once (the accumulators
  // are not live yet; two parts where two blocks share an SM, whose 128
  // registers a thread hold no more without spilling)
  if (nch > 0) {
    if constexpr (K27) {
      stage_im2col(slabs, xs, H, W, hw, h0, w0);
    } else {
      constexpr int G = BN <= 64 && !MULTI ? 2 : 8;
#pragma unroll
      for (int p0 = 0; p0 < PARTS; p0 += G) {
        uint32_t pv[G][2][8];
#pragma unroll
        for (int g = 0; g < G; ++g)
          load_part(pv[g], xs, sp, Cin, hw, cb * BK, p0 + g);
#pragma unroll
        for (int g = 0; g < G; ++g) store_part(slabs, pv[g], p0 + g);
      }
    }
  }

  float acc[2][BN / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.0f;
  uint32_t a[2][KS][4];
  uint32_t va[2][8], vb[2][8];  // the next chunk's parts in flight

  // item it = (chunk c of the split, tap); with LOOK = 2 the taps run in
  // pairs, so that the staging's register buffer is chosen at compile time
  // by the tap's parity (odd_tap)
  auto item = [&](int c, int tap, auto odd_tap) {
    const int it = c * TAPS + tap;
    wgmma_wait<1>();         // only item it - 1's second M tile may run
    cp_async_wait<D - 1>();  // this thread's copies of item it landed
    fence_proxy_async();
    __syncthreads();  // item it's weights and chunk c's slab are complete;
                      // both warpgroups are past item it - 2, whose slot
                      // (it + D) % WS is refilled now
    if (it + D < total) load_w(it + D);
    cp_async_commit();
    item_products<BN, KS>(acc, a, smem_addr(slabs + (c & 1) * SLAB_BYTES),
                          make_desc(smem_addr(sm + (it % WS) * SLOT)),
                          K27 ? 4 : tap);  // K27: the centre tap's rows
    // the next chunk's slab behind this tap's products: part tap's loads
    // (taps 0 .. 7) land while LOOK taps run, and are stored then (the
    // last parts at tap 8)
    if constexpr (!K27 && MULTI) {
      if (c + 1 < nch) {
        unsigned char* nxt = slabs + ((c + 1) & 1) * SLAB_BYTES;
        const int ci0 = (cb + c + 1) * BK;
        if constexpr (LOOK == 1) {
          if (tap > 0) store_part(nxt, va, tap - 1);
          if (tap < PARTS) load_part(va, xs, sp, Cin, hw, ci0, tap);
        } else {
          uint32_t(&v)[2][8] = decltype(odd_tap)::value ? vb : va;
          if (tap >= 2) store_part(nxt, v, tap - 2);
          if (tap == TAPS - 1) store_part(nxt, vb, PARTS - 1);
          if (tap < PARTS) load_part(v, xs, sp, Cin, hw, ci0, tap);
        }
      }
    }
  };
  for (int c = 0; c < nch; ++c) {
    if constexpr (LOOK == 2 && MULTI) {
      for (int q = 0; q < TAPS / 2; ++q) {  // taps in pairs: even, odd
        item(c, 2 * q, std::false_type{});
        item(c, 2 * q + 1, std::true_type{});
      }
      item(c, TAPS - 1, std::false_type{});
    } else {
      for (int tap = 0; tap < TAPS; ++tap) item(c, tap, std::false_type{});
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  cp_async_wait<0>();
  __syncthreads();  // every product and copy is done: the ring is free

  float* cs = reinterpret_cast<float*>(sm);  // (BN, LDP)
  stage_acc<BN>(cs, acc);
  __syncthreads();
  store_tile<BN>(cs, epi,
                 work == nullptr
                     ? nullptr
                     : work + static_cast<size_t>(blockIdx.z) * Cout * hw,
                 Cout, H, W, co0, h0, w0,
                 PAIRS ? static_cast<size_t>(blockIdx.z / splits) * Cout * hw
                       : 0);
}

// y = epi(work[0] + work[1] + ...): each pair's (blockIdx.y's) split
// partials summed in split order, each output handed to the epilogue once.
template <typename Epi>
__global__ void conv3x3_split_reduce_kernel(const float* __restrict__ work,
                                            Epi epi, int splits, int Cout,
                                            int H, int W) {
  const size_t hw = static_cast<size_t>(H) * W, n = Cout * hw;
  const float* wk = work + blockIdx.y * splits * n;
  const size_t ob = blockIdx.y * n;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += wk[sp * n + i];
    epi(ob + i, static_cast<int>(i / hw), static_cast<int>(i % hw / W), s);
  }
}

template <typename Epi>
int reduce_splits(float* work, Epi epi, int splits, int Cout, int H, int W,
                  int pairs, cudaStream_t st) {
  if (splits > 1) {
    const long long n = static_cast<long long>(Cout) * H * W;
    const dim3 grid(dpst::grid_for(n, 256, std::max(1, 132 * 16 / pairs)),
                    pairs);
    conv3x3_split_reduce_kernel<Epi><<<grid, 256, 0, st>>>(work, epi, splits,
                                                          Cout, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// One instance: MULTI unless the block sums one chunk at BN <= 64 (or is
// conv1_1's K27); PAIRS for a batch of pairs > 1 images.
template <int BN, bool K27, bool MULTI, bool PAIRS, typename Epi>
int launch_inst(const void* x, const void* wp, Epi epi, float* work, int Cin,
                int Cout, int H, int W, int splits, int cps, int pairs,
                cudaStream_t st) {
  const int bytes = smem_bytes<BN>(slabs_for(BN, cps));
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(
      conv3x3_wgmma_kernel<BN, K27, MULTI, Epi, PAIRS>, smem_bytes<BN>(2),
      allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Cout + BN - 1) / BN, pairs * splits);
  conv3x3_wgmma_kernel<BN, K27, MULTI, Epi, PAIRS><<<grid, NT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp), epi,
      splits > 1 ? work : nullptr, Cin, Cout, H, W, cps, splits);
  return reduce_splits(work, epi, splits, Cout, H, W, pairs, st);
}

template <int BN, bool K27, bool PAIRS, typename Epi>
int launch_bn(const void* x, const void* wp, Epi epi, float* work, int Cin,
              int Cout, int H, int W, int splits, int cps, int pairs,
              cudaStream_t st) {
  if constexpr (K27) {
    return launch_inst<BN, true, false, PAIRS, Epi>(
        x, wp, epi, work, Cin, Cout, H, W, splits, cps, pairs, st);
  } else {
    if constexpr (BN <= 64) {
      if (cps == 1)
        return launch_inst<BN, false, false, PAIRS, Epi>(
            x, wp, epi, work, Cin, Cout, H, W, splits, cps, pairs, st);
    }
    return launch_inst<BN, false, true, PAIRS, Epi>(
        x, wp, epi, work, Cin, Cout, H, W, splits, cps, pairs, st);
  }
}

// The bf16 conv of `pairs` images (PAIRS: the batch instance, for pairs >
// 1) on N tiles of bn output channels (one of Widths), in `splits` splits
// of `cps` chunks of 64 input channels, each non-empty; work (pairs,
// splits, Cout, H, W) fp32 when splits > 1. Returns cudaGetLastError()
// after the launches.
template <bool PAIRS, typename Epi, int... N>
int launch(const void* x, const void* wp, Epi epi, float* work, int Cin,
           int Cout, int H, int W, int bn, int splits, int cps, int pairs,
           cudaStream_t st, Widths<N...>) {
  const int chunks = (Cin + BK - 1) / BK;
  if (Cin < 1 || Cout < 1 || H < 1 || W < 1 || splits < 1 || cps < 1 ||
      (splits - 1) * cps >= chunks || (splits > 1 && work == nullptr) ||
      pairs < 1 || (pairs > 1) != PAIRS || pairs * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((bn == N &&
          (rc = launch_bn<N, false, PAIRS, Epi>(x, wp, epi, work, Cin, Cout,
                                                H, W, splits, cps, pairs, st),
           true)) ||
         ...);
  return rc;
}

// conv1_1 (Cin = 3) as one K of 32: wp packed (Cout, 32), Cout <= 64.
template <typename Epi>
int launch_k27(const void* x, const void* wp, Epi epi, int Cout, int H, int W,
               cudaStream_t st) {
  if (Cout < 1 || Cout > 64 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bn<64, true, false, Epi>(x, wp, epi, nullptr, 3, Cout, H, W,
                                         1, 1, 1, st);
}

// Resources of the instance that sums cps chunks a block at N tiles of BN,
// for the record: registers a thread, local memory bytes a thread (spills and
// stack), dynamic shared memory bytes a block, resident blocks an SM.
template <int BN, bool K27, typename Epi>
int attrs(int cps, int* out) {
  const void* fn = reinterpret_cast<const void*>(
      conv3x3_wgmma_kernel<BN, K27, !K27, Epi>);
  if constexpr (BN <= 64) {
    if (cps == 1)
      fn = reinterpret_cast<const void*>(
          conv3x3_wgmma_kernel<BN, K27, false, Epi>);
  }
  const int bytes = smem_bytes<BN>(slabs_for(BN, cps));
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = bytes;
  out[3] = blocks;
  return 0;
}

}  // namespace conv90
}  // namespace
