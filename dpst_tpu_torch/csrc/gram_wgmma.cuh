// Hopper bodies of the bf16 masked-Gram kernels of csrc/gram.cu
// (dpst_gram_fwd, dpst_gram_relu_fwd, dpst_gram_bwd and dpst_gram_wbwd in
// bf16; fp32 keeps the CUDA-core tiles of gram_tile.cuh and gram.cu, since
// TF32 would drop mantissa bits):
//
//   forward    G_k = F . round(F * m2_k)^T in fp32   f (C, P), m2 (K, P)
//              (gram_relu_fwd: F = round(max(z + b, 0)), z + b in fp32)
//   backward   dF  = round( sum_{k,c'} S_k[c][c'] * round(F[c'] * m2_k) )
//   weighted-after backward (gram_wbwd)
//              dF  = round( sum_k (S_k . F)[c] * m2_k ), each class's
//              product summed in fp32, then times m2_k in fp32, folded in
//              class order
//              (gram_relu_bwd: F = round(max(z + b, 0)), and the sum
//              times relu'(z + b) in fp32 before the rounding: dz)
//
// They replace the TPU kernels dpst_tpu/ops/gram_stream.py:_fwd_kernel
// (launched by _gram_fwd_call) and :_bwd_kernel (launched by
// _gram_raw_bwd), with the rounding of dpst_tpu/ops/losses.py:
// _grams_raw_flat, dpst_tpu/ops/gram_s2d.py:_fwd_kernel2, :_fwd_kernel,
// :_bwd_kernel2 and :_bwd_kernel, and dpst_tpu/ops/gram_pallas.py:
// _bwd_kernel. Summation orders differ
// from the TPU's; every product accumulates in fp32, the weighted operand
// is rounded to bf16 as the JAX package forms it, dF is rounded once, and
// no float atomics are used, so a rerun is bit-identical.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at 512^2, K = 4, each
// tap's Grams take 2*K*C*C*P = 8.6 GFLOP (2.1 at conv5_1), 8.7 us at
// peak, while conv1_1 (C = 64, P = 2^18) reads 32 MB of F and the backward
// writes 32 MB of dF: bytes bound conv1_1 (~20 us for the backward),
// operations the deep taps. At 4096^2 gram_wbwd's conv3_1 (C = 256, P =
// 2^20) takes 550 GFLOP, 0.556 ms at peak; gram_relu_fwd's conv1_1 at
// 1024^2 (C = 64, P = 2^20) reads 143 MB, 0.043 ms.
//
// Design. One warpgroup (128 threads) per block runs wgmma (m64nNk16, fp32
// accumulators in registers). The weighted operand is never stored: F
// arrives in shared memory once per stage, each thread reads its wgmma A
// fragment of F with ldmatrix, multiplies it by m2_k and rounds it in
// registers, once per class, and hands it to wgmma as the register A
// operand. The other operand (F in the forward, the cotangent in the
// backward) is read by wgmma from shared memory in the 128-byte swizzled
// K-major layout. Operands arrive by cp.async (16 bytes a thread, no
// division in the address arithmetic) in a ring of slots, so the loads of
// later stages overlap this stage's products.
//   forward: a block owns a 64 x 64 tile (rows j, columns i) of all classes
//     of a class group (up to KG = 4 accumulators of 32 registers) over one
//     split of P. A stage brings F[j tile] and F[i tile] (once for a
//     diagonal tile) and the group's masks, 128 pixels deep; the block
//     computes G_k^T[j][i] = sum_p round(F_j m2_k) F_i and stores it
//     transposed. Each split writes an fp32 partial that gram.cu sums in a
//     fixed order; the splits are sized so the grid is one wave. The
//     bias+ReLU variant cooks each landed tile in place, once (F_i and F_j
//     are the same bytes on a diagonal tile), before any read of it.
//   backward: a block owns a c tile (N = 64 or 128 rows) and walks p tiles
//     of 64 pixels, one after the other in one ring (a persistent block:
//     the short blocks of conv1_1 would otherwise wait on their first
//     loads). For each p tile it walks the reduction r = (k, c') in items
//     of 64 c' of one class; F[c' chunk, p tile] is loaded and read into
//     registers once per chunk (ldmatrix.trans) and serves every class;
//     the cotangent comes as the plain matrix A = (C, K*Cp), A[c][k*Cp +
//     c'] = S_k[c][c'] (Cp = C rounded up to 8, zero padded), whose tiles
//     are 16-byte rows. One fp32 accumulator takes all K*C products; the
//     epilogue (a template parameter: gram.cu rounds the sum, block12.cu
//     adds its conv term and relu' first) rounds it once and stores dF in
//     16-byte vectors through shared memory. The p tiles may walk a band
//     of rows in each of several stacked bands (BwdArgs). Where the (p
//     tile x c tile) grid cannot fill the card (conv5_1 at 512^2), the
//     reduction is split across blocks into fp32 partials, summed in a
//     fixed order and rounded once.
//   weighted-after backward: m2_k meets each class's product only once
//     the product is complete, so the reduction walks classes outer and c'
//     chunks inner, with two fp32 accumulators (the class's product, and
//     the running weighted sum that the class folds into). F is then the
//     same for every class: a block keeps its p tile's F chunks resident in
//     shared memory, where wgmma reads them as a transposed operand. Two
//     warpgroups take 64 pixels each of a 128-pixel p tile and share each
//     cotangent tile, which halves the cotangent's traffic from L2 against
//     one warpgroup's 64 pixels (that traffic, not the tensor cores, holds
//     gram_bwd's body). See gram_wbwd_body.
//   bias+ReLU backward (gram_relu_bwd): gram_wbwd_body with a cook of each
//     z chunk where it lands and relu' before the store, for any C; at C
//     <= 64 (conv1_1, the only tap that takes it on the main paths) a body
//     of its own, bound by bytes: the whole cotangent resident, four
//     warpgroups each with its own ring of raw z tiles run ahead, and a
//     tile's class products issued two at a time in dz's own layout (S_k
//     times F, F read transposed). See gram_relu_bwd64_body.
// Rows need 16-byte alignment: P % 8 == 0 (the wrapper pads P with zero
// columns, which add nothing to G and whose dF is dropped).
//
// The (P, C) form (template parameter PC, false by default: gram.cu's,
// gram_relu_bwd.cu's, gram_wbwd_pairs.cu's and block12.cu's instances are
// the (C, P) form's code): the tap as a channels_last activation holds it,
// P rows of C channels (C % 8 == 0), read where it lies and never copied to
// (C, P). A tile then holds 64 pixel rows of 64 channels (the same 128-byte
// swizzle), which the bodies read through the other orientation of each
// operand (ldmatrix with or without .trans, a descriptor read K-major or
// MN-major), so every product, weighting, fold and rounding is the (C, P)
// form's; dF and dz leave in (P, C) order, a pixel's channels in 16-byte
// pieces, so autograd hands the bias+ReLU backward a channels_last
// cotangent. Only the masks need P % 8 == 0 (the wrapper pads them; F's
// pixel rows are checked one by one). gram_pc.cu and gram_pc_wbwd.cu
// instantiate them (translation units of their own, so that the (C, P)
// kernels compile as they did without them) and hand their kernels out as
// handles (namespace gram_pc, at the end): each form is launched by its
// twin's launch code, templated on PC, through `launch`.
#pragma once

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

// Internal linkage, as gram_tile.cuh: each source that includes the header
// (gram.cu, block12.cu) gets its own kernels.
namespace {
namespace gram90 {

using namespace hopper;
using bf16 = __nv_bfloat16;
using dpst::from_f;
using dpst::to_f;

constexpr int NT = 128;               // one warpgroup
constexpr int BK = 64;                // depth of a swizzle atom (128 bytes)
constexpr int STAGES = 4;             // slots of the backward's ring
constexpr int TILE_BYTES = 64 * 128;  // 64 rows of 64 bf16
constexpr int KG = 4;                 // classes per forward block
// the forward's stages are FWD_HALVES atoms deep, in a ring of FWD_STAGES
// (on the H100 two atoms in three slots ran 8-10 % faster than one atom in
// four or six slots; two atoms in four slots left one block an SM)
constexpr int FWD_HALVES = 2;
constexpr int FWD_STAGES = 3;

// Two bf16 of F (low half first) times their masks, each product in fp32
// (exact) rounded once to bf16: round(F * m2), the plain version's value.
__device__ __forceinline__ uint32_t weigh2(uint32_t x, float m0, float m1) {
  __nv_bfloat162 v;
  memcpy(&v, &x, 4);
  const float2 xf = __bfloat1622float2(v);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fmul_rn(xf.x, m0), __fmul_rn(xf.y, m1));
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// The forward's operands: F and the masks as rows of ldf and ldm elements,
// in bands of P pixels whose first pixels lie fband and mband elements
// apart (one band, fband = mband = 0, for gram.cu; block12's Gram
// partials take one band per 32-row band of the image).
struct FwdArgs {
  const bf16* f;
  const bf16* m2;
  float* out;
  long long ldf, ldm, fband, mband;
  int C, P, K, S, chunk;
  const bf16* bias = nullptr;  // (C,): the bias+ReLU variant's b
  int prows = 0;  // the (P, C) form's pixel rows of F (P may pad past them)
};

// Two bf16 of the raw tap (low half first) cooked as the plain version
// does: round(max(z + b, 0)), z + b in fp32.
__device__ __forceinline__ uint32_t cook2(uint32_t x, float b) {
  __nv_bfloat162 v;
  memcpy(&v, &x, 4);
  const float2 zf = __bfloat1622float2(v);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      fmaxf(__fadd_rn(zf.x, b), 0.0f), fmaxf(__fadd_rn(zf.y, b), 0.0f));
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// Two bf16 of the raw tap of two channels (low half first) cooked with
// their own biases: the (P, C) form's pieces hold 8 channels of a pixel.
__device__ __forceinline__ uint32_t cook2b(uint32_t x, float b0, float b1) {
  __nv_bfloat162 v;
  memcpy(&v, &x, 4);
  const float2 zf = __bfloat1622float2(v);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      fmaxf(__fadd_rn(zf.x, b0), 0.0f), fmaxf(__fadd_rn(zf.y, b1), 0.0f));
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// A 16-byte piece of a (P, C) tile, 8 channels of one pixel, cooked with
// the 8 channels' biases.
__device__ __forceinline__ uint4 cook16b(uint4 v, const float (&b)[8]) {
  v.x = cook2b(v.x, b[0], b[1]);
  v.y = cook2b(v.y, b[2], b[3]);
  v.z = cook2b(v.z, b[4], b[5]);
  v.w = cook2b(v.w, b[6], b[7]);
  return v;
}

// Cook a landed 64-row tile in place. Thread tid takes the 16-byte pieces
// tid + NT * i, i < 4, which lie in rows (tid >> 3) + 16 i: b[i] is that
// row's bias (0 for a row past C, whose zero fill then stays 0).
__device__ __forceinline__ void cook_tile(unsigned char* tile,
                                          const float (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + NT * i;
    uint4* q = reinterpret_cast<uint4*>(tile + swz(e >> 3, e & 7));
    uint4 v = *q;
    v.x = cook2(v.x, b[i]);
    v.y = cook2(v.y, b[i]);
    v.z = cook2(v.z, b[i]);
    v.w = cook2(v.w, b[i]);
    *q = v;
  }
}

// Cook a landed 64-pixel tile of the (P, C) form in place: thread tid
// takes the pieces tid + NT * i, i < 4, all of channel chunk tid & 7, whose
// 8 biases are b (0 past C, where the zero fill then stays 0).
__device__ __forceinline__ void cook_tile_pc(unsigned char* tile,
                                             const float (&b)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + NT * i;
    uint4* q = reinterpret_cast<uint4*>(tile + swz(e >> 3, e & 7));
    *q = cook16b(*q, b);
  }
}

// Forward body of one block; the kernels that launch it (gram.cu's
// gram_fwd_wgmma_kernel, block12.cu's block12_gram_wgmma_kernel) give it a
// grid (tiles * tiles, ceil(K / KG), bands * S). Block (tile, class group,
// z = band * S + split) computes out[z][k][i0..][j0..] = sum over the
// band's pixels p in [split * chunk, min(P, (split + 1) * chunk)) of
// F[i][p] * round(F[j][p] * m2_k[p]) for the group's classes. A stage is
// H = FWD_HALVES atoms of 64 pixels deep; chunk % (64 * H) == 0, and the
// rows are 16-byte aligned (P, ldf, ldm, fband and mband % 8 == 0).
// RELU (gram_relu_fwd) takes f as the raw tap z and cooks F = round(max(z
// + b, 0)) in shared memory; without it (gram_fwd, block12's Gram
// partials) that step is compiled out. A cooked zero fill is relu(b), not
// 0: pixels past the split or padded by the wrapper still add nothing,
// since their masks are zero and round(F * 0) = 0.
// PC (gram_pc.cu): F is the tap as it lies in a channels_last activation,
// P rows of C channels (C % 8 == 0, ldf the row stride, fband a pair's),
// of which the first a.prows are pixels. A stage brings 64H pixel rows of
// the F_j and F_i tiles (16-byte rows of 8 channels, swizzled as wgmma
// reads a MN-major operand): the A fragments of F_j come by ldmatrix.trans
// and F_i is wgmma's B operand read transposed, so the products, the
// weighting and the stores are the (C, P) form's, term for term.
template <bool RELU = false, bool PC = false>
__device__ __forceinline__ void gram_fwd_body(const FwdArgs& a) {
  constexpr int H = FWD_HALVES, S = FWD_STAGES;
  // a slot: F_j halves, F_i halves, then the group's masks (KG x 64H bf16)
  constexpr int SLOT = 2 * H * TILE_BYTES + 1024;
  static_assert(KG * 128 * H <= 1024, "the masks fit their part of a slot");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int C = a.C, K = a.K;
  const int band = blockIdx.z / a.S, split = blockIdx.z - band * a.S;
  const bf16* f = a.f + band * a.fband;
  const bf16* m2 = a.m2 + band * a.mband;
  const size_t ldf = static_cast<size_t>(a.ldf), ldm = static_cast<size_t>(a.ldm);
  const int tiles = (C + 63) >> 6;
  const int tj = blockIdx.x / tiles, ti = blockIdx.x - tj * tiles;
  const int j0 = tj * 64, i0 = ti * 64;
  const bool diag = ti == tj;
  const int k0 = blockIdx.y * KG, kn = min(KG, K - k0);
  const int pb = split * a.chunk, pe = min(a.P, pb + a.chunk);
  const int nst = (pe - pb + BK * H - 1) / (BK * H);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // stage s: F[j0.., p0..p0+64H), F[i0.., same] and the group's masks
  auto load = [&](int s) {
    const uint32_t sa = smem_addr(sm + (s % S) * SLOT);
    const int p0 = pb + s * BK * H;
    if constexpr (PC) {
      // pixel rows p0 .. p0 + 64H, 8 channels a piece; tile h holds rows
      // 64h .. 64h + 63
#pragma unroll
      for (int e = tid; e < 64 * 8 * H; e += NT) {
        const int hr = e >> 3, c = e & 7, h = hr >> 6, r = hr & 63;
        const int p = p0 + hr;
        const bool pv = p < pe && p < a.prows;
        const bool vj = pv && j0 + c * 8 < C;
        cp_async16(sa + h * TILE_BYTES + swz(r, c),
                   vj ? f + p * ldf + j0 + c * 8 : f, vj);
        if (!diag) {
          const bool vi = pv && i0 + c * 8 < C;
          cp_async16(sa + (H + h) * TILE_BYTES + swz(r, c),
                     vi ? f + p * ldf + i0 + c * 8 : f, vi);
        }
      }
    } else {
#pragma unroll
      for (int e = tid; e < 64 * 8 * H; e += NT) {
        const int hr = e >> 3, c = e & 7, h = hr >> 6, r = hr & 63;
        const int p = p0 + h * 64 + c * 8;
        const bool pv = p < pe;
        const bool vj = pv && j0 + r < C;
        cp_async16(sa + h * TILE_BYTES + swz(r, c),
                   vj ? f + (j0 + r) * ldf + p : f, vj);
        if (!diag) {
          const bool vi = pv && i0 + r < C;
          cp_async16(sa + (H + h) * TILE_BYTES + swz(r, c),
                     vi ? f + (i0 + r) * ldf + p : f, vi);
        }
      }
    }
    if (tid < kn * 8 * H) {
      const int q = tid / (8 * H), c = tid % (8 * H), p = p0 + c * 8;
      const bool v = p < pe;
      cp_async16(sa + 2 * H * TILE_BYTES + q * 128 * H + c * 16,
                 v ? m2 + (k0 + q) * ldm + p : m2, v);
    }
  };

  float acc[KG][32];
#pragma unroll
  for (int q = 0; q < KG; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.0f;

  // the biases of the rows this thread cooks (cook_tile), of F_j and F_i;
  // PC: of the 8 channels of its chunk tid & 7 (cook_tile_pc)
  float bj[PC ? 8 : 4], bi[PC ? 8 : 4];
  if constexpr (RELU && PC) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = (tid & 7) * 8 + i;
      bj[i] = j0 + c < C ? to_f(a.bias[j0 + c]) : 0.0f;
      bi[i] = i0 + c < C ? to_f(a.bias[i0 + c]) : 0.0f;
    }
  } else if constexpr (RELU) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 16 * i;
      bj[i] = j0 + r < C ? to_f(a.bias[j0 + r]) : 0.0f;
      bi[i] = i0 + r < C ? to_f(a.bias[i0 + r]) : 0.0f;
    }
  }

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<S - 2>();
    fence_proxy_async();
    __syncthreads();  // stage s landed; stage s - 1's slot is free
    if (s + S - 1 < nst) load(s + S - 1);
    cp_async_commit();
    if constexpr (RELU) {
      // each landed tile once: on a diagonal tile F_i is F_j
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if constexpr (PC)
          cook_tile_pc(sm + (s % S) * SLOT + h * TILE_BYTES, bj);
        else
          cook_tile(sm + (s % S) * SLOT + h * TILE_BYTES, bj);
      }
      if (!diag) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if constexpr (PC)
            cook_tile_pc(sm + (s % S) * SLOT + (H + h) * TILE_BYTES, bi);
          else
            cook_tile(sm + (s % S) * SLOT + (H + h) * TILE_BYTES, bi);
        }
      }
      fence_proxy_async();  // generic stores, then wgmma's async reads
      __syncthreads();
    }

    const unsigned char* slot = sm + (s % S) * SLOT;
    const uint32_t sa = smem_addr(slot);
    const bf16* msk = reinterpret_cast<const bf16*>(slot + 2 * H * TILE_BYTES);
    uint32_t wa[2][4][4];  // weighted fragments, two classes in flight
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint64_t desc =
          make_desc(sa + ((diag ? 0 : H) + h) * TILE_BYTES);
      // warp w's A rows are j0 + 16w .. + 15: its F fragments for the four
      // 16-pixel steps of this half
      uint32_t fa[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if constexpr (PC)
          // the tile's rows are pixels: A[j][p] = F[p][j], transposed
          ldmatrix_x4_trans(fa[ks], sa + h * TILE_BYTES +
                                        swz(ks * 16 + ((lane >> 4) << 3) +
                                                (lane & 7),
                                            2 * w + ((lane >> 3) & 1)));
        else
          ldmatrix_x4(fa[ks], sa + h * TILE_BYTES + swz(w * 16 + (lane & 15),
                                                      ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int q = 0; q < KG; ++q) {
        if (q < kn) {
          // the class issued two before this one released wa[q & 1]; the
          // half's first class follows the last half's class kn - 1,
          // which used the same buffer when kn is odd
          if (q == 0 && h > 0 && (kn & 1))
            wgmma_wait<0>();
          else if (h > 0 || q >= 2)
            wgmma_wait<1>();
          const bf16* mq = msk + q * 64 * H + h * 64;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            // columns 2t, 2t + 1 and 2t + 8, 2t + 9 of this 16-pixel step
            const int pc = ks * 16 + 2 * t;
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(mq + pc));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(mq + pc + 8));
            wa[q & 1][ks][0] = weigh2(fa[ks][0], lo.x, lo.y);
            wa[q & 1][ks][1] = weigh2(fa[ks][1], lo.x, lo.y);
            wa[q & 1][ks][2] = weigh2(fa[ks][2], hi.x, hi.y);
            wa[q & 1][ks][3] = weigh2(fa[ks][3], hi.x, hi.y);
          }
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            if constexpr (PC)
              wgmma_64rt(acc[q], wa[q & 1][ks], desc + 128 * ks);
            else
              wgmma_64(acc[q], wa[q & 1][ks], desc + 2 * ks);
          }
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
  }
#pragma unroll
  for (int q = 0; q < KG; ++q) fence_regs(acc[q]);

  // acc[q][4n + 2h + e] = G^T[j0 + 16w + g + 8h][i0 + 8n + 2t + e]
  float* o = a.out + (static_cast<size_t>(blockIdx.z) * K + k0) * C * C;
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    if (q < kn) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + w * 16 + g + 8 * h, i = i0 + 8 * n + 2 * t + e;
            if (i < C && j < C)
              o[(static_cast<size_t>(q) * C + i) * C + j] =
                  acc[q][4 * n + 2 * h + e];
          }
    }
  }
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  if constexpr (N == 64)
    wgmma_64(d, a, desc);
  else
    wgmma_128(d, a, desc);
}

// The backward's operands and its walk over the pixels. F, dF and the
// epilogue's tensors are rows of ldf elements (one a channel), the masks
// rows of ldm (one a class); a is the cotangent matrix (C, K*Cp). The
// pixels walked are [pb, pe) of each of the bands whose first pixels lie
// bstride elements apart, in p tiles of 64 pixels, tpb a band and ptiles
// in all: gram.cu walks one band [0, P); block12.cu the rows of each band
// of a stacked group whose cotangent reaches an own output row. pb, pe,
// ldf, ldm and bstride are multiples of 8 (16-byte rows); pixel indices
// (below ptiles * 64 + bstride * bands) fit an int. gram.cu's batch runs
// `pairs` pairs in one grid (the body's PAIRS instance), the pair of a
// block blockIdx.z / (gridDim.z / pairs): its F and dF start pf elements
// after the previous pair's, its masks pm, its cotangent matrix pa
// (block12.cu: one pair).
struct BwdArgs {
  const bf16* f;
  const bf16* m2;
  const bf16* a;
  bf16* out;
  float* work;  // split partials (C rows of ldf each), or nullptr
  long long ldf, ldm;
  int bstride, pb, pe, tpb, ptiles;
  int C, K, ipb;
  long long pf = 0, pm = 0, pa = 0;
  int pairs = 1;
};

// gram.cu's epilogue: dF = round(acc). An epilogue that reads memory
// (kReads) is called only at the walked pixels.
struct BwdRound {
  static constexpr bool kReads = false;
  __device__ __forceinline__ float operator()(float acc, size_t) const {
    return acc;
  }
};

// Backward body. Grid (groups, ceil(C / N), pairs * splits), z = pair *
// splits + split. Block (g, c tile, z) walks, on its pair's operands, the p tiles g, g + groups, ... (at least one: groups <=
// ptiles) and, for each, its share of the reduction: the items [split *
// ipb, min(nit, (split + 1) * ipb)) of r = (c' chunk j of 64, class k), in
// that order. It computes over its items
//   acc = sum_r a[c][k*Cp + c'] * round(F[c'][p] * m2[k][p])
// and, when work is null (then splits == 1), stores round(epi(acc, idx))
// at out[idx], idx = c * ldf + p, through a staging tile as 16-byte rows;
// else acc in fp32 at work[split][pair][idx], which gram_bwd_reduce_kernel
// sums in split order and rounds once (the pairs' dF are contiguous). epi
// reads nothing outside the walked pixels. The ring runs on across p
// tiles, so a block's next tile loads while it finishes this one. Without
// PAIRS (one pair) the pair arithmetic compiles out, and the body is the
// one-pair body register for register.
// PC (gram_pc.cu): F and dF lie as in a channels_last activation, pixel
// rows of ldf elements (C % 8 == 0), one band [0, pe): a chunk's F tile
// holds 64 pixel rows of 64 channels, whose A fragments come by a plain
// ldmatrix, so the products are the (C, P) form's; dF leaves through a
// staging tile of pixel rows, and split partials are (splits, pairs, pe,
// C). Only gram.cu's rounding epilogue (no kReads) takes it.
template <int N, typename Epi, bool PAIRS = false, bool PC = false>
__device__ __forceinline__ void gram_bwd_body(const BwdArgs& ar,
                                              const Epi& epi) {
  constexpr int SLOT = TILE_BYTES + N * 128;  // F chunk, cotangent tile
  constexpr int D = STAGES - 2;               // items loaded ahead
  constexpr int LDT = 72;                     // epilogue tile row (bf16)
  constexpr int LDP = N + 8;  // PC: epilogue tile row (bf16), a pixel's
  static_assert(N * LDT * 2 <= SLOT, "the epilogue tile fits a slot");
  static_assert(!PC || (64 * LDP * 2 <= SLOT && !Epi::kReads),
                "the (P, C) epilogue tile fits a slot, and rounds only");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  bf16* msk = reinterpret_cast<bf16*>(sm + STAGES * SLOT);  // [STAGES][64]
  const int nsplit = PAIRS ? gridDim.z / ar.pairs : gridDim.z;
  const int pair = PAIRS ? blockIdx.z / nsplit : 0;
  const int split = blockIdx.z - pair * nsplit;
  const bf16* __restrict__ f = ar.f + pair * ar.pf;
  const bf16* __restrict__ m2 = ar.m2 + pair * ar.pm;
  const bf16* __restrict__ a = ar.a + pair * ar.pa;
  bf16* __restrict__ out = ar.out + pair * ar.pf;
  const int C = ar.C, K = ar.K;
  const size_t ldf = static_cast<size_t>(ar.ldf);
  const size_t ldm = static_cast<size_t>(ar.ldm);
  const int cpad = (C + 7) & ~7, lda = K * cpad;
  const int c0 = blockIdx.y * N;
  const int nit = ((C + 63) >> 6) * K;
  const int ib = split * ar.ipb;
  const int per = min(nit, ib + ar.ipb) - ib;  // items per p tile
  const int bx = blockIdx.x, gx = gridDim.x;
  const int ntile = (ar.ptiles - 1 - bx) / gx + 1;
  const int total = ntile * per;
  const int jb = ib / K, kb = ib - jb * K;  // the split's first item
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // position of an item: p tile (u-th of the block) with its first pixel
  // p0 and the end pe of its band's walked pixels, c' chunk j, class k,
  // and n, its index among the tile's items
  struct Pos {
    int u, j, k, n, p0, pe;
  };
  auto at_tile = [&](Pos& q) {
    const int tile = bx + q.u * gx, band = tile / ar.tpb;
    const int base = band * ar.bstride;
    q.p0 = base + ar.pb + (tile - band * ar.tpb) * 64;
    q.pe = base + ar.pe;
  };
  auto advance = [&](Pos& q) {
    if (++q.n == per) {
      q.n = 0;
      ++q.u;
      q.j = jb;
      q.k = kb;
      at_tile(q);
    } else if (++q.k == K) {
      q.k = 0;
      ++q.j;
    }
  };

  // item `it` at q into slot it % STAGES: F[64j.., p0..] where the item
  // starts a chunk or a tile (the chunk's F serves all its classes), the
  // class's masks m2[k][p0..p0+64), and a[c0.., k*cpad + 64j ..]
  auto load = [&](int it, const Pos& q) {
    const int slot = it % STAGES;
    const uint32_t sa = smem_addr(sm + slot * SLOT);
    if (q.k == 0 || q.n == 0) {
      if constexpr (PC) {
        // pixel rows p0 .. p0 + 63, channels 64j .. 64j + 63
#pragma unroll
        for (int e = tid; e < 64 * 8; e += NT) {
          const int r = e >> 3, c = e & 7, cr = q.j * 64 + c * 8;
          const int p = q.p0 + r;
          const bool v = cr < C && p < q.pe;
          cp_async16(sa + swz(r, c), v ? f + p * ldf + cr : f, v);
        }
      } else {
#pragma unroll
        for (int e = tid; e < 64 * 8; e += NT) {
          const int r = e >> 3, c = e & 7, cr = q.j * 64 + r;
          const int p = q.p0 + c * 8;
          const bool v = cr < C && p < q.pe;
          cp_async16(sa + swz(r, c), v ? f + cr * ldf + p : f, v);
        }
      }
    }
    if (tid < 8) {
      const int p = q.p0 + tid * 8;
      const bool v = p < q.pe;
      cp_async16(smem_addr(msk + slot * 64 + tid * 8),
                 v ? m2 + q.k * ldm + p : m2, v);
    }
    const int col = q.k * cpad + q.j * 64;
#pragma unroll
    for (int e = tid; e < N * 8; e += NT) {
      const int r = e >> 3, c = e & 7, cr = c0 + r;
      const bool v = cr < C && q.j * 64 + c * 8 < cpad;
      cp_async16(sa + TILE_BYTES + swz(r, c),
                 v ? a + static_cast<size_t>(cr) * lda + col + c * 8 : a, v);
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;

  Pos ql{0, jb, kb, 0, 0, 0};  // next item to load
  at_tile(ql);
#pragma unroll
  for (int it = 0; it < D; ++it) {
    if (it < total) {
      load(it, ql);
      advance(ql);
    }
    cp_async_commit();
  }

  // the tile's sums: through epi and a staging tile in the just-used slot
  // to 16-byte rows of out, or fp32 partials.
  // acc[4n + 2h + e] = sum at pixel p0 + 16w + g + 8h, channel c0 + 8n +
  // 2t + e
  auto epilogue = [&](const Pos& q, unsigned char* slot) {
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (PC) {
      if (ar.work == nullptr) {
        __syncthreads();  // every warp is done reading the slot
        bf16* tb = reinterpret_cast<bf16*>(slot);  // [64 pixels][LDP]
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                tb + (w * 16 + g + 8 * h) * LDP + 8 * n + 2 * t) =
                __floats2bfloat162_rn(acc[4 * n + 2 * h],
                                      acc[4 * n + 2 * h + 1]);
        __syncthreads();
#pragma unroll
        for (int e = tid; e < 64 * (N / 8); e += NT) {
          const int r = e / (N / 8), c = e % (N / 8);
          const int p = q.p0 + r, cr = c0 + c * 8;
          if (cr < C && p < q.pe)
            *reinterpret_cast<uint4*>(out + p * ldf + cr) =
                *reinterpret_cast<const uint4*>(tb + r * LDP + c * 8);
        }
      } else {
        float* wk = ar.work +
                    static_cast<size_t>(PAIRS ? split * ar.pairs + pair
                                              : split) * ar.pf;
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cr = c0 + 8 * n + 2 * t + e;
              const int p = q.p0 + w * 16 + g + 8 * h;
              if (cr < C && p < q.pe)
                wk[p * ldf + cr] = acc[4 * n + 2 * h + e];
            }
      }
    } else if (ar.work == nullptr) {
      // epi's loads all issued before the staging stores
      if constexpr (Epi::kReads) {
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cr = c0 + 8 * n + 2 * t + e;
              const int p = q.p0 + w * 16 + g + 8 * h;
              float& v = acc[4 * n + 2 * h + e];
              v = cr < C && p < q.pe ? epi(v, cr * ldf + p) : 0.0f;
            }
      }
      __syncthreads();  // every warp is done reading the slot
      bf16* tb = reinterpret_cast<bf16*>(slot);
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tb[(8 * n + 2 * t + e) * LDT + w * 16 + g + 8 * h] =
                from_f<bf16>(acc[4 * n + 2 * h + e]);
      __syncthreads();
#pragma unroll
      for (int e = tid; e < N * 8; e += NT) {
        const int r = e >> 3, c = e & 7, cr = c0 + r, p = q.p0 + c * 8;
        if (cr < C && p < q.pe)
          *reinterpret_cast<uint4*>(out + cr * ldf + p) =
              *reinterpret_cast<const uint4*>(tb + r * LDT + c * 8);
      }
    } else {
      float* wk = ar.work +
                  static_cast<size_t>(PAIRS ? split * ar.pairs + pair : split) *
                      C * ldf;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cr = c0 + 8 * n + 2 * t + e;
            const int p = q.p0 + w * 16 + g + 8 * h;
            if (cr < C && p < q.pe) wk[cr * ldf + p] = acc[4 * n + 2 * h + e];
          }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  };

  Pos qc{0, jb, kb, 0, 0, 0};  // item being computed
  at_tile(qc);
  uint32_t ff[4][4];     // the chunk's F fragments (A layout, rows p)
  uint32_t wf[2][4][4];  // weighted fragments, two items in flight
  auto item = [&](int it, uint32_t(&wq)[4][4]) {
    wgmma_wait<1>();  // item it - 2 released wq and its slot
    cp_async_wait<D - 1>();
    fence_proxy_async();
    __syncthreads();  // item it landed
    if (it + D < total) {
      load(it + D, ql);
      advance(ql);
    }
    cp_async_commit();
    const int slot = it % STAGES;
    unsigned char* sp = sm + slot * SLOT;
    const uint32_t sa = smem_addr(sp);
    if (qc.k == 0 || qc.n == 0) {
      // A[p][c'] = F[c'][p]: rows p0 + 16w .., the chunk's 16-deep steps
      // (PC: the tile's rows are the pixels, A as it lies)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if constexpr (PC)
          ldmatrix_x4(ff[ks], sa + swz(w * 16 + (lane & 15),
                                       ks * 2 + (lane >> 4)));
        else
          ldmatrix_x4_trans(ff[ks], sa + swz(ks * 16 + ((lane >> 4) << 3) +
                                                 (lane & 7),
                                             2 * w + ((lane >> 3) & 1)));
      }
    }
    // this thread's A rows are pixels 16w + g and 16w + g + 8
    const float mlo = to_f(msk[slot * 64 + w * 16 + g]);
    const float mhi = to_f(msk[slot * 64 + w * 16 + g + 8]);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wq[ks][0] = weigh2(ff[ks][0], mlo, mlo);
      wq[ks][1] = weigh2(ff[ks][1], mhi, mhi);
      wq[ks][2] = weigh2(ff[ks][2], mlo, mlo);
      wq[ks][3] = weigh2(ff[ks][3], mhi, mhi);
    }
    wgmma_fence();
    const uint64_t desc = make_desc(sa + TILE_BYTES);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_n<N>(acc, wq[ks], desc + 2 * ks);
    wgmma_commit();
    if (qc.n == per - 1) epilogue(qc, sp);
    advance(qc);
  };
  for (int it = 0; it < total; it += 2) {
    item(it, wf[0]);
    if (it + 1 < total) item(it + 1, wf[1]);
  }
  cp_async_wait<0>();
}

// The weighted-after backward's operands: F and dF as C rows of ldf
// elements, the masks K rows of ldm, the cotangent matrix a (C, K*Cp) as
// for gram_bwd_body; P pixels (P, ldf, ldm % 8 == 0), walked in p tiles
// of WPIX; each split takes kps classes. A batch of `pairs` pairs (the
// bias+ReLU backward's) has its pair's F and dF pf elements after the
// previous pair's, its masks pm and its cotangent matrix pa.
struct WbwdArgs {
  const bf16* f;
  const bf16* m2;
  const bf16* a;
  bf16* out;
  float* work;  // split partials (splits, pairs, C, ldf), or nullptr
  long long ldf, ldm;
  int C, P, K, kps;
  long long pf = 0, pm = 0, pa = 0;
  int pairs = 1;
};

// gram_relu_bwd's operands: gram_wbwd's, with f the raw tap z, and its
// bias b (C,).
struct ReluBwdArgs : WbwdArgs {
  const bf16* bias;
};

constexpr int WNT = 2 * NT;  // two warpgroups
constexpr int WPIX = 128;    // pixels of a p tile, 64 a warpgroup
constexpr int WMAXC = 512;   // channels whose F chunks fit shared memory
constexpr int CHUNK_BYTES = 2 * TILE_BYTES;  // 64 channels x WPIX pixels
constexpr int WSTAGES = 4;   // slots of its ring

// relu'(x) of the plain version (the subgradient of max(x, 0) that splits
// ties): 1 above 0, 1/2 at exactly 0, 0 below
__device__ __forceinline__ float relu_grad(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}

// Eight bf16 of the raw tap (a 16-byte piece of one row) cooked:
// round(max(z + b, 0)).
__device__ __forceinline__ uint4 cook16(uint4 v, float b) {
  v.x = cook2(v.x, b);
  v.y = cook2(v.y, b);
  v.z = cook2(v.z, b);
  v.w = cook2(v.w, b);
  return v;
}

// F chunk slots of the weighted-after backward with a ring of NS slots: a
// p tile's ceil(C / 64) chunks, and at least NS, so that the next tile's
// chunk, loaded NS - 2 items ahead, never lands on a chunk that products
// still in flight (the last two items') read.
__host__ __device__ constexpr int wbwd_fslots(int C, int NS) {
  return (C + 63) / 64 > NS ? (C + 63) / 64 : NS;
}

// Weighted-after backward body (gram_wbwd). Grid (groups, ceil(C / N),
// pairs * splits), WNT threads, z = pair * splits + split. Block (g, c
// tile, z) walks, on its pair's operands, the p tiles g, g +
// groups, ... (at least one: groups <= ceil(P / WPIX)) and, for each, the
// items (k, j) of its classes k in [split * kps, min(K, (split + 1) *
// kps)) outer and its c' chunks j of 64 inner. Over a class's items it
// sums in fp32
//   prod = sum_{c'} a[c][k*Cp + c'] * F[c'][p]
// and, when the class is complete, folds it into the weighted sum in
// class order: tot = tot + prod * m2_k[p] (each rounded, no contraction),
// as gram.cu's fp32 tile and the plain version do. When work is null
// (then splits == 1) it stores round(tot) at out[c * ldf + p] through a
// staging tile as 16-byte rows; else tot in fp32 at work[split][pair],
// which gram_wbwd_reduce_kernel sums in split order and rounds once.
//
// Warpgroup h computes the tile's pixels 64h .. 64h + 63 (accumulator
// rows) for the c tile's N channels (columns), so every cotangent tile
// that lands serves 128 pixels. The tile's F chunk j arrives once, with
// the first class's item j, into F slot (u * nch + j) % wbwd_fslots(C)
// (u: the block's tile count so far), where it stays for every class;
// wgmma reads it from there as the transposed A operand (A[p][c'] =
// F[c'][p]: pixel rows of 128 bytes are MN-major), so F costs no registers
// and no ldmatrix (which, issued each item before its products, held back
// an earlier version of this body on the H100). The cotangent tiles and the
// masks come through a ring of NS slots that runs on across p tiles, NS -
// 2 items ahead. A class's fold waits for its last products
// (wgmma_wait<0>), the one point where the tensor cores drain.
//
// RELU (gram_relu_bwd above 64 channels, or past RMAXK classes) takes f as
// the raw tap z: each F chunk is cooked in place, round(max(z + b, 0)) with
// b = 0 on rows past C, when it lands (with the split's first class), and
// the epilogue multiplies each weighted sum by relu'(z + b), z read again
// from device memory (the cooked chunk has lost the sign of z + b), before
// the rounding or the split partial (relu' is 0, 1/2 or 1: exact, so the
// split partials may take it one by one). Without RELU (gram_wbwd) both
// steps are compiled out.
// PAIRS: a batch's instance (see gram_bwd_body); gram_wbwd runs one pair.
// PC (gram_pc_wbwd.cu): F and dF lie as in a channels_last activation, P
// pixel rows of ldf elements (C % 8 == 0), a pair's pf apart; an F chunk is
// two tiles of 64 pixel rows of its 64 channels, which wgmma reads as a
// K-major A operand (the same products as the (C, P) form's transposed
// read), each tile cooked with the 8 biases of a piece's channels; dF
// leaves through a staging tile of pixel rows, and split partials are
// (splits, pairs, P, C).
template <int N, int NS, bool RELU = false, typename Args = WbwdArgs,
          bool PAIRS = false, bool PC = false>
__device__ __forceinline__ void gram_wbwd_body(const Args& ar) {
  constexpr int SBYTES = N * 128;  // a cotangent tile: N rows of 64 c'
  constexpr int D = NS - 2;        // items loaded ahead
  static_assert(N * 64 * 2 == SBYTES, "a staging tile fills a ring slot");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int nsplit = PAIRS ? gridDim.z / ar.pairs : gridDim.z;
  const int pair = PAIRS ? blockIdx.z / nsplit : 0;
  const int split = blockIdx.z - pair * nsplit;
  const bf16* __restrict__ f = ar.f + pair * ar.pf;
  const bf16* __restrict__ m2 = ar.m2 + pair * ar.pm;
  const bf16* __restrict__ a = ar.a + pair * ar.pa;
  bf16* __restrict__ out = ar.out + pair * ar.pf;
  const int C = ar.C, K = ar.K, P = ar.P;
  const int nch = (C + 63) >> 6, fs = wbwd_fslots(C, NS);
  unsigned char* ring = sm + fs * CHUNK_BYTES;  // [NS][SBYTES]
  bf16* msk = reinterpret_cast<bf16*>(ring + NS * SBYTES);  // [NS][WPIX]
  const size_t ldf = static_cast<size_t>(ar.ldf);
  const size_t ldm = static_cast<size_t>(ar.ldm);
  const int cpad = (C + 7) & ~7, lda = K * cpad;
  const int c0 = blockIdx.y * N;
  const int kb = split * ar.kps, ke = min(K, kb + ar.kps);
  const int per = (ke - kb) * nch;  // items per p tile
  const int bx = blockIdx.x, gx = gridDim.x;
  const int ptiles = (P + WPIX - 1) / WPIX;
  const int total = ((ptiles - 1 - bx) / gx + 1) * per;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;

  // position of an item: p tile (u-th of the block) with its first pixel
  // p0, class k, c' chunk j, and n, its index among the tile's items
  struct Pos {
    int u, k, j, n, p0;
  };
  auto advance = [&](Pos& q) {
    if (++q.n == per) {
      q.n = 0;
      ++q.u;
      q.k = kb;
      q.j = 0;
      q.p0 = (bx + q.u * gx) * WPIX;
    } else if (++q.j == nch) {
      q.j = 0;
      ++q.k;
    }
  };
  auto fslot = [&](const Pos& q) {
    return sm + ((q.u * nch + q.j) % fs) * CHUNK_BYTES;
  };

  // item `it` at q: with the split's first class, F[64j.., p0..p0+WPIX)
  // into its F slot (two swizzled tiles of 64 channel rows, one a
  // warpgroup's 64 pixels); with the class's last chunk, its masks
  // m2[k][p0..); always a[c0.., k*cpad + 64j ..] into ring slot it % NS
  auto load = [&](int it, const Pos& q) {
    const int slot = it % NS;
    if (q.k == kb) {
      const uint32_t fa = smem_addr(fslot(q));
      if constexpr (PC) {
        // pixel rows p0 .. p0 + WPIX, channels 64j ..: tile r >> 6
#pragma unroll
        for (int e = tid; e < WPIX * 8; e += WNT) {
          const int r = e >> 3, c = e & 7, cr = q.j * 64 + c * 8;
          const int p = q.p0 + r;
          const bool v = cr < C && p < P;
          cp_async16(fa + (r >> 6) * TILE_BYTES + swz(r & 63, c),
                     v ? f + p * ldf + cr : f, v);
        }
      } else {
#pragma unroll
        for (int e = tid; e < 64 * 16; e += WNT) {
          const int r = e >> 4, c = e & 15, cr = q.j * 64 + r;
          const int p = q.p0 + c * 8;
          const bool v = cr < C && p < P;
          cp_async16(fa + (c >> 3) * TILE_BYTES + swz(r, c & 7),
                     v ? f + cr * ldf + p : f, v);
        }
      }
    }
    if (q.j == nch - 1 && tid < WPIX / 8) {
      const int p = q.p0 + tid * 8;
      const bool v = p < P;
      cp_async16(smem_addr(msk + slot * WPIX + tid * 8),
                 v ? m2 + q.k * ldm + p : m2, v);
    }
    const uint32_t sa = smem_addr(ring + slot * SBYTES);
    const int col = q.k * cpad + q.j * 64;
#pragma unroll
    for (int e = tid; e < N * 8; e += WNT) {
      const int r = e >> 3, c = e & 7, cr = c0 + r;
      const bool v = cr < C && q.j * 64 + c * 8 < cpad;
      cp_async16(sa + swz(r, c),
                 v ? a + static_cast<size_t>(cr) * lda + col + c * 8 : a, v);
    }
  };

  // prod[4n + 2h + e] and tot[...]: pixel p0 + 64wg + 16w + g + 8h,
  // channel c0 + 8n + 2t + e
  float prod[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) prod[i] = tot[i] = 0.0f;

  Pos ql{0, kb, 0, 0, bx * WPIX};  // next item to load
#pragma unroll
  for (int it = 0; it < D; ++it) {
    if (it < total) {
      load(it, ql);
      advance(ql);
    }
    cp_async_commit();
  }

  // the tile's weighted sums: rounded through a staging tile in a free
  // ring slot (this item's for warpgroup 0, the last item's for 1, both
  // read by finished products) to 16-byte rows of out, or fp32 partials
  auto epilogue = [&](const Pos& q, int slot) {
    const int px0 = q.p0 + wg * 64;
    if constexpr (RELU) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cr = c0 + 8 * n + 2 * t + e;
            const int p = px0 + w * 16 + g + 8 * h;
            if (cr < C && p < P) {
              float& v = tot[4 * n + 2 * h + e];
              const size_t zi = PC ? p * ldf + cr : cr * ldf + p;
              v = __fmul_rn(v, relu_grad(__fadd_rn(to_f(f[zi]),
                                                   to_f(ar.bias[cr]))));
            }
          }
    }
    if constexpr (PC) {
      if (ar.work == nullptr) {
        __syncthreads();  // both warpgroups are done with the two slots
        unsigned char* tb =
            ring + (wg == 0 ? slot : (slot + NS - 1) % NS) * SBYTES;
        // row r (a pixel) of N channels, 16-byte pieces XOR-swizzled by r
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = w * 16 + g + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                tb + r * (2 * N) + ((n ^ (r & 7)) << 4) + t * 4) =
                __floats2bfloat162_rn(tot[4 * n + 2 * h],
                                      tot[4 * n + 2 * h + 1]);
          }
        __syncthreads();
#pragma unroll
        for (int e = tid & (NT - 1); e < 64 * (N / 8); e += NT) {
          const int r = e / (N / 8), c = e % (N / 8);
          const int p = px0 + r, cr = c0 + c * 8;
          if (cr < C && p < P)
            *reinterpret_cast<uint4*>(out + p * ldf + cr) =
                *reinterpret_cast<const uint4*>(tb + r * (2 * N) +
                                                ((c ^ (r & 7)) << 4));
        }
      } else {
        float* wk = ar.work +
                    static_cast<size_t>(PAIRS ? split * ar.pairs + pair
                                              : split) * ar.pf;
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cr = c0 + 8 * n + 2 * t + e;
              const int p = px0 + w * 16 + g + 8 * h;
              if (cr < C && p < P) wk[p * ldf + cr] = tot[4 * n + 2 * h + e];
            }
      }
    } else if (ar.work == nullptr) {
      __syncthreads();  // both warpgroups are done with the two slots
      unsigned char* tb =
          ring + (wg == 0 ? slot : (slot + NS - 1) % NS) * SBYTES;
      // row r (a channel) of 64 pixels, 16-byte pieces XOR-swizzled by r
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * n + 2 * t + e, px = w * 16 + g + 8 * h;
            *reinterpret_cast<bf16*>(tb + r * 128 +
                                     (((px >> 3) ^ (r & 7)) << 4) +
                                     (px & 7) * 2) =
                from_f<bf16>(tot[4 * n + 2 * h + e]);
          }
      __syncthreads();
#pragma unroll
      for (int e = tid & (NT - 1); e < N * 8; e += NT) {
        const int r = e >> 3, c = e & 7, cr = c0 + r, p = px0 + c * 8;
        if (cr < C && p < P)
          *reinterpret_cast<uint4*>(out + cr * ldf + p) =
              *reinterpret_cast<const uint4*>(tb + r * 128 +
                                              ((c ^ (r & 7)) << 4));
      }
    } else {
      float* wk = ar.work +
                  static_cast<size_t>(PAIRS ? split * ar.pairs + pair : split) *
                      C * ldf;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cr = c0 + 8 * n + 2 * t + e;
            const int p = px0 + w * 16 + g + 8 * h;
            if (cr < C && p < P) wk[cr * ldf + p] = tot[4 * n + 2 * h + e];
          }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.0f;
  };

  Pos qc{0, kb, 0, 0, bx * WPIX};  // item being computed
  auto item = [&](int it) {
    wgmma_wait<1>();  // item it - 2 released its ring slot
    cp_async_wait<D - 1>();
    fence_proxy_async();
    __syncthreads();  // item it landed
    if (it + D < total) {
      load(it + D, ql);
      advance(ql);
    }
    cp_async_commit();
    if constexpr (RELU) {
      if (qc.k == kb) {
        // the chunk landed with this item: cook it before any product
        unsigned char* fc = fslot(qc);
        if constexpr (PC) {
          // pieces tid + WNT i: pixel rows, all of channel chunk tid & 7
          float b8[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int cr = qc.j * 64 + (tid & 7) * 8 + i;
            b8[i] = cr < C ? to_f(ar.bias[cr]) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = tid + WNT * i, r = e >> 3;
            uint4* q = reinterpret_cast<uint4*>(fc + (r >> 6) * TILE_BYTES +
                                                swz(r & 63, e & 7));
            *q = cook16b(*q, b8);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = tid + WNT * i, r = e >> 4, c = e & 15;
            const int cr = qc.j * 64 + r;
            uint4* q = reinterpret_cast<uint4*>(fc + (c >> 3) * TILE_BYTES +
                                                swz(r, c & 7));
            *q = cook16(*q, cr < C ? to_f(ar.bias[cr]) : 0.0f);
          }
        }
        fence_proxy_async();  // generic stores, then wgmma's async reads
        __syncthreads();
      }
    }
    const int slot = it % NS;
    // A = F^T: the warpgroup's tile of the chunk, 16 channel rows a step
    // (PC: the tile's rows are the pixels, A K-major as it lies)
    const uint64_t adesc =
        make_desc(smem_addr(fslot(qc)) + wg * TILE_BYTES);
    const uint64_t bdesc = make_desc(smem_addr(ring + slot * SBYTES));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (PC && N == 64)
        wgmma_64kk(prod, adesc + 2 * ks, bdesc + 2 * ks);
      else if constexpr (PC)
        wgmma_128kk(prod, adesc + 2 * ks, bdesc + 2 * ks);
      else if constexpr (N == 64)
        wgmma_64t(prod, adesc + 128 * ks, bdesc + 2 * ks);
      else
        wgmma_128t(prod, adesc + 128 * ks, bdesc + 2 * ks);
    }
    wgmma_commit();
    if (qc.j == nch - 1) {
      // the class's product is complete: fold it in, weighted by its mask
      wgmma_wait<0>();
      fence_regs(prod);
      const bf16* mq = msk + slot * WPIX + wg * 64 + w * 16 + g;
      const float mlo = to_f(mq[0]), mhi = to_f(mq[8]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        tot[i] = __fadd_rn(tot[i], __fmul_rn(prod[i], (i & 2) ? mhi : mlo));
        prod[i] = 0.0f;
      }
      if (qc.n == per - 1) epilogue(qc, slot);
    }
    advance(qc);
  };
  // two items an iteration (faster on the H100 than one)
  for (int it = 0; it < total; it += 2) {
    item(it);
    if (it + 1 < total) item(it + 1);
  }
  cp_async_wait<0>();
}

// the C <= 64 bias+ReLU backward: four warpgroups (the most that its 128
// registers a thread allow) hide more latency than two with deeper rings
constexpr int RNS = 3;     // raw z slots of each warpgroup's ring
constexpr int RWG = 4;     // warpgroups of a block
constexpr int RPIX = 64 * RWG;  // pixels of its p tile, 64 a warpgroup
constexpr int RKA = 2;     // class products issued before one drain
constexpr int RMAXK = 8;   // classes whose cotangent tiles stay resident

// Named barrier of one warpgroup (ids 1, 2, ...; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(NT) : "memory");
}

// The bias+ReLU backward at C <= 64 and K <= RMAXK (gram_relu_bwd at
// conv1_1: C = 64, K = 4, P = 2^18 .. 2^24). Grid (groups, pairs), block
// (g, pair) on its pair's operands (WbwdArgs' pair strides), RWG * NT
// threads, one block an SM (its shared memory: relu_bwd64_smem). There one
// 64 x 64 product a class serves a 64-pixel tile, 128 KB of z and dz a
// class product: the kernel is bound by bytes (z in, dz out), and the
// design keeps everything else off that stream and the stream itself in
// flight:
//   - the cotangent a (C x K*Cp) lands once, as K swizzled tiles of 64
//     rows, and stays for the block's life;
//   - block g walks the RPIX-pixel p tiles g, g + groups, ...; warpgroup h
//     takes pixels 64h .. 64h + 63 of each, on its own: its own ring of
//     RNS raw z tiles (with their masks), run RNS - 1 tiles ahead by
//     cp.async, its own F tile and its own named barrier, so that one
//     warpgroup's cook and stores overlap another's products;
//   - a landed z tile is cooked from its ring slot into the F tile (the
//     raw tile stays: relu' needs the sign of z + b, which the cooked
//     zero has lost);
//   - a class's product is dz's own layout, S_k (A, the resident tile,
//     K-major) times F (B, the F tile read transposed): a thread's
//     accumulators hold pixel pairs of two channels, so the masks, the raw
//     z and the staged dz move as bf16 pairs;
//   - the tile's class products are issued RKA at a time back to back,
//     drained once, and folded into the weighted sum in class order (tot
//     = tot + prod * m2_k, rounded apart, as the plain version); reading
//     one accumulator while another class's product is in flight makes
//     ptxas serialize them, and four warpgroups leave 128 registers a
//     thread, so RKA = 2;
//   - the epilogue multiplies by relu'(z + b) (z from the raw slot, b on
//     rows past C 0), rounds once, stages the tile in the F tile and
//     stores it as 16-byte rows, which drain while the next tile's
//     products run.
// Pixels past P (the wrapper pads P to 8; a p tile may pass P) load as
// zeros, cook to relu(b), meet zero masks and are never stored; rows past
// C cook to 0, meet zero cotangent columns and are never stored.
// PAIRS: a batch's instance (see gram_bwd_body).
// PC (gram_pc_wbwd.cu): z and dz lie as in a channels_last activation, P
// pixel rows of ldf elements (C % 8 == 0), a pair's pf apart. A z tile then
// holds 64 pixel rows of the C channels, and a class's product is taken
// the other way round, F (A, the F tile, K-major) times S_k (B, the
// resident tile, K-major): the accumulators hold channel pairs of two
// pixels, as the gram_wbwd body's do, the masks meet them by pixel row,
// and z, the biases (from a table of the 64 in shared memory) and the
// staged dz move as channel pairs.
template <int NS, int NWG, bool PAIRS = false, bool PC = false>
__device__ __forceinline__ void gram_relu_bwd64_body(const ReluBwdArgs& ar) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const int pair = PAIRS ? blockIdx.y : 0;
  const bf16* __restrict__ z = ar.f + pair * ar.pf;
  const bf16* __restrict__ m2 = ar.m2 + pair * ar.pm;
  const bf16* __restrict__ a = ar.a + pair * ar.pa;
  bf16* __restrict__ out = ar.out + pair * ar.pf;
  const int C = ar.C, K = ar.K, P = ar.P;
  const size_t ldf = static_cast<size_t>(ar.ldf);
  const size_t ldm = static_cast<size_t>(ar.ldm);
  const int cpad = (C + 7) & ~7;
  const size_t lda = static_cast<size_t>(K) * cpad;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (NT - 1);
  const int w = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int ntile = ((P + 64 * NWG - 1) / (64 * NWG) - 1 - bx) / gx + 1;
  // [K cotangent tiles][NWG F tiles][NWG x NS raw z tiles][NWG x NS mask
  // slots of K rows of 64 pixels]
  unsigned char* cot = sm;
  unsigned char* ft = sm + (K + wg) * TILE_BYTES;
  unsigned char* zr = sm + (K + NWG + wg * NS) * TILE_BYTES;
  unsigned char* mr =
      sm + (K + NWG + NWG * NS) * TILE_BYTES + wg * NS * K * 128;
  // PC: the biases of the 64 channels, fp32, behind the mask slots
  float* bsm = reinterpret_cast<float*>(sm + (K + NWG + NWG * NS) *
                                                 TILE_BYTES +
                                        NWG * NS * K * 128);

  // the warpgroup's part of its u-th p tile: z rows into slot u % NS (row
  // r a channel, 16-byte pieces swizzled as wgmma reads F), the masks
  // m2[k][p0 .. p0 + 64) behind it
  auto load = [&](int u) {
    const int s = u % NS;
    const int p0 = (bx + u * gx) * (64 * NWG) + wg * 64;
    const uint32_t za = smem_addr(zr + s * TILE_BYTES);
    if constexpr (PC) {
      // pixel rows p0 .. p0 + 63, 8 channels a piece
#pragma unroll
      for (int e = wt; e < 64 * 8; e += NT) {
        const int r = e >> 3, c = e & 7, p = p0 + r;
        const bool v = c * 8 < C && p < P;
        cp_async16(za + swz(r, c), v ? z + p * ldf + c * 8 : z, v);
      }
    } else {
#pragma unroll
      for (int e = wt; e < 64 * 8; e += NT) {
        const int r = e >> 3, c = e & 7, p = p0 + c * 8;
        const bool v = r < C && p < P;
        cp_async16(za + swz(r, c), v ? z + r * ldf + p : z, v);
      }
    }
    if (wt < K * 8) {
      const int q = wt >> 3, c = wt & 7, p = p0 + c * 8;
      const bool v = p < P;
      cp_async16(smem_addr(mr + (s * K + q) * 128 + c * 16),
                 v ? m2 + q * ldm + p : m2, v);
    }
  };

  // the cotangent, tile k = a[0 .. 64, k*cpad .. k*cpad + 64) (zero past
  // C rows and past cpad columns), then the first NS - 1 tiles
  for (int e = tid; e < K * 64 * 8; e += NWG * NT) {
    const int k = e >> 9, r = (e >> 3) & 63, c = e & 7;
    const bool v = r < C && c * 8 < cpad;
    cp_async16(smem_addr(cot + k * TILE_BYTES) + swz(r, c),
               v ? a + r * lda + k * cpad + c * 8 : a, v);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < ntile) load(u);
    cp_async_commit();
  }

  // the biases of the rows this thread cooks (pieces wt + NT i: rows
  // (wt >> 3) + 16 i) and of the channels its accumulators hold (16w + g
  // and 16w + g + 8); 0 past C. PC: of the 8 channels of the chunk wt & 7
  // that its pieces hold, and the table of all 64
  float bc[PC ? 8 : 4], bo[2];
  if constexpr (PC) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = (wt & 7) * 8 + i;
      bc[i] = c < C ? to_f(ar.bias[c]) : 0.0f;
    }
    if (tid < 64) bsm[tid] = tid < C ? to_f(ar.bias[tid]) : 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (wt >> 3) + 16 * i;
      bc[i] = r < C ? to_f(ar.bias[r]) : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w + g + 8 * h;
      bo[h] = r < C ? to_f(ar.bias[r]) : 0.0f;
    }
  }

  cp_async_wait<NS - 1>();  // the cotangent landed (every thread's part)
  fence_proxy_async();
  __syncthreads();

  // acc: RKA classes' products; tot: the weighted sum. [4n + 2h + e]:
  // channel 16w + g + 8h, pixel 8n + 2t + e of the warpgroup's 64
  float acc[RKA][32], tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.0f;
  const uint64_t fdesc = make_desc(smem_addr(ft));
  const uint32_t cot_a = smem_addr(cot);

  for (int u = 0; u < ntile; ++u) {
    cp_async_wait<NS - 2>();
    wg_sync(wg);  // tile u landed; slot u - 1 and the F tile are free
    if (u + NS - 1 < ntile) load(u + NS - 1);
    cp_async_commit();
    const int s = u % NS;
    const unsigned char* zs = zr + s * TILE_BYTES;
    const unsigned char* ms = mr + s * K * 128;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = wt + NT * i;
      const uint32_t off = swz(e >> 3, e & 7);
      if constexpr (PC)
        *reinterpret_cast<uint4*>(ft + off) =
            cook16b(*reinterpret_cast<const uint4*>(zs + off), bc);
      else
        *reinterpret_cast<uint4*>(ft + off) =
            cook16(*reinterpret_cast<const uint4*>(zs + off), bc[i]);
    }
    fence_proxy_async();  // generic stores, then wgmma's async reads
    wg_sync(wg);

    // RKA classes' products back to back, one drain, then their folds in
    // class order
    for (int k0 = 0; k0 < K; k0 += RKA) {
#pragma unroll
      for (int q = 0; q < RKA; ++q) {
        if (k0 + q < K) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[q][i] = 0.0f;
          wgmma_fence();
          const uint64_t adesc = make_desc(cot_a + (k0 + q) * TILE_BYTES);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            if constexpr (PC)
              wgmma_64kk(acc[q], fdesc + 2 * ks, adesc + 2 * ks);
            else
              wgmma_64tb(acc[q], adesc + 2 * ks, fdesc + 128 * ks);
          }
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < RKA; ++q) {
        if (k0 + q < K && PC) {
          fence_regs(acc[q]);
          if constexpr (PC) {
            // acc[q][4n + 2h + e]: pixel 16w + g + 8h, channel 8n + 2t + e
            const bf16* mq = reinterpret_cast<const bf16*>(
                                 ms + (k0 + q) * 128) + 16 * w + g;
            const float mlo = to_f(mq[0]), mhi = to_f(mq[8]);
#pragma unroll
            for (int i = 0; i < 32; ++i)
              tot[i] = __fadd_rn(tot[i],
                                 __fmul_rn(acc[q][i], (i & 2) ? mhi : mlo));
          }
        } else if (k0 + q < K) {
          fence_regs(acc[q]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 m = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    ms + (k0 + q) * 128 + n * 16 + t * 4));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * n + 2 * h;
              tot[i] = __fadd_rn(tot[i], __fmul_rn(acc[q][i], m.x));
              tot[i + 1] =
                  __fadd_rn(tot[i + 1], __fmul_rn(acc[q][i + 1], m.y));
            }
          }
        }
      }
    }
    wg_sync(wg);  // every warp's products are done: the F tile is free

    // dz = round(tot * relu'(z + b)), pixel pairs staged in the F tile's
    // layout (PC: channel pairs of a pixel, their biases from the table)
    if constexpr (PC) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * n + 2 * h;
          const uint32_t off = swz(16 * w + g + 8 * h, n) + t * 4;
          const float2 zf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(zs + off));
          const float2 bb =
              *reinterpret_cast<const float2*>(bsm + 8 * n + 2 * t);
          *reinterpret_cast<__nv_bfloat162*>(ft + off) =
              __floats2bfloat162_rn(
                  __fmul_rn(tot[i], relu_grad(__fadd_rn(zf.x, bb.x))),
                  __fmul_rn(tot[i + 1], relu_grad(__fadd_rn(zf.y, bb.y))));
          tot[i] = tot[i + 1] = 0.0f;
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * n + 2 * h;
          const uint32_t off = swz(16 * w + g + 8 * h, n) + t * 4;
          const float2 zf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(zs + off));
          *reinterpret_cast<__nv_bfloat162*>(ft + off) = __floats2bfloat162_rn(
              __fmul_rn(tot[i], relu_grad(__fadd_rn(zf.x, bo[h]))),
              __fmul_rn(tot[i + 1], relu_grad(__fadd_rn(zf.y, bo[h]))));
          tot[i] = tot[i + 1] = 0.0f;
        }
    }
    wg_sync(wg);
    const int p0 = (bx + u * gx) * (64 * NWG) + wg * 64;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = wt + NT * i, r = e >> 3, c = e & 7;
      if constexpr (PC) {
        const int p = p0 + r;
        if (c * 8 < C && p < P)
          *reinterpret_cast<uint4*>(out + p * ldf + c * 8) =
              *reinterpret_cast<const uint4*>(ft + swz(r, c));
      } else {
        const int p = p0 + c * 8;
        if (r < C && p < P)
          *reinterpret_cast<uint4*>(out + r * ldf + p) =
              *reinterpret_cast<const uint4*>(ft + swz(r, c));
      }
    }
  }
  cp_async_wait<0>();
}

// out[i] = round(work[0][i] + work[1][i] + ...): split partials summed in
// split order, rounded once.
__device__ __forceinline__ void reduce_round(const float* __restrict__ work,
                                             bf16* __restrict__ out,
                                             int splits, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += work[sp * n + i];
    out[i] = from_f<bf16>(s);
  }
}

// The split partials of gram_bwd_wgmma_kernel.
__global__ void gram_bwd_reduce_kernel(const float* __restrict__ work,
                                       bf16* __restrict__ out, int splits,
                                       long long n) {
  reduce_round(work, out, splits, n);
}

// Dynamic shared memory of the kernels (bytes, with the alignment slack).
inline size_t fwd_smem() {
  return FWD_STAGES * (2 * FWD_HALVES * TILE_BYTES + 1024) + 1024;
}
template <int N>
inline size_t bwd_smem() {
  return STAGES * (TILE_BYTES + N * 128 + 128) + 1024;
}
template <int N, int NS>
inline size_t wbwd_smem(int C) {
  return static_cast<size_t>(wbwd_fslots(C, NS)) * CHUNK_BYTES +
         NS * (N * 128 + WPIX * 2) + 1024;
}
inline size_t relu_bwd64_smem(int K) {
  return static_cast<size_t>(K + RWG + RWG * RNS) * TILE_BYTES +
         RWG * RNS * K * 128 + 1024;
}
// the (P, C) form's: its table of 64 fp32 biases besides
inline size_t relu_bwd64_pc_smem(int K) { return relu_bwd64_smem(K) + 256; }

// Resources of kernel fn for the record (dpst_gram_wgmma_attrs): out =
// registers a thread, local memory bytes a thread (spills and stack),
// dynamic shared memory bytes a block, resident blocks an SM.
inline int record_attrs(const void* fn, size_t smem, int threads, int* out) {
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

// Launch the kernel `fn` (a __global__ function's handle, from this unit or
// another: gram_pc's (P, C) instances) on its one argument struct.
template <typename Args>
cudaError_t launch(const void* fn, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, Args args) {
  void* params[] = {&args};
  return cudaLaunchKernel(fn, grid, dim3(threads), params, smem, st);
}

}  // namespace gram90
}  // namespace

// The (P, C) instances of the bodies (gram_pc.cu, gram_pc_wbwd.cu), by the
// template arguments of their (C, P) twins: n the c tile's rows, pairs the
// batch instance.
namespace gram_pc {
const void* fwd_kernel(bool relu);                 // gram_fwd_body
const void* bwd_kernel(int n, bool pairs);         // gram_bwd_body
const void* wbwd_kernel(int n, bool pairs);        // gram_wbwd_body
const void* relu_bwd_kernel(int n, bool pairs);    // its bias+ReLU steps
const void* relu_bwd64_kernel(bool pairs);         // gram_relu_bwd64_body
}  // namespace gram_pc
