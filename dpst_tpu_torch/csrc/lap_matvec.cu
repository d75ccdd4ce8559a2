// Matting-Laplacian matvec y = L.v (Levin closed-form matting), per RGB
// channel, in fp32.
//
// Replaces the TPU kernel dpst_tpu/ops/laplacian_pallas.py:_lap_matvec_kernel
// (launched by _matvec_padded) and computes the function of
// dpst_tpu/ops/laplacian.py:matvec_xla on the packed (14, H, W) stats planes
// (img x3, mu x3, Lambda-sym x6, valid, win_count):
//   pass 1 at each window centre k:  s = box3(v), q_m = box3(I_m v),
//       t_m = q_m - mu_m s,  b = Lambda t,
//       alpha = (mu.b - s) / 9 * valid,  beta_m = -b_m / 9 * valid;
//   pass 2 at each pixel i:  y = n_i v_i + box3(alpha) + sum_m I_m box3(beta_m).
// Box sums are zero outside the image ("SAME").
//
// What bounds it on the H100: bytes. One launch reads 14 stats planes and
// 3 v planes and writes 3 y planes (20 fp32 planes), against about 110 fp32
// operations per pixel and channel: far below the card's ratio of
// operations to bytes. The design reads each plane once per tile: a block
// stages v and the image planes for its 16x32 tile plus a 2-pixel halo in
// shared memory, computes s, t, b, alpha and beta for the tile plus a
// 1-pixel ring into shared memory (mu, Lambda and valid are read once, at
// that position, for all three channels), then runs the second box pass and
// writes y. The intermediates never reach device memory (the XLA lowering
// round-trips about 28 planes).
//
// Precision: Lambda reaches about 1e6, so the result is sensitive to
// cancellation. Everything is fp32 on the CUDA cores, and every product and
// sum goes through __fmul_rn / __fadd_rn, which the compiler never fuses
// into FMAs: the kernel rounds at the same places and in the same order as
// the plain PyTorch version (laplacian.py:matvec), box sums included
// (column pass (x[j] + x[j+1]) + x[j-1], then the same for rows).
#include "dpst_common.cuh"

namespace {

constexpr int TH = 16;   // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int NT = 256;  // threads per block
constexpr int HR = TH + 4, WR = TW + 4;  // v / image region (2-px halo)
constexpr int HA = TH + 2, WA = TW + 2;  // alpha / beta region (1-px ring)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// 3x3 box sum at (r, c) of a row-major shared plane with row stride `ld`.
__device__ __forceinline__ float box3(const float* a, int ld, int r, int c) {
  float col[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float* row = a + (r - 1 + d) * ld;
    col[d] = add(add(row[c], row[c + 1]), row[c - 1]);
  }
  return add(add(col[0], col[1]), col[2]);
}

// box3 of the product of two shared planes (both zero outside the image).
__device__ __forceinline__ float box3_prod(const float* a, const float* b,
                                           int ld, int r, int c) {
  float col[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int o = (r - 1 + d) * ld;
    col[d] = add(add(mul(a[o + c], b[o + c]), mul(a[o + c + 1], b[o + c + 1])),
                 mul(a[o + c - 1], b[o + c - 1]));
  }
  return add(add(col[0], col[1]), col[2]);
}

__global__ void __launch_bounds__(NT)
lap_matvec_kernel(const float* __restrict__ stats, const float* __restrict__ v,
                  float* __restrict__ y, int H, int W) {
  __shared__ float sv[3][HR * WR];    // v, per channel
  __shared__ float simg[3][HR * WR];  // image planes
  __shared__ float sa[3][HA * WA];    // alpha, per channel
  __shared__ float sb[9][HA * WA];    // beta_m, per channel (ch * 3 + m)

  const long long plane = static_cast<long long>(H) * W;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const float win = 9.0f;

  // stage v and the image for the tile plus a 2-pixel halo (0 outside)
  for (int e = threadIdx.x; e < 6 * HR * WR; e += NT) {
    const int p = e / (HR * WR), rem = e % (HR * WR);
    const int gy = y0 - 2 + rem / WR, gx = x0 - 2 + rem % WR;
    float val = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const long long o = static_cast<long long>(gy) * W + gx;
      val = p < 3 ? v[p * plane + o] : stats[(p - 3) * plane + o];
    }
    if (p < 3) sv[p][rem] = val; else simg[p - 3][rem] = val;
  }
  __syncthreads();

  // pass 1 on the tile plus a 1-pixel ring
  for (int e = threadIdx.x; e < HA * WA; e += NT) {
    const int rr = e / WA, cc = e % WA;
    const int gy = y0 - 1 + rr, gx = x0 - 1 + cc;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sa[ch][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 9; ++q) sb[q][e] = 0.0f;
      continue;
    }
    const long long o = static_cast<long long>(gy) * W + gx;
    float mu[3], lam[6];
#pragma unroll
    for (int m = 0; m < 3; ++m) mu[m] = stats[(3 + m) * plane + o];
#pragma unroll
    for (int m = 0; m < 6; ++m) lam[m] = stats[(6 + m) * plane + o];
    const float valid = stats[12 * plane + o];
    const int sym[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    const int r = rr + 1, c = cc + 1;  // position in the halo region
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float s = box3(sv[ch], WR, r, c);
      float t[3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        t[m] = sub(box3_prod(simg[m], sv[ch], WR, r, c), mul(mu[m], s));
      float b[3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        b[m] = add(add(mul(lam[sym[m][0]], t[0]), mul(lam[sym[m][1]], t[1])),
                   mul(lam[sym[m][2]], t[2]));
      const float mub =
          add(add(mul(mu[0], b[0]), mul(mu[1], b[1])), mul(mu[2], b[2]));
      sa[ch][e] = mul(__fdiv_rn(sub(mub, s), win), valid);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        sb[ch * 3 + m][e] = mul(__fdiv_rn(-b[m], win), valid);
    }
  }
  __syncthreads();

  // pass 2: gather the window contributions back to the tile's pixels
  for (int e = threadIdx.x; e < TH * TW; e += NT) {
    const int r = e / TW, c = e % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const long long o = static_cast<long long>(gy) * W + gx;
    const float nwin = stats[13 * plane + o];
    const int hr = (r + 2) * WR + (c + 2);  // position in the halo region
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float ba = box3(sa[ch], WA, r + 1, c + 1);
      float ib[3];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        ib[m] = mul(simg[m][hr], box3(sb[ch * 3 + m], WA, r + 1, c + 1));
      y[ch * plane + o] = add(add(mul(nwin, sv[ch][hr]), ba),
                              add(add(ib[0], ib[1]), ib[2]));
    }
  }
}

}  // namespace

extern "C" int dpst_lap_matvec(const void* stats, const void* v, void* y,
                               int H, int W, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  lap_matvec_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stats), static_cast<const float*>(v),
      static_cast<float*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}
