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
// 3 v planes and writes 3 y planes (20 fp32 planes, 0.40 ms at 4096^2),
// against about 411 fp32 operations a pixel, 12 of them divisions by 9:
// issued alone they would take about 0.3 ms at 4096^2, so the design has
// to keep both streams near one pass and overlap them.
//
// A batch of B pairs (the JAX package's vmapped pallas_call) is one launch:
// the pair is the grid's third index, with its own stats (or one stack
// shared by every pair, read with a pair stride of 0).
//
// Design: a strip walk. Each warp owns a strip of LW = 30 output columns
// and `rows` output rows (ops/laplacian_cuda.py:lap_plan) and walks down
// it, one row a step; lane l holds column x0 - 1 + l (lanes 1..30 its
// outputs, lanes 0 and 31 the pass-1 ring). A step takes one new row of v
// and the image (each lane its own column; lanes 0 and 31 also the column
// beyond, the 2-pixel halo) and one row of mu, Lambda, valid and n, which
// cp.async brought into the warp's own rings of shared-memory slots AHEAD
// steps before, so that the loads of later rows overlap this row's
// arithmetic and hold no registers. The left and right neighbours come from
// the adjacent lanes (shuffles; no block barrier), and the row's horizontal
// sums of v and I_m v join the last two rows' sums, which stay in
// registers: a box sum costs two adds. Pass 1 then runs at the row above
// (mu, Lambda and valid read once a pixel, for the three channels), its
// alpha and beta get their own horizontal sums by shuffles, and pass 2 runs
// one row above that, with those sums carried the same way (three buffers
// each, rotated by a loop of three steps) and v and I of its row still in
// their slot. Every plane is read once a pixel, coalesced, but for the
// strip's two halo columns and the halo rows of a band (L2 hits between
// neighbouring strips). The division by 9 is exact in three fused
// operations (div9).
//
// Precision: Lambda reaches about 1e6, so the result is sensitive to
// cancellation. Everything is fp32 on the CUDA cores, and every product and
// sum goes through __fmul_rn / __fadd_rn / __fsub_rn, which the compiler
// never fuses into FMAs, and the division through div9, which equals
// __fdiv_rn: the kernel rounds at the same places and in the same order as
// the plain PyTorch version on the CPU (laplacian.py:matvec), box sums
// included (along a row (x[j] + x[j+1]) + x[j-1], then along the column
// (c[i-1] + c[i]) + c[i+1]), and equals it bit for bit. (On the card
// PyTorch divides by a scalar as a product with its reciprocal, so the plain
// version there differs in the last bit of some alpha and beta.)
#include <cstdint>

#include "dpst_common.cuh"

namespace {

constexpr int LW = 30;          // output columns of a warp's strip
constexpr int WARPS = 4;        // strips of a block
constexpr int NT = 32 * WARPS;  // threads per block
constexpr int AHEAD = 2;        // steps whose loads are in flight
// a step's loads go to two rings of slots: v and the image (a plane of 32
// lanes each, then the two halo columns' six values: lane 0's left, lane
// 31's right), read again two steps later by pass 2; and mu, Lambda, valid
// and n (planes of 32 lanes)
constexpr int VSLOTS = AHEAD + 3, VSLOT = 6 * 32 + 12;
constexpr int SSLOTS = AHEAD + 1, SSLOT = 11 * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// x / 9 rounded to nearest, the value of __fdiv_rn(x, 9.0f), in two fused
// operations after a product: q = RN(x * RN(1/9)) is within two ulps of
// x / 9, so r = x - 9 q is exact (a multiple of ulp(q) below 18 of them),
// and q + r * RN(1/9) differs from x / 9 by far less than x / 9 lies from
// any midpoint of two floats (at least half an ulp over 9: x is a multiple
// of 8 ulp(q)), so its rounding is x / 9's. r = 0 keeps q (x / 9 exact, the
// sign of a zero kept), an infinite x gives q. chip_smoke.py checks it
// against __fdiv_rn on all 2^32 floats (dpst_lap_div9_mismatches).
__device__ __forceinline__ float div9(float x) {
  constexpr float kInv9 = 1.0f / 9.0f;
  const float q = __fmul_rn(x, kInv9);
  const float r = __fmaf_rn(-9.0f, q, x);
  return (r == 0.0f || isinf(q)) ? q : __fmaf_rn(r, kInv9, q);
}

// _box3's order along a row: (x[j] + x[j+1]) + x[j-1]
__device__ __forceinline__ float hsum(float l, float c, float r) {
  return add(add(c, r), l);
}
// and along a column: (c[i-1] + c[i]) + c[i+1]
__device__ __forceinline__ float vsum(float u, float c, float d) {
  return add(add(u, c), d);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, or 4 zero bytes if !valid (src is
// then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Grid (strip groups, row bands, pairs): with PAIRS blockIdx.z is the
// pair, whose stats start `spair` floats after the previous pair's (0: one
// stats stack shared by every pair) and whose v and y planes 3 H W after;
// without it (one pair) that arithmetic compiles out.
template <bool PAIRS>
__global__ void __launch_bounds__(NT, 4)
lap_matvec_kernel(const float* __restrict__ st, const float* __restrict__ v,
                  float* __restrict__ y, int H, int W, int rows,
                  long long spair) {
  __shared__ float vring[WARPS][VSLOTS][VSLOT];
  __shared__ float sring[WARPS][SSLOTS][SSLOT];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int x0 = (blockIdx.x * WARPS + wid) * LW;
  if (x0 >= W) return;  // the whole warp
  const long long plane = static_cast<long long>(H) * W;
  if constexpr (PAIRS) {
    st += blockIdx.z * spair;
    v += blockIdx.z * 3 * plane;
    y += blockIdx.z * 3 * plane;
  }
  const int r0 = blockIdx.y * rows, r1 = min(H, r0 + rows);
  const int j = x0 - 1 + lane;
  const bool jin = j >= 0 && j < W;
  const bool edge = lane == 0 || lane == 31;
  const int je = lane == 0 ? j - 1 : j + 1;
  const bool jein = edge && je >= 0 && je < W;
  const bool owner = lane >= 1 && lane <= LW && j < W;
  // step R's slots (R >= r0 - 3)
  auto vslot = [&](int R) { return vring[wid][(R - r0 + 3) % VSLOTS]; };
  auto sslot = [&](int R) { return sring[wid][(R - r0 + 3) % SSLOTS]; };

  // step R's loads: v and the image at (R + 1, j) (and at (R + 1, je) for
  // lanes 0 and 31) and, with `stats`, mu, Lambda and valid at (R, j) and n
  // at (R - 1, j); zeros outside the image. One commit group.
  auto load = [&](int R, bool stats) {
    float* vs = vslot(R);
    float* ss = sslot(R);
    const bool i1 = R + 1 >= 0 && R + 1 < H, i0 = R >= 0 && R < H;
    const bool im = R - 1 >= 0 && R - 1 < H;
    const long long o1 = static_cast<long long>(R + 1) * W;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float* src = q < 3 ? v + q * plane : st + (q - 3) * plane;
      cp_async4(vs + q * 32 + lane, i1 && jin ? src + o1 + j : v, i1 && jin);
      if (edge)
        cp_async4(vs + 6 * 32 + 2 * q + (lane == 31),
                  i1 && jein ? src + o1 + je : v, i1 && jein);
    }
    if (stats) {
      const long long o0 = static_cast<long long>(R) * W + j;
#pragma unroll
      for (int q = 0; q < 10; ++q)
        cp_async4(ss + q * 32 + lane,
                  i0 && jin ? st + (3 + q) * plane + o0 : v, i0 && jin);
      cp_async4(ss + 10 * 32 + lane,
                im && jin ? st + 13 * plane + o0 - W : v, im && jin);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // row sums of the pass-1 operands of the row a slot holds: h[ch] =
  // rowsum(v_ch), h[3 + 3 ch + m] = rowsum(I_m v_ch); neighbours from the
  // adjacent lanes, the halo columns from the slot
  auto rowsums1 = [&](const float* vs, float (&h)[12]) {
    float a[6], l[6], r[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      a[q] = vs[q * 32 + lane];
      const float e = vs[6 * 32 + 2 * q + (lane == 31)];
      const float up = __shfl_up_sync(FULL, a[q], 1);
      const float dn = __shfl_down_sync(FULL, a[q], 1);
      l[q] = lane == 0 ? e : up;
      r[q] = lane == 31 ? e : dn;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      h[ch] = hsum(l[ch], a[ch], r[ch]);
#pragma unroll
      for (int m = 0; m < 3; ++m)
        h[3 + 3 * ch + m] = hsum(mul(l[3 + m], l[ch]), mul(a[3 + m], a[ch]),
                                 mul(r[3 + m], r[ch]));
    }
  };

  // rows r0 - 2 and r0 - 1 (the v and image loads of steps r0 - 3 and
  // r0 - 2, for their row sums) and the walk's first AHEAD steps, all in
  // flight together
#pragma unroll
  for (int k = 0; k < AHEAD + 2; ++k) load(r0 - 3 + k, k >= 2);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD) : "memory");
  __syncwarp();
  float h1a[12], h1b[12], h1c[12], h2a[12], h2b[12], h2c[12];
  rowsums1(vslot(r0 - 3), h1a);
  rowsums1(vslot(r0 - 2), h1b);
#pragma unroll
  for (int i = 0; i < 12; ++i) h2a[i] = h2b[i] = 0.0f;

  const int sym[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  // step R: pass 1 at (R, j) from the row sums of rows R - 1 (p1), R (p2)
  // and R + 1 (into n1); pass 2 at (R - 1, j) from the alpha and beta row
  // sums of rows R - 2 (q1), R - 1 (q2) and R (into n2)
  auto step = [&](int R, const float (&p1)[12], const float (&p2)[12],
                  float (&n1)[12], const float (&q1)[12],
                  const float (&q2)[12], float (&n2)[12]) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1) : "memory");
    __syncwarp();  // every lane's copies of step R landed; step R - 1 read
    if (R + AHEAD <= r1)
      load(R + AHEAD, true);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* ss = sslot(R);
    rowsums1(vslot(R), n1);
    float ab[12];  // alpha per channel, then beta[3 ch + m]
    if (R >= 0 && R < H && jin) {
      float s[10];
#pragma unroll
      for (int q = 0; q < 10; ++q) s[q] = ss[q * 32 + lane];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float sv = vsum(p1[ch], p2[ch], n1[ch]);
        float t[3], b[3];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          t[m] = sub(vsum(p1[3 + 3 * ch + m], p2[3 + 3 * ch + m],
                          n1[3 + 3 * ch + m]),
                     mul(s[m], sv));
#pragma unroll
        for (int m = 0; m < 3; ++m)
          b[m] = add(add(mul(s[3 + sym[m][0]], t[0]),
                         mul(s[3 + sym[m][1]], t[1])),
                     mul(s[3 + sym[m][2]], t[2]));
        const float mub =
            add(add(mul(s[0], b[0]), mul(s[1], b[1])), mul(s[2], b[2]));
        ab[ch] = mul(div9(sub(mub, sv)), s[9]);
#pragma unroll
        for (int m = 0; m < 3; ++m)
          ab[3 + 3 * ch + m] = mul(div9(-b[m]), s[9]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i) ab[i] = 0.0f;
    }
    // their row sums at row R (lanes 1..30 read lanes 0..31)
#pragma unroll
    for (int i = 0; i < 12; ++i)
      n2[i] = hsum(__shfl_up_sync(FULL, ab[i], 1), ab[i],
                   __shfl_down_sync(FULL, ab[i], 1));
    if (owner && R - 1 >= r0) {
      // v and I at (R - 1, j): step R - 2's slot, n: this step's
      const float* own = vslot(R - 2);
      const float n = ss[10 * 32 + lane];
      const long long o = static_cast<long long>(R - 1) * W + j;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float ba = vsum(q1[ch], q2[ch], n2[ch]);
        float ib[3];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          ib[m] = mul(own[(3 + m) * 32 + lane],
                      vsum(q1[3 + 3 * ch + m], q2[3 + 3 * ch + m],
                           n2[3 + 3 * ch + m]));
        y[ch * plane + o] = add(add(mul(n, own[ch * 32 + lane]), ba),
                                add(add(ib[0], ib[1]), ib[2]));
      }
    }
  };
  // three steps an iteration, so that the carried row sums rotate through
  // three buffers without copies
  for (int R = r0 - 1; R <= r1; R += 3) {
    step(R, h1a, h1b, h1c, h2a, h2b, h2c);
    if (R + 1 <= r1) step(R + 1, h1b, h1c, h1a, h2b, h2c, h2a);
    if (R + 2 <= r1) step(R + 2, h1c, h1a, h1b, h2c, h2a, h2b);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Mismatches of div9 against __fdiv_rn(x, 9.0f) over the bit patterns
// [base, base + n): both NaN counts as a match.
__global__ void div9_check_kernel(unsigned base, unsigned long long n,
                                  unsigned long long* __restrict__ bad) {
  unsigned long long local = 0;
  for (unsigned long long i =
           blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
           threadIdx.x;
       i < n; i += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float x = __uint_as_float(base + static_cast<unsigned>(i));
    const float a = div9(x), b = __fdiv_rn(x, 9.0f);
    if (__float_as_uint(a) != __float_as_uint(b) && !(isnan(a) && isnan(b)))
      ++local;
  }
  if (local) atomicAdd(bad, local);
}

}  // namespace

// B pairs in one launch: v and y (B, 3, H, W), the stats of pair b at
// stats + b * spair (spair = 14 H W for a (B, 14, H, W) stack, 0 for one
// stack that every pair shares). rows: the output rows of a strip
// (ops/laplacian_cuda.py:lap_plan), >= 1.
extern "C" int dpst_lap_matvec(const void* stats, const void* v, void* y,
                               int H, int W, int rows, int B,
                               long long spair, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (rows < 1 || B < 1 || B > 65535 || spair < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (W + LW - 1) / LW;
  const dim3 grid((strips + WARPS - 1) / WARPS, (H + rows - 1) / rows, B);
  (B > 1 ? lap_matvec_kernel<true> : lap_matvec_kernel<false>)
      <<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(stats), static_cast<const float*>(v),
          static_cast<float*>(y), H, W, rows, spair);
  return static_cast<int>(cudaGetLastError());
}

// out: one zero-initialised unsigned 64-bit count on the device; adds the
// floats x (all 2^32 bit patterns) where the matvec's division by 9 and
// __fdiv_rn(x, 9.0f) differ.
extern "C" int dpst_lap_div9_mismatches(void* out, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  div9_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      0u, 1ull << 32, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
