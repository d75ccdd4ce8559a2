// Tie-splitting 2x2/2 max-pool backward, NHWC form: pool_bwd.cu's
// function (the same arithmetic element for element, so bit-equal to it and
// to the plain version) on the operands as channels_last activations hold
// them, x (N, H, W, C), y and g (N, H/2, W/2, C) in memory. A thread takes
// V channels of one pooled pixel (V = 16 bytes where C is a multiple of it
// and the tensors start on 16-byte boundaries, else 1), so its loads of x,
// y and g and its stores of gx are whole vectors of consecutive channels.
// It lives in a translation unit of its own, so that pool_bwd.cu's kernel
// compiles as it did without it (in one unit with it, pool2_bwd_kernel
// compiled to other code).
#include <stdint.h>

#include "dpst_common.cuh"

namespace {

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void pool2_bwd_nhwc_kernel(const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      const T* __restrict__ g,
                                      T* __restrict__ gx, int N, int C, int H,
                                      int W) {
  using dpst::from_f;
  using dpst::to_f;
  using P = Vec<T, V>;
  const int h2 = H / 2, w2 = W / 2;
  const int hc = (H + 1) / 2, wc = (W + 1) / 2, cv = C / V;
  const long long total = static_cast<long long>(N) * hc * wc * cv;
  const long long row = static_cast<long long>(W) * C;
  P zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(idx % cv);
    long long t = idx / cv;
    const int j = static_cast<int>(t % wc);
    t /= wc;
    const int i = static_cast<int>(t % hc);
    const long long n = t / hc;
    const long long base = ((n * H + 2 * i) * W + 2 * j) * C + q * V;
    P* o00 = reinterpret_cast<P*>(gx + base);
    P* o01 = reinterpret_cast<P*>(gx + base + C);
    P* o10 = reinterpret_cast<P*>(gx + base + row);
    P* o11 = reinterpret_cast<P*>(gx + base + row + C);
    if (i < h2 && j < w2) {
      const long long o = ((n * h2 + i) * w2 + j) * C + q * V;
      const P yv = *reinterpret_cast<const P*>(y + o);
      const P gv = *reinterpret_cast<const P*>(g + o);
      const P x00 = *reinterpret_cast<const P*>(x + base);
      const P x01 = *reinterpret_cast<const P*>(x + base + C);
      const P x10 = *reinterpret_cast<const P*>(x + base + row);
      const P x11 = *reinterpret_cast<const P*>(x + base + row + C);
      P r00, r01, r10, r11;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float yk = to_f(yv.v[k]);
        const float m00 = to_f(x00.v[k]) == yk ? 1.0f : 0.0f;
        const float m01 = to_f(x01.v[k]) == yk ? 1.0f : 0.0f;
        const float m10 = to_f(x10.v[k]) == yk ? 1.0f : 0.0f;
        const float m11 = to_f(x11.v[k]) == yk ? 1.0f : 0.0f;
        const float ties = (m00 + m01) + (m10 + m11);
        const float qv =
            to_f(from_f<T>(to_f(gv.v[k]) / fmaxf(ties, 1.0f)));
        r00.v[k] = from_f<T>(m00 * qv);
        r01.v[k] = from_f<T>(m01 * qv);
        r10.v[k] = from_f<T>(m10 * qv);
        r11.v[k] = from_f<T>(m11 * qv);
      }
      *o00 = r00;
      *o01 = r01;
      *o10 = r10;
      *o11 = r11;
    } else {
      // odd trailing row or column: it never entered the pool
      const bool col2 = 2 * j + 1 < W, row2 = 2 * i + 1 < H;
      *o00 = zero;
      if (col2) *o01 = zero;
      if (row2) *o10 = zero;
      if (row2 && col2) *o11 = zero;
    }
  }
}

template <typename T, int V>
void launch_nhwc(const void* x, const void* y, const void* g, void* gx,
                 int N, int C, int H, int W, cudaStream_t s) {
  const long long total =
      static_cast<long long>(N) * ((H + 1) / 2) * ((W + 1) / 2) * (C / V);
  pool2_bwd_nhwc_kernel<T, V>
      <<<dpst::grid_for(total, 256, 132 * 64), 256, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const T*>(g), static_cast<T*>(gx), N, C, H, W);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, gx (N, H, W, C) and y, g (N, H/2, W/2, C) in memory: the operands of
// a channels_last activation's pool.
extern "C" int dpst_pool2_bwd_nhwc(const void* x, const void* y,
                                   const void* g, void* gx, int N, int C,
                                   int H, int W, int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (N < 1 || C < 1 || H < 1 || W < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(g) &&
                   aligned16(gx);
  if (dtype == DPST_DTYPE_F32) {
    if (vec && C % 4 == 0)
      launch_nhwc<float, 4>(x, y, g, gx, N, C, H, W, s);
    else
      launch_nhwc<float, 1>(x, y, g, gx, N, C, H, W, s);
  } else if (dtype == DPST_DTYPE_BF16) {
    if (vec && C % 8 == 0)
      launch_nhwc<__nv_bfloat16, 8>(x, y, g, gx, N, C, H, W, s);
    else
      launch_nhwc<__nv_bfloat16, 1>(x, y, g, gx, N, C, H, W, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

