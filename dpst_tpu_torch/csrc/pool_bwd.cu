// Tie-splitting 2x2/2 max-pool backward.
//
// Replaces the TPU kernel dpst_tpu/ops/pool_pallas.py:_bwd_kernel (launched
// by maxpool2_bwd_pallas) and computes the function of
// dpst_tpu/models/vgg.py:_maxpool2_bwd: inside each 2x2 window,
// mask = (x == y), ties = sum of the mask, gx = mask * (g / max(ties, 1)).
// PyTorch's own max-pool backward gives the whole cotangent to the first tie
// instead, so it cannot stand in.
//
// What bounds it on the H100: bytes. It reads x (H*W*C), y and g
// (H*W*C/4 each) and writes gx (H*W*C) once: 2.5*H*W*C elements, about a
// dozen operations per pooled element. The design moves each byte once: one
// thread per pooled element and channel reads its four x values, y and g
// and writes its four gradients, so nothing round-trips through memory
// (the TPU's XLA lowering materialized two 2x upsamples and a tie count).
// The equality is taken after widening to fp32, which is exact, and the
// divide and the product are rounded to the pool's dtype in the same order
// as the plain version, so the result is bit-equal to it. An odd trailing
// row or column never entered the pool and gets 0.
#include "dpst_common.cuh"

namespace {

template <typename T>
__global__ void pool2_bwd_kernel(const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ g,
                                 T* __restrict__ gx, int C, int H, int W) {
  using dpst::from_f;
  using dpst::to_f;
  const int h2 = H / 2, w2 = W / 2;
  const int hc = (H + 1) / 2, wc = (W + 1) / 2;
  const long long total = static_cast<long long>(C) * hc * wc;
  const T zero = from_f<T>(0.0f);
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % wc);
    const long long t = idx / wc;
    const int i = static_cast<int>(t % hc);
    const long long c = t / hc;
    const long long base = (c * H + 2 * i) * W + 2 * j;
    if (i < h2 && j < w2) {
      const long long o = (c * h2 + i) * w2 + j;
      const float yv = to_f(y[o]);
      const float m00 = to_f(x[base]) == yv ? 1.0f : 0.0f;
      const float m01 = to_f(x[base + 1]) == yv ? 1.0f : 0.0f;
      const float m10 = to_f(x[base + W]) == yv ? 1.0f : 0.0f;
      const float m11 = to_f(x[base + W + 1]) == yv ? 1.0f : 0.0f;
      const float ties = (m00 + m01) + (m10 + m11);  // exact small integer
      // q is rounded to T before the product, as the plain version stores
      // g / max(ties, 1) in the pool's dtype
      const float q = to_f(from_f<T>(to_f(g[o]) / fmaxf(ties, 1.0f)));
      gx[base] = from_f<T>(m00 * q);
      gx[base + 1] = from_f<T>(m01 * q);
      gx[base + W] = from_f<T>(m10 * q);
      gx[base + W + 1] = from_f<T>(m11 * q);
    } else {
      // odd trailing row or column: it never entered the pool
      const bool col2 = 2 * j + 1 < W, row2 = 2 * i + 1 < H;
      gx[base] = zero;
      if (col2) gx[base + 1] = zero;
      if (row2) gx[base + W] = zero;
      if (row2 && col2) gx[base + W + 1] = zero;
    }
  }
}

}  // namespace

extern "C" int dpst_pool2_bwd(const void* x, const void* y, const void* g,
                              void* gx, int C, int H, int W, int dtype,
                              void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  const long long total =
      static_cast<long long>(C) * ((H + 1) / 2) * ((W + 1) / 2);
  const int threads = 256;
  const int blocks = dpst::grid_for(total, threads, 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DPST_DTYPE_F32) {
    pool2_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(g), static_cast<float*>(gx), C, H, W);
  } else if (dtype == DPST_DTYPE_BF16) {
    pool2_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(gx), C, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
