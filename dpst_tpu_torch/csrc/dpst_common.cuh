// Shared helpers of the port's CUDA kernels (built for sm_90a).
//
// Every kernel file exposes plain C entry points loaded with ctypes: device
// pointers and the CUDA stream arrive as void*, sizes as int, and each entry
// point returns cudaGetLastError() right after its launches, so a launch the
// device refused is reported to the Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DPST_DTYPE_F32 0
#define DPST_DTYPE_BF16 1

namespace dpst {

template <typename T>
__device__ __forceinline__ float to_f(T x);

template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float to T (round to nearest even, as PyTorch and XLA do when an
// fp32 intermediate is stored in the tensor's dtype).
template <typename T>
__device__ __forceinline__ T from_f(float x);

template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

inline int grid_for(long long n, int threads, int max_blocks) {
  long long b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  return static_cast<int>(b < max_blocks ? b : max_blocks);
}

}  // namespace dpst
