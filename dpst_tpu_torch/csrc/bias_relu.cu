// The VGG's bias add and ReLU, forward and backward, one pass each way.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add, jnp.maximum
// and its subgradient into the neighbouring ops. In PyTorch the same chain
// was eight ATen launches a layer (a broadcast add and clamp_min forward;
// two compares, a product, zeros and two wheres backward) that moved about
// 34 bytes a bf16 element. Over an (N, C, H, W) contiguous tensor z and a
// (C,) bias b in the same dtype:
//
//   forward   a = round(z + b_c),  y = isnan(a) ? a : max(a, 0)
//   backward  dz = a > 0 ? g : (a == 0 ? round(g * 0.5) : +0)
//
// with z + b_c and g * 0.5 formed in fp32 and rounded to the dtype, as
// ATen's bf16 add and product do, so both match the composite of
// models/vgg.py bit for bit (relu'(0) = 1/2, signed zeros and NaN
// included). The backward recomputes a from z and b rather than reading a
// saved a: the same bytes.
//
// What bounds it on the H100: bytes. The forward reads z and writes y (4
// bytes a bf16 element), the backward reads z and g and writes dz (6
// bytes); a few operations an element. The design moves each byte once in
// 16-byte vectors: a block row (blockIdx.y) walks channel planes, so a
// block loads its plane's bias once, and its blocks (blockIdx.x) stride
// over the plane's vectors. Where a plane starts off a 16-byte boundary
// (H*W not a multiple of the vector width) its head and tail run element
// by element; where the tensors' starts differ modulo 16 bytes the whole
// plane does. No shared memory, no atomics, no scratch.
#include <stdint.h>

#include "dpst_common.cuh"

namespace {

using dpst::from_f;
using dpst::to_f;

constexpr int kThreads = 256;
// 8 blocks of 256 threads fill an SM's 2048 threads (at most 32 registers
// a thread): the more loads in flight, the nearer the bandwidth
constexpr int kBlocksPerSm = 8;

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* p) {
  Pack<T> r;
  *reinterpret_cast<uint4*>(&r) = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const Pack<T>& r) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

// round(z + b), as ATen's add rounds its fp32 sum to the tensor's dtype
template <typename T>
__device__ __forceinline__ T add_bias(T z, float b) {
  return from_f<T>(to_f(z) + b);
}

// torch.clamp_min(a, 0): NaN passes unchanged, else fmaxf
template <typename T>
__device__ __forceinline__ T relu_fwd(T a) {
  const float f = to_f(a);
  return isnan(f) ? a : from_f<T>(fmaxf(f, 0.0f));
}

template <typename T>
__device__ __forceinline__ T relu_bwd(T a, T g) {
  const float f = to_f(a);
  if (f > 0.0f) return g;
  return f == 0.0f ? from_f<T>(to_f(g) * 0.5f) : from_f<T>(0.0f);
}

// Elements of a plane before its first 16-byte boundary, or the whole
// plane where the tensors cannot be read in vectors together.
template <typename T>
__device__ __forceinline__ long long plane_head(const T* p, long long hw,
                                                bool vec) {
  if (!vec) return hw;
  const long long h =
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  return h < hw ? h : hw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bias_relu_fwd_kernel(const T* __restrict__ z, const T* __restrict__ bias,
                         T* __restrict__ y, long long planes, int C,
                         long long hw, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const long long t0 = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
    const float b = to_f(bias[p % C]);
    const T* zp = z + p * hw;
    T* yp = y + p * hw;
    const long long head = plane_head(zp, hw, vec);
    const long long nvec = (hw - head) / V;
    const T* zv = zp + head;
    T* yv = yp + head;
    for (long long i = t0; i < nvec; i += stride) {
      Pack<T> r = load_pack(zv + i * V);
#pragma unroll
      for (int k = 0; k < V; ++k) r.v[k] = relu_fwd(add_bias(r.v[k], b));
      store_pack(yv + i * V, r);
    }
    const long long body_end = head + nvec * V;
    for (long long s = t0; s < hw - nvec * V; s += stride) {
      const long long e = s < head ? s : body_end + (s - head);
      yp[e] = relu_fwd(add_bias(zp[e], b));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    bias_relu_bwd_kernel(const T* __restrict__ z, const T* __restrict__ bias,
                         const T* __restrict__ g, T* __restrict__ dz,
                         long long planes, int C, long long hw, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const long long t0 = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
    const float b = to_f(bias[p % C]);
    const T* zp = z + p * hw;
    const T* gp = g + p * hw;
    T* dp = dz + p * hw;
    const long long head = plane_head(zp, hw, vec);
    const long long nvec = (hw - head) / V;
    for (long long i = t0; i < nvec; i += stride) {
      const long long o = head + i * V;
      const Pack<T> zr = load_pack(zp + o);
      Pack<T> gr = load_pack(gp + o);
#pragma unroll
      for (int k = 0; k < V; ++k)
        gr.v[k] = relu_bwd(add_bias(zr.v[k], b), gr.v[k]);
      store_pack(dp + o, gr);
    }
    const long long body_end = head + nvec * V;
    for (long long s = t0; s < hw - nvec * V; s += stride) {
      const long long e = s < head ? s : body_end + (s - head);
      dp[e] = relu_bwd(add_bias(zp[e], b), gp[e]);
    }
  }
}

// The grid: a block row a plane (up to 65535, the rest walked by the
// rows), and enough blocks along a plane that about 32 blocks of 256
// threads land on each of the 132 SMs (four waves of the 8 an SM holds;
// 2-3 % nearer the byte bound at 2048² than two waves), but no more than
// the plane has vectors for.
dim3 plane_grid(long long planes, long long hw, int vec_width) {
  const long long rows = planes < 65535 ? planes : 65535;
  const long long units = (hw + vec_width - 1) / vec_width;
  long long cols = (units + kThreads - 1) / kThreads;
  long long fill = (132LL * 32 + rows - 1) / rows;
  if (cols > fill) cols = fill;
  if (cols < 1) cols = 1;
  return dim3(static_cast<unsigned>(cols), static_cast<unsigned>(rows));
}

bool together(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) ^ reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

}  // namespace

// z, y: (planes, hw) contiguous, plane p of channel p % C; bias (C,)
extern "C" int dpst_bias_relu_fwd(const void* z, const void* bias, void* y,
                                  long long planes, int C, long long hw,
                                  int dtype, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (planes <= 0 || hw <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = together(z, y);
  if (dtype == DPST_DTYPE_F32) {
    bias_relu_fwd_kernel<float>
        <<<plane_grid(planes, hw, 4), kThreads, 0, s>>>(
            static_cast<const float*>(z), static_cast<const float*>(bias),
            static_cast<float*>(y), planes, C, hw, vec);
  } else if (dtype == DPST_DTYPE_BF16) {
    bias_relu_fwd_kernel<__nv_bfloat16>
        <<<plane_grid(planes, hw, 8), kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(z),
            static_cast<const __nv_bfloat16*>(bias),
            static_cast<__nv_bfloat16*>(y), planes, C, hw, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// z, g, dz: (planes, hw) contiguous; bias (C,)
extern "C" int dpst_bias_relu_bwd(const void* z, const void* bias,
                                  const void* g, void* dz, long long planes,
                                  int C, long long hw, int dtype,
                                  void* stream) {
  cudaGetLastError();
  if (planes <= 0 || hw <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = together(z, g) && together(z, dz);
  if (dtype == DPST_DTYPE_F32) {
    bias_relu_bwd_kernel<float>
        <<<plane_grid(planes, hw, 4), kThreads, 0, s>>>(
            static_cast<const float*>(z), static_cast<const float*>(bias),
            static_cast<const float*>(g), static_cast<float*>(dz), planes, C,
            hw, vec);
  } else if (dtype == DPST_DTYPE_BF16) {
    bias_relu_bwd_kernel<__nv_bfloat16>
        <<<plane_grid(planes, hw, 8), kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(z),
            static_cast<const __nv_bfloat16*>(bias),
            static_cast<const __nv_bfloat16*>(g),
            static_cast<__nv_bfloat16*>(dz), planes, C, hw, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
