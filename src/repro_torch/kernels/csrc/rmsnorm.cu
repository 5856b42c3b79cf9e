// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (`rmsnorm_kernel`, launched by `fused_rmsnorm`): row blocks of 256 x the
// full feature dim, math in f32, output cast back to the input dtype.
//
// Bound on the H100: bytes. A call reads x once and writes y once,
// 2 * rows * d * sizeof(T) bytes, against ~4 flops per element, so the
// kernel can at best run at the card's memory rate (3.35 TB/s).
//
// Design: one warp per row, four rows per 128-thread block, so the grid has
// rows / 4 blocks and fills the card at the prefill shape ([4096, 1536])
// while a decode call ([4, 1536]) is one block. Each lane sums x^2 over a
// strided slice of the row in f32, a butterfly of warp shuffles completes
// the sum, and a second pass over the row (now in L1/L2) writes the scaled
// output. Where d and every pointer allow it, lanes move 16 bytes per load
// (8 bf16 or 4 f32). Any d (16 for qk-norm heads up to 8192) and any row
// count are taken; bf16 is converted only through the cuda_bf16 intrinsics.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int rows, int d, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  using P = Pack<T, VEC>;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* yr = reinterpret_cast<P*>(y + row * d);
  const int n = d / VEC;

  float ss = 0.f;
  for (int i = lane; i < n; i += 32) {
    const P a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(a.v[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < n; i += 32) {
    const P a = xr[i];
    const P g = wr[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(to_f32(a.v[j]) * r * to_f32(g.v[j]));
    yr[i] = o;
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (d % V == 0 && aligned16(x) && aligned16(w) && aligned16(y)) {
    rmsnorm_kernel<T, V><<<grid, block, 0, stream>>>(xt, wt, yt, rows, d, eps);
  } else {
    rmsnorm_kernel<T, 1><<<grid, block, 0, stream>>>(xt, wt, yt, rows, d, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, y, rows, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
