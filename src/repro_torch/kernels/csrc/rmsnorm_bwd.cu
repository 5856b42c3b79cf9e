// RMSNorm backward for Hopper (sm_90a): the gradients of
// y = x * r * w, r = rsqrt(mean(x^2) + eps), given g = dL/dy, in f32:
//
//   dx = r * (g * w) - x * r^3 * mean(g * w * x)     (cast to x's dtype)
//   dw = sum over rows of g * x * r                  (cast to w's dtype)
//
// Replaces jax.grad of the jnp function that the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py (`rmsnorm_kernel`, launched by
// `fused_rmsnorm` at :36) computes; the JAX package has no backward kernel
// and differentiates its plain jnp RMSNorm. x, g and dx are [rows, d]
// contiguous, w and dw [d], 1 <= d <= 8192, f32 or bf16 (w in x's dtype).
//
// Bound on the H100: bytes. The function reads x, g and w and writes dx and
// dw, against ~10 f32 flops an element. This design also moves the dw
// partial sums ([blocks, d] f32, written once and read once): its own
// overhead, outside the function's bound.
//
// Design (simple first): two launches and no atomics, so a step on the card
// gives the same bits every time.
// * rows: `blocks` blocks, each a contiguous share of the rows; one warp per
//   row. A warp reads its row once to sum x^2 and g*w*x (xor butterflies
//   close both), then again (from L1) to write dx and to add g*x*r into its
//   own [d] f32 accumulator in shared memory. At the end the block adds its
//   warps' accumulators in warp order and writes one row of partial sums.
// * dw: one thread per column adds the `blocks` partial rows in block order.
// r is recomputed from x: the forward saves nothing but x and w. The kernels
// allocate nothing (the caller passes the partial buffer) and launch on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 8192;
constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 96 * 1024;   // the warps' dw accumulators
constexpr int kDwThreads = 256;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                 T* __restrict__ dx, float* __restrict__ part, int rows, int d,
                 int rows_per_block, float eps) {
  extern __shared__ float acc[];  // [warps][d]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = acc + warp * d;
  for (int c = lane; c < d; c += 32) mine[c] = 0.f;

  const float inv_d = 1.f / static_cast<float>(d);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += warps) {
    const T* xr = x + static_cast<long long>(row) * d;
    const T* gr = g + static_cast<long long>(row) * d;
    T* dxr = dx + static_cast<long long>(row) * d;
    float ss = 0.f, sgwx = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(xr[c]);
      ss += xv * xv;
      sgwx += to_f32(gr[c]) * to_f32(w[c]) * xv;
    }
    ss = warp_sum(ss);
    sgwx = warp_sum(sgwx);
    const float r = rsqrtf(ss * inv_d + eps);
    const float coef = r * r * r * (sgwx * inv_d);
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(xr[c]);
      const float gv = to_f32(gr[c]);
      dxr[c] = from_f32<T>(r * (gv * to_f32(w[c])) - xv * coef);
      mine[c] += gv * xv * r;
    }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < warps; ++k) s += acc[k * d + c];
    out[c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
rmsnorm_bwd_dw(const float* __restrict__ part, T* __restrict__ dw, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<long long>(b) * d + c];
  dw[c] = from_f32<T>(s);
}

// warps per block of the rows launch: as many as the shared budget holds,
// up to kMaxWarps (d 8192 f32 accumulators take 32 KiB a warp)
int warps_for(int d) {
  const int fit = kSmemBudget / (d * static_cast<int>(sizeof(float)));
  return fit < 1 ? 1 : (fit > kMaxWarps ? kMaxWarps : fit);
}

template <typename T>
int launch(const void* x, const void* w, const void* g, void* dx, void* dw, void* part,
           int rows, int d, int blocks, float eps, cudaStream_t s) {
  // dynamic shared memory above 48 KiB: an attribute of each device, set
  // once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(rmsnorm_bwd_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBudget);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int warps = warps_for(d);
  const int rows_per_block = (rows + blocks - 1) / blocks;
  const size_t smem = static_cast<size_t>(warps) * d * sizeof(float);
  rmsnorm_bwd_rows<T><<<blocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, rows_per_block, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_dw<T><<<(d + kDwThreads - 1) / kDwThreads, kDwThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(dw), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx [rows, d] and dw [d] from x, w, g; `part` is [blocks, d] f32 scratch,
// blocks >= 1 (the wrapper takes min(rows, 2 x SMs)). dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launches.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* g, void* dx,
                                 void* dw, void* part, int rows, int d, int blocks, float eps,
                                 int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, g, dx, dw, part, rows, d, blocks, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, g, dx, dw, part, rows, d, blocks, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
