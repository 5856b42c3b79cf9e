// Diagonal linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t along
// time, h_{-1} = 0, for every channel of a [B, S, C] pair of tensors.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (`ssm_scan_kernel`, launched by `ssm_scan` and batched over leading dims by
// ops.py::ssm_scan_batched): the state is kept in f32 and the output is cast
// to the input dtype.
//
// Bound on the H100: bytes. A call reads a and b once and writes h once,
// 3 * B * S * C * sizeof(T) bytes, against one FMA per element. At the
// prefill shape of hymba-1.5b ([4, 1152, 3200 * 16] f32) that is 2.83 GB,
// about 0.85 ms at 3.35 TB/s.
//
// Design: the TPU grid walks (channel block, time block) in order and
// carries the state across time blocks in a VMEM scratch row. Hopper blocks
// run in no order, so the time loop moves inside the thread: one thread per
// channel, walking S in sequence with its state in a register. C is huge on
// this path (di * n = 51,200 channels per batch row), so one launch covers
// every channel of every batch row (grid.y = B) and neighbouring threads
// read neighbouring channels of the same time step: every load and store of
// a warp is one coalesced 128-byte (f32) or 64-byte (bf16) transaction. The
// FMA chain is serial, so each thread loads the next kAhead steps of a and b
// while it runs the current kAhead: up to 2 * kAhead loads in flight per
// thread keep the memory system busy. Ragged S and C are masked, never
// padded. The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // time steps loaded ahead of the FMA chain

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

// a, b, h: [B, S, C], contiguous; grid (ceil(C / kThreads), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
                int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * C + c;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;

  float an[kAhead], bn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const long long off = static_cast<long long>(u) * C;
    an[u] = u < S ? to_f32(ap[off]) : 0.f;
    bn[u] = u < S ? to_f32(bp[off]) : 0.f;
  }
  float state = 0.f;
  for (int t0 = 0; t0 < S; t0 += kAhead) {
    float ac[kAhead], bc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
    // issue the next kAhead steps' loads before this group's FMA chain
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      const long long off = static_cast<long long>(t) * C;
      an[u] = t < S ? to_f32(ap[off]) : 0.f;
      bn[u] = t < S ? to_f32(bp[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = fmaf(ac[u], state, bc[u]);
        hp[static_cast<long long>(t) * C] = from_f32<T>(state);
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* h, int B, int S, int C,
            cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), S, C);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; a, b, h [B, S, C] contiguous, B <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(const void* a, const void* b, void* h, int B, int S, int C,
                              int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, h, B, S, C, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, h, B, S, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
