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
//
// Backward (repro_ssm_scan_bwd): the reverse scan. The reference has no
// backward kernel; it differentiates the jnp scan of
// src/repro/models/mamba.py::selective_scan with jax.grad, which is this
// function: with g_t = dh_t + a_{t+1} * g_{t+1} (a_S = 0), db_t = g_t and
// da_t = g_t * h_{t-1} (h_{-1} = 0), h being the forward's output. Bound:
// bytes. It reads a, h and dh once and writes da and db once, 5 * B * S * C
// * sizeof(T) bytes against one FMA and one multiply per element: 4.72 GB at
// the train shape of hymba-1.5b ([4, 1152, 51200] f32), about 1.41 ms at
// 3.35 TB/s. Design: the forward's, walking S from the end. One thread per
// channel holds g in a register; neighbouring threads read neighbouring
// channels; the loads of the next kAhead steps (a_{t+1}, dh_t, h_{t-1}: up to
// 3 * kAhead in flight) are issued before the current kAhead steps' serial
// FMA chain; ragged S and C are masked.

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

// the inputs of backward step t: a_{t+1} (0 at t = S - 1), dh_t and h_{t-1}
// (0 at t = 0); all 0 for t < 0, past the start of the walk
template <typename T>
__device__ __forceinline__ void load_bwd_step(const T* ap, const T* gp, const T* hp, int t,
                                              int S, int C, float& an, float& gn, float& hn) {
  const long long off = static_cast<long long>(t) * C;
  an = (t >= 0 && t + 1 < S) ? to_f32(ap[off + C]) : 0.f;
  gn = t >= 0 ? to_f32(gp[off]) : 0.f;
  hn = t >= 1 ? to_f32(hp[off - C]) : 0.f;
}

// a, h, dh, da, db: [B, S, C], contiguous; grid (ceil(C / kThreads), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                    const T* __restrict__ dh, T* __restrict__ da, T* __restrict__ db,
                    int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * C + c;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = dh + base;
  T* dap = da + base;
  T* dbp = db + base;

  float an[kAhead], gn[kAhead], hn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) load_bwd_step(ap, gp, hp, S - 1 - u, S, C, an[u], gn[u], hn[u]);
  float g = 0.f;
  for (int t0 = S - 1; t0 >= 0; t0 -= kAhead) {
    float ac[kAhead], gc[kAhead], hc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
      hc[u] = hn[u];
    }
    // issue the next kAhead steps' loads before this group's FMA chain
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      load_bwd_step(ap, gp, hp, t0 - kAhead - u, S, C, an[u], gn[u], hn[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        g = fmaf(ac[u], g, gc[u]);
        const long long off = static_cast<long long>(t) * C;
        dbp[off] = from_f32<T>(g);
        dap[off] = from_f32<T>(g * hc[u]);
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

// dtype: 0 = float32, 1 = bfloat16; a, h, dh, da, db [B, S, C] contiguous,
// B <= 65535. Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_bwd(const void* a, const void* h, const void* dh, void* da,
                                  void* db, int B, int S, int C, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  if (dtype == 0) {
    ssm_scan_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(h),
        static_cast<const float*>(dh), static_cast<float*>(da), static_cast<float*>(db), S, C);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    ssm_scan_bwd_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(a), static_cast<const bf*>(h), static_cast<const bf*>(dh),
        static_cast<bf*>(da), static_cast<bf*>(db), S, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes per thread and static shared memory per
// block of the forward (backward = 0) or backward kernel in `dtype`.
extern "C" int repro_ssm_scan_attrs(int dtype, int backward, int* regs, int* local_bytes,
                                    int* smem_bytes) {
  const void* fn = nullptr;
  if (dtype == 0) {
    fn = backward ? reinterpret_cast<const void*>(ssm_scan_bwd_kernel<float>)
                  : reinterpret_cast<const void*>(ssm_scan_kernel<float>);
  } else if (dtype == 1) {
    fn = backward ? reinterpret_cast<const void*>(ssm_scan_bwd_kernel<__nv_bfloat16>)
                  : reinterpret_cast<const void*>(ssm_scan_kernel<__nv_bfloat16>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
