// Fused selective scan of a Mamba head for Hopper (sm_90a): the diagonal
// SSM recurrence and its readout in one pass, for inference.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d, state j)
//   y_t = (sum_j h_t[j] * C_t[j] + D * x_t) * silu(z_t)
//
// Replaces no Pallas kernel on its own: it computes what the chain
// src/repro/models/mamba.py::mamba_mix builds around the `ssm_scan` kernel
// (src/repro/kernels/ssm_scan/kernel.py): the f32 [B, S, di, n] tensors
// a = exp(dt * A) and bu = dt * x * B, the scan over them, the C
// contraction, the D skip and the gate. The chain writes and reads
// a, bu and h, five or six [B, S, di, n] f32 tensors a layer; this kernel
// keeps the n states of a channel in registers and never writes them.
//
// Bound on the H100: bytes and the exponentials. A call reads x and dt
// (f32 [B, S, di]), z ([B, S, di] in the activation dtype), B and C (f32
// [B, S, n]) and writes y ([B, S, di], activation dtype): at hymba-1.5b's
// prefill (B 8, S 3,146, di 3,200, n 16, bf16) ~0.97 GB, 0.29 ms at
// 3.35 TB/s. It takes B * S * di * n exponentials (1.29 G there), 0.31 ms
// on the SFUs at 16 a clock an SM.
//
// Design. Time is serial, so one thread walks it for its states. The
// (batch row, channel) pairs are few (25,600 at the shape above), so each
// channel's n states are split over kLanes = 4 neighbouring lanes of a warp,
// NS = n / 4 states each: 102,400 threads, resident in one wave at <= 64
// registers a thread. A block holds kChannels = 32 channels of one batch row
// (128 threads): 800 blocks, 6 or 7 an SM. Times below are of one call at
// the shape above on an H100 80GB HBM3 at 700 W. A thread's own loads, one
// step at a time, left the kernel waiting on memory: a first design that read
// x, dt, B and C straight from global memory took 1.55 ms; x and dt, and B
// and C, each cost about a third of that. So the block stages time in tiles of
// kTile = 16 steps through shared memory, two tiles deep: while it runs
// tile k, tile k + 1's x, dt, B and C (coalesced rows of the block's
// channels, and of B's and C's n states, which every channel of the row
// shares) are in flight by cp.async, and its z (in the activation dtype,
// 2 bytes in bf16) in registers, stored after the tile; two barriers a
// tile. Staging everything through registers spilled at 64 registers
// (1.20 ms); blocks of 16 channels ran 10% slower than 32, of 64 spilled.
// This design takes 0.94 ms. x, dt and z sit channel-major in a stage, so a
// lane reads 4 steps of its channel in one 16-byte load. Within a tile the
// steps go in groups of kSteps = kLanes. For each step a lane sums its
// states' h * C; the group's four partial sums of the four lanes are then
// combined by a transposed butterfly (two rounds of shuffles, three in all)
// that leaves lane g with the whole sum of step g, so each lane finishes one
// step of the group: D skip, gate, store. Every step's sum is
// (p_0 + p_2) + (p_1 + p_3), p_g being lane g's sum over its states in
// order. exp is ex2.approx of dt * (A * log2 e); the state stays f32.
// Steps past S stage x = dt = 0, which leaves the state unchanged
// (exp(0) = 1, bu = 0); channels past di stage zeros and store nothing, but
// their lanes take part in the shuffles and barriers. Ragged S and di are
// masked, never padded; inputs are read element by element, so any row
// strides of z, B and C will do. The kernel allocates nothing and launches
// on the caller's stream.
//
// ref.py's CPU emulation (`selective_scan_fused_tiled`) follows this loop:
// its groups, its split of n over lanes, its order of the C sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                    // lanes a channel (split of n)
constexpr int kSteps = kLanes;               // time steps a group (one a lane at the end)
constexpr int kChannels = 32;                // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kMinBlocks = 8;                // an SM's blocks at <= 64 registers a thread
constexpr int kTile = 16;                    // time steps a shared-memory stage
constexpr int kRow = kTile + 4;              // a channel's padded row of a stage
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from global to shared memory, asynchronously; zeros if !ok
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NS consecutive floats of shared memory, NS * 4-byte aligned
template <int NS>
__device__ __forceinline__ void load_states(const float* p, float (&v)[NS]) {
  if constexpr (NS == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(NS == 2, "NS is 2 or 4");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// xc, dt, out: [B, S, di] contiguous; z: [B, S, di] with strides (z_sb, z_ss, 1);
// Bm, Cm: [B, S, n] with strides (bc_sb, bc_ss, 1); A: [di, n]; D: [di];
// state_in (or null), state_out: [B, di, n]. Grid (ceil(di / kChannels), B),
// kThreads threads.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_fused_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                            const float* __restrict__ A, const float* __restrict__ Bm,
                            const float* __restrict__ Cm, const float* __restrict__ D,
                            const T* __restrict__ z, const float* __restrict__ state_in,
                            T* __restrict__ out, float* __restrict__ state_out, int S, int di,
                            long long z_sb, long long z_ss, long long bc_sb, long long bc_ss) {
  constexpr int n = NS * kLanes;
  constexpr int kPer = kTile * kChannels / kThreads;  // x, dt, z elements a thread stages
  constexpr int kPerBC = kTile * n / kThreads;        // B, C elements a thread stages
  static_assert(kPer * kThreads == kTile * kChannels && kPerBC * kThreads == kTile * n,
                "a tile is staged in whole elements a thread");
  static_assert(kSteps == 4 && kTile % kSteps == 0, "a lane reads 4 steps at once");
  // x, dt and z channel-major (a lane reads 4 steps of its channel at once),
  // rows padded to kRow floats against bank conflicts; B and C step-major
  __shared__ __align__(16) float xs[2][kChannels][kRow];
  __shared__ __align__(16) float ds[2][kChannels][kRow];
  __shared__ __align__(16) float zs[2][kChannels][kRow];
  __shared__ __align__(16) float bs[2][kTile][n];
  __shared__ __align__(16) float cs[2][kTile][n];

  const int tid = threadIdx.x;
  const int g = tid % kLanes;                 // this lane's share of the states
  const int c = tid / kLanes;                 // this thread's channel in the block
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool valid = d < di;
  const int dd = valid ? d : 0;

  float a2[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a2[j] = valid ? A[dd * n + g * NS + j] * kLog2e : 0.f;
    h[j] = (valid && state_in) ? state_in[(static_cast<long long>(b) * di + dd) * n + g * NS + j]
                               : 0.f;
  }
  const float dskip = valid ? D[dd] : 0.f;

  const long long row0 = static_cast<long long>(b) * S * di;
  const float* xb = xc + row0;
  const float* db = dt + row0;
  T* ob = out + row0;
  const T* zb = z + b * z_sb;
  const float* bb = Bm + b * bc_sb;
  const float* cb = Cm + b * bc_sb;   // Bm and Cm share strides

  // a thread's share of one tile: element e = tid + kThreads * k, at
  // (step e / kChannels, channel e % kChannels) of x, dt, z and
  // (step e / n, state e % n) of B, C. x, dt, B and C go to shared memory
  // by cp.async (zeros past S and di); z, in the activation dtype, through
  // registers.
  auto load_tile = [&](int t0, int s) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + kThreads * k;
      const int u = e / kChannels, col = e % kChannels;
      const int t = t0 + u, ch = d0 + col;
      const bool ok = t < S && ch < di;
      const long long off = ok ? static_cast<long long>(t) * di + ch : 0;
      cp_async4(&xs[s][col][u], xb + off, ok);
      cp_async4(&ds[s][col][u], db + off, ok);
    }
#pragma unroll
    for (int k = 0; k < kPerBC; ++k) {
      const int e = tid + kThreads * k;
      const int t = t0 + e / n;
      const bool ok = t < S;
      const long long off = ok ? t * bc_ss + e % n : 0;
      cp_async4(&bs[s][e / n][e % n], bb + off, ok);
      cp_async4(&cs[s][e / n][e % n], cb + off, ok);
    }
    cp_async_commit();
  };
  float rz[kPer];
  auto fetch_z = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + kThreads * k;
      const int t = t0 + e / kChannels, ch = d0 + e % kChannels;
      rz[k] = (t < S && ch < di) ? to_f32(zb[t * z_ss + ch]) : 0.f;
    }
  };
  auto stash_z = [&](int s) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + kThreads * k;
      zs[s][e % kChannels][e / kChannels] = rz[k];
    }
  };

  load_tile(0, 0);
  fetch_z(0);
  stash_z(0);
  for (int t0 = 0, s = 0; t0 < S; t0 += kTile, s ^= 1) {
    const bool more = t0 + kTile < S;
    if (more) {            // the next tile, in flight while this one runs
      load_tile(t0 + kTile, s ^ 1);
      fetch_z(t0 + kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();       // this tile has landed, every thread's share
#pragma unroll
    for (int u0 = 0; u0 < kTile; u0 += kSteps) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[s][c][u0]);
      const float4 dv = *reinterpret_cast<const float4*>(&ds[s][c][u0]);
      const float x[kSteps] = {xv.x, xv.y, xv.z, xv.w};
      const float dl[kSteps] = {dv.x, dv.y, dv.z, dv.w};
      float p[kSteps];  // this lane's sum of h * C, a step
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float bv[NS], cv[NS];
        load_states<NS>(&bs[s][u0 + u][g * NS], bv);
        load_states<NS>(&cs[s][u0 + u][g * NS], cv);
        const float dx = dl[u] * x[u];
        p[u] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          h[j] = fmaf(ex2(dl[u] * a2[j]), h[j], dx * bv[j]);
          p[u] = fmaf(h[j], cv[j], p[u]);
        }
      }

      // transposed butterfly: lane g ends with step g's sum over the 4 lanes
      const bool hi = g & 2;
      const float k0 = hi ? p[2] : p[0], k1 = hi ? p[3] : p[1];
      const float s0 = hi ? p[0] : p[2], s1 = hi ? p[1] : p[3];
      const float q0 = k0 + __shfl_xor_sync(0xffffffffu, s0, 2);  // step (hi ? 2 : 0)
      const float q1 = k1 + __shfl_xor_sync(0xffffffffu, s1, 2);  // step (hi ? 3 : 1)
      const bool lo = g & 1;
      const float y = (lo ? q1 : q0) + __shfl_xor_sync(0xffffffffu, lo ? q0 : q1, 1);

      const int t = t0 + u0 + g;
      if (valid && t < S) {
        const float zc = zs[s][c][u0 + g];
        const float gate = zc / (1.f + __expf(-zc));
        ob[static_cast<long long>(t) * di + d] =
            from_f32<T>(fmaf(dskip, xs[s][c][u0 + g], y) * gate);
      }
    }
    if (more) stash_z(s ^ 1);
    __syncthreads();       // every thread is done with stage s before it is refilled
  }
  if (valid) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      state_out[(static_cast<long long>(b) * di + d) * n + g * NS + j] = h[j];
  }
}

template <typename T, int NS>
cudaError_t launch(const float* xc, const float* dt, const float* A, const float* Bm,
                   const float* Cm, const float* D, const void* z, const float* state_in,
                   void* out, float* state_out, int B, int S, int di, long long z_sb,
                   long long z_ss, long long bc_sb, long long bc_ss, cudaStream_t stream) {
  // kMinBlocks blocks an SM need up to kMinBlocks * 19 KiB of shared memory:
  // ask for the largest shared-memory carveout once
  static const cudaError_t carved = cudaFuncSetAttribute(
      selective_scan_fused_kernel<T, NS>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carved != cudaSuccess) return carved;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  selective_scan_fused_kernel<T, NS><<<grid, kThreads, 0, stream>>>(
      xc, dt, A, Bm, Cm, D, static_cast<const T*>(z), state_in, static_cast<T*>(out), state_out,
      S, di, z_sb, z_ss, bc_sb, bc_ss);
  return cudaGetLastError();
}

const void* kernel_of(int dtype, int n) {
  if (dtype == 0 && n == 16) return reinterpret_cast<const void*>(selective_scan_fused_kernel<float, 4>);
  if (dtype == 0 && n == 8) return reinterpret_cast<const void*>(selective_scan_fused_kernel<float, 2>);
  if (dtype == 1 && n == 16)
    return reinterpret_cast<const void*>(selective_scan_fused_kernel<__nv_bfloat16, 4>);
  if (dtype == 1 && n == 8)
    return reinterpret_cast<const void*>(selective_scan_fused_kernel<__nv_bfloat16, 2>);
  return nullptr;
}

}  // namespace

// dtype (of z and out): 0 = float32, 1 = bfloat16; n: 8 or 16; state_in may
// be null (h_{-1} = 0). B <= 65535. Returns cudaGetLastError() after the launch
// (or the error of setting the kernel's shared-memory carveout).
extern "C" int repro_selective_scan(const void* xc, const void* dt, const void* A, const void* Bm,
                                    const void* Cm, const void* D, const void* z,
                                    const void* state_in, void* out, void* state_out, int B, int S,
                                    int di, int n, long long z_sb, long long z_ss,
                                    long long bc_sb, long long bc_ss, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || di <= 0 || !kernel_of(dtype, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xc);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  const float* bm = static_cast<const float*>(Bm);
  const float* cm = static_cast<const float*>(Cm);
  const float* ds = static_cast<const float*>(D);
  const float* h0 = static_cast<const float*>(state_in);
  float* h1 = static_cast<float*>(state_out);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 0 && n == 16) {
    err = launch<float, 4>(x, d, a, bm, cm, ds, z, h0, out, h1, B, S, di, z_sb, z_ss, bc_sb,
                           bc_ss, s);
  } else if (dtype == 0) {
    err = launch<float, 2>(x, d, a, bm, cm, ds, z, h0, out, h1, B, S, di, z_sb, z_ss, bc_sb,
                           bc_ss, s);
  } else if (n == 16) {
    err = launch<bf, 4>(x, d, a, bm, cm, ds, z, h0, out, h1, B, S, di, z_sb, z_ss, bc_sb, bc_ss,
                        s);
  } else {
    err = launch<bf, 2>(x, d, a, bm, cm, ds, z, h0, out, h1, B, S, di, z_sb, z_ss, bc_sb, bc_ss,
                        s);
  }
  return static_cast<int>(err);
}

// Registers and local (spill) bytes per thread, and static shared memory per
// block, of the instance for `dtype` and `n`.
extern "C" int repro_selective_scan_attrs(int dtype, int n, int* regs, int* local_bytes,
                                          int* smem_bytes) {
  const void* fn = kernel_of(dtype, n);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
