// List schedule of one task graph under K hardware-parameter vectors, for
// Hopper (sm_90a): per vector the makespan and the busy time of each of the
// four engine classes, both times `repeats`.
//
// Replaces the XLA program of src/repro/core/vectorized.py
// (`_schedule_many_stats_impl`, :238: `_durations` + `schedule`'s
// `jax.lax.scan` over the tasks + `schedule_stats`' busy scatter, under
// `jax.vmap` over the vectors). It is no Pallas kernel; the campaign
// prescreen makes one such call per part screen, and eager PyTorch would
// launch some six operations per task instead.
//
// Bound on the H100: neither bytes nor operations. A call reads the task
// records once (N * 80 bytes) and does ~20 f32 operations per task and
// vector; at N 42, K 192 that is a few nanoseconds of either. What limits
// it is the chain of N dependent steps per vector: a task starts when its
// dependencies and its engine are done, which were written one step before.
//
// Design: one thread per parameter vector walks the tasks in order. The
// end time of every task goes to `done` [N, K] in device memory (a
// dependency may reach back to any earlier task) and the time each engine
// unit is free to `free_` [n_units, K]; both are laid out so that the
// threads of a warp touch neighbouring words. Every thread of a warp reads
// the same task record at once (one broadcast load). The busy sums stay in
// registers and are taken in task order.
//
// Exactness: the result must equal the JAX package's bit for bit, since the
// campaign records that come out of it are frozen. Every operation is one
// f32 operation with one rounding, in the reference's order, written with
// the _rn intrinsics so that nvcc contracts nothing into an FMA; division
// is IEEE. max() lets a NaN through, as jnp.maximum does. A dependency
// index outside [0, i) reads 0.0, as the reference's zero-filled `done`
// row does. The caller checks classes and units; a unit out of range still
// never writes outside `free_`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kParams = 13;

__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// feats: [N, 8] f32 (flops, elems, bytes, io_bytes, gemm_m, gemm_n,
// coll_phases, coll_bytes) as 2 float4 a task; ints: [N, 12] int32 (class,
// unit, cross_pod, pad, 8 dependency slots) as 3 int4 a task.
__global__ void __launch_bounds__(kThreads)
list_schedule_kernel(const float4* __restrict__ feats, const int4* __restrict__ ints,
                     const float* __restrict__ params, int N, int K, int n_units,
                     float repeats, float* __restrict__ done, float* __restrict__ free_,
                     float* __restrict__ makespan, float* __restrict__ busy) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const float* p = params + static_cast<size_t>(k) * kParams;
  const float macs = p[0], f = p[1], vpu_rate = p[2], hbm = p[3], dma_oh = p[4];
  const float link = p[5], lat = p[6], dcn = p[7], dcn_lat = p[8], rows = p[9];
  const float vmem_bw = p[10], t_oh = p[11], cols = p[12];
  const float mxu_rate = __fmul_rn(__fmul_rn(2.0f, macs), f);   // (2.0 * macs) * f
  const float vpu_rate_f = __fmul_rn(vpu_rate, f);
  for (int u = 0; u < n_units; ++u) free_[static_cast<size_t>(u) * K + k] = 0.0f;

  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, mk = 0.0f;
  for (int i = 0; i < N; ++i) {
    const float4 fa = __ldg(feats + 2 * i);       // flops, elems, bytes, io_bytes
    const float4 fb = __ldg(feats + 2 * i + 1);   // gemm_m, gemm_n, phases, coll_bytes
    const int4 ia = __ldg(ints + 3 * i);          // class, unit, cross_pod, pad
    const int4 da = __ldg(ints + 3 * i + 1);
    const int4 db = __ldg(ints + 3 * i + 2);

    float dur;
    if (ia.x == 0) {            // MXU: ragged-edge padding of M and N
      const float m = jmax(fb.x, 1.0f), nn = jmax(fb.y, 1.0f);
      const float padded = __fmul_rn(
          __fmul_rn(__fmul_rn(ceilf(__fdiv_rn(m, rows)), rows), ceilf(__fdiv_rn(nn, cols))),
          cols);
      const float pad = __fdiv_rn(padded, __fmul_rn(m, nn));
      dur = __fadd_rn(jmax(__fdiv_rn(__fmul_rn(fa.x, pad), mxu_rate),
                           __fdiv_rn(fa.w, vmem_bw)), t_oh);
    } else if (ia.x == 1) {     // VPU
      dur = __fadd_rn(jmax(__fdiv_rn(fa.y, vpu_rate_f), __fdiv_rn(fa.w, vmem_bw)), t_oh);
    } else if (ia.x == 2) {     // DMA
      dur = __fadd_rn(dma_oh, __fdiv_rn(fa.z, hbm));
    } else {                    // ICI
      const float bw = ia.z ? dcn : link, latv = ia.z ? dcn_lat : lat;
      dur = __fmul_rn(fb.z, __fadd_rn(latv, __fdiv_rn(fb.w, bw)));
    }

    const int dps[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
    float ready = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dp = dps[j];
      const float v = (dp >= 0 && dp < i) ? done[static_cast<size_t>(dp) * K + k] : 0.0f;
      ready = j == 0 ? v : jmax(ready, v);
    }
    const int u = ia.y;
    const int uc = u < 0 ? 0 : (u >= n_units ? n_units - 1 : u);
    const float end = __fadd_rn(jmax(ready, free_[static_cast<size_t>(uc) * K + k]), dur);
    done[static_cast<size_t>(i) * K + k] = end;
    if (u == uc) free_[static_cast<size_t>(u) * K + k] = end;
    mk = i == 0 ? end : jmax(mk, end);
    switch (ia.x) {
      case 0: b0 = __fadd_rn(b0, dur); break;
      case 1: b1 = __fadd_rn(b1, dur); break;
      case 2: b2 = __fadd_rn(b2, dur); break;
      case 3: b3 = __fadd_rn(b3, dur); break;
      default: break;
    }
  }
  makespan[k] = __fmul_rn(mk, repeats);
  float* bk = busy + static_cast<size_t>(k) * 4;
  bk[0] = __fmul_rn(b0, repeats);
  bk[1] = __fmul_rn(b1, repeats);
  bk[2] = __fmul_rn(b2, repeats);
  bk[3] = __fmul_rn(b3, repeats);
}

}  // namespace

// feats [N, 8] f32, ints [N, 12] int32 (16-byte aligned), params [K, 13]
// f32; scratch done [N, K] and free_ [n_units, K] f32; out makespan [K],
// busy [K, 4] f32. Returns cudaGetLastError() after the launch.
extern "C" int repro_list_schedule(const void* feats, const void* ints, const void* params,
                                   int N, int K, int n_units, float repeats, void* done,
                                   void* free_, void* makespan, void* busy, void* stream) {
  if (N <= 0 || K <= 0 || n_units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kThreads - 1) / kThreads);
  list_schedule_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(feats), static_cast<const int4*>(ints),
      static_cast<const float*>(params), N, K, n_units, repeats,
      static_cast<float*>(done), static_cast<float*>(free_), static_cast<float*>(makespan),
      static_cast<float*>(busy));
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes and static shared bytes of the kernel, for
// chip_smoke.py's report.
extern "C" int repro_list_schedule_attrs(int* registers, int* spill_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, list_schedule_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = a.numRegs;
  *spill_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
