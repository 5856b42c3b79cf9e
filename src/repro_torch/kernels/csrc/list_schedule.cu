// List schedule of one task graph under K hardware-parameter vectors, for
// Hopper (sm_90a): per vector the makespan and the busy time of each of the
// four engine classes, both times `repeats`.
//
// Replaces the XLA program of src/repro/core/vectorized.py
// (`_schedule_many_stats_impl`, :239: `_durations` + `schedule`'s
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
// Design: one plan (make_plan, exported as repro_list_schedule_plan; its
// twin is kernels/list_schedule/ref.py::list_schedule_plan) picks the
// first of two variants that fits, at the largest T that fits.
//   shared: a block takes T vectors (a power of two, at most 64 and no more
//     than K needs) and keeps the packed tasks, `done` [N + 1][T] and `free`
//     [n_units][T] in the 232,448 B of opt-in shared memory. A pre-pass of
//     all 512 threads packs every task (16-bit row indices of its slots, a
//     missing dependency pointing at the zero row N, and its unit, class
//     and forwarding bits: 20 B a task) and computes every duration off the
//     chain, each thread for one vector over a stride of tasks, writing it
//     into the task's `done` slot. Then one thread a vector walks the
//     tasks: the max over the dependency slots and the engine's free slot,
//     plus the duration, written back over the duration. A step's loads
//     (the next task's record, duration, slots and free time) are issued
//     one step ahead, and a slot of the previous task, or the free slot it
//     wrote, takes the previous end from a register, so a step waits on no
//     memory.
//   global: the first design, for graphs too large for shared memory even
//     at T 1 (N above ~9,600): one thread a vector, `done` [N, K] and
//     `free_` in device memory, durations on the chain.
//
// Exactness: the result must equal the JAX package's bit for bit, since the
// campaign records that come out of it are frozen. Every operation is one
// f32 operation with one rounding, in the reference's order, written with
// the _rn intrinsics so that nvcc contracts nothing into an FMA; division
// is IEEE. jmax lets the first NaN through, as jnp.maximum does, and keeps
// its first argument on a tie; so a tree of jmax over the dependency slots
// in their order gives the bits of the reference's fold. A dependency index
// outside [0, i) reads 0.0, as the reference's zero-filled `done` row does:
// in the shared variant a slot at i or later holds a duration, not 0.0,
// and the guard keeps it out. The caller checks classes and units; a unit
// out of range still never writes outside `free`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGlobalThreads = 64;
constexpr int kSharedThreads = 512;
constexpr int kMaxVectors = 64;
constexpr long long kSmemLimit = 232448;   // opt-in shared memory of a block
constexpr int kParams = 13;

enum Variant { kGlobal = 0, kShared = 1 };

// -- the plan -------------------------------------------------------------------

struct Plan {
  int variant;
  int vectors;    // T: parameter vectors (chain threads) per block
  int grid;
  int threads;
  long long smem; // dynamic shared memory per block
};

// the packed tasks, N + 2 of 20 B, then done [N + 1][T] (a zero row for
// the missing dependencies) and free [n_units][T] f32
long long shared_bytes(long long N, long long n_units, long long T) {
  return 20 * (N + 2) + 4 * T * (N + 1 + n_units);
}

// T <= 64 and no more than K needs (a power of two)
int max_vectors(int K) {
  int T = 1;
  while (T < kMaxVectors && T < K) T <<= 1;
  return T;
}

// `forced` < 0: the plan's own choice, shared where it fits at T 1, else
// global. shared takes the largest power-of-two T that fits; T 1 when none
// does (a forced launch the runtime then refuses).
Plan make_plan(int N, int K, int n_units, int forced) {
  const int v = forced >= 0 ? forced
                            : (shared_bytes(N, n_units, 1) <= kSmemLimit ? kShared : kGlobal);
  if (v == kGlobal)
    return {kGlobal, kGlobalThreads, (K + kGlobalThreads - 1) / kGlobalThreads,
            kGlobalThreads, 0};
  int T = max_vectors(K);
  while (T > 1 && shared_bytes(N, n_units, T) > kSmemLimit) T >>= 1;
  return {kShared, T, (K + T - 1) / T, kSharedThreads, shared_bytes(N, n_units, T)};
}

// -- the arithmetic, shared by every variant -----------------------------------

__device__ __forceinline__ float jmax(float a, float b) {
  return (a == a && !(a >= b)) ? b : a;   // a NaN: a; b NaN: b; else a < b ? b : a
}

struct Params {
  float mxu_rate, vpu_rate_f, hbm, dma_oh, link, lat, dcn, dcn_lat, rows, vmem_bw, t_oh,
      cols;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  Params q;
  q.mxu_rate = __fmul_rn(__fmul_rn(2.0f, __ldg(p + 0)), __ldg(p + 1));  // (2.0 * macs) * f
  q.vpu_rate_f = __fmul_rn(__ldg(p + 2), __ldg(p + 1));
  q.hbm = __ldg(p + 3);
  q.dma_oh = __ldg(p + 4);
  q.link = __ldg(p + 5);
  q.lat = __ldg(p + 6);
  q.dcn = __ldg(p + 7);
  q.dcn_lat = __ldg(p + 8);
  q.rows = __ldg(p + 9);
  q.vmem_bw = __ldg(p + 10);
  q.t_oh = __ldg(p + 11);
  q.cols = __ldg(p + 12);
  return q;
}

// feats fa: flops, elems, bytes, io_bytes; fb: gemm_m, gemm_n, phases,
// coll_bytes
__device__ __forceinline__ float duration(const float4 fa, const float4 fb, int cls,
                                          int cross, const Params& q) {
  if (cls == 0) {             // MXU: ragged-edge padding of M and N
    const float m = jmax(fb.x, 1.0f), nn = jmax(fb.y, 1.0f);
    const float padded = __fmul_rn(
        __fmul_rn(__fmul_rn(ceilf(__fdiv_rn(m, q.rows)), q.rows), ceilf(__fdiv_rn(nn, q.cols))),
        q.cols);
    const float pad = __fdiv_rn(padded, __fmul_rn(m, nn));
    return __fadd_rn(jmax(__fdiv_rn(__fmul_rn(fa.x, pad), q.mxu_rate),
                          __fdiv_rn(fa.w, q.vmem_bw)), q.t_oh);
  }
  if (cls == 1)               // VPU
    return __fadd_rn(jmax(__fdiv_rn(fa.y, q.vpu_rate_f), __fdiv_rn(fa.w, q.vmem_bw)), q.t_oh);
  if (cls == 2)               // DMA
    return __fadd_rn(q.dma_oh, __fdiv_rn(fa.z, q.hbm));
  const float bw = cross ? q.dcn : q.link, latv = cross ? q.dcn_lat : q.lat;   // ICI
  return __fmul_rn(fb.z, __fadd_rn(latv, __fdiv_rn(fb.w, bw)));
}

__device__ __forceinline__ int clamp_unit(int u, int n_units) {
  return u < 0 ? 0 : (u >= n_units ? n_units - 1 : u);
}

__device__ __forceinline__ void add_busy(int cls, float dur, float& b0, float& b1, float& b2,
                                         float& b3) {
  switch (cls) {
    case 0: b0 = __fadd_rn(b0, dur); break;
    case 1: b1 = __fadd_rn(b1, dur); break;
    case 2: b2 = __fadd_rn(b2, dur); break;
    case 3: b3 = __fadd_rn(b3, dur); break;
    default: break;
  }
}

__device__ __forceinline__ void write_out(int k, float mk, float b0, float b1, float b2,
                                          float b3, float repeats, float* __restrict__ makespan,
                                          float* __restrict__ busy) {
  makespan[k] = __fmul_rn(mk, repeats);
  float* bk = busy + static_cast<size_t>(k) * 4;
  bk[0] = __fmul_rn(b0, repeats);
  bk[1] = __fmul_rn(b1, repeats);
  bk[2] = __fmul_rn(b2, repeats);
  bk[3] = __fmul_rn(b3, repeats);
}

// -- global: done and free in device memory ------------------------------------

// feats: [N, 8] f32 as 2 float4 a task; ints: [N, 12] int32 (class, unit,
// cross_pod, pad, 8 dependency slots) as 3 int4 a task.
__global__ void __launch_bounds__(kGlobalThreads)
list_schedule_global_kernel(const float4* __restrict__ feats, const int4* __restrict__ ints,
                            const float* __restrict__ params, int N, int K, int n_units,
                            float repeats, float* __restrict__ done, float* __restrict__ free_,
                            float* __restrict__ makespan, float* __restrict__ busy) {
  const int k = blockIdx.x * kGlobalThreads + threadIdx.x;
  if (k >= K) return;
  const Params q = load_params(params + static_cast<size_t>(k) * kParams);
  for (int u = 0; u < n_units; ++u) free_[static_cast<size_t>(u) * K + k] = 0.0f;

  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f, mk = 0.0f;
  for (int i = 0; i < N; ++i) {
    const int4 ia = __ldg(ints + 3 * i);          // class, unit, cross_pod, pad
    const int4 da = __ldg(ints + 3 * i + 1);
    const int4 db = __ldg(ints + 3 * i + 2);
    const float dur = duration(__ldg(feats + 2 * i), __ldg(feats + 2 * i + 1), ia.x, ia.z, q);

    const int dps[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
    float ready = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dp = dps[j];
      const float v = (dp >= 0 && dp < i) ? done[static_cast<size_t>(dp) * K + k] : 0.0f;
      ready = j == 0 ? v : jmax(ready, v);
    }
    const int u = ia.y, uc = clamp_unit(u, n_units);
    const float end = __fadd_rn(jmax(ready, free_[static_cast<size_t>(uc) * K + k]), dur);
    done[static_cast<size_t>(i) * K + k] = end;
    if (u == uc) free_[static_cast<size_t>(u) * K + k] = end;
    mk = i == 0 ? end : jmax(mk, end);
    add_busy(ia.x, dur, b0, b1, b2, b3);
  }
  write_out(k, mk, b0, b1, b2, b3, repeats, makespan, busy);
}

// -- shared: the chain in shared memory ----------------------------------------

// One task as the chain reads it: the 8 dependency slots as float indices
// into `done` (dp * T for 0 <= dp < i, else N * T, the zero row), two to a
// word, and one word of `meta`: the free slot of its clamped unit (uc * T,
// bits 0-15), which slots hold the previous task (bits 16-23), its class
// (bits 24-26; 4 for none), whether it writes its free slot (bit 27) and
// whether that slot holds the previous task's end (bit 28). Every index
// fits 16 bits: N * T <= 58,112 wherever the shared variant fits.
struct Task {
  uint32_t d01, d23, d45, d67, meta;
};

constexpr int kTaskBytes = 20;

__device__ __forceinline__ Task dummy_task(int zero_row) {
  const uint32_t z = static_cast<uint32_t>(zero_row) * 0x10001u;
  return {z, z, z, z, 4u << 24};
}

// the packed record of task i < N, from its raw rows (class, unit,
// cross_pod, pad; 8 slots) and the unit of task i-1
__device__ __forceinline__ Task pack_task(const int4* __restrict__ ints, int i, int N,
                                          int lg_t, int n_units) {
  const int4 a = __ldg(ints + 3 * i), da = __ldg(ints + 3 * i + 1),
             db = __ldg(ints + 3 * i + 2);
  const int up = i > 0 ? __ldg(ints + 3 * (i - 1)).y : -1;
  const int dps[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
  uint32_t idx[8], fwd = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    idx[j] = static_cast<uint32_t>(((dps[j] >= 0 && dps[j] < i) ? dps[j] : N) << lg_t);
    fwd |= (i > 0 && dps[j] == i - 1) ? (1u << j) : 0u;
  }
  const int uc = clamp_unit(a.y, n_units);
  const bool from_prev = i > 0 && up == clamp_unit(up, n_units) && up == uc;
  const uint32_t cls = (a.x >= 0 && a.x < 4) ? a.x : 4;
  const uint32_t meta = (static_cast<uint32_t>(uc) << lg_t) | (fwd << 16) | (cls << 24) |
                        (a.y == uc ? 1u << 27 : 0u) | (from_prev ? 1u << 28 : 0u);
  return {idx[0] | idx[1] << 16, idx[2] | idx[3] << 16, idx[4] | idx[5] << 16,
          idx[6] | idx[7] << 16, meta};
}

// Dynamic shared memory: the packed tasks, N + 2 of them (two dummies past
// the end), 16 B of slots then 4 B of meta each, then done [N + 1][T] (row
// N stays 0.0) and free [n_units][T] f32, T = 1 << lg_t.
__global__ void __launch_bounds__(kSharedThreads)
list_schedule_shared_kernel(const float4* __restrict__ feats, const int4* __restrict__ ints,
                            const float* __restrict__ params, int N, int K, int n_units,
                            int lg_t, float repeats, float* __restrict__ makespan,
                            float* __restrict__ busy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = 1 << lg_t;
  const int n_rec = N + 2;
  uint4* rec_deps = reinterpret_cast<uint4*>(smem);
  uint32_t* rec_meta = reinterpret_cast<uint32_t*>(smem + 16 * static_cast<size_t>(n_rec));
  float* done = reinterpret_cast<float*>(smem + kTaskBytes * static_cast<size_t>(n_rec));
  float* freeu = done + static_cast<size_t>(N + 1) * T;
  const int k0 = blockIdx.x * T;

  // pre-pass, every thread of the block: the packed tasks, the zero row and
  // free, then the durations, each thread for one vector over a stride of
  // tasks (its parameters loaded once)
  for (int i = threadIdx.x; i < n_rec; i += kSharedThreads) {
    const Task r = i < N ? pack_task(ints, i, N, lg_t, n_units) : dummy_task(N << lg_t);
    rec_deps[i] = make_uint4(r.d01, r.d23, r.d45, r.d67);
    rec_meta[i] = r.meta;
  }
  for (int e = threadIdx.x; e < (n_units + 1) * T; e += kSharedThreads)
    (e < T ? done[(N << lg_t) + e] : freeu[e - T]) = 0.0f;
  {
    const int t = threadIdx.x & (T - 1), k = k0 + t;
    if (k < K) {
      const Params q = load_params(params + static_cast<size_t>(k) * kParams);
#pragma unroll 4
      for (int i = threadIdx.x >> lg_t; i < N; i += kSharedThreads >> lg_t) {
        const int4 ia = __ldg(ints + 3 * i);
        done[(i << lg_t) + t] =
            duration(__ldg(feats + 2 * i), __ldg(feats + 2 * i + 1), ia.x, ia.z, q);
      }
    }
  }
  __syncthreads();

  // the chain: one thread a vector, its column of done and free
  const int t = threadIdx.x, k = k0 + t;
  if (t >= T || k >= K) return;
  float* col = done + t;
  float* fcol = freeu + t;
  auto fetch = [&](int i) -> Task {
    const uint4 d = rec_deps[i];
    return {d.x, d.y, d.z, d.w, rec_meta[i]};
  };
  auto load_deps = [&](const Task& r, float (&v)[8]) {
    v[0] = col[r.d01 & 0xffff]; v[1] = col[r.d01 >> 16];
    v[2] = col[r.d23 & 0xffff]; v[3] = col[r.d23 >> 16];
    v[4] = col[r.d45 & 0xffff]; v[5] = col[r.d45 >> 16];
    v[6] = col[r.d67 & 0xffff]; v[7] = col[r.d67 >> 16];
  };

  Task cur = fetch(0), nxt = fetch(1);
  float cv[8];
  load_deps(cur, cv);
  float cdur = col[0], cfree = fcol[cur.meta & 0xffff];
  float prev = 0.0f;                       // the end of the previous task
  float mk = -INFINITY;                    // jmax(-inf, x) is x, bit for bit
  float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
  int row = 0;                             // i * T
  for (int i = 0; i < N; ++i) {
    // what task i+1 reads, loaded before task i writes: its slot of task i
    // and a free slot task i writes are stale here, and are forwarded
    float nv[8];
    load_deps(nxt, nv);
    const float ndur = col[row + T], nfree = fcol[nxt.meta & 0xffff];
    const Task nn = fetch(i + 2);

    // step i
    const uint32_t m = cur.meta;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (m >> (16 + j)) & 1u ? prev : cv[j];
    const float ready = jmax(jmax(jmax(v[0], v[1]), jmax(v[2], v[3])),
                             jmax(jmax(v[4], v[5]), jmax(v[6], v[7])));
    const float end = __fadd_rn(jmax(ready, (m >> 28) & 1u ? prev : cfree), cdur);
    col[row] = end;
    if ((m >> 27) & 1u) fcol[m & 0xffff] = end;
    mk = jmax(mk, end);
    // busy in task order: the other classes add +0.0, which leaves their
    // sums (never -0.0) as they are
    const uint32_t c = (m >> 24) & 7u;
    b0 = __fadd_rn(b0, c == 0 ? cdur : 0.0f);
    b1 = __fadd_rn(b1, c == 1 ? cdur : 0.0f);
    b2 = __fadd_rn(b2, c == 2 ? cdur : 0.0f);
    b3 = __fadd_rn(b3, c == 3 ? cdur : 0.0f);
    prev = end;
    row += T;

    cur = nxt;
    nxt = nn;
#pragma unroll
    for (int j = 0; j < 8; ++j) cv[j] = nv[j];
    cdur = ndur;
    cfree = nfree;
  }
  write_out(k, mk, b0, b1, b2, b3, repeats, makespan, busy);
}

template <typename F>
int func_attrs(F fn, int* registers, int* spill_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = a.numRegs;
  *spill_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

}  // namespace

// feats [N, 8] f32, ints [N, 12] int32 (16-byte aligned), params [K, 13]
// f32; out makespan [K], busy [K, 4] f32. `variant` -1 takes the plan's
// choice, 0/1 forces global/shared. Scratch done [N, K] and
// free_ [n_units, K] f32 is read only by the global variant (NULL
// otherwise). Returns cudaGetLastError() after the launch, or the error that
// refused it (a shared-memory size above the card's limit among them).
extern "C" int repro_list_schedule(const void* feats, const void* ints, const void* params,
                                   int N, int K, int n_units, float repeats, int variant,
                                   void* done, void* free_, void* makespan, void* busy,
                                   void* stream) {
  if (N <= 0 || K <= 0 || n_units <= 0 || variant < -1 || variant > kShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(N, K, n_units, variant);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* f4 = static_cast<const float4*>(feats);
  const int4* i4 = static_cast<const int4*>(ints);
  const float* pr = static_cast<const float*>(params);
  float* mk = static_cast<float*>(makespan);
  float* bz = static_cast<float*>(busy);
  if (p.variant == kGlobal) {
    if (done == nullptr || free_ == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    list_schedule_global_kernel<<<p.grid, p.threads, 0, s>>>(
        f4, i4, pr, N, K, n_units, repeats, static_cast<float*>(done),
        static_cast<float*>(free_), mk, bz);
    return static_cast<int>(cudaGetLastError());
  }
  int lg_t = 0;
  while ((1 << lg_t) < p.vectors) ++lg_t;
  const int smem = p.smem > kSmemLimit + 1 ? static_cast<int>(kSmemLimit + 1)
                                           : static_cast<int>(p.smem);
  const cudaError_t err = cudaFuncSetAttribute(
      list_schedule_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // the refusal is reported here, not by the next launch
    return static_cast<int>(err);
  }
  list_schedule_shared_kernel<<<p.grid, p.threads, smem, s>>>(f4, i4, pr, N, K, n_units,
                                                               lg_t, repeats, mk, bz);
  return static_cast<int>(cudaGetLastError());
}

// The plan repro_list_schedule takes for these inputs (`variant` as there),
// as 5 ints: variant, vectors, grid, threads, dynamic shared bytes (capped
// at the limit + 1: such a launch is refused).
extern "C" int repro_list_schedule_plan(int N, int K, int n_units, int variant, int* out) {
  if (N <= 0 || K <= 0 || n_units <= 0 || variant < -1 || variant > kShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(N, K, n_units, variant);
  out[0] = p.variant;
  out[1] = p.vectors;
  out[2] = p.grid;
  out[3] = p.threads;
  out[4] = p.smem > kSmemLimit + 1 ? static_cast<int>(kSmemLimit + 1) : static_cast<int>(p.smem);
  return 0;
}

// Registers, local (spill) bytes and static shared bytes of a variant's
// kernel, for chip_smoke.py's report.
extern "C" int repro_list_schedule_attrs(int variant, int* registers, int* spill_bytes,
                                         int* smem_bytes) {
  if (variant == kGlobal)
    return func_attrs(list_schedule_global_kernel, registers, spill_bytes, smem_bytes);
  if (variant == kShared)
    return func_attrs(list_schedule_shared_kernel, registers, spill_bytes, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
