// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (`rmsnorm_kernel`, launched by `fused_rmsnorm` at :36): row blocks of 256 x
// the full feature dim, math in f32 (mean = sum / d, w cast to f32), output
// cast back to the input dtype. x is [rows, d] contiguous, w [d], any row
// count, 1 <= d <= 8192, f32 or bf16.
//
// Bound on the H100: bytes. A call reads x and w once and writes y once,
// (2 * rows * d + d) * sizeof(T) bytes at 3.35 TB/s, against ~4 f32 flops an
// element. At the decode shapes ([4, 1536], [4, 1600]: 25-28 KB, ~8 ns of
// bytes) it is bound by latency instead: the launch and the trips to device
// memory that depend on each other.
//
// One plan (make_plan, exported as repro_rmsnorm_plan; its twin is
// kernels/rmsnorm/ref.py::rmsnorm_plan) picks a variant from (rows, d, dtype,
// 16-byte alignment of x, w and y, SM count):
//
// * latency (16-byte loads possible, fewer rows than SMs: decode). One block
//   per row; each thread holds one or two 16-byte vectors of x and of w,
//   both loaded before any arithmetic, so the call makes one trip to device
//   memory, not two dependent ones. Warp shuffles and one step through
//   shared memory close the sum; the output is scaled from registers and
//   written once.
// * rows (16-byte loads possible, many rows under 4 KiB: the bf16
//   prefill norms and the per-head qk-norm). `tpr` lanes per row, a power of
//   two (several rows to a warp when a row has fewer than 32 vectors, so no
//   lane idles at d = 128 bf16), four warps a block, one wave of small
//   blocks. A first pass sums the squares, a second reads the row again
//   (from L1) with w and writes. At these shapes it measured level with a
//   device copy of the same bytes, ahead of the ring below.
// * stream (16-byte loads possible, many rows of 4 KiB or more: the f32
//   prefill norms, the bf16 ones of d >= 2048, d up to 8192). The 4 KiB
//   limit is where the two variants cross in both dtypes: chip_smoke.py
//   phase 3 times them against each other at 4096 rows from 2.25 to 16 KiB
//   (PERF.md §6).
//   Persistent blocks, one or two per SM, each an even, contiguous share of
//   the rows. One producer thread stages w once and streams tiles of whole
//   rows through a two-stage ring in shared memory by 1-D bulk copy
//   (cp.async.bulk, completing on an mbarrier), so x leaves device memory
//   once, where two passes over rows this wide would miss L1.
//   Eight consumer warps reduce and write the rows that have arrived and
//   free each stage through an empty mbarrier. One warp takes a row up to
//   8 KiB; wider rows span 2 or 4 warps, whose partial sums meet in shared
//   memory behind a named barrier.
// * scalar (d or a pointer rules out 16-byte loads). The rows kernel with
//   element loads, one warp per row.
//
// Every variant sums a thread's squares in order, closes the sum over a
// warp (or lane group) by an xor butterfly and adds the warps' partial sums
// in warp order (ref.py::rmsnorm_tiled emulates it). bf16 is converted only
// through the cuda_bf16 intrinsics. The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// -- the plan -------------------------------------------------------------------

enum Variant { kScalar = 0, kLatency = 1, kRows = 2, kStream = 3 };

constexpr int kSmemLimit = 232448;     // shared memory one block may use (227 KiB)
constexpr int kSmemPerSm = 233472;     // shared memory of one SM (228 KiB)
constexpr int kSmemPerBlock = 1024;    // of which the system keeps per block
constexpr int kMaxThreads = 1024;
constexpr int kMaxD = 8192;
constexpr int kMaxDevices = 64;
constexpr int kRowsWarps = 4;          // rows, scalar: warps per block
constexpr int kStreamMinBytes = 4096;   // stream: narrowest row (narrower ones take rows)
constexpr int kConsumerWarps = 8;      // stream: warps that reduce and write
constexpr int kStages = 2;             // stream: stages of the ring
constexpr int kWarpVecs = 512;         // stream: vectors of a row one warp takes alone

struct Plan {
  int variant;    // Variant
  int grid;       // blocks
  int threads;    // threads per block
  int tpr;        // threads that share one row
  int vec;        // elements per load
  int vpt;        // loads of x per thread and row, at most
  int tile_rows;  // rows per block (rows, scalar), per stage (stream)
  int stages;     // stages of the ring (stream)
  int smem;       // dynamic shared memory per block, bytes
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// w, the ring, full and empty mbarriers per stage, one for w, partial sums
inline int stream_smem(int row_bytes, int stage_bytes) {
  return row_bytes + kStages * stage_bytes + 8 * (2 * kStages + 1) + 4 * 2 * kConsumerWarps;
}

// the plan of the many-rows variant `variant` (kRows or kStream); 16-byte
// loads must be possible
Plan many_rows_plan(int variant, int rows, int d, int esize, int n_sm) {
  const int vec = 16 / esize;
  const int nvec = d / vec;
  const int row_bytes = d * esize;
  if (variant == kRows) {
    const int tpr = std::min(32, pow2_at_least(nvec));
    const int per_block = 32 * kRowsWarps / tpr;
    return {kRows, cdiv(rows, per_block), 32 * kRowsWarps, tpr, vec, cdiv(nvec, tpr),
            per_block, 0, 0};
  }
  const int tpr = nvec <= kWarpVecs ? 32 : 32 * pow2_at_least(cdiv(nvec, kWarpVecs));
  const int tile_rows = 32 * kConsumerWarps / tpr;
  const int smem = stream_smem(row_bytes, tile_rows * row_bytes);
  const int per_sm = 2 * (smem + kSmemPerBlock) <= kSmemPerSm ? 2 : 1;
  return {kStream, std::min(rows, per_sm * n_sm), 32 * (kConsumerWarps + 1), tpr, vec,
          cdiv(nvec, tpr), tile_rows, kStages, smem};
}

inline bool vec_ok(int d, int esize, bool aligned) { return aligned && d % (16 / esize) == 0; }

Plan make_plan(int rows, int d, int esize, bool aligned, int n_sm) {
  const int vec = 16 / esize;
  if (!vec_ok(d, esize, aligned))
    return {kScalar, cdiv(rows, kRowsWarps), 32 * kRowsWarps, 32, 1, cdiv(d, 32), kRowsWarps,
            0, 0};
  const int nvec = d / vec;
  if (rows < n_sm) {
    const int vpt = nvec <= kMaxThreads ? 1 : 2;
    const int threads = 32 * cdiv(cdiv(nvec, vpt), 32);
    return {kLatency, rows, threads, threads, vec, vpt, 1, 0, 0};
  }
  return many_rows_plan(d * esize < kStreamMinBytes ? kRows : kStream, rows, d, esize, n_sm);
}

// -- element types -----------------------------------------------------------------

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

// N elements moved as one load (16 bytes, or one element in the scalar variant)
template <typename T, int N = 16 / sizeof(T)>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Packs are taken by value: a copy is one load, where reading the elements
// through a reference may become one load per element.
template <typename T, int N>
__device__ __forceinline__ void add_squares(float& ss, const Pack<T, N> a) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float f = to_f32(a.v[j]);
    ss += f * f;
  }
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> scale(const Pack<T, N> a, const Pack<T, N> g, float r) {
  Pack<T, N> o;
#pragma unroll
  for (int j = 0; j < N; ++j) o.v[j] = from_f32<T>(to_f32(a.v[j]) * r * to_f32(g.v[j]));
  return o;
}

// xor butterfly over aligned groups of W lanes (a power of two <= 32); every
// lane of a group ends with the same sum
template <int W>
__device__ __forceinline__ float group_sum(float ss) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// -- PTX wrappers (mbarriers, 1-D bulk copy, named barriers) ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed (the spin stays
// inside one asm block, so the warp leaves it converged).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global into
// shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- rows (VEC = 16 / sizeof(T)) and scalar (VEC = 1): TPR lanes per row -----------
// (TPR is a template argument: with a runtime stride the loops kept fewer
// loads in flight, and the kernel measured slower than with a constant one)

template <typename T, int VEC, int TPR>
__global__ void __launch_bounds__(32 * kRowsWarps)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
             int d, float eps) {
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const int tg = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (32 * kRowsWarps / TPR) + threadIdx.x / TPR;
  if (TPR == 32 && row >= rows) return;  // the whole warp leaves together
  const bool live = row < rows;          // else lanes past the end join the shuffles
  const P* xr = reinterpret_cast<const P*>(x + (live ? row : 0) * d);
  const P* wr = reinterpret_cast<const P*>(w);
  float ss = 0.f;
  if (live)
    for (int i = tg; i < nvec; i += TPR) add_squares(ss, xr[i]);
  ss = group_sum<TPR>(ss);
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  P* yr = reinterpret_cast<P*>(y + row * d);
  for (int i = tg; i < nvec; i += TPR) yr[i] = scale(xr[i], wr[i], r);
}

// -- latency: one block per row, x and w in registers ---------------------------------

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_latency(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int d,
                float eps) {
  using P = Pack<T>;
  __shared__ float part[kMaxThreads / 32];
  const int nvec = d / static_cast<int>(16 / sizeof(T));
  const long long row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* yr = reinterpret_cast<P*>(y + row * d);
  // every load of x and w is issued before any arithmetic: one trip
  P a[VPT], g[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      a[j] = xr[i];
      g[j] = wr[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) add_squares(ss, a[j]);
  }
  ss = group_sum<32>(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < static_cast<int>(blockDim.x / 32); ++k) total += part[k];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) yr[i] = scale(a[j], g[j], r);
  }
}

// -- stream: persistent blocks, rows through a ring of bulk copies --------------------

template <typename T>
__global__ void __launch_bounds__(32 * (kConsumerWarps + 1))
rmsnorm_stream(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
               int d, float eps, int tpr) {
  using P = Pack<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nvec = d / static_cast<int>(16 / sizeof(T));
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int groups = 32 * kConsumerWarps / tpr;  // rows per stage, one per group
  const int stage_bytes = groups * row_bytes;
  const P* s_w = reinterpret_cast<const P*>(smem);
  unsigned char* s_x = smem + row_bytes;
  const uint32_t bars = smem_u32(s_x + kStages * stage_bytes);  // full[s], empty[s], w
  float* red = reinterpret_cast<float*>(s_x + kStages * stage_bytes + 8 * (2 * kStages + 1));
  const uint32_t bar_w = bars + 8 * 2 * kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this block's rows: an even, contiguous share
  const long long r0 = static_cast<long long>(blockIdx.x) * rows / gridDim.x;
  const long long r1 = static_cast<long long>(blockIdx.x + 1) * rows / gridDim.x;
  const int n_tiles = static_cast<int>((r1 - r0 + groups - 1) / groups);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    mbar_init(bar_w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer warp: one thread issues every copy
    if (lane != 0) return;
    mbar_expect_tx(bar_w, row_bytes);
    bulk_load(smem_u32(s_w), w, row_bytes, bar_w);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
      const long long r = r0 + static_cast<long long>(t) * groups;
      const int n = static_cast<int>(min(static_cast<long long>(groups), r1 - r));
      mbar_expect_tx(bars + 8 * s, n * row_bytes);
      bulk_load(smem_u32(s_x + s * stage_bytes), x + r * d, n * row_bytes, bars + 8 * s);
    }
    return;
  }

  // consumers: `tpr` threads (1, 2 or 4 whole warps) per row; group g takes
  // row g of each stage, thread tg its vectors tg, tg + tpr, ...
  const int g = threadIdx.x / tpr;
  const int tg = threadIdx.x % tpr;
  const int wpr = tpr / 32;  // warps per row
  int par = 0;               // which half of `red` this row uses
  mbar_wait(bar_w, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * s, (t / kStages) & 1);
    const long long r = r0 + static_cast<long long>(t) * groups;
    const int n = static_cast<int>(min(static_cast<long long>(groups), r1 - r));
    if (g < n) {  // the same for every warp of the group
      const P* xrow = reinterpret_cast<const P*>(s_x + s * stage_bytes) + g * nvec;
      float ss = 0.f;
      for (int i = tg; i < nvec; i += tpr) add_squares(ss, xrow[i]);
      ss = group_sum<32>(ss);
      if (wpr > 1) {
        if (lane == 0) red[par * kConsumerWarps + warp] = ss;
        named_barrier(1 + g, tpr);
        ss = 0.f;
        for (int k = 0; k < wpr; ++k) ss += red[par * kConsumerWarps + g * wpr + k];
        par ^= 1;
      }
      const float rs = rsqrtf(ss / static_cast<float>(d) + eps);
      P* yr = reinterpret_cast<P*>(y + (r + g) * d);
      for (int i = tg; i < nvec; i += tpr) yr[i] = scale(xrow[i], s_w[i], rs);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
  }
}

// -- host side ---------------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = n;
  return n;
}

template <typename T>
using RowsKernel = void (*)(const T*, const T*, T*, int, int, float);

// the 16-byte rows instance for `tpr` lanes per row
template <typename T>
RowsKernel<T> rows_kernel(int tpr) {
  constexpr int V = 16 / sizeof(T);
  switch (tpr) {
    case 1: return rmsnorm_rows<T, V, 1>;
    case 2: return rmsnorm_rows<T, V, 2>;
    case 4: return rmsnorm_rows<T, V, 4>;
    case 8: return rmsnorm_rows<T, V, 8>;
    case 16: return rmsnorm_rows<T, V, 16>;
    case 32: return rmsnorm_rows<T, V, 32>;
    default: return nullptr;
  }
}

template <typename T>
int launch(const Plan& p, const void* x, const void* w, void* y, int rows, int d, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (p.variant == kScalar) {
    rmsnorm_rows<T, 1, 32><<<p.grid, p.threads, 0, stream>>>(xt, wt, yt, rows, d, eps);
  } else if (p.variant == kRows) {
    const RowsKernel<T> k = rows_kernel<T>(p.tpr);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    k<<<p.grid, p.threads, 0, stream>>>(xt, wt, yt, rows, d, eps);
  } else if (p.variant == kLatency) {
    if (p.vpt == 1)
      rmsnorm_latency<T, 1><<<p.grid, p.threads, 0, stream>>>(xt, wt, yt, d, eps);
    else
      rmsnorm_latency<T, 2><<<p.grid, p.threads, 0, stream>>>(xt, wt, yt, d, eps);
  } else {
    // dynamic shared memory above 48 KiB: an attribute of each device, set
    // once per device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(rmsnorm_stream<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
    rmsnorm_stream<T><<<p.grid, p.threads, p.smem, stream>>>(xt, wt, yt, rows, d, eps, p.tpr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs(int variant, int tpr, int vpt, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (variant == kScalar)
    err = cudaFuncGetAttributes(&a, rmsnorm_rows<T, 1, 32>);
  else if (variant == kRows)
    err = rows_kernel<T>(tpr) ? cudaFuncGetAttributes(&a, rows_kernel<T>(tpr))
                              : cudaErrorInvalidValue;
  else if (variant == kLatency)
    err = vpt == 1 ? cudaFuncGetAttributes(&a, rmsnorm_latency<T, 1>)
                   : cudaFuncGetAttributes(&a, rmsnorm_latency<T, 2>);
  else
    err = cudaFuncGetAttributes(&a, rmsnorm_stream<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 1 <= d <= 8192. Returns cudaGetLastError()
// after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y, int rows, int d, float eps,
                             int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_sm = sm_count();
  if (n_sm <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int esize = dtype == 0 ? 4 : 2;
  const Plan p = make_plan(rows, d, esize, aligned16(x) && aligned16(w) && aligned16(y), n_sm);
  if (dtype == 0) return launch<float>(p, x, w, y, rows, d, eps, s);
  return launch<__nv_bfloat16>(p, x, w, y, rows, d, eps, s);
}

// repro_rmsnorm with the many-rows variant `variant` (2 = rows, 3 = stream)
// in place of the plan's choice, at any row count. It exists to time the two
// against each other where the plan picks one (chip_smoke.py phase 3); the
// wrapper never calls it. The inputs must allow 16-byte loads.
extern "C" int repro_rmsnorm_variant(const void* x, const void* w, void* y, int rows, int d,
                                     float eps, int dtype, int variant, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || (dtype != 0 && dtype != 1) ||
      (variant != kRows && variant != kStream))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2;
  if (!vec_ok(d, esize, aligned16(x) && aligned16(w) && aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sm = sm_count();
  if (n_sm <= 0) return static_cast<int>(cudaErrorNoDevice);
  const Plan p = many_rows_plan(variant, rows, d, esize, n_sm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, x, w, y, rows, d, eps, s);
  return launch<__nv_bfloat16>(p, x, w, y, rows, d, eps, s);
}

// The plan repro_rmsnorm takes for these inputs, as 9 ints in the order of
// struct Plan (ref.py::RmsnormPlan). n_sm <= 0 asks the current device.
extern "C" int repro_rmsnorm_plan(int rows, int d, int dtype, int aligned, int n_sm, int* out) {
  if (rows <= 0 || d <= 0 || d > kMaxD || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_sm <= 0) n_sm = sm_count();
  if (n_sm <= 0) return static_cast<int>(cudaErrorNoDevice);
  const Plan p = make_plan(rows, d, dtype == 0 ? 4 : 2, aligned != 0, n_sm);
  const int v[9] = {p.variant, p.grid, p.threads, p.tpr, p.vec, p.vpt, p.tile_rows, p.stages,
                    p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Registers per thread, spill (local) bytes per thread and static shared
// memory per block of the instance for (variant, dtype, tpr, vpt) of a plan
// (cudaFuncGetAttributes); the dynamic shared memory is the plan's `smem`.
extern "C" int repro_rmsnorm_attrs(int variant, int dtype, int tpr, int vpt, int* regs,
                                   int* local_bytes, int* smem_bytes) {
  if (variant < kScalar || variant > kStream) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return attrs<float>(variant, tpr, vpt, regs, local_bytes, smem_bytes);
  if (dtype == 1) return attrs<__nv_bfloat16>(variant, tpr, vpt, regs, local_bytes, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
