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
// overhead, outside the function's bound (0.5-1 us at [4096, 1536]).
//
// Two launches and no atomics, so a step on the card gives the same bits
// every time. One plan (make_plan, exported as repro_rmsnorm_bwd_plan; its
// twin is kernels/rmsnorm/ref.py::rmsnorm_bwd_plan) picks a variant:
// * vector (x, g, dx and w 16-byte aligned, d a multiple of the 16-byte
//   vector): one pass over each row. `tpr` lanes hold a row (a power of two:
//   the fewest that keep each lane at most 12 f32 or 6 bf16 vectors of x,
//   i.e. 48 values; one warp a row at d 1536, 4 lanes a row at d 128), each
//   lane the vectors lane, lane + tpr, ... of its row in registers, x and g
//   loaded as 16-byte vectors before any arithmetic. The lanes reduce sum x^2
//   and sum g*w*x (xor butterflies, and through shared memory in warp order
//   when a row spans warps), then write dx from registers. Each lane owns
//   fixed columns, so it loads its slice of w once per block and adds
//   g*x*r for its columns over the rows of its group in registers. At the
//   end the groups of a warp are added by an xor butterfly and the warps in
//   warp order through one [d] f32 buffer in shared memory, and the block
//   writes one partial row. Blocks take contiguous, even shares of the rows.
// * scalar (otherwise): one warp a row, element loads, two passes over the
//   row, a [warps][d] f32 accumulator in shared memory.
// Then a second launch adds the partial rows in a fixed order: eight slices
// of them in order per column, then the slices in order.
// r is recomputed from x: the forward saves nothing but x and w. The kernels
// allocate nothing (the caller passes the partial buffer, `blocks` rows at
// most) and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8192;
constexpr int kThreads = 256;            // vector variant: eight warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecsF32 = 12;          // 16-byte vectors of x per lane and row
constexpr int kMaxVecsBf16 = 6;
constexpr int kScalarMaxWarps = 8;
constexpr int kScalarSmem = 96 * 1024;   // the scalar variant's dw accumulators
constexpr int kDwCols = 32;               // dw launch: columns a block
constexpr int kDwSlices = 8;             // dw launch: slices of the partial rows a block
constexpr int kMaxDevices = 64;

enum Variant { kScalar = 0, kVector = 1 };

struct Plan {
  int variant, tpr, vec, vpt, blocks, smem;
};

Plan make_plan(int rows, int d, int esize, bool aligned, int blocks) {
  const int vec = 16 / esize;
  if (!aligned || d % vec != 0) {
    const int fit = kScalarSmem / (d * 4);
    const int warps = fit < 1 ? 1 : (fit > kScalarMaxWarps ? kScalarMaxWarps : fit);
    return Plan{kScalar, 32, 1, (d + 31) / 32, blocks < rows ? blocks : rows, warps * d * 4};
  }
  const int nvec = d / vec;
  const int vmax = esize == 4 ? kMaxVecsF32 : kMaxVecsBf16;
  int tpr = 1;
  while ((nvec + tpr - 1) / tpr > vmax) tpr *= 2;
  const int groups = kThreads / tpr;
  const int need = (rows + groups - 1) / groups;
  return Plan{kVector, tpr, vec, (nvec + tpr - 1) / tpr, blocks < need ? blocks : need, d * 4};
}

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

// the 16-byte vector at element offset e of p, as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x, f[2 * i + 1] = p.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The vector variant: VPT vectors of 16 bytes per lane and row, tpr lanes a
// row (a power of two, at most kThreads).
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, 1)
rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                T* __restrict__ dx, float* __restrict__ part, int rows, int d, int tpr,
                float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float buf[];          // [d]: the warps' dw, added in warp order
  __shared__ float red[kWarps][2];        // a row's sums when it spans warps
  const int nvec = d / kVec;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = threadIdx.x / tpr, gl = threadIdx.x % tpr;
  const int n_groups = kThreads / tpr;
  const int span = tpr > 32 ? tpr / 32 : 1;   // warps of one group
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  uint4* dx4 = reinterpret_cast<uint4*>(dx);

  uint4 wv[VPT];
  float acc[VPT][kVec];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = gl + tpr * i;
    wv[i] = c < nvec ? reinterpret_cast<const uint4*>(w)[c] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

  const float inv_d = 1.f / static_cast<float>(d);
  const int per_block = (rows + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per_block;
  const int r1 = min(rows, r0 + per_block);
  const int steps = r1 > r0 ? (r1 - r0 + n_groups - 1) / n_groups : 0;  // uniform in the block
  for (int step = 0; step < steps; ++step) {
    const int row = r0 + step * n_groups + group;
    const bool ok = row < r1;
    const long long base = static_cast<long long>(row) * nvec;
    uint4 xv[VPT], gv[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = gl + tpr * i;
      const bool in = ok && c < nvec;
      xv[i] = in ? x4[base + c] : make_uint4(0, 0, 0, 0);
      gv[i] = in ? g4[base + c] : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f, sgwx = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      float xf[kVec], gf[kVec], wf[kVec];
      unpack<T>(xv[i], xf);
      unpack<T>(gv[i], gf);
      unpack<T>(wv[i], wf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ss += xf[e] * xf[e];
        sgwx += gf[e] * wf[e] * xf[e];
      }
    }
    // close the sums over the row's lanes: an xor butterfly inside the
    // warp, then the warps of the group in warp order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < tpr) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sgwx += __shfl_xor_sync(0xffffffffu, sgwx, o);
      }
    }
    if (span > 1) {
      if (lane == 0) red[warp][0] = ss, red[warp][1] = sgwx;
      __syncthreads();
      const int w0 = (warp / span) * span;
      ss = sgwx = 0.f;
      for (int k = 0; k < span; ++k) ss += red[w0 + k][0], sgwx += red[w0 + k][1];
      __syncthreads();                      // red is read before the next row writes it
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float coef = r * r * r * (sgwx * inv_d);
    if (!ok) continue;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = gl + tpr * i;
      if (c >= nvec) continue;
      float xf[kVec], gf[kVec], wf[kVec], out[kVec];
      unpack<T>(xv[i], xf);
      unpack<T>(gv[i], gf);
      unpack<T>(wv[i], wf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        out[e] = r * (gf[e] * wf[e]) - xf[e] * coef;
        acc[i][e] += gf[e] * xf[e] * r;
      }
      dx4[base + c] = pack<T>(out);
    }
  }

  // dw: the groups of a warp by an xor butterfly, then the warps in warp
  // order through buf (the first warps to own a column write it)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= tpr) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
      }
    }
  }
  for (int turn = 0; turn < kWarps; ++turn) {
    if (warp == turn && lane < tpr) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = gl + tpr * i;
        if (c >= nvec) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float* slot = &buf[c * kVec + e];
          *slot = turn < span ? acc[i][e] : *slot + acc[i][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) out[c] = buf[c];
}

// The scalar variant: one warp a row, element loads, two passes.
template <typename T>
__global__ void __launch_bounds__(kScalarMaxWarps * 32)
rmsnorm_bwd_scalar(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ part, int rows, int d,
                   int rows_per_block, float eps) {
  extern __shared__ float acc_s[];  // [warps][d]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* mine = acc_s + warp * d;
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
    for (int k = 0; k < warps; ++k) s += acc_s[k * d + c];
    out[c] = s;
  }
}

// dw: a block of kDwCols columns x kDwSlices slices; slice k adds the
// partial rows [k * per, (k + 1) * per) in order, then the slices are added
// in order (ref.py::rmsnorm_bwd_tiled follows the same order)
template <typename T>
__global__ void __launch_bounds__(kDwCols * kDwSlices)
rmsnorm_bwd_dw(const float* __restrict__ part, T* __restrict__ dw, int blocks, int d) {
  __shared__ float sums[kDwSlices][kDwCols];
  const int cl = threadIdx.x % kDwCols, sl = threadIdx.x / kDwCols;
  const int c = blockIdx.x * kDwCols + cl;
  const int per = (blocks + kDwSlices - 1) / kDwSlices;
  const int b1 = min(blocks, (sl + 1) * per);
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = sl * per; b < b1; ++b) s += part[static_cast<long long>(b) * d + c];
  }
  sums[sl][cl] = s;
  __syncthreads();
  if (sl != 0 || c >= d) return;
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kDwSlices; ++k) t += sums[k][cl];
  dw[c] = from_f32<T>(t);
}

template <typename K>
int allow_smem_once(K kernel, int bytes) {
  // dynamic shared memory above 48 KiB: an attribute of each device and
  // kernel, set once per device
  static bool set[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && set[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScalarSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices) set[dev] = true;
  return 0;
}

template <typename T, int VPT>
void launch_vec(const Plan& p, const void* x, const void* w, const void* g, void* dx,
                void* part, int rows, int d, float eps, cudaStream_t s) {
  rmsnorm_bwd_vec<T, VPT><<<p.blocks, kThreads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, p.tpr, eps);
}

template <typename T, int VPT>
const void* vec_kernel() {
  return reinterpret_cast<const void*>(rmsnorm_bwd_vec<T, VPT>);
}

// the vector instance for p.vpt (1..12 in f32, 1..6 in bf16); launch (or
// report the kernel with fn != nullptr)
template <typename T>
bool vec_dispatch(const Plan& p, const void* x, const void* w, const void* g, void* dx,
                  void* part, int rows, int d, float eps, cudaStream_t s, const void** fn) {
#define REPRO_RB_CASE(N)                                                  \
  case N:                                                                 \
    if (fn != nullptr) *fn = vec_kernel<T, N>();                          \
    else launch_vec<T, N>(p, x, w, g, dx, part, rows, d, eps, s);         \
    return true;
  switch (p.vpt) {
    REPRO_RB_CASE(1) REPRO_RB_CASE(2) REPRO_RB_CASE(3) REPRO_RB_CASE(4) REPRO_RB_CASE(5)
    REPRO_RB_CASE(6)
  }
  if constexpr (sizeof(T) == 4) {
    switch (p.vpt) {
      REPRO_RB_CASE(7) REPRO_RB_CASE(8) REPRO_RB_CASE(9) REPRO_RB_CASE(10) REPRO_RB_CASE(11)
      REPRO_RB_CASE(12)
    }
  }
#undef REPRO_RB_CASE
  return false;
}

template <typename T>
int launch(const Plan& p, const void* x, const void* w, const void* g, void* dx, void* dw,
           void* part, int rows, int d, float eps, cudaStream_t s) {
  if (p.variant == kScalar) {
    const int e = allow_smem_once(rmsnorm_bwd_scalar<T>, p.smem);
    if (e != 0) return e;
    rmsnorm_bwd_scalar<T><<<p.blocks, p.smem / (4 * d) * 32, p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
        static_cast<T*>(dx), static_cast<float*>(part), rows, d,
        (rows + p.blocks - 1) / p.blocks, eps);
  } else if (!vec_dispatch<T>(p, x, w, g, dx, part, rows, d, eps, s, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_dw<T><<<(d + kDwCols - 1) / kDwCols, kDwCols * kDwSlices, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(dw), p.blocks, d);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dx [rows, d] and dw [d] from x, w, g; `part` is [blocks, d] f32 scratch,
// blocks >= 1 (the wrapper takes min(rows, SMs); the plan may use fewer).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launches.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w, const void* g, void* dx,
                                 void* dw, void* part, int rows, int d, int blocks, float eps,
                                 int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || blocks <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(g) && aligned16(dx);
  const Plan p = make_plan(rows, d, dtype == 0 ? 4 : 2, aligned, blocks);
  if (dtype == 0) return launch<float>(p, x, w, g, dx, dw, part, rows, d, eps, s);
  return launch<__nv_bfloat16>(p, x, w, g, dx, dw, part, rows, d, eps, s);
}

// The plan a call takes: out = {variant (0 scalar, 1 vector), tpr, vec (elements
// a load), vpt, blocks, dynamic shared memory bytes}.
extern "C" int repro_rmsnorm_bwd_plan(int rows, int d, int dtype, int aligned, int blocks,
                                      int* out) {
  if (rows <= 0 || d <= 0 || d > kMaxD || blocks <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(rows, d, dtype == 0 ? 4 : 2, aligned != 0, blocks);
  out[0] = p.variant, out[1] = p.tpr, out[2] = p.vec, out[3] = p.vpt, out[4] = p.blocks;
  out[5] = p.smem;
  return 0;
}

// Registers and local (spill) bytes per thread, and static shared memory per
// block, of the rows kernel a plan of this variant and vpt launches.
extern "C" int repro_rmsnorm_bwd_attrs(int variant, int vpt, int dtype, int* regs,
                                       int* local_bytes, int* smem_bytes) {
  const void* fn = nullptr;
  const Plan p{variant, 32, 1, vpt, 1, 0};
  if (variant == kScalar) {
    fn = dtype == 0 ? reinterpret_cast<const void*>(rmsnorm_bwd_scalar<float>)
                    : reinterpret_cast<const void*>(rmsnorm_bwd_scalar<__nv_bfloat16>);
  } else {
    const bool ok = dtype == 0 ? vec_dispatch<float>(p, nullptr, nullptr, nullptr, nullptr,
                                                     nullptr, 0, 0, 0.f, nullptr, &fn)
                               : vec_dispatch<__nv_bfloat16>(p, nullptr, nullptr, nullptr,
                                                             nullptr, nullptr, 0, 0, 0.f,
                                                             nullptr, &fn);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
