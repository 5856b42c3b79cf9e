// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu / flash_attention_wgmma.cu, read and written
// in the model layout, GQA, causal with an optional sliding window and sinks.
//
// Replaces jax.grad of the function that the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (`flash_attention_kernel`,
// launched by `flash_attention` at :99) computes; the JAX package has no
// backward kernel and differentiates its plain jnp attention. With
// s = q.k * scale over the visible pairs (the forward's mask: `visible`
// below), P = exp(s - L), L the row's logsumexp, and D = rowsum(dO * O):
//
//   dV = P^T dO      dP = dO V^T      dS = P * (dP - D)
//   dQ = scale * dS K                 dK = scale * dS^T Q
//
// summed over the G = H / KV query heads of each kv head for dK and dV.
//
// Bound on the H100: operations. Five products over the visible pairs
// (q.k, dO.v, P.dO, dS.k, dS.q), 10 * hd flops a pair, against ~7 tensors of
// [B, S, heads, hd] moved once.
//
// Design (simple first: scalar f32 FMAs, no tensor cores), in FA2's order,
// three launches on the caller's stream and no atomics:
// (a) pre-pass, one 256-thread block per (batch*head, 64 query rows), four
//     threads a row as in the scalar forward: L by an online max and sum
//     over K tiles of 32 keys in shared memory, D = rowsum(dO * O); both f32
//     into [B*H, Sq] buffers. The forward kernels are untouched: L is
//     recomputed here, so the bf16 serve path keeps its instance.
// (b) dK, dV, one 256-thread block per (64 keys, batch*kv head), four
//     threads a key holding a quarter of its k and v rows and of its dK and
//     dV accumulators in registers. The block walks the G query heads of
//     its group and the query tiles of 32 rows that can see its keys (Q, dO,
//     L, D staged in shared memory), so the group sum stays in the block.
// (c) dQ, one 256-thread block per (batch*head, 64 query rows), four threads
//     a row holding q, dO and the dQ accumulator; K and V stream through
//     shared memory in tiles of 32 keys.
// All math is f32 (bf16 inputs converted once as they are staged); outputs
// are cast to the inputs' dtype once. Key and query tiles that no visible
// pair reaches are skipped; ragged tails of Sq and Sk are masked, never
// padded. A row that sees no key has l = 0, L = +inf and P = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 64;           // query rows per block: pre-pass and dQ
constexpr int kKeys = 32;           // keys per shared tile: pre-pass and dQ
constexpr int kKeyRows = 64;        // keys per block: dK, dV
constexpr int kQTile = 32;          // query rows per shared tile: dK, dV
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
static_assert(kRows * kThreadsPerRow == kThreads && kKeyRows * kThreadsPerRow == kThreads,
              "one row (or key) per four threads");

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

// The forward's mask, shared by the three launches: key `col` is visible
// from query `row` (top-left causal, window and sinks, ragged key tail).
__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal, int window,
                                        int n_sink) {
  if (col >= Sk) return false;
  if (!causal) return true;
  return col <= row && (window == 0 || col > row - window || col < n_sink);
}

// A partial dot product of four threads' quarters, closed over the four.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

struct Shape {
  int Sq, Sk, H, KV, causal, window, n_sink;
  float scale;
};

// this thread's quarter of a row of HD values, as float4 chunks interleaved
// over the four threads of the row
template <typename T, int kMine>
__device__ __forceinline__ void load_quarter(float (&dst)[kMine][4], const T* src, int part,
                                             bool ok) {
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d0 = 4 * (part + kThreadsPerRow * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[c][e] = ok ? to_f32(src[d0 + e]) : 0.f;
  }
}

template <int HD, int kMine>
__device__ __forceinline__ float dot_quarter(const float (&a)[kMine][4], const float* row,
                                             int part) {
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(&row[4 * (part + kThreadsPerRow * c)]);
    dot += a[c][0] * b.x + a[c][1] * b.y + a[c][2] * b.z + a[c][3] * b.w;
  }
  return quad_sum(dot);
}

template <int HD, int kMine>
__device__ __forceinline__ void axpy_quarter(float (&acc)[kMine][4], float a, const float* row,
                                             int part) {
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(&row[4 * (part + kThreadsPerRow * c)]);
    acc[c][0] += a * b.x;
    acc[c][1] += a * b.y;
    acc[c][2] += a * b.z;
    acc[c][3] += a * b.w;
  }
}

// Key tiles [k0, k0 + kKeys) that hold a visible pair for some row of the
// query tile starting at q0 (kRows rows); the twin of ref.py::bwd_key_tile_visited.
__device__ __forceinline__ bool key_tile_visited(int k0, int q0, const Shape& sh) {
  if (!sh.causal) return true;
  if (k0 >= q0 + kRows) return false;
  return sh.window == 0 || k0 < sh.n_sink || k0 + kKeys > q0 - sh.window + 1;
}

// K/V tile [k0, k0 + kKeys) of kv head `kvh` into shared memory, in f32.
template <typename T, int HD>
__device__ __forceinline__ void stage_keys(float (*ks)[HD], float (*vs)[HD], const T* kb,
                                           const T* vb, int k0, int Sk, long long kv_stride) {
  for (int e = threadIdx.x; e < kKeys * HD; e += kThreads) {
    const int j = e / HD;
    const int dd = e % HD;
    const int col = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (col < Sk) {
      kx = to_f32(kb[col * kv_stride + dd]);
      if (vs != nullptr) vx = to_f32(vb[col * kv_stride + dd]);
    }
    ks[j][dd] = kx;
    if (vs != nullptr) vs[j][dd] = vx;
  }
}

// (a) L and D of every query row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_prepass(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
               const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
               Shape sh) {
  constexpr int kMine = HD / 4 / kThreadsPerRow;
  static_assert(kMine >= 1, "unsupported head dim");
  __shared__ __align__(16) float ks[kKeys][HD];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int b = bh / sh.H, h = bh % sh.H, kvh = h / (sh.H / sh.KV);
  const int part = threadIdx.x % kThreadsPerRow;
  const int row = q0 + threadIdx.x / kThreadsPerRow;
  const bool row_ok = row < sh.Sq;
  const long long q_stride = static_cast<long long>(sh.H) * HD;
  const long long kv_stride = static_cast<long long>(sh.KV) * HD;
  const long long q_off = (static_cast<long long>(b) * sh.Sq + row) * q_stride +
                          static_cast<long long>(h) * HD;
  const T* kb = k + static_cast<long long>(b) * sh.Sk * kv_stride + static_cast<long long>(kvh) * HD;

  float qr[kMine][4], orow[kMine][4], dor[kMine][4];
  load_quarter<T, kMine>(qr, q + q_off, part, row_ok);
  load_quarter<T, kMine>(orow, o + q_off, part, row_ok);
  load_quarter<T, kMine>(dor, dout + q_off, part, row_ok);
  float dd = 0.f;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dd += dor[c][e] * orow[c][e];
  }
  dd = quad_sum(dd);

  float m = kNeg, l = 0.f;
  const int k_end = sh.causal ? min(sh.Sk, q0 + kRows) : sh.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    if (!key_tile_visited(k0, q0, sh)) continue;  // uniform per block
    __syncthreads();
    stage_keys<T, HD>(ks, nullptr, kb, nullptr, k0, sh.Sk, kv_stride);
    __syncthreads();
    float s[kKeys];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float dot = dot_quarter<HD, kMine>(qr, ks[j], part);
      s[j] = visible(row, k0 + j, sh.Sk, sh.causal, sh.window, sh.n_sink) ? dot * sh.scale
                                                                           : kNeg;
      m_new = fmaxf(m_new, s[j]);
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) psum += (s[j] <= 0.5f * kNeg) ? 0.f : expf(s[j] - m_new);
    l = l * expf(m - m_new) + psum;
    m = m_new;
  }
  if (row_ok && part == 0) {
    const long long i = static_cast<long long>(bh) * sh.Sq + row;
    lse[i] = l > 0.f ? m + logf(l) : CUDART_INF_F;
    delta[i] = dd;
  }
}

// (b) dK and dV of 64 keys of one kv head, summed over its G query heads.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int kMine = HD / 4 / kThreadsPerRow;
  __shared__ __align__(16) float qs[kQTile][HD];
  __shared__ __align__(16) float dos[kQTile][HD];
  __shared__ float ls[kQTile];
  __shared__ float ds[kQTile];

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kKeyRows;   // key tile 0 sees the most rows: it goes first
  const int b = bkv / sh.KV, kvh = bkv % sh.KV;
  const int G = sh.H / sh.KV;
  const int part = threadIdx.x % kThreadsPerRow;
  const int col = k0 + threadIdx.x / kThreadsPerRow;
  const bool col_ok = col < sh.Sk;
  const long long q_stride = static_cast<long long>(sh.H) * HD;
  const long long kv_stride = static_cast<long long>(sh.KV) * HD;
  const long long kv_off = (static_cast<long long>(b) * sh.Sk + col) * kv_stride +
                           static_cast<long long>(kvh) * HD;

  float kr[kMine][4], vr[kMine][4], dka[kMine][4], dva[kMine][4];
  load_quarter<T, kMine>(kr, k + kv_off, part, col_ok);
  load_quarter<T, kMine>(vr, v + kv_off, part, col_ok);
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  }

  // the query rows that can see a key of this tile
  const int c_last = min(sh.Sk, k0 + kKeyRows) - 1;
  int q_lo = 0, q_hi = sh.Sq;
  if (sh.causal) {
    q_lo = k0;
    if (sh.window > 0 && k0 >= sh.n_sink) q_hi = min(sh.Sq, c_last + sh.window);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = static_cast<long long>(b) * sh.H + h;
    for (int q0 = q_lo; q0 < q_hi; q0 += kQTile) {
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x; e < kQTile * HD; e += kThreads) {
        const int i = e / HD;
        const int dd = e % HD;
        const int row = q0 + i;
        float qx = 0.f, dx = 0.f;
        if (row < sh.Sq) {
          const long long off = (static_cast<long long>(b) * sh.Sq + row) * q_stride +
                                static_cast<long long>(h) * HD + dd;
          qx = to_f32(q[off]);
          dx = to_f32(dout[off]);
        }
        qs[i][dd] = qx;
        dos[i][dd] = dx;
      }
      if (threadIdx.x < kQTile) {
        const int row = q0 + threadIdx.x;
        ls[threadIdx.x] = row < sh.Sq ? lse[bh * sh.Sq + row] : CUDART_INF_F;
        ds[threadIdx.x] = row < sh.Sq ? delta[bh * sh.Sq + row] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < kQTile; ++i) {
        const int row = q0 + i;
        const float s = dot_quarter<HD, kMine>(kr, qs[i], part);
        const float dp = dot_quarter<HD, kMine>(vr, dos[i], part);
        const float p = (row < sh.Sq && visible(row, col, sh.Sk, sh.causal, sh.window, sh.n_sink))
                            ? expf(s * sh.scale - ls[i])
                            : 0.f;
        axpy_quarter<HD, kMine>(dva, p, dos[i], part);
        axpy_quarter<HD, kMine>(dka, p * (dp - ds[i]), qs[i], part);
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d0 = 4 * (part + kThreadsPerRow * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[kv_off + d0 + e] = from_f32<T>(dka[c][e] * sh.scale);
      dv[kv_off + d0 + e] = from_f32<T>(dva[c][e]);
    }
  }
}

// (c) dQ of 64 query rows of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Shape sh) {
  constexpr int kMine = HD / 4 / kThreadsPerRow;
  __shared__ __align__(16) float ks[kKeys][HD];
  __shared__ __align__(16) float vs[kKeys][HD];

  const int bh = blockIdx.x;
  const int n_q = (sh.Sq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest tiles first
  const int b = bh / sh.H, h = bh % sh.H, kvh = h / (sh.H / sh.KV);
  const int part = threadIdx.x % kThreadsPerRow;
  const int row = q0 + threadIdx.x / kThreadsPerRow;
  const bool row_ok = row < sh.Sq;
  const long long q_stride = static_cast<long long>(sh.H) * HD;
  const long long kv_stride = static_cast<long long>(sh.KV) * HD;
  const long long q_off = (static_cast<long long>(b) * sh.Sq + row) * q_stride +
                          static_cast<long long>(h) * HD;
  const long long kv_base = static_cast<long long>(b) * sh.Sk * kv_stride +
                            static_cast<long long>(kvh) * HD;

  float qr[kMine][4], dor[kMine][4], dqa[kMine][4];
  load_quarter<T, kMine>(qr, q + q_off, part, row_ok);
  load_quarter<T, kMine>(dor, dout + q_off, part, row_ok);
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[c][e] = 0.f;
  }
  const long long ri = static_cast<long long>(bh) * sh.Sq + row;
  const float L = row_ok ? lse[ri] : CUDART_INF_F;
  const float D = row_ok ? delta[ri] : 0.f;

  const int k_end = sh.causal ? min(sh.Sk, q0 + kRows) : sh.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    if (!key_tile_visited(k0, q0, sh)) continue;  // uniform per block
    __syncthreads();
    stage_keys<T, HD>(ks, vs, k + kv_base, v + kv_base, k0, sh.Sk, kv_stride);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float s = dot_quarter<HD, kMine>(qr, ks[j], part);
      const float dp = dot_quarter<HD, kMine>(dor, vs[j], part);
      const float p = (row_ok && visible(row, k0 + j, sh.Sk, sh.causal, sh.window, sh.n_sink))
                          ? expf(s * sh.scale - L)
                          : 0.f;
      axpy_quarter<HD, kMine>(dqa, p * (dp - D), ks[j], part);
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d0 = 4 * (part + kThreadsPerRow * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[q_off + d0 + e] = from_f32<T>(dqa[c][e] * sh.scale);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o, const void* dout,
              void* dq, void* dk, void* dv, float* lse, float* delta, int B, const Shape& sh,
              cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q(B * sh.H, (sh.Sq + kRows - 1) / kRows);
  fa_bwd_prepass<T, HD><<<grid_q, kThreads, 0, s>>>(qt, kt, static_cast<const T*>(o), dot,
                                                    lse, delta, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k(B * sh.KV, (sh.Sk + kKeyRows - 1) / kKeyRows);
  fa_bwd_dkdv<T, HD><<<grid_k, kThreads, 0, s>>>(qt, kt, vt, dot, lse, delta,
                                                 static_cast<T*>(dk), static_cast<T*>(dv), sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq<T, HD><<<grid_q, kThreads, 0, s>>>(qt, kt, vt, dot, lse, delta,
                                               static_cast<T*>(dq), sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 void* dq, void* dk, void* dv, float* lse, float* delta, int B, int hd,
                 const Shape& sh, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, sh, s);
    case 32: return launch_hd<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, sh, s);
    case 64: return launch_hd<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, sh, s);
    case 128: return launch_hd<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, sh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq: [B, Sq, H, hd]; k, v, dk, dv: [B, Sk, KV, hd]; all
// contiguous, in one dtype (0 = float32, 1 = bfloat16); lse and delta are
// [B*H, Sq] f32 scratch. hd in {16, 32, 64, 128}; H % KV == 0; Sk >= 1;
// window >= 0 and n_sink >= 0 act only when causal (0 = no window).
// Returns cudaGetLastError() after the three launches (or the first error).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int B, int Sq,
                                         int Sk, int H, int KV, int hd, int causal, int window,
                                         int n_sink, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{Sq, Sk, H, KV, causal, causal ? window : 0, causal ? n_sink : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 0) return launch_dtype<float>(q, k, v, o, dout, dq, dk, dv, l, d, B, hd, sh, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, d, B, hd, sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
