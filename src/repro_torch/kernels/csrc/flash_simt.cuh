// Shared parts of the flash attention kernels on the CUDA cores (sm_90a): the
// forward (flash_attention.cu) and the backward (flash_attention_bwd.cu). The
// one definition of the mask (`visible`) and of the tile predicates built on
// it, the 64-row tiles of both, and the register-tiled products from padded
// f32 shared tiles (a SIMT GEMM): 256 threads as 16 x 16, each owning a 4 x 4
// block of S (`dot_4x4`), then 4 rows x hd/16 columns of an hd-wide
// accumulator (`Cols`).
//
// Everything sits in an anonymous namespace: each including file gets its
// own copy, and the objects link into one library without clashes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // rows of a query tile and keys of a key tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kLd = 4;            // padding of a staged f32 row (floats)

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

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Shape {
  int Sq, Sk, H, KV, causal, window, n_sink;
  float scale_log2;   // scale * log2(e)
  int lse_stride;     // row stride of L and D: Sq rounded up to kTile
};

// window and n_sink act only under causal
inline Shape make_shape(int Sq, int Sk, int H, int KV, float scale, int causal, int window,
                        int n_sink) {
  return Shape{Sq, Sk, H, KV, causal ? 1 : 0, causal ? window : 0, causal ? n_sink : 0,
               scale * 1.4426950408889634f, cdiv(Sq, kTile) * kTile};
}

// The mask: key `col` is visible from query `row` (top-left causal, window
// and sinks, ragged tails). The one predicate of every SIMT kernel.
__device__ __forceinline__ bool visible(int row, int col, const Shape& sh) {
  if (row >= sh.Sq || col >= sh.Sk) return false;
  if (!sh.causal) return true;
  return col <= row && (sh.window == 0 || col > row - sh.window || col < sh.n_sink);
}

// Does the tile [q0, q0 + kTile) x [k0, k0 + kTile) need the mask test, i.e.
// does it hold a hidden pair? (Otherwise every pair is visible.)
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, const Shape& sh) {
  if (q0 + kTile > sh.Sq || k0 + kTile > sh.Sk) return true;
  if (!sh.causal) return false;
  if (k0 + kTile - 1 > q0) return true;   // crosses the diagonal
  return sh.window > 0 && k0 <= q0 + kTile - 1 - sh.window && k0 + kTile > sh.n_sink;
}

// Does key tile [k0, k0 + kTile) hold a visible pair for some row of the
// query tile [q0, q0 + kTile)? The twin of ref.py::tile_visited at 64 x 64.
__device__ __forceinline__ bool key_tile_visited(int k0, int q0, const Shape& sh) {
  if (k0 >= sh.Sk) return false;
  if (!sh.causal) return true;
  if (k0 >= q0 + kTile) return false;
  return sh.window == 0 || k0 < sh.n_sink || k0 + kTile > q0 - sh.window + 1;
}

// The columns of an hd-wide accumulator row a thread of column tx owns:
// kVec-wide runs at kVec * tx + 16 * kVec * m (m < kChunks), hd / 16 in all.
// kVec is the widest of 4, 2, 1 that divides hd / 16: 4 at hd 64 and 128, 2
// at hd 32, 1 at hd 16 and at hd 80 (five single columns tx + 16 m).
template <int HD>
struct Cols {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  static constexpr int kCount = HD / 16;
  static constexpr int kVec = kCount % 4 == 0 ? 4 : kCount % 2 == 0 ? 2 : 1;
  static constexpr int kChunks = kCount / kVec;
  static __device__ __forceinline__ int col(int tx, int m) { return kVec * tx + 16 * kVec * m; }
};

template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x, dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

// Floats of one staged row tile and of one [64][64] P / dS tile, both padded.
template <int HD>
struct SimtSmem {
  static constexpr int kRowTile = kTile * (HD + kLd);
  static constexpr int kPTile = kTile * (kTile + kLd);
};

// 16 bytes of T as f32 into dst (4 floats of f32, 8 of bf16)
template <typename T>
__device__ __forceinline__ void store_f32(float* dst, const uint4& u) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 a = __bfloat1622float2(h[2 * i]), b = __bfloat1622float2(h[2 * i + 1]);
      *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(a.x, a.y, b.x, b.y);
    }
  }
}

// rows [r0, r0 + kTile) of one head of a [B, S, heads, HD] tensor into a
// [kTile][HD + kLd] f32 tile; rows past S read as 0. 16-byte loads (every row
// starts on 16 bytes when the tensor does: HD * sizeof(T) is a multiple of
// 16), issued in groups of kGroup a thread (0: all of them) before the
// group's first store; a thread's last group may be partial (hd 80: 5 f32
// loads in groups of 4, 3 bf16 loads in groups of 2), its missing loads
// predicated off as past the tile; a tensor that is not 16-byte aligned is
// read element by element.
template <typename T, int HD, int kGroup = 0>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int b, int S,
                                           int heads, int head, int r0) {
  constexpr int kVec = 16 / sizeof(T);           // elements of one load
  static_assert(HD % kVec == 0, "a row must be whole 16-byte loads");
  constexpr int kPerRow = HD / kVec;
  constexpr int kLoads = kTile * kPerRow;
  constexpr int kIters = (kLoads + kThreads - 1) / kThreads;
  constexpr int kG = kGroup == 0 || kGroup > kIters ? kIters : kGroup;
  constexpr int kGroups = (kIters + kG - 1) / kG;
  const long long rs = static_cast<long long>(heads) * HD;
  const T* base = src + (static_cast<long long>(b) * S * heads + head) * HD;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll 1
    for (int g = 0; g < kGroups * kG; g += kG) {
      uint4 u[kG];
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int e = threadIdx.x + (g + i) * kThreads;
        const int row = r0 + e / kPerRow;
        u[i] = make_uint4(0, 0, 0, 0);
        if (e < kLoads && row < S)
          u[i] = *reinterpret_cast<const uint4*>(base + row * rs + (e % kPerRow) * kVec);
      }
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int e = threadIdx.x + (g + i) * kThreads;
        if (e < kLoads)
          store_f32<T>(dst + (e / kPerRow) * (HD + kLd) + (e % kPerRow) * kVec, u[i]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int row = r0 + r;
      dst[r * (HD + kLd) + d] = row < S ? to_f32(base[row * rs + d]) : 0.f;
    }
  }
}

// acc[a][b] += sum_d A[ra(a)][d] * B[rb(b)][d] over the HD columns of two
// staged tiles, A rows ra0 + a * sa, B rows rb0 + b * sb (a, b < 4); one FMA
// chain per sum
template <int HD>
__device__ __forceinline__ void dot_4x4(float (&acc)[4][4], const float* A, int ra0, int sa,
                                        const float* B, int rb0, int sb) {
  constexpr int ld = HD + kLd;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = *reinterpret_cast<const float4*>(&A[(ra0 + a * sa) * ld + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = *reinterpret_cast<const float4*>(&B[(rb0 + c * sb) * ld + d]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t = fmaf(x[a].x, y[c].x, acc[a][c]);
        t = fmaf(x[a].y, y[c].y, t);
        t = fmaf(x[a].z, y[c].z, t);
        acc[a][c] = fmaf(x[a].w, y[c].w, t);
      }
    }
  }
}

}  // namespace
