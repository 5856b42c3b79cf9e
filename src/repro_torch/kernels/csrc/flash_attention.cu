// Flash attention forward for Hopper (sm_90a): online softmax, causal or not,
// with an optional sliding window and always-attended sink prefix, GQA, read
// and written in the model layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, launched by `flash_attention`): running
// (m, l, acc) in f32, causal mask `col <= row` aligned top-left, masked
// scores set to NEG = -1e30, p = 0 where s <= NEG/2, and the output divided
// by max(l, 1e-30), so a row with no visible key comes out as 0. A causal
// call may also take a sliding window and sinks (Hymba's banded attention
// with meta tokens, repro/models/attention.py::attention and
// ::sink_banded_attention): key `col` is visible from query `row` when
//   col <= row && (window == 0 || col > row - window || col < n_sink).
// window = n_sink = 0 is the plain causal mask, bit for bit.
//
// Bound on the H100: operations. At the prefill shape of qwen2-1.5b
// (B=4, S=1024, H=12, KV=2, hd=128, causal) the function needs ~12.9 GFLOP
// against ~29 MB of q/k/v/o traffic; the [S, S] scores never leave the SM.
//
// Design (simple first; tensor cores, TMA and warp specialisation are later
// work): one 256-thread block per (batch*head, tile of 64 query rows), four
// threads per query row. A thread keeps a quarter of its row's q and of its
// output accumulator in registers, as float4 chunks interleaved so the four
// threads of a row read neighbouring 16-byte words of shared memory. K and V
// stream through shared memory in tiles of 32 keys, converted to f32 once
// per tile; a dot product is a per-thread partial sum of scalar FMAs closed
// by two warp shuffles. Causal tiles that lie wholly above the diagonal are
// skipped, and so, under a window, are the key tiles that lie wholly between
// the sinks and the band of every row of the query tile; a skipped tile would
// only have added p = 0 with m unchanged. The window is a template flag
// (kWindow), so a call without one runs the plain causal instance, whose
// inner loop carries no window test. The heaviest query tiles are
// scheduled first. Ragged tails of
// Sq and Sk are masked, never padded. GQA: q head h of batch b reads kv head
// h / (H / KV) of batch b, i.e. flattened index i = b*H + h reads
// (i / H) * KV + (i % H) / G. The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // query rows per block
constexpr int kKeys = 32;           // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kRows * kThreadsPerRow;
constexpr float kNeg = -1e30f;
constexpr int kLseAlign = 64;       // lse rows padded to this (the backward's tile)

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

// q, o: [B, Sq, H, HD]; k, v: [B, Sk, KV, HD]; all contiguous. kWindow:
// causal with window > 0. kLse: also store each row's logsumexp for the
// backward, in the exp2 domain the backward reads (that of the tensor-core
// forward): lse[bh * lse_stride + row] = m * log2(e) + log2(l), +inf for a
// row that sees no key. The serve path launches the instance without it.
template <typename T, int HD, bool kWindow, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       int H, int KV, float scale, int causal, int window,
                       int n_sink, float* __restrict__ lse, int lse_stride) {
  constexpr int kChunks = HD / 4;                          // float4 chunks in a row
  constexpr int kMine = kChunks / kThreadsPerRow;          // chunks per thread
  static_assert(kMine >= 1 && kChunks % kThreadsPerRow == 0, "unsupported head dim");

  __shared__ __align__(16) float ks[kKeys][HD];
  __shared__ __align__(16) float vs[kKeys][HD];

  const int bh = blockIdx.x;
  const int n_q = (Sq + kRows - 1) / kRows;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.y);  // heaviest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int part = tid % kThreadsPerRow;
  const int row = qt * kRows + tid / kThreadsPerRow;
  const bool row_ok = row < Sq;

  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const T* qb = q + static_cast<long long>(b) * Sq * q_stride + static_cast<long long>(h) * HD;
  const T* kb = k + static_cast<long long>(b) * Sk * kv_stride + static_cast<long long>(kvh) * HD;
  const T* vb = v + static_cast<long long>(b) * Sk * kv_stride + static_cast<long long>(kvh) * HD;
  T* ob = o + static_cast<long long>(b) * Sq * q_stride + static_cast<long long>(h) * HD;

  float qr[kMine][4];
  float acc[kMine][4];
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d0 = 4 * (part + kThreadsPerRow * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c][e] = row_ok ? to_f32(qb[row * q_stride + d0 + e]) : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kNeg;
  float l = 0.f;

  // causal: columns past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, (qt + 1) * kRows) : Sk;
  // windowed: key tiles in [n_sink, first row of the tile - window] are
  // masked for every row of the tile
  const int band_lo = kWindow ? qt * kRows - window + 1 : 0;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    if (kWindow && k0 >= n_sink && k0 + kKeys <= band_lo) continue;  // uniform per block
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int j = e / HD;
      const int dd = e % HD;
      const int col = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (col < Sk) {
        kx = to_f32(kb[col * kv_stride + dd]);
        vx = to_f32(vb[col * kv_stride + dd]);
      }
      ks[j][dd] = kx;
      vs[j][dd] = vx;
    }
    __syncthreads();

    float s[kKeys];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][4 * (part + kThreadsPerRow * c)]);
        dot += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = k0 + j;
      float sj = dot * scale;
      if (col >= Sk ||
          (causal && (col > row || (kWindow && col <= row - window && col >= n_sink))))
        sj = kNeg;
      s[j] = sj;
      m_new = fmaxf(m_new, sj);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = (s[j] <= 0.5f * kNeg) ? 0.f : expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < kMine; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][4 * (part + kThreadsPerRow * c)]);
        acc[c][0] += s[j] * vv.x;
        acc[c][1] += s[j] * vv.y;
        acc[c][2] += s[j] * vv.z;
        acc[c][3] += s[j] * vv.w;
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  if constexpr (kLse) {
    if (part == 0)
      lse[static_cast<long long>(bh) * lse_stride + row] =
          l > 0.f ? fmaf(m, 1.4426950408889634f, log2f(l)) : __int_as_float(0x7f800000);
  }
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kMine; ++c) {
    const int d0 = 4 * (part + kThreadsPerRow * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) ob[row * q_stride + d0 + e] = from_f32<T>(acc[c][e] / denom);
  }
}

template <typename T, int HD>
void launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
               int Sk, int H, int KV, float scale, int causal, int window, int n_sink,
               cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const int ls = (Sq + kLseAlign - 1) / kLseAlign * kLseAlign;
  const bool windowed = causal && window > 0;
  if (windowed && lse) {
    flash_attention_kernel<T, HD, true, true><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, Sq, Sk, H, KV, scale, causal, window, n_sink, lse, ls);
  } else if (windowed) {
    flash_attention_kernel<T, HD, true, false><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, Sq, Sk, H, KV, scale, causal, window, n_sink, nullptr, 0);
  } else if (lse) {
    flash_attention_kernel<T, HD, false, true><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, Sq, Sk, H, KV, scale, causal, 0, 0, lse, ls);
  } else {
    flash_attention_kernel<T, HD, false, false><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, Sq, Sk, H, KV, scale, causal, 0, 0, nullptr, 0);
  }
}

template <typename T>
bool launch_dtype(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  int Sq, int Sk, int H, int KV, int hd, float scale, int causal, int window,
                  int n_sink, cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                                    \
  case HD:                                                                                   \
    launch_hd<T, HD>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal, window, n_sink,     \
                     stream);                                                                \
    return true;
  switch (hd) {
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    default: return false;
  }
#undef REPRO_FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128}; H % KV == 0;
// window >= 0 and n_sink >= 0 act only when causal (0 = no window). lse:
// nullptr (the serve path's instance), or [B*H, round_up(Sq, 64)] f32 that
// receives each row's logsumexp in the exp2 domain (see the kernel).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                                     int causal, int window, int n_sink, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  bool ok = false;
  if (dtype == 0) {
    ok = launch_dtype<float>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, scale, causal, window,
                             n_sink, s);
  } else if (dtype == 1) {
    ok = launch_dtype<__nv_bfloat16>(q, k, v, o, l, B, Sq, Sk, H, KV, hd, scale, causal,
                                     window, n_sink, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
