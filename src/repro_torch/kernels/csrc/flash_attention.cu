// Flash attention forward on the CUDA cores for Hopper (sm_90a): online
// softmax, causal or not, with an optional sliding window and always-attended
// sink prefix, GQA, read and written in the model layout. It takes every call
// the tensor-core kernel (flash_attention_wgmma.cu, bf16 at hd 64/128) does
// not: f32 at every head dim, kept true f32 (no TF32), and bf16 at hd 16, 32
// and 80 (HuBERT's d 1280 over 16 heads).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, launched by `flash_attention` at :99): running
// (m, l, acc) in f32, causal mask `col <= row` aligned top-left, masked
// scores set to NEG = -1e30, p = 0 where s <= NEG/2, and the output divided
// by max(l, 1e-30), so a row with no visible key comes out as 0. A causal
// call may also take a sliding window and sinks (Hymba's banded attention
// with meta tokens, repro/models/attention.py::attention and
// ::sink_banded_attention): key `col` is visible from query `row` when
//   col <= row && (window == 0 || col > row - window || col < n_sink).
// The mask and the tile predicates are the backward's (flash_simt.cuh).
//
// Bound on the H100: operations. At the prefill shape of qwen2-1.5b
// (B=4, S=1024, H=12, KV=2, hd=128, causal) the function needs ~12.9 GFLOP
// of f32 FMAs (192 us at 67 TFLOP/s) against ~29 MB of q/k/v/o traffic; the
// [S, S] scores never leave the SM.
//
// Design: register-tiled products from shared memory (a SIMT GEMM), the
// geometry of the backward's SIMT kernels. One 256-thread block per
// (batch*head, tile of 64 query rows), the heaviest query tiles first; the
// threads form a 16 x 16 grid (tx = threadIdx % 16, ty = threadIdx / 16).
// Q is staged once into a padded f32 [64][hd+4] shared tile; K and V stream
// through tiles of 64 keys, staged the same way with 16-byte loads and
// converted to f32 once. Per key tile:
//  * S = Q K^T: thread (tx, ty) forms the 4 x 4 block of rows 4ty + i, keys
//    tx + 16j (`dot_4x4`: 8 float4 loads for 64 FMAs).
//  * Online softmax on raw scores, the scale folded into exp2: the row max
//    and sum over the 16 tx lanes of a row (xor shuffles 1, 2, 4, 8 inside a
//    half-warp); p = exp2(s*scale*log2e - m*scale*log2e), 0 where s <= NEG/2;
//    alpha = exp2((m_old - m_new)*scale*log2e); l in f32.
//  * P goes to shared memory transposed ([key][row]), then O += P V: each
//    thread owns rows 4ty + i x hd/16 columns (`Cols`), one float4 of P and
//    hd/64 float4s of V a key for 4 x hd/16 FMAs.
// Key tiles that hold no visible pair are skipped (`key_tile_visited`, the
// twin of ref.py::tile_visited at 64 x 64): a skipped tile would only add
// p = 0 with m unchanged. Only tiles that hold a hidden pair (the diagonal,
// band and sink edges, ragged Sq and Sk tails: `tile_needs_mask`) test each
// pair; tails are masked, never padded. No atomics: every sum has one order.
//
// Occupancy: two blocks an SM (16 warps), each hiding the other's staging.
// At hd 128 the Q, K, V and P tiles would take 116 KiB, one block an SM; so
// where K's tile holds P (hd >= 64), P is written into it once every thread
// has formed its S (one more barrier a tile), and Q, K/P and V take 99 KiB.
// Registers are capped at 128 a thread (__launch_bounds__). A build for one
// block an SM (P in a tile of its own, no cap) was 10-23% slower at every
// shape chip_smoke.py times (PERF.md).
//
// GQA: q head h of batch b reads kv head h / (H / KV). The kernel allocates
// nothing and launches on the caller's stream.

#include "flash_simt.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxDevices = 64;

constexpr int kBlocksPerSm = 2;

template <int HD>
struct FwdCfg {
  using M = SimtSmem<HD>;
  // P in K's tile where the tile holds it (hd >= 64)
  static constexpr bool kShareP = M::kRowTile >= M::kPTile;
  static constexpr int kSmem = 4 * (3 * M::kRowTile + (kShareP ? 0 : M::kPTile));
};

// 16-byte loads in flight a thread while staging: under the cap of 128
// registers, 16 floats' worth (4 loads of f32, 2 of bf16) beside the
// accumulators
template <typename T>
constexpr int kLoadGroup = static_cast<int>(sizeof(T));

// q, o: [B, Sq, H, HD]; k, v: [B, Sk, KV, HD]; all contiguous. kLse: also
// store each row's logsumexp for the backward, in the exp2 domain:
// lse[bh * lse_stride + row] = m * scale * log2(e) + log2(l), +inf for a row
// that sees no key. The serve path launches the instance without it; the
// two compute the output with the same code.
template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Shape sh) {
  using C = FwdCfg<HD>;
  using M = SimtSmem<HD>;
  using CC = Cols<HD>;
  constexpr int ld = HD + kLd;
  constexpr int pld = kTile + kLd;
  extern __shared__ float4 smem_fwd[];
  float* qs = reinterpret_cast<float*>(smem_fwd);
  float* ks = qs + M::kRowTile;
  float* vs = ks + M::kRowTile;
  float* ps = C::kShareP ? ks : vs + M::kRowTile;   // [key][row], P transposed

  const int bh = blockIdx.x;
  const int n_q = cdiv(sh.Sq, kTile);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;  // heaviest tiles first
  const int b = bh / sh.H, h = bh % sh.H, kvh = h / (sh.H / sh.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float sl2 = sh.scale_log2;

  stage_rows<T, HD, kLoadGroup<T>>(qs, q, b, sh.Sq, sh.H, h, q0);
  float m[4], l[4], acc[4][CC::kCount];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CC::kCount; ++c) acc[i][c] = 0.f;
  }

  const int k_end = sh.causal ? imin(sh.Sk, q0 + kTile) : sh.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    if (!key_tile_visited(k0, q0, sh)) continue;   // uniform per block
    __syncthreads();                               // the previous tile is consumed
    stage_rows<T, HD, kLoadGroup<T>>(ks, k, b, sh.Sk, sh.KV, kvh, k0);
    stage_rows<T, HD, kLoadGroup<T>>(vs, v, b, sh.Sk, sh.KV, kvh, k0);
    __syncthreads();
    float s[4][4] = {};
    dot_4x4<HD>(s, qs, 4 * ty, 1, ks, tx, 16);
    if (tile_needs_mask(q0, k0, sh)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!visible(q0 + 4 * ty + i, k0 + tx + 16 * c, sh)) s[i][c] = kNeg;
      }
    }
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float ms = m_new * sl2;
      alpha[i] = exp2f((m[i] - m_new) * sl2);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = s[i][c] <= 0.5f * kNeg ? 0.f : exp2f(fmaf(s[i][c], sl2, -ms));
        sum += s[i][c];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = fmaf(l[i], alpha[i], sum);
      m[i] = m_new;
    }
    if constexpr (C::kShareP) __syncthreads();    // every thread has read K
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&ps[(tx + 16 * c) * pld + 4 * ty]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < CC::kCount; ++c) acc[i][c] *= alpha[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      const float4 w = *reinterpret_cast<const float4*>(&ps[key * pld + 4 * ty]);
      const float wi[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int mm = 0; mm < CC::kChunks; ++mm) {
        float vv[CC::kVec];
        lds<CC::kVec>(vv, &vs[key * ld + CC::col(tx, mm)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < CC::kVec; ++e)
            acc[i][mm * CC::kVec + e] = fmaf(wi[i], vv[e], acc[i][mm * CC::kVec + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sh.Sq) continue;
    if constexpr (kLse) {
      if (tx == 0)
        lse[static_cast<long long>(bh) * sh.lse_stride + row] =
            l[i] > 0.f ? fmaf(m[i], sl2, log2f(l[i])) : __int_as_float(0x7f800000);
    }
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD;
#pragma unroll
    for (int mm = 0; mm < CC::kChunks; ++mm) {
#pragma unroll
      for (int e = 0; e < CC::kVec; ++e)
        out[CC::col(tx, mm) + e] = from_f32<T>(acc[i][mm * CC::kVec + e] / denom);
    }
  }
}

// dynamic shared memory above 48 KiB: an attribute of each device and
// kernel instance, set once per device
template <typename T, int HD, bool kLse>
cudaError_t allow_smem() {
  constexpr int bytes = FwdCfg<HD>::kSmem;
  static bool set[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && set[dev])) return e;
  e = cudaFuncSetAttribute(flash_attention_simt<T, HD, kLse>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) set[dev] = true;
  return e;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B;
  Shape sh;
};

template <typename T, int HD, bool kLse>
int launch(const Args& a, cudaStream_t s) {
  cudaError_t e = allow_smem<T, HD, kLse>();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_simt<T, HD, kLse>
      <<<dim3(a.B * a.sh.H, cdiv(a.sh.Sq, kTile)), kThreads, FwdCfg<HD>::kSmem, s>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<T*>(a.o), a.lse, a.sh);
  return static_cast<int>(cudaGetLastError());
}

// registers, local bytes and shared memory of the instance, and the blocks
// of it an SM of the current device holds (the occupancy calculator)
template <typename T, int HD, bool kLse>
int attrs_of(int* attr) {
  constexpr int smem = FwdCfg<HD>::kSmem;
  cudaError_t e = allow_smem<T, HD, kLse>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, flash_attention_simt<T, HD, kLse>);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attr[3], flash_attention_simt<T, HD, kLse>,
                                                    kThreads, smem);
  attr[0] = fa.numRegs;
  attr[1] = static_cast<int>(fa.localSizeBytes);
  attr[2] = static_cast<int>(fa.sharedSizeBytes) + smem;
  return static_cast<int>(e);
}

// launch the instance (attr == nullptr), or report its attributes
template <typename T, int HD>
int run(const Args& a, cudaStream_t s, int* attr) {
  if (attr != nullptr) return a.lse ? attrs_of<T, HD, true>(attr) : attrs_of<T, HD, false>(attr);
  return a.lse ? launch<T, HD, true>(a, s) : launch<T, HD, false>(a, s);
}

template <typename T>
int dispatch(const Args& a, int hd, cudaStream_t s, int* attr) {
  switch (hd) {
    case 16: return run<T, 16>(a, s, attr);
    case 32: return run<T, 32>(a, s, attr);
    case 64: return run<T, 64>(a, s, attr);
    case 80: return run<T, 80>(a, s, attr);
    case 128: return run<T, 128>(a, s, attr);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 80, 128}; H % KV == 0;
// window >= 0 and n_sink >= 0 act only when causal (0 = no window). lse:
// nullptr (the serve path's instance), or [B*H, round_up(Sq, 64)] f32 that
// receives each row's logsumexp in the exp2 domain (see the kernel).
// Returns cudaGetLastError() after the launch (or the first error).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                                     int causal, int window, int n_sink, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), B,
               make_shape(Sq, Sk, H, KV, scale, causal, window, n_sink)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, hd, s, nullptr);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, hd, s, nullptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread, local (spill) bytes per thread and shared memory per
// block of the instance a call at (hd, dtype) launches (with lse != 0 the
// one that stores L), and the blocks of it an SM of the current device holds.
extern "C" int repro_flash_attention_attrs(int hd, int dtype, int lse, int* blocks_per_sm,
                                           int* regs, int* local_bytes, int* smem_bytes) {
  int attr[4] = {0, 0, 0, 0};
  float dummy = 0.f;
  const Args a{nullptr, nullptr, nullptr, nullptr, lse ? &dummy : nullptr, 0, Shape{}};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) err = dispatch<float>(a, hd, nullptr, attr);
  if (dtype == 1) err = dispatch<__nv_bfloat16>(a, hd, nullptr, attr);
  *regs = attr[0];
  *local_bytes = attr[1];
  *smem_bytes = attr[2];
  *blocks_per_sm = attr[3];
  return err;
}
