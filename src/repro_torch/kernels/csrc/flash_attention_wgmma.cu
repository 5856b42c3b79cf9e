// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 q/k/v/o in
// the model layout, head dim 64, 80 or 128, online softmax, causal or not,
// with an optional sliding window and always-attended sink prefix, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, launched by `flash_attention` at :99) for bf16 at
// head dims 64, 80 and 128; every other call keeps the CUDA-core kernel of
// flash_attention.cu. The function is that kernel's, unchanged: running
// (m, l, acc) in f32, scale 1/sqrt(hd), causal mask `col <= row` aligned top
// left, under a window `col > row - window || col < n_sink`, masked scores set
// to NEG = -1e30, p = 0 where s <= NEG/2, the output divided by max(l, 1e-30)
// (a row that sees no key comes out as 0), q head h reads kv head h / (H/KV).
//
// Bound on the H100: operations. At qwen2-1.5b's prefill (B 4, S 1024, H 12,
// KV 2, hd 128, causal) the visible pairs need 12.9 GFLOP (13.0 us at 989
// TFLOP/s bf16) against 29 MB of q/k/v/o (8.8 us at 3.35 TB/s); hymba-1.5b's
// windowed call at S 1152 needs 17.0 GFLOP against 35 MB; HuBERT's encoder
// call (B 4, S 1500, H = KV 16, hd 80, non-causal) 46.1 GFLOP (46.6 us)
// against 61 MB (18.3 us), with one exp2 a pair (144 M) beside 320 flops
// (PERF.md §6 has the worked bounds). So the products have to run on the
// tensor cores, and the loads must hide under them:
//
// * Block: two consumer warpgroups of 64 query rows each (128 rows) and one
//   producer warpgroup; one block per (query tile, b*h), heaviest tiles
//   first. The block starts at 168 registers a thread; setmaxnreg moves
//   them from the producer (down to 40) to the consumers (up to 232), which
//   hold the S and O accumulators and P without spilling at hd 128.
// * Loads: one producer thread brings Q in once and streams K/V tiles of 128
//   keys through a ring of stages (2 at hd 128, 3 at hd 64 and 80) by
//   TMA, over tensor maps of the 4-D model layout [B, S, heads, hd] (no
//   transpose is materialised). At hd 64 and 128 a box is 64 columns (one
//   128-byte swizzle row) and hd 128 takes two boxes side by side. hd 80's
//   160-byte rows are a multiple of 32 bytes but not of 64 or 128, so it
//   takes five boxes of 16 columns under the 32-byte swizzle (the atom
//   CUTLASS picks for a K extent of 80): each box is one k-step of S and one
//   16-column atom of V. `mbarrier`s say when a stage is full (TMA
//   byte count) and when both warpgroups have released it. TMA zero-fills
//   rows past Sq or Sk. The tensor maps are `__grid_constant__` parameters,
//   encoded on the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda).
// * Scores: S = Q K^T by wgmma m64n128k16, both operands K-major from the
//   swizzled shared memory, f32 in registers. Masking and the online
//   softmax run on the accumulator fragments; a row's max and sum close over
//   the four threads of a quad. Only tiles that cross the diagonal, the band
//   edge, the sink edge or the Sk tail take the mask test. `l` sums the f32
//   p, before rounding.
// * Output: P is rounded to bf16 in registers and fed as the register A
//   operand of O += P V (wgmma m64n{hd}k16); the S fragment layout is the A
//   fragment layout. V is the MN-major B operand (transpose bit set): 8-key
//   groups one atom (8 box rows) apart, 16- or 64-column atoms one box apart.
// * Skipped tiles: the twin of ref.py::tile_visited. Causal key tiles wholly
//   past the query tile's last row are not loaded, and under a window neither
//   are tiles wholly between the sinks and the band of every row of the tile.
// * Store: each thread writes its rows of O as bf16 pairs, rows past Sq
//   skipped.
//
// The kernel allocates nothing and launches on the caller's stream.

#include "flash_wgmma.cuh"

namespace {

constexpr int kWarpgroups = 2;                    // consumer warpgroups, 64 rows each
constexpr int kRows = 64 * kWarpgroups;           // query rows per block
constexpr int kKeys = 128;                        // keys per K/V tile (wgmma N of S)
constexpr int kThreads = 128 * (kWarpgroups + 1);  // + one producer warpgroup
constexpr float kNeg = -1e30f;
constexpr int kLseAlign = 64;                     // lse rows padded to this (the backward's tile)

// The shared-memory plan of the instance at HD (Python twin:
// kernel.py::wgmma_smem_plan). A box row is kRowBytes wide: 128 bytes (64
// columns, 128-byte swizzle) where hd is a multiple of 64, else 32 bytes
// (16 columns, 32-byte swizzle: hd 80).
template <int HD>
struct Cfg {
  static constexpr bool kSw32 = HD % kBox != 0;
  static constexpr int kBoxCols = kSw32 ? 16 : kBox;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 box rows: one swizzle atom
  static constexpr int kSteps = kRowBytes / 32;     // k-steps of 16 columns a box row
  static constexpr int kBoxes = HD / kBoxCols;
  // K/V stages: hd 80 takes 3 (141 KiB; 4 stages, 181 KiB, measured 1% slower
  // at HuBERT's shape on the H100: PERF.md §6)
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;  // one K or one V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // 1024 bytes of slack to align the swizzled tiles, then Q, K/V stages, barriers
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
  static_assert(HD % kBoxCols == 0 && kSmem <= 227 * 1024, "no shared-memory plan for HD");
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSw32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;

  // descriptor of a tile of box rows: 8-row atoms kAtomBytes apart, `lbo`
  // between boxes (the MN-major V) or unused (K-major Q and K)
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return kSw32 ? desc_sw32(addr, lbo, kAtomBytes) : desc_sw128(addr, lbo, kAtomBytes);
  }
};

// -- the kernel ---------------------------------------------------------------

// The twin of ref.py::tile_visited: does key tile [k0, k0 + kKeys) hold a
// visible (row, col) pair for some row of the query tile [q0, q0 + kRows)?
__device__ __forceinline__ bool tile_visited(int k0, int q0, int Sk, int causal, int window,
                                             int n_sink) {
  if (k0 >= Sk) return false;
  if (!causal) return true;
  if (k0 >= q0 + kRows) return false;  // wholly past the tile's last row
  // under a window: not wholly between the sinks and the band of row q0
  return window == 0 || k0 < n_sink || k0 + kKeys > q0 - window + 1;
}

// q, o: [B, Sq, H, HD]; k, v: [B, Sk, KV, HD], bf16, read through the tensor
// maps (boxes of Cfg<HD>::kBoxCols columns x 1 head x rows x 1 batch).
// kWindow: causal with window > 0; the plain instance carries no window test.
// kLse: also store each row's logsumexp for the backward, in the exp2 domain
// of the online softmax, lse[bh * lse_stride + row] = m * scale_log2 +
// log2(l) (+inf for a row that sees no key); the serve path launches the
// instance without it.
template <int HD, bool kWindow, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
                             float scale_log2, int causal, int window, int n_sink,
                             float* __restrict__ lse, int lse_stride) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bar_q = base + C::kBarOffset;
  auto s_k = [&](int st) { return base + C::kQBytes + st * 2 * C::kTileBytes; };
  auto s_v = [&](int st) { return s_k(st) + C::kTileBytes; };
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + C::kStages + st); };
  if (!kWindow) window = n_sink = 0;

  const int bh = blockIdx.x;
  const int n_q = (Sq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kRows;  // heaviest tiles first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int k_end = causal ? min(Sk, q0 + kRows) : Sk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128 * kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kWarpgroups) {
    // producer warpgroup: gives up registers; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 128 * kWarpgroups) return;
    mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
    for (int bx = 0; bx < C::kBoxes; ++bx)
      tma_load_4d(s_q + bx * kRows * C::kRowBytes, &q_map, bar_q, bx * C::kBoxCols, h, q0, b);
    int it = 0;
    for (int k0 = 0; k0 < k_end; k0 += kKeys) {
      if (!tile_visited(k0, q0, Sk, causal, window, n_sink)) continue;
      const int st = it % C::kStages;
      mbar_wait(bar_empty(st), ((it / C::kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full(st), 2 * C::kTileBytes);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        const uint32_t off = bx * kKeys * C::kRowBytes;
        tma_load_4d(s_k(st) + off, &k_map, bar_full(st), bx * C::kBoxCols, kvh, k0, b);
        tma_load_4d(s_v(st) + off, &v_map, bar_full(st), bx * C::kBoxCols, kvh, k0, b);
      }
      ++it;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumer warpgroup wg: query rows r_lo .. r_lo + 63; this thread holds
  // rows row0 and row0 + 8, columns 8j + cq and 8j + cq + 1 of each 8-column
  // block j of an accumulator
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * (t / 32) + lane / 4;
  const int cq = 2 * (lane % 4);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  const uint32_t q_wg = s_q + wg * 64 * C::kRowBytes;
  int it = 0;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    if (!tile_visited(k0, q0, Sk, causal, window, n_sink)) continue;
    const int st = it % C::kStages;
    mbar_wait(bar_full(st), (it / C::kStages) & 1);

    // S = Q K^T over hd in steps of 16 (32 bytes of a box row: a quarter of
    // a 128-byte row, or the whole of a 32-byte one)
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk / C::kSteps, off = (kk % C::kSteps) * 32;
      const uint64_t da = C::desc(q_wg + bx * kRows * C::kRowBytes + off, 16);
      const uint64_t db = C::desc(s_k(st) + bx * kKeys * C::kRowBytes + off, 16);
      wgmma_ss_n128(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask only tiles that cross the Sk tail, the diagonal, the sink edge or
    // the band edge for some row of this warpgroup
    const int k_last = k0 + kKeys - 1;
    const bool need_mask =
        k_last >= Sk ||
        (causal && (k_last > r_lo ||
                    (kWindow && k_last >= n_sink && k0 <= r_lo + 63 - window)));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + cq + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool hidden =
              col >= Sk ||
              (causal && (col > row || (kWindow && col <= row - window && col >= n_sink)));
          if (hidden) s[4 * j + e] = kNeg;
        }
      }
    }

    // online softmax on raw scores: p = exp2(s * scale*log2e - m * scale*log2e)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float alpha[2], msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
      msc[r] = mx[r] * scale_log2;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        const float p = x <= 0.5f * kNeg ? 0.f : exp2f(fmaf(x, scale_log2, -msc[e >> 1]));
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 as the register A operand (the S fragment
    // of columns 16kk..16kk+15 is the A fragment of k-step kk); V MN-major,
    // 8-key groups one atom apart, hd boxes kKeys box rows apart
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = C::desc(s_v(st) + kk * 16 * C::kRowBytes, kKeys * C::kRowBytes);
      wgmma_rs<HD>(acc, pa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty(st));
    ++it;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  if constexpr (kLse) {
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Sq)
          lse[static_cast<long long>(bh) * lse_stride + row] =
              l[r] > 0.f ? fmaf(m[r], scale_log2, log2f(l[r])) : __int_as_float(0x7f800000);
      }
    }
  }
  const long long row_stride = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * Sq + row) * row_stride +
                          static_cast<long long>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD, bool kWindow, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int KV, float scale_log2, int causal, int window, int n_sink,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, HD, kRows, C::kBoxCols, C::kSwizzle) ||
      !make_map(&km, k, B, Sk, KV, HD, kKeys, C::kBoxCols, C::kSwizzle) ||
      !make_map(&vm, v, B, Sk, KV, HD, kKeys, C::kBoxCols, C::kSwizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, kWindow, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_attention_wgmma_kernel<HD, kWindow, kLse><<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, scale_log2, causal, window,
      n_sink, lse, (Sq + kLseAlign - 1) / kLseAlign * kLseAlign);
  return static_cast<int>(cudaGetLastError());
}

// the instance for (hd, windowed, lse): a function of the call's shape only
template <int HD, bool kWindow, bool kLse>
int launch_or_attrs(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int Sq, int Sk, int H, int KV, float scale_log2, int causal, int window,
                    int n_sink, cudaStream_t stream, int* attr) {
  if (attr == nullptr)
    return launch<HD, kWindow, kLse>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale_log2, causal,
                                     window, n_sink, stream);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_attention_wgmma_kernel<HD, kWindow, kLse>);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr[0] = a.numRegs;
  attr[1] = static_cast<int>(a.localSizeBytes);
  attr[2] = static_cast<int>(a.sharedSizeBytes) + Cfg<HD>::kSmem;
  return 0;
}

template <int HD>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
             int Sk, int H, int KV, float scale_log2, int causal, int window, int n_sink,
             cudaStream_t s, int* attr) {
  const bool windowed = causal && window > 0;
  if (lse != nullptr) {
    if (windowed)
      return launch_or_attrs<HD, true, true>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale_log2, 1,
                                             window, n_sink, s, attr);
    else
      return launch_or_attrs<HD, false, true>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale_log2,
                                              causal, 0, 0, s, attr);
  }
  if (windowed)
    return launch_or_attrs<HD, true, false>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale_log2, 1,
                                            window, n_sink, s, attr);
  return launch_or_attrs<HD, false, false>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale_log2,
                                           causal, 0, 0, s, attr);
}

}  // namespace

// bf16 only; hd in {64, 80, 128}; Sq, Sk > 0 (a tensor map has no empty
// dimension); H % KV == 0; q, k, v, o contiguous and 16-byte aligned; window
// >= 0 and n_sink >= 0 act only when causal (0 = no window). lse: nullptr
// (the serve path's instance), or [B*H, round_up(Sq, 64)] f32 that receives
// each row's logsumexp in the exp2 domain (see the kernel), for the
// backward (flash_attention_bwd.cu).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int B, int Sq, int Sk, int H, int KV,
                                           int hd, int causal, int window, int n_sink,
                                           float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return dispatch<64>(q, k, v, o, l, B, Sq, Sk, H, KV, scale_log2, causal, window, n_sink, s,
                        nullptr);
  if (hd == 80)
    return dispatch<80>(q, k, v, o, l, B, Sq, Sk, H, KV, scale_log2, causal, window, n_sink, s,
                        nullptr);
  if (hd == 128)
    return dispatch<128>(q, k, v, o, l, B, Sq, Sk, H, KV, scale_log2, causal, window, n_sink, s,
                         nullptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread at launch (before setmaxnreg), local (spill) bytes per
// thread and shared memory per block of the instance that a call with this
// hd, window and lse (0: the serve path's; 1: the one that stores L) would
// launch.
extern "C" int repro_flash_attention_wgmma_attrs(int hd, int windowed, int lse, int* regs,
                                                 int* local_bytes, int* smem_bytes) {
  int attr[3] = {0, 0, 0};
  float dummy = 0.f;
  float* l = lse ? &dummy : nullptr;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    err = dispatch<64>(nullptr, nullptr, nullptr, nullptr, l, 1, 1, 1, 1, 1, 1.f, 1,
                       windowed ? 1 : 0, 0, nullptr, attr);
  if (hd == 80)
    err = dispatch<80>(nullptr, nullptr, nullptr, nullptr, l, 1, 1, 1, 1, 1, 1.f, 1,
                       windowed ? 1 : 0, 0, nullptr, attr);
  if (hd == 128)
    err = dispatch<128>(nullptr, nullptr, nullptr, nullptr, l, 1, 1, 1, 1, 1, 1.f, 1,
                        windowed ? 1 : 0, 0, nullptr, attr);
  *regs = attr[0];
  *local_bytes = attr[1];
  *smem_bytes = attr[2];
  return err;
}
