// Flash attention forward on Hopper's tensor cores (sm_90a): bf16 q/k/v/o in
// the model layout, head dim 64 or 128, online softmax, causal or not, with an
// optional sliding window and always-attended sink prefix, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, launched by `flash_attention` at :99) for bf16 at
// head dims 64 and 128; every other call keeps the scalar kernel of
// flash_attention.cu. The function is that kernel's, unchanged: running
// (m, l, acc) in f32, scale 1/sqrt(hd), causal mask `col <= row` aligned top
// left, under a window `col > row - window || col < n_sink`, masked scores set
// to NEG = -1e30, p = 0 where s <= NEG/2, the output divided by max(l, 1e-30)
// (a row that sees no key comes out as 0), q head h reads kv head h / (H/KV).
//
// Bound on the H100: operations. At qwen2-1.5b's prefill (B 4, S 1024, H 12,
// KV 2, hd 128, causal) the visible pairs need 12.9 GFLOP (13.0 us at 989
// TFLOP/s bf16) against 29 MB of q/k/v/o (8.8 us at 3.35 TB/s); hymba-1.5b's
// windowed call at S 1152 needs 17.0 GFLOP against 35 MB (PERF.md §6 has the
// worked bounds). So the products have to run on the tensor cores, and the
// loads must hide under them:
//
// * Block: two consumer warpgroups of 64 query rows each (128 rows) and one
//   producer warpgroup; one block per (query tile, b*h), heaviest tiles
//   first. The block starts at 168 registers a thread; setmaxnreg moves
//   them from the producer (down to 40) to the consumers (up to 232), which
//   hold the S and O accumulators and P without spilling at hd 128.
// * Loads: one producer thread brings Q in once and streams K/V tiles of 128
//   keys through a ring of stages (2 at hd 128, 3 at hd 64) by TMA, over
//   tensor maps of the 4-D model layout [B, S, heads, hd] (no transpose is
//   materialised). A box is 64 columns (one 128-byte swizzle row); hd 128
//   takes two boxes side by side. `mbarrier`s say when a stage is full (TMA
//   byte count) and when both warpgroups have released it. TMA zero-fills
//   rows past Sq or Sk. The tensor maps are `__grid_constant__` parameters,
//   encoded on the host with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda).
// * Scores: S = Q K^T by wgmma m64n128k16, both operands K-major from the
//   128-byte-swizzled shared memory, f32 in registers. Masking and the online
//   softmax run on the accumulator fragments; a row's max and sum close over
//   the four threads of a quad. Only tiles that cross the diagonal, the band
//   edge, the sink edge or the Sk tail take the mask test. `l` sums the f32
//   p, before rounding.
// * Output: P is rounded to bf16 in registers and fed as the register A
//   operand of O += P V (wgmma m64n{hd}k16); the S fragment layout is the A
//   fragment layout. V is the MN-major B operand (transpose bit set).
// * Skipped tiles: the twin of ref.py::tile_visited. Causal key tiles wholly
//   past the query tile's last row are not loaded, and under a window neither
//   are tiles wholly between the sinks and the band of every row of the tile.
// * Store: each thread writes its rows of O as bf16 pairs, rows past Sq
//   skipped.
//
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;                    // consumer warpgroups, 64 rows each
constexpr int kRows = 64 * kWarpgroups;           // query rows per block
constexpr int kKeys = 128;                        // keys per K/V tile (wgmma N of S)
constexpr int kThreads = 128 * (kWarpgroups + 1);  // + one producer warpgroup
constexpr int kBox = 64;                          // columns per TMA box (128 bytes)
constexpr float kNeg = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;  // one K or one V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // 1024 bytes of slack to align the swizzled tiles, then Q, K/V stages, barriers
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// -- PTX wrappers -------------------------------------------------------------

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

// One box of a 4-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes). lbo/sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64x64] (+)= A[64x16] * B[16x64], A from registers, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64x128] (+)= A[64x16] * B[16x128], A and B by shared-memory descriptor, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x128] (+)= A[64x16] * B[16x128], A from registers, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

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
// maps (boxes of kBox columns x 1 head x rows x 1 batch). kWindow: causal with
// window > 0; the plain instance carries no window test.
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
                             float scale_log2, int causal, int window, int n_sink) {
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
      tma_load_4d(s_q + bx * kRows * 128, &q_map, bar_q, bx * kBox, h, q0, b);
    int it = 0;
    for (int k0 = 0; k0 < k_end; k0 += kKeys) {
      if (!tile_visited(k0, q0, Sk, causal, window, n_sink)) continue;
      const int st = it % C::kStages;
      mbar_wait(bar_empty(st), ((it / C::kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full(st), 2 * C::kTileBytes);
#pragma unroll
      for (int bx = 0; bx < C::kBoxes; ++bx) {
        tma_load_4d(s_k(st) + bx * kKeys * 128, &k_map, bar_full(st), bx * kBox, kvh, k0, b);
        tma_load_4d(s_v(st) + bx * kKeys * 128, &v_map, bar_full(st), bx * kBox, kvh, k0, b);
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
  const uint32_t q_wg = s_q + wg * 64 * 128;
  int it = 0;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    if (!tile_visited(k0, q0, Sk, causal, window, n_sink)) continue;
    const int st = it % C::kStages;
    mbar_wait(bar_full(st), (it / C::kStages) & 1);

    // S = Q K^T over hd in steps of 16 (32 bytes inside a 128-byte box row)
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = desc_sw128(q_wg + (kk / 4) * kRows * 128 + off, 16, 1024);
      const uint64_t db = desc_sw128(s_k(st) + (kk / 4) * kKeys * 128 + off, 16, 1024);
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
    // 8-key groups 1024 bytes apart, hd boxes kKeys*128 bytes apart
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
      const uint64_t db = desc_sw128(s_v(st) + kk * 16 * 128, kKeys * 128, 1024);
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

// -- host side ----------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map over a contiguous bf16 [batch, seq, heads, hd]; boxes of kBox
// columns x 1 head x `rows` x 1 batch, 128-byte swizzle, zero fill past the
// edges.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int hd,
              int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kWindow>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, float scale_log2, int causal, int window, int n_sink, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, HD, kRows) || !make_map(&km, k, B, Sk, KV, HD, kKeys) ||
      !make_map(&vm, v, B, Sk, KV, HD, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_attention_wgmma_kernel<HD, kWindow><<<grid, kThreads, Cfg<HD>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, scale_log2, causal, window,
      n_sink);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kWindow>
int attrs(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_attention_wgmma_kernel<HD, kWindow>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes) + Cfg<HD>::kSmem;
  return 0;
}

}  // namespace

// bf16 only; hd in {64, 128}; Sq, Sk > 0 (a tensor map has no empty
// dimension); H % KV == 0; q, k, v, o contiguous and 16-byte aligned; window
// >= 0 and n_sink >= 0 act only when causal (0 = no window). Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                           int B, int Sq, int Sk, int H, int KV, int hd,
                                           int causal, int window, int n_sink, float scale,
                                           void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  const bool windowed = causal && window > 0;
  if (hd == 64)
    return windowed ? launch<64, true>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, 1, window,
                                       n_sink, s)
                    : launch<64, false>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, 0, 0,
                                        s);
  if (hd == 128)
    return windowed ? launch<128, true>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, 1, window,
                                        n_sink, s)
                    : launch<128, false>(q, k, v, o, B, Sq, Sk, H, KV, scale_log2, causal, 0,
                                         0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread at launch (before setmaxnreg), local (spill) bytes per
// thread and shared memory per block of the instance that a call with this
// hd and window would launch.
extern "C" int repro_flash_attention_wgmma_attrs(int hd, int windowed, int* regs,
                                                 int* local_bytes, int* smem_bytes) {
  if (hd == 64)
    return windowed ? attrs<64, true>(regs, local_bytes, smem_bytes)
                    : attrs<64, false>(regs, local_bytes, smem_bytes);
  if (hd == 128)
    return windowed ? attrs<128, true>(regs, local_bytes, smem_bytes)
                    : attrs<128, false>(regs, local_bytes, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}
