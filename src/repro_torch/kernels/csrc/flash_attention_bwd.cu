// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu / flash_attention_wgmma.cu, read and written
// in the model layout, GQA, causal with an optional sliding window and sinks.
//
// Replaces jax.grad of the function that the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (`flash_attention_kernel`,
// launched by `flash_attention` at :99) computes; the JAX package has no
// backward kernel and differentiates its plain jnp attention. With
// s = q.k over the visible pairs (the mask: `visible` in flash_simt.cuh,
// shared with the forward), P = exp2(s * scale * log2(e) - L), L the row's
// logsumexp in the exp2 domain as the forward stored it (flash_mha under
// autograd launches the forward instance that stores L), and
// D = rowsum(dO * O):
//
//   dV = P^T dO      dP = dO V^T      dS = P * (dP - D)
//   dQ = scale * dS K                 dK = scale * dS^T Q
//
// summed over the G = H / KV query heads of each kv head for dK and dV.
//
// Bound on the H100: operations. The function needs five products over the
// visible pairs (q.k, dO.v, P.dO, dS.k, dS.q), 10 * hd flops a pair. Without
// atomics this design computes seven: the dQ kernel recomputes S and dP,
// the price of a deterministic sum (14 * hd flops a pair; chip_smoke.py
// prints both counts beside the bound).
//
// Four launches on the caller's stream, no atomics (a train step gives the
// same bits every run), nothing allocated (the wrapper passes D and the
// partial sums as scratch):
// (a) fa_bwd_delta: D = rowsum(dO * O) of every query row, f32, into
//     [B*H, lse_stride] (rows past Sq get 0); byte-bound: 16-byte loads,
//     every load of a 64-row block issued before the first add.
// (b) dK, dV over a balanced grid. The work of a key tile of 64 keys and a
//     kv head is its G heads x the 64-row query tiles that can see it
//     ("units"; bwd_key_tile_rows). Each key tile's units are cut into
//     ceil(units / kSplitUnits) equal splits, one block each, walking its
//     units head by head; a block writes its f32 dK, dV sums for its 64 keys
//     as one partial. At qwen2-1.5b (causal, S 1024, G 6) the heaviest key
//     tile has 96 units and the lightest 6: 33 blocks a (b, kv head), none
//     above 32 units. Partial traffic there: 33 partials x 64 keys x 128 x
//     4 B x 2 per (b, kv head), 17.3 MB written and read again, ~10 us at
//     3.35 TB/s against the function's 32.6 us bf16 bound. One block per
//     (key tile, q head) with per-head partials would move 50 MB twice
//     (~30 us), so the split of the query range is the one taken.
// (c) dQ, one block per (64 query rows, b*h), over the key tiles that can
//     see them, heaviest query tiles first; dQ written once, no partials.
// (d) fa_bwd_finalize: per (key tile, b*kv head), the partials of its splits
//     added in split order, dK scaled, both cast to the output dtype (a key
//     tile no row sees gets zeros).
//
// bf16 at hd 64, 80 and 128 (every bf16 train step of qwen2, hymba and
// HuBERT) runs (b) and (c) on the tensor cores, with the forward's machinery
// (flash_wgmma.cuh): a producer warpgroup (one thread issues every TMA load;
// setmaxnreg 24) and one consumer warpgroup (setmaxnreg 232), two blocks an
// SM (__launch_bounds__(256, 2)).
// * dK/dV: the consumer owns 64 keys. K and V are loaded once; (Q, dO)
//   tiles of 64 rows and their L and D (1-D bulk copies) stream through an
//   mbarrier ring. Per tile: S^T = K Q^T and dP^T = V dO^T by wgmma
//   m64n64k16 (both operands K-major), P^T and dS^T formed on the f32
//   accumulator fragments and rounded to bf16 as the register A operand of
//   dV += P^T dO and dK += dS^T Q, with dO and Q read from the same shared
//   tiles as the MN-major B operand (the transpose bit, as the forward reads
//   V). Two f32 accumulators of 64 x hd, S^T and dP^T.
// * dQ: the consumer owns 64 query rows (Q, dO loaded once; L and D in
//   registers); K/V tiles of 64 keys stream in: S = Q K^T, dP = dO V^T, dS
//   rounded to bf16, dQ += dS K (K MN-major).
// * Layout (WCfg<HD>, as the forward's Cfg<HD>): a 64-row tile is TMA boxes
//   side by side. hd 64 and 128 take 64-column boxes under the 128-byte
//   swizzle. HuBERT's hd 80 (160-byte rows: a multiple of 32 bytes, not of
//   64) takes five 16-column boxes under the 32-byte swizzle: each box is one
//   k-step of S^T, dP^T (S, dP) and one 16-column atom of the MN-major B
//   operand, which reads the boxes one box (2,048 B) apart; dK, dV and dQ by
//   m64n80k16; 3 stages, 82.6 KiB a block. TMA zero-fills rows past Sq and
//   Sk, so the last tiles of a ragged length (HuBERT's T 1500 = 23 x 64 +
//   28) take the mask test on every fragment.
// Every other call (f32, kept true f32 as on the rest of the port, and bf16
// at hd 16/32) runs (b) and (c) on the CUDA cores as register-tiled products
// from shared memory (a SIMT GEMM): 256 threads as 16 x 16, each owning a
// 4 x 4 block of S^T/dP^T (S/dP in dQ), then 4 rows x hd/16 columns of dK
// and dV (dQ); tiles staged as f32 rows padded by 4 floats, read as float4
// (flash_simt.cuh, shared with the forward). f32 at HuBERT's hd 80 (320-byte
// rows) takes five single columns a thread (Cols<80>) and a partial last
// group of 16-byte loads, as the forward's instance does: dK/dV 118.5 KiB of
// shared memory, dQ 101.0 KiB, one block an SM.
// All math is f32; only masked tiles (the diagonal, band and sink edges,
// ragged Sq and Sk tails) take the mask test; tails are masked, never padded.

#include <type_traits>

#include "flash_simt.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kSplitUnits = 32;   // most units (head x query tile) one dK/dV block walks
constexpr int kFinalParts = 4;    // blocks a key tile in the partials' sum

// The 64-row query tiles that can see key tile j, from *q_lo (local rows,
// tiles counted from local row 0: a multiple of kTile); the twin of
// ref.py::bwd_key_tile_rows. Global row q_off + r sees the tile from row k0
// on, and under a window (k0 past the sinks) up to the row before its last
// key + window.
__host__ __device__ inline int key_tile_rows(int j, const Shape& sh, int* q_lo) {
  const int k0 = j * kTile;
  *q_lo = 0;
  if (k0 >= sh.Sk) return 0;
  int lo = 0, hi = sh.Sq;
  if (sh.causal) {
    lo = k0 > sh.q_off ? (k0 - sh.q_off) / kTile * kTile : 0;
    if (sh.window > 0 && k0 >= sh.n_sink)
      hi = imin(sh.Sq, imin(sh.Sk, k0 + kTile) - 1 + sh.window - sh.q_off);
  }
  *q_lo = lo;
  return hi > lo ? cdiv(hi - lo, kTile) : 0;
}

// One dK/dV block: key tile j, units [u0, u1) of its G * n_qt (unit u is
// head u / n_qt, query tile q_lo + (u % n_qt) * kTile), partial slot `slot`.
struct Item {
  int j, q_lo, n_qt, u0, u1, slot;
};

// The item of block `item`, key tiles in order and each tile's splits in
// order (the twin of ref.py::bwd_split_plan); false past the last one.
// With items == nullptr the count of items is returned in *count.
__host__ __device__ inline bool find_item(int item, const Shape& sh, Item* it, int* count) {
  const int G = sh.H / sh.KV;
  const int n_kt = cdiv(sh.Sk, kTile);
  int base = 0;
  for (int j = 0; j < n_kt; ++j) {
    int q_lo;
    const int n_qt = key_tile_rows(j, sh, &q_lo);
    const int units = G * n_qt;
    const int ns = cdiv(units, kSplitUnits);
    if (it != nullptr && item < base + ns) {
      const int s = item - base;
      const int chunk = cdiv(units, ns);
      *it = Item{j, q_lo, n_qt, s * chunk, imin(units, (s + 1) * chunk), item};
      return true;
    }
    base += ns;
  }
  if (count != nullptr) *count = base;
  return false;
}

__host__ __device__ inline int n_slots_of(const Shape& sh) {
  int n = 0;
  find_item(0, sh, nullptr, &n);
  return n;
}

// -- (a) D = rowsum(dO * O) ----------------------------------------------------

// The lanes of a row: its 16-byte vectors rounded up to a power of two, so
// that a row's lanes form one aligned group of a warp (the xor shuffle adds
// within it) and the passes cover the tile's rows exactly. Lanes past the
// row's vectors load nothing (hd 80: 10 vectors on 16 lanes in bf16, 20 on
// 32 in f32); at hd 16/32/64/128 the lanes are the vectors. The twin is
// ref.py::bwd_delta_reads.
__host__ __device__ constexpr int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A block takes kTile rows of one head; a row's 16-byte vectors spread over
// kLanes lanes, and each thread loads its vectors of kTile * kLanes /
// kThreads rows before adding any, so every load of the block is in flight
// at once (16-byte aligned rows: hd * sizeof(T) is a multiple of 16).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             Shape sh) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kParts = HD / kVec;                    // 16-byte vectors of a row
  constexpr int kLanes = pow2_ceil(kParts);            // lanes of a row
  static_assert(HD % kVec == 0 && kLanes <= 32, "a row must be whole vectors of one warp");
  constexpr int kRowsPerPass = kThreads / kLanes;
  constexpr int kPasses = kRowsPerPass < kTile ? kTile / kRowsPerPass : 1;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int b = bh / sh.H, h = bh % sh.H;
  const int part = threadIdx.x % kLanes;
  uint4 ov[kPasses], dv[kPasses];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = i * kRowsPerPass + threadIdx.x / kLanes;
    const int row = q0 + r;
    ov[i] = dv[i] = make_uint4(0, 0, 0, 0);
    if (part < kParts && r < kTile && row < sh.Sq) {
      const long long off =
          ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD / kVec + part;
      ov[i] = reinterpret_cast<const uint4*>(o)[off];
      dv[i] = reinterpret_cast<const uint4*>(dout)[off];
    }
  }
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const T* a = reinterpret_cast<const T*>(&ov[i]);
    const T* c = reinterpret_cast<const T*>(&dv[i]);
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc += to_f32(c[e]) * to_f32(a[e]);
#pragma unroll
    for (int w = kLanes / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    const int r = i * kRowsPerPass + threadIdx.x / kLanes;
    if (part == 0 && r < kTile) delta[static_cast<long long>(bh) * sh.lse_stride + q0 + r] = acc;
  }
}

// -- (d) dK, dV from the partials ------------------------------------------------

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v, float scale) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v.x * scale, v.y * scale, v.z * scale,
                                                  v.w * scale);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * scale, v.y * scale);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * scale, v.w * scale);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  }
}

// Blocks (key tile, b*kv head, one of kFinalParts parts of the tile), 4
// columns a thread.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_finalize(const float* __restrict__ part_k, const float* __restrict__ part_v,
                T* __restrict__ dk, T* __restrict__ dv, int n_slots, float scale, Shape sh) {
  const int j = blockIdx.x, bkv = blockIdx.y;
  const int G = sh.H / sh.KV;
  int base = 0, ns = 0;
  for (int jj = 0; jj <= j; ++jj) {      // the slot of tile j's first split
    int q_lo;
    const int n = cdiv(G * key_tile_rows(jj, sh, &q_lo), kSplitUnits);
    if (jj < j) base += n; else ns = n;
  }
  const int k0 = j * kTile;
  const int n_keys = imin(kTile, sh.Sk - k0);
  const int b = bkv / sh.KV, kvh = bkv % sh.KV;
  const long long p0 = (static_cast<long long>(bkv) * n_slots + base) * kTile * HD;
  const int n4 = n_keys * HD / 4;                      // float4s of the tile
  const int lo = blockIdx.z * n4 / kFinalParts, hi = (blockIdx.z + 1) * n4 / kFinalParts;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int e = 4 * i;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int s = 0; s < ns; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&part_k[p0 + static_cast<long long>(s) *
                                                                         kTile * HD + e]);
      const float4 c = *reinterpret_cast<const float4*>(&part_v[p0 + static_cast<long long>(s) *
                                                                         kTile * HD + e]);
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
    }
    const int key = k0 + e / HD, d = e % HD;
    const long long off = ((static_cast<long long>(b) * sh.Sk + key) * sh.KV + kvh) * HD + d;
    store4<T>(dk + off, sk, scale);
    store4<T>(dv + off, sv, 1.f);
  }
}

// -- CUDA-core (SIMT) dQ and dK/dV ----------------------------------------------

// dQ of 64 query rows of one head. Thread (tx, ty): rows 4ty + i, keys
// tx + 16j of a key tile; then rows 4ty + i x its Cols of dQ.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dq, float scale, Shape sh) {
  using M = SimtSmem<HD>;
  using CC = Cols<HD>;
  constexpr int ld = HD + kLd;
  extern __shared__ float4 smem_simt[];
  float* qs = reinterpret_cast<float*>(smem_simt);
  float* dos = qs + M::kRowTile;
  float* ks = dos + M::kRowTile;
  float* vs = ks + M::kRowTile;
  float* dss = vs + M::kRowTile;   // [key][row], dS transposed

  const int bh = blockIdx.x;
  const int n_q = cdiv(sh.Sq, kTile);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;  // heaviest tiles first
  const int b = bh / sh.H, h = bh % sh.H, kvh = h / (sh.H / sh.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_rows<T, HD>(qs, q, b, sh.Sq, sh.H, h, q0);
  stage_rows<T, HD>(dos, dout, b, sh.Sq, sh.H, h, q0);
  float L[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const long long ri = static_cast<long long>(bh) * sh.lse_stride + row;
    L[i] = row < sh.Sq ? lse[ri] : 0.f;
    D[i] = row < sh.Sq ? delta[ri] : 0.f;
  }
  float acc[4][CC::kCount];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < CC::kCount; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(q0, sh) + sh.q_off;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int kr0 = k0 - sh.q_off;
    if (!key_tile_visited(kr0, q0, sh)) continue;  // uniform per block
    __syncthreads();                               // the previous tile is consumed
    stage_rows<T, HD>(ks, k, b, sh.Sk, sh.KV, kvh, k0);
    stage_rows<T, HD>(vs, v, b, sh.Sk, sh.KV, kvh, k0);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4<HD>(s, qs, 4 * ty, 1, ks, tx, 16);
    dot_4x4<HD>(dp, dos, 4 * ty, 1, vs, tx, 16);
    const bool mask = tile_needs_mask(q0, kr0, sh);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool seen = !mask || visible(q0 + 4 * ty + i, kr0 + tx + 16 * c, sh);
        const float p = seen ? exp2f(fmaf(s[i][c], sh.scale_log2, -L[i])) : 0.f;
        ds[i] = p * (dp[i][c] - D[i]);
      }
      *reinterpret_cast<float4*>(&dss[(tx + 16 * c) * (kTile + kLd) + 4 * ty]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      const float4 w = *reinterpret_cast<const float4*>(&dss[key * (kTile + kLd) + 4 * ty]);
      const float wi[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int m = 0; m < CC::kChunks; ++m) {
        float kk[CC::kVec];
        lds<CC::kVec>(kk, &ks[key * ld + CC::col(tx, m)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < CC::kVec; ++e) acc[i][m * CC::kVec + e] += wi[i] * kk[e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sh.Sq) continue;
    T* out = dq + ((static_cast<long long>(b) * sh.Sq + row) * sh.H + h) * HD;
#pragma unroll
    for (int m = 0; m < CC::kChunks; ++m) {
#pragma unroll
      for (int e = 0; e < CC::kVec; ++e)
        out[CC::col(tx, m) + e] = from_f32<T>(acc[i][m * CC::kVec + e] * scale);
    }
  }
}

// dK, dV partial sums of one Item. Thread (tx, ty): keys 4ty + j, rows
// tx + 16i of a query tile; then keys 4ty + j x its Cols of dK and dV.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ part_k,
                 float* __restrict__ part_v, int n_slots, Shape sh) {
  using M = SimtSmem<HD>;
  using CC = Cols<HD>;
  constexpr int ld = HD + kLd;
  extern __shared__ float4 smem_simt[];
  float* ks = reinterpret_cast<float*>(smem_simt);
  float* vs = ks + M::kRowTile;
  float* qs = vs + M::kRowTile;
  float* dos = qs + M::kRowTile;
  float* ps = dos + M::kRowTile;   // [row][key], P transposed back
  float* dss = ps + M::kPTile;     // [row][key]
  float* ls = dss + M::kPTile;
  float* dl = ls + kTile;

  Item it;
  if (!find_item(blockIdx.x, sh, &it, nullptr)) return;
  const int bkv = blockIdx.y;
  const int b = bkv / sh.KV, kvh = bkv % sh.KV, G = sh.H / sh.KV;
  const int k0 = it.j * kTile;
  const int kr0 = k0 - sh.q_off;                   // the tile's first key, from the shard's row 0
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_rows<T, HD>(ks, k, b, sh.Sk, sh.KV, kvh, k0);
  stage_rows<T, HD>(vs, v, b, sh.Sk, sh.KV, kvh, k0);
  float dka[4][CC::kCount], dva[4][CC::kCount];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < CC::kCount; ++c) dka[j][c] = dva[j][c] = 0.f;
  }

  for (int u = it.u0; u < it.u1; ++u) {
    const int h = kvh * G + u / it.n_qt;
    const int q0 = it.q_lo + (u % it.n_qt) * kTile;
    const long long bh = static_cast<long long>(b) * sh.H + h;
    __syncthreads();                               // the previous unit is consumed
    stage_rows<T, HD>(qs, q, b, sh.Sq, sh.H, h, q0);
    stage_rows<T, HD>(dos, dout, b, sh.Sq, sh.H, h, q0);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      ls[threadIdx.x] = row < sh.Sq ? lse[bh * sh.lse_stride + row] : 0.f;
      dl[threadIdx.x] = row < sh.Sq ? delta[bh * sh.lse_stride + row] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_4x4<HD>(s, ks, 4 * ty, 1, qs, tx, 16);
    dot_4x4<HD>(dp, vs, 4 * ty, 1, dos, tx, 16);
    const bool mask = tile_needs_mask(q0, kr0, sh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tx + 16 * i;
      const float L = ls[r], D = dl[r];
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool seen = !mask || visible(q0 + r, kr0 + 4 * ty + j, sh);
        p[j] = seen ? exp2f(fmaf(s[j][i], sh.scale_log2, -L)) : 0.f;
        ds[j] = p[j] * (dp[j][i] - D);
      }
      *reinterpret_cast<float4*>(&ps[r * (kTile + kLd) + 4 * ty]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dss[r * (kTile + kLd) + 4 * ty]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float4 pw = *reinterpret_cast<const float4*>(&ps[r * (kTile + kLd) + 4 * ty]);
      const float4 sw = *reinterpret_cast<const float4*>(&dss[r * (kTile + kLd) + 4 * ty]);
      const float pj[4] = {pw.x, pw.y, pw.z, pw.w};
      const float sj[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
      for (int m = 0; m < CC::kChunks; ++m) {
        float dov[CC::kVec], qv[CC::kVec];
        lds<CC::kVec>(dov, &dos[r * ld + CC::col(tx, m)]);
        lds<CC::kVec>(qv, &qs[r * ld + CC::col(tx, m)]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < CC::kVec; ++e) {
            dva[j][m * CC::kVec + e] += pj[j] * dov[e];
            dka[j][m * CC::kVec + e] += sj[j] * qv[e];
          }
        }
      }
    }
  }
  const long long p0 = (static_cast<long long>(bkv) * n_slots + it.slot) * kTile * HD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long row = p0 + static_cast<long long>(4 * ty + j) * HD;
#pragma unroll
    for (int m = 0; m < CC::kChunks; ++m) {
#pragma unroll
      for (int e = 0; e < CC::kVec; ++e) {
        part_k[row + CC::col(tx, m) + e] = dka[j][m * CC::kVec + e];
        part_v[row + CC::col(tx, m) + e] = dva[j][m * CC::kVec + e];
      }
    }
  }
}

template <int HD>
constexpr int simt_smem(bool dkdv) {
  return 4 * (4 * SimtSmem<HD>::kRowTile +
              (dkdv ? 2 * SimtSmem<HD>::kPTile + 2 * kTile : SimtSmem<HD>::kPTile));
}

// -- tensor-core (wgmma) dQ and dK/dV, bf16 at hd 64, 80 and 128 -----------------

// The shared-memory plan of the instance at HD (Python twin:
// kernel.py::wgmma_bwd_smem_plan). A 64-row tile is kBoxes TMA boxes side by
// side, each kTile rows of kRowBytes: 128 bytes (64 columns, 128-byte
// swizzle) where hd is a multiple of 64, else 32 bytes (16 columns, 32-byte
// swizzle: hd 80's 160-byte rows), as in the forward's Cfg<HD>. Two blocks an
// SM (two consumer warpgroups) take precedence over a deeper ring: at hd 128
// a third stage no longer fits two blocks in shared memory.
template <int HD>
struct WCfg {
  static constexpr bool kSw32 = HD % kBox != 0;
  static constexpr int kBoxCols = kSw32 ? 16 : kBox;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;      // 8 box rows: one swizzle atom
  static constexpr int kSteps = kRowBytes / 32;         // k-steps of 16 columns a box row
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kBoxBytes = kTile * kRowBytes;   // one box of a 64-row tile
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kTileBytes = kTile * HD * 2;     // one 64-row bf16 tile
  // two fixed tiles (K, V in dK/dV; Q, dO in dQ), the ring of tile pairs,
  // L and D of each stage (dK/dV), the barriers
  static constexpr int kRingOff = 2 * kTileBytes;
  static constexpr int kLdOff = kRingOff + kStages * 2 * kTileBytes;
  static constexpr int kBarOff = kLdOff + kStages * 2 * kTile * 4;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (1 + 2 * kStages);
  // two blocks in the SM's 228 KiB, 1 KiB of it reserved per block
  static_assert(HD % kBoxCols == 0 && kTileBytes % 1024 == 0 &&
                    2 * (kSmem + 1024) <= 228 * 1024,
                "no two-blocks-an-SM shared-memory plan for HD");
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSw32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;

  // descriptor of a tile of box rows: 8-row atoms kAtomBytes apart, `lbo`
  // between boxes (an MN-major B operand) or unused (K-major operands)
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return kSw32 ? desc_sw32(addr, lbo, kAtomBytes) : desc_sw128(addr, lbo, kAtomBytes);
  }
};

// S (+)= A B^T over HD in k-steps of 16: A and B two 64-row tiles, both
// K-major; a k-step is 32 bytes of a box row (a quarter of a 128-byte row,
// or the whole of a 32-byte one)
template <int HD>
__device__ __forceinline__ void wgmma_tile_nt(float (&d)[32], uint32_t a, uint32_t b) {
  using C = WCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / C::kSteps) * C::kBoxBytes + (kk % C::kSteps) * 32;
    wgmma_ss_n64(d, C::desc(a + off, 16), C::desc(b + off, 16), kk > 0);
  }
}

// acc[64 x HD] += P[64 x 64] B[64 x HD], P from registers (the S fragment
// layout, rounded to bf16), B a 64-row tile read MN-major: 8-row groups one
// atom apart, the boxes' column atoms one box apart (LBO)
template <int HD>
__device__ __forceinline__ void wgmma_tile_pv(float (&acc)[HD / 2], const uint32_t (&p)[4][4],
                                              uint32_t b) {
  using C = WCfg<HD>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs<HD>(acc, p[kk], C::desc(b + kk * 16 * C::kRowBytes, C::kBoxBytes), 1);
}

// the kBoxes boxes of 64 rows of a tensor map into a tile at `dst`
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int head, int row, int b) {
  using C = WCfg<HD>;
#pragma unroll
  for (int bx = 0; bx < C::kBoxes; ++bx)
    tma_load_4d(dst + bx * C::kBoxBytes, map, bar, bx * C::kBoxCols, head, row, b);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ part_k,
                  float* __restrict__ part_v, int n_slots, Shape sh) {
  using C = WCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);      // generic pointer to `base`
  const uint32_t s_k = base, s_v = base + C::kTileBytes;
  auto s_q = [&](int st) { return base + C::kRingOff + st * 2 * C::kTileBytes; };
  auto s_do = [&](int st) { return s_q(st) + C::kTileBytes; };
  auto ld_off = [&](int st) { return C::kLdOff + st * 2 * kTile * 4; };
  const uint32_t bar_kv = base + C::kBarOff;
  auto bar_full = [&](int st) { return bar_kv + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_kv + 8 * (1 + C::kStages + st); };

  Item it;
  if (!find_item(blockIdx.x, sh, &it, nullptr)) return;
  const int bkv = blockIdx.y;
  const int b = bkv / sh.KV, kvh = bkv % sh.KV, G = sh.H / sh.KV;
  const int k0 = it.j * kTile;
  const int kr0 = k0 - sh.q_off;                   // the tile's first key, from the shard's row 0

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warpgroup: gives up registers; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 128) return;
    mbar_expect_tx(bar_kv, 2 * C::kTileBytes);
    tma_tile<HD>(s_k, &k_map, bar_kv, kvh, k0, b);
    tma_tile<HD>(s_v, &v_map, bar_kv, kvh, k0, b);
    for (int u = it.u0, n = 0; u < it.u1; ++u, ++n) {
      const int h = kvh * G + u / it.n_qt;
      const int q0 = it.q_lo + (u % it.n_qt) * kTile;
      const long long row = (static_cast<long long>(b) * sh.H + h) * sh.lse_stride + q0;
      const int st = n % C::kStages;
      mbar_wait(bar_empty(st), ((n / C::kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full(st), 2 * C::kTileBytes + 2 * kTile * 4);
      tma_tile<HD>(s_q(st), &q_map, bar_full(st), h, q0, b);
      tma_tile<HD>(s_do(st), &do_map, bar_full(st), h, q0, b);
      bulk_load(base + ld_off(st), lse + row, kTile * 4, bar_full(st));
      bulk_load(base + ld_off(st) + kTile * 4, delta + row, kTile * 4, bar_full(st));
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // this thread holds keys kr and kr + 8 of the tile, and query columns
  // 8j + cq, 8j + cq + 1 of each 8-column block j of S^T and dP^T
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int kr = 16 * (t / 32) + lane / 4;
  const int cq = 2 * (lane % 4);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int u = it.u0, n = 0; u < it.u1; ++u, ++n) {
    const int q0 = it.q_lo + (u % it.n_qt) * kTile;
    const int st = n % C::kStages;
    mbar_wait(bar_full(st), (n / C::kStages) & 1);

    // S^T and dP^T as two groups: P^T is formed while dP^T is in flight
    float s[32], dp[32];
    wgmma_fence();
    wgmma_tile_nt<HD>(s, s_k, s_q(st));
    wgmma_commit();
    wgmma_tile_nt<HD>(dp, s_v, s_do(st));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const float* Ls = reinterpret_cast<const float*>(gbase + ld_off(st));
    const float* Ds = Ls + kTile;
    const bool mask = tile_needs_mask(q0, kr0, sh);
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 L = *reinterpret_cast<const float2*>(&Ls[8 * j + cq]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool seen = !mask || visible(q0 + 8 * j + cq + (e & 1), kr0 + kr + 8 * (e >> 1), sh);
        s[4 * j + e] =
            seen ? exp2f(fmaf(s[4 * j + e], sh.scale_log2, (e & 1) ? -L.y : -L.x)) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 D = *reinterpret_cast<const float2*>(&Ds[8 * j + cq]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? D.y : D.x));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        sa[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    wgmma_tile_pv<HD>(dv, pa, s_do(st));
    wgmma_tile_pv<HD>(dk, sa, s_q(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(pa);
    fence_operand(sa);
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_empty(st));
  }

  const long long p0 = (static_cast<long long>(bkv) * n_slots + it.slot) * kTile * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = p0 + static_cast<long long>(kr + 8 * r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(&part_k[row + 8 * j + cq]) =
          make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(&part_v[row + 8 * j + cq]) =
          make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, float scale,
                Shape sh) {
  using C = WCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = base + C::kTileBytes;
  auto s_k = [&](int st) { return base + C::kRingOff + st * 2 * C::kTileBytes; };
  auto s_v = [&](int st) { return s_k(st) + C::kTileBytes; };
  const uint32_t bar_q = base + C::kBarOff;
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + C::kStages + st); };

  const int bh = blockIdx.x;
  const int n_q = cdiv(sh.Sq, kTile);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTile;  // heaviest tiles first
  const int b = bh / sh.H, h = bh % sh.H, kvh = h / (sh.H / sh.KV);
  const int kr_end = key_end(q0, sh);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 128) return;
    mbar_expect_tx(bar_q, 2 * C::kTileBytes);
    tma_tile<HD>(s_q, &q_map, bar_q, h, q0, b);
    tma_tile<HD>(s_do, &do_map, bar_q, h, q0, b);
    int n = 0;
    for (int kr0 = -sh.q_off; kr0 < kr_end; kr0 += kTile) {
      if (!key_tile_visited(kr0, q0, sh)) continue;
      const int st = n % C::kStages;
      mbar_wait(bar_empty(st), ((n / C::kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full(st), 2 * C::kTileBytes);
      tma_tile<HD>(s_k(st), &k_map, bar_full(st), kvh, kr0 + sh.q_off, b);
      tma_tile<HD>(s_v(st), &v_map, bar_full(st), kvh, kr0 + sh.q_off, b);
      ++n;
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // this thread holds query rows qr and qr + 8 of the tile, and key columns
  // 8j + cq, 8j + cq + 1 of each 8-column block j of S and dP
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int qr = 16 * (t / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  float L[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 8 * r;
    const long long ri = static_cast<long long>(bh) * sh.lse_stride + row;
    L[r] = row < sh.Sq ? lse[ri] : 0.f;
    D[r] = row < sh.Sq ? delta[ri] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  int n = 0;
  for (int kr0 = -sh.q_off; kr0 < kr_end; kr0 += kTile) {
    if (!key_tile_visited(kr0, q0, sh)) continue;
    const int st = n % C::kStages;
    mbar_wait(bar_full(st), (n / C::kStages) & 1);

    // S and dP as two groups: P is formed while dP is in flight
    float s[32], dp[32];
    wgmma_fence();
    wgmma_tile_nt<HD>(s, s_q, s_k(st));
    wgmma_commit();
    wgmma_tile_nt<HD>(dp, s_do, s_v(st));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    const bool mask = tile_needs_mask(q0, kr0, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool seen = !mask || visible(q0 + qr + 8 * r, kr0 + 8 * j + cq + (e & 1), sh);
        s[4 * j + e] = seen ? exp2f(fmaf(s[4 * j + e], sh.scale_log2, -L[r])) : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - D[e >> 1]);
    }
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
    wgmma_tile_pv<HD>(acc, sa, s_k(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sa);
    fence_regs(acc);
    mbar_arrive(bar_empty(st));
    ++n;
  }

  const long long row_stride = static_cast<long long>(sh.H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + 8 * r;
    if (row >= sh.Sq) continue;
    __nv_bfloat16* out = dq + (static_cast<long long>(b) * sh.Sq + row) * row_stride +
                         static_cast<long long>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j + cq) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// -- host side ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float *delta, *part_k, *part_v;
  int B, n_slots;
  float scale;
  Shape sh;
};

// The kernels of one call, by the `kind` of repro_flash_attention_bwd_attrs.
enum Kind { kDq = 0, kDkdv = 1, kDelta = 2, kFinal = 3 };

// bf16 at hd 64, 80 and 128 runs dQ and dK/dV on the tensor cores
template <typename T, int HD>
constexpr bool kTensorCores =
    std::is_same<T, __nv_bfloat16>::value && (HD == 64 || HD == 80 || HD == 128);

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// registers, spill bytes, shared memory and the blocks an SM of the current
// device holds (the occupancy calculator, at the launch's shared memory)
template <typename K>
int attrs_of(K kernel, int dyn_smem, int* attr) {
  cudaFuncAttributes a;
  cudaError_t err = allow_smem(kernel, dyn_smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attr[3], kernel, kThreads, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr[0] = a.numRegs;
  attr[1] = static_cast<int>(a.localSizeBytes);
  attr[2] = static_cast<int>(a.sharedSizeBytes) + dyn_smem;
  return 0;
}

template <typename T, int HD>
int launch_simt(const Args& a, cudaStream_t s) {
  constexpr int dq_smem = simt_smem<HD>(false), dkdv_smem = simt_smem<HD>(true);
  cudaError_t e = allow_smem(fa_bwd_dq_simt<T, HD>, dq_smem);
  if (e == cudaSuccess) e = allow_smem(fa_bwd_dkdv_simt<T, HD>, dkdv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  if (a.n_slots > 0) {
    fa_bwd_dkdv_simt<T, HD><<<dim3(a.n_slots, a.B * a.sh.KV), kThreads, dkdv_smem, s>>>(
        q, k, v, d, a.lse, a.delta, a.part_k, a.part_v, a.n_slots, a.sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fa_bwd_dq_simt<T, HD><<<dim3(a.B * a.sh.H, cdiv(a.sh.Sq, kTile)), kThreads, dq_smem, s>>>(
      q, k, v, d, a.lse, a.delta, static_cast<T*>(a.dq), a.scale, a.sh);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const Args& a, cudaStream_t s) {
  using C = WCfg<HD>;
  CUtensorMap qm, km, vm, dm;
  if (!make_map(&qm, a.q, a.B, a.sh.Sq, a.sh.H, HD, kTile, C::kBoxCols, C::kSwizzle) ||
      !make_map(&dm, a.dout, a.B, a.sh.Sq, a.sh.H, HD, kTile, C::kBoxCols, C::kSwizzle) ||
      !make_map(&km, a.k, a.B, a.sh.Sk, a.sh.KV, HD, kTile, C::kBoxCols, C::kSwizzle) ||
      !make_map(&vm, a.v, a.B, a.sh.Sk, a.sh.KV, HD, kTile, C::kBoxCols, C::kSwizzle))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(fa_bwd_dq_wgmma<HD>, C::kSmem);
  if (e == cudaSuccess) e = allow_smem(fa_bwd_dkdv_wgmma<HD>, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.n_slots > 0) {
    fa_bwd_dkdv_wgmma<HD><<<dim3(a.n_slots, a.B * a.sh.KV), kThreads, C::kSmem, s>>>(
        qm, km, vm, dm, a.lse, a.delta, a.part_k, a.part_v, a.n_slots, a.sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fa_bwd_dq_wgmma<HD><<<dim3(a.B * a.sh.H, cdiv(a.sh.Sq, kTile)), kThreads, C::kSmem, s>>>(
      qm, km, vm, dm, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.scale, a.sh);
  return static_cast<int>(cudaGetLastError());
}

// D, then dK/dV and dQ, then the partials' sum, on the caller's stream
template <typename T, int HD>
int run(const Args& a, cudaStream_t s) {
  fa_bwd_delta<T, HD><<<dim3(a.B * a.sh.H, a.sh.lse_stride / kTile), kThreads, 0, s>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.sh);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  if constexpr (kTensorCores<T, HD>) e = launch_wgmma<HD>(a, s);
  else e = launch_simt<T, HD>(a, s);
  if (e != 0) return e;
  fa_bwd_finalize<T, HD><<<dim3(cdiv(a.sh.Sk, kTile), a.B * a.sh.KV, kFinalParts), kThreads,
                           0, s>>>(a.part_k, a.part_v, static_cast<T*>(a.dk),
                                   static_cast<T*>(a.dv), a.n_slots, a.scale, a.sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int attrs(int kind, int* attr) {
  if (kind == kDelta) return attrs_of(fa_bwd_delta<T, HD>, 0, attr);
  if (kind == kFinal) return attrs_of(fa_bwd_finalize<T, HD>, 0, attr);
  if constexpr (kTensorCores<T, HD>)
    return kind == kDq ? attrs_of(fa_bwd_dq_wgmma<HD>, WCfg<HD>::kSmem, attr)
                       : attrs_of(fa_bwd_dkdv_wgmma<HD>, WCfg<HD>::kSmem, attr);
  else
    return kind == kDq ? attrs_of(fa_bwd_dq_simt<T, HD>, simt_smem<HD>(false), attr)
                       : attrs_of(fa_bwd_dkdv_simt<T, HD>, simt_smem<HD>(true), attr);
}

// the backward (attr == nullptr) or the attributes of its kernel `kind`
template <typename T>
int dispatch(const Args& a, int hd, cudaStream_t s, int kind, int* attr) {
  switch (hd) {
    case 16: return attr ? attrs<T, 16>(kind, attr) : run<T, 16>(a, s);
    case 32: return attr ? attrs<T, 32>(kind, attr) : run<T, 32>(a, s);
    case 64: return attr ? attrs<T, 64>(kind, attr) : run<T, 64>(a, s);
    case 80: return attr ? attrs<T, 80>(kind, attr) : run<T, 80>(a, s);
    case 128: return attr ? attrs<T, 128>(kind, attr) : run<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Partial rows of dK and dV the backward needs per (b, kv head): the number
// of dK/dV blocks of one (b, kv head), the twin of ref.py::bwd_split_plan.
extern "C" int repro_flash_attention_bwd_slots(int Sq, int Sk, int H, int KV, int causal,
                                               int window, int n_sink, int q_off) {
  if (Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || q_off < 0) return -1;
  return n_slots_of(make_shape(Sq, Sk, H, KV, 1.f, causal, window, n_sink, q_off));
}

// q, o, dout, dq: [B, Sq, H, hd]; k, v, dk, dv: [B, Sk, KV, hd]; all
// contiguous, in one dtype (0 = float32, 1 = bfloat16). lse: [B*H, lse_stride]
// f32 from the forward (lse_stride = Sq rounded up to 64; exp2 domain);
// delta: the same shape, scratch; part_k, part_v: [B*KV, n_slots, 64, hd]
// f32 scratch, n_slots from repro_flash_attention_bwd_slots. hd in {16, 32,
// 64, 80, 128}; H % KV == 0; Sq, Sk >= 1; window >= 0, n_sink >= 0 and q_off
// >= 0 (the global index of q's first row; n_slots must be counted with it)
// act only when causal; o and dout 16-byte aligned (D reads them as 16-byte
// vectors).
// bf16 at hd 64/80/128 runs the tensor-core kernels, which need q, k and v
// 16-byte aligned too. Returns cudaGetLastError() after the
// launches (or the first error).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* delta,
                                         void* part_k, void* part_v, int n_slots, int B,
                                         int Sq, int Sk, int H, int KV, int hd, int causal,
                                         int window, int n_sink, int q_off, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || window < 0 ||
      n_sink < 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = make_shape(Sq, Sk, H, KV, scale, causal, window, n_sink, q_off);
  if (n_slots != n_slots_of(sh)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<float*>(part_k),
               static_cast<float*>(part_v), B, n_slots, scale, sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!aligned(o) || !aligned(dout)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(a, hd, s, 0, nullptr);
  if (dtype == 1) {
    if ((hd == 64 || hd == 80 || hd == 128) && !(aligned(q) && aligned(k) && aligned(v)))
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<__nv_bfloat16>(a, hd, s, 0, nullptr);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers per thread at launch (the tensor-core kernels then move them by
// setmaxnreg), local (spill) bytes per thread, shared memory per block and
// the blocks an SM of the current device holds, of the kernel `kind` (0 dQ,
// 1 dK/dV, 2 D, 3 the partials' sum) that a call with this dtype and hd
// launches.
extern "C" int repro_flash_attention_bwd_attrs(int kind, int hd, int dtype, int* blocks_per_sm,
                                               int* regs, int* local_bytes, int* smem_bytes) {
  if (kind < 0 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
  int attr[4] = {0, 0, 0, 0};
  const Args a{};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) err = dispatch<float>(a, hd, nullptr, kind, attr);
  if (dtype == 1) err = dispatch<__nv_bfloat16>(a, hd, nullptr, kind, attr);
  *regs = attr[0];
  *local_bytes = attr[1];
  *smem_bytes = attr[2];
  *blocks_per_sm = attr[3];
  return err;
}
