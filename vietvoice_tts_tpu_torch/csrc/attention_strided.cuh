// The bfloat16 tensor-core attention on strided q, k, v [B, H, N, d] (unit
// stride along d, 16-byte-aligned rows), d any multiple of 8 up to 1024,
// output [B, N, H, d]: flash_attention.cu's bf16 variant, and the second
// pass of fused_rope_attention.cu from d = 256 (on q and k that its first
// pass has rotated). launch_strided() picks one of two kernels from d:
//
// Up to d = 256: attention_tile_kernel, the tile step of attention_mma.cuh
//   at the smallest tile width D (32, 64, 128, 192, 256) that holds the
//   head, its columns past d zero. A block is two warpgroups, 128 query
//   rows, which share every K/V tile. q, k and v are copied as they lie,
//   strides and all, by 16-byte cp.async into bf16 tiles in the layout the
//   wgmma descriptors read; the tiles form a ring (two stages from D = 128,
//   three below), and the copy of a later tile is in flight while a tile is
//   computed. One barrier per tile. At D = 256 the Q tiles and two stages
//   take 193 KB, and the accumulator 128 registers a thread of the 255 a
//   256-thread block allows.
//
// Above 256: attention_wide_kernel. attention_mma.cuh's step keeps the whole
//   [64, D] output accumulator of a warpgroup in registers, D / 2 floats a
//   thread: 256 at d = 512, over the 255 a thread may have before S, m and
//   l are counted; and its Q, K and V tiles at d = 512 would take 192 KB for
//   a single stage. So here:
//
// - Column blocks. A block owns 64 query rows and one block of CW output
//   columns (CW = 192 or 256; wide_block_width). The fewest blocks of at
//   most 256 columns cover d; each has its own grid cell and recomputes S for
//   its rows: the logits' flops are paid once per column block (d 512: twice,
//   so the call does 1.5x the flops of one pass; d 384: twice in blocks of
//   192). Sharing S across the blocks of a row would need P in shared memory
//   and a hand-over between warpgroups; that is later work.
// - Q stays in shared memory for the whole key walk, cut into atoms of 64
//   columns ([64, 64] tiles, 8 KB each; 128 KB at d = 1024).
// - K and V stream through a ring of WIDE_RING [64, 64] slots, in the order
//   the consumer takes them: for each key tile, the d / 64 atoms of K, then
//   the CW / 64 atoms of V that this block's columns need. S accumulates over
//   the K atoms (4 wgmma m64n64k16 each, the last atom's zero columns
//   past d included), and each V atom is one m64n64 piece of P . V (4
//   wgmma).
// - Two warpgroups, 256 threads. The producer copies slots by cp.async and
//   keeps WIDE_LAG of them in flight before it hands the oldest over on its
//   mbarrier ("full"); the consumer runs the products and the softmax and
//   hands each slot back ("empty") when its wgmma have completed. A thread
//   may have 255 registers: the CW = 256 accumulator (128), S (32) and P
//   (16) fit.
// - Key biases are read by the consumer from the mask (L1-cached bytes), so
//   no slot carries them.
//
// Zero columns and rows: columns past d and rows past N are zero-filled by
// the copies, exactly as in attention_mma.cuh, so the padding adds nothing
// to S and P . V's columns past d are computed on zeros and never stored.
// The weights are rounded to bfloat16 for P . V, as the TPU kernels round
// them.

#pragma once

#include "attention_mma.cuh"

namespace vv_mma {

// ---- up to 256 columns: the tile step ---------------------------------------

constexpr int TILE_WARPGROUPS = 2;
constexpr int TILE_THREADS = TILE_WARPGROUPS * WG_THREADS;
constexpr int TILE_BQ = TILE_WARPGROUPS * WG_ROWS;  // queries per block

// Shared memory of one block: the Q tiles (one per warpgroup), a ring of
// STAGES K tiles and V tiles, the ring's key biases; 1024 bytes of slack to
// start on a 1024-byte boundary. D is the tile width (D = 256: 193 KB).
template <int D>
struct TileSmem {
  using L = TileLayout<D>;
  static constexpr int STAGES = D >= 128 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = L::BYTES;
  static constexpr uint32_t KV_BYTES = L::BYTES;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + TILE_WARPGROUPS * Q_BYTES;
  static constexpr uint32_t V = K + STAGES * KV_BYTES;
  static constexpr uint32_t BIAS = V + STAGES * KV_BYTES;
  static constexpr size_t BYTES = BIAS + STAGES * BK * sizeof(float) + 1024;
};

template <int D>
__global__ void __launch_bounds__(TILE_THREADS)
attention_tile_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ mask,  // [B, N] or null
                      __nv_bfloat16* __restrict__ out,   // [B, N, H, d]
                      Strides sq, Strides sk, Strides sv,
                      int n, int heads, int d, float scale_log2) {
  using S = TileSmem<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias = reinterpret_cast<float*>(smem_raw + (base - raw) + S::BIAS);

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int q0 = blockIdx.x * TILE_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_head = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* k_head = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* v_head = v + b * sv.b + h * sv.h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (long long)b * n;
  const int tiles = (n + BK - 1) / BK;

  const TileCopier<D, TILE_THREADS> copier(tid);
  auto load_kv = [&](int t) {
    const int stage = t % STAGES;
    copier.copy(base + S::K + stage * S::KV_BYTES, k_head, sk.n, t * BK, n, d);
    copier.copy(base + S::V + stage * S::KV_BYTES, v_head, sv.n, t * BK, n, d);
    if (tid < BK)
      bias[stage * BK + tid] = key_bias(mask_row, t * BK + tid, n);
  };

  // The two Q tiles are one [128, D] copy: warpgroup w's tile is rows
  // 64 w .. 64 w + 63, stored as a tile of 64 rows of its own.
#pragma unroll
  for (int w = 0; w < TILE_WARPGROUPS; ++w)
    copier.copy(base + S::Q + w * S::Q_BYTES, q_head, sq.n, q0 + w * WG_ROWS, n, d);
  // One commit group per tile, empty past the last tile, so that "all but
  // the newest STAGES - 2 groups" always means "tile t has landed".
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) load_kv(t);
    cp_async_commit();
  }

  RowState<D> st;
  st.init();
  const uint32_t q_addr = base + S::Q + wg * S::Q_BYTES;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile t is complete; everyone is done with tile t - 1
    if (t + STAGES - 1 < tiles) load_kv(t + STAGES - 1);  // into tile t - 1's stage
    cp_async_commit();
    const int stage = t % STAGES;
    tile_step<D>(q_addr, base + S::K + stage * S::KV_BYTES, base + S::V + stage * S::KV_BYTES,
                 bias + stage * BK, scale_log2, st);
  }

  const int row0 = q0 + wg * WG_ROWS;
  const long long pitch = (long long)heads * d;
  store_output<D>(st, out + ((long long)b * n + row0) * pitch + (long long)h * d, pitch, row0,
                  n, d);
}

// D: the tile width; d: the head's (<= D).
template <int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v, const void* mask,
                        void* out, Strides sq, Strides sk, Strides sv, int b, int heads,
                        int n, int d, cudaStream_t stream) {
  auto kernel = attention_tile_kernel<D>;
  constexpr size_t smem = TileSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE_BQ - 1) / TILE_BQ, heads, b);
  kernel<<<grid, TILE_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), sq, sk, sv, n, heads, d,
      LOG2E / sqrtf((float)d));
  return cudaGetLastError();
}

// ---- above 256 columns: column blocks --------------------------------------

constexpr int WIDE_THREADS = 2 * WG_THREADS;  // a consumer and a producer warpgroup
constexpr int WIDE_ATOM = 64;                 // columns of a Q atom and of a ring slot
constexpr uint32_t WIDE_SLOT_BYTES = TileLayout<WIDE_ATOM>::BYTES;  // 8 KB
constexpr int WIDE_RING = 8;                  // slots in the ring
constexpr int WIDE_LAG = 4;                   // slots in flight before one is handed over
constexpr int WIDE_MAX_COLS = 256;            // output columns of a block, at most
constexpr int WIDE_MAX_D = 1024;              // Q atoms of 128 KB, the ring 64 KB
static_assert(WIDE_LAG < WIDE_RING, "the producer hands a slot over before it reuses it");

// Column blocks that cover a head of width d: the fewest of at most 256
// columns, each the narrowest multiple of 64 that covers d / blocks.
inline int wide_column_blocks(int d) { return (d + WIDE_MAX_COLS - 1) / WIDE_MAX_COLS; }
inline int wide_block_width(int d) {
  const int blocks = wide_column_blocks(d);
  const int cols = (d + blocks - 1) / blocks;
  return (cols + WIDE_ATOM - 1) / WIDE_ATOM * WIDE_ATOM;
}
inline size_t wide_smem_bytes(int d) {
  const int atoms = (d + WIDE_ATOM - 1) / WIDE_ATOM;
  return (size_t)(atoms + WIDE_RING) * WIDE_SLOT_BYTES + 2 * WIDE_RING * 8 + 1024;
}

template <int CW>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
attention_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const uint8_t* __restrict__ mask,  // [B, N] or null
                      __nv_bfloat16* __restrict__ out,   // [B, N, H, d]
                      Strides sq, Strides sk, Strides sv, int n, int heads, int d,
                      float scale_log2) {
  static_assert(CW == 192 || CW == 256, "the widths wide_block_width gives above 256");
  constexpr int V_ATOMS = CW / WIDE_ATOM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int atoms = (d + WIDE_ATOM - 1) / WIDE_ATOM;
  const uint32_t ring = base + atoms * WIDE_SLOT_BYTES;
  const uint32_t full = ring + WIDE_RING * WIDE_SLOT_BYTES;
  const uint32_t empty = full + 8 * WIDE_RING;

  const int col_blocks = gridDim.y / heads;
  const int h = blockIdx.y / col_blocks;
  const int c0 = (blockIdx.y % col_blocks) * CW;  // this block's first output column
  const int row0 = blockIdx.x * WG_ROWS;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_head = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* k_head = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* v_head = v + b * sv.b + h * sv.h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (long long)b * n;
  const int tiles = (n + BK - 1) / BK;
  const int items = atoms + V_ATOMS;  // ring slots per key tile
  const int wg = threadIdx.x / WG_THREADS;
  const int t_wg = threadIdx.x % WG_THREADS;

  // full[s]: the producer's 128 threads have written slot s. empty[s]: the
  // consumer's 128 threads are done reading it.
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIDE_RING; ++s) {
      mbarrier_init(full + 8 * s, WG_THREADS);
      mbarrier_init(empty + 8 * s, WG_THREADS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();  // the only block-wide barrier

  const TileCopier<WIDE_ATOM, WG_THREADS> copier(t_wg);
  if (wg == 1) {
    // The producer: slot `seq` holds item seq % items of key tile
    // seq / items. A slot is handed over once the copies WIDE_LAG slots
    // later have been started, so that many are always in flight.
    int seq = 0;
    for (int t = 0; t < tiles; ++t) {
      for (int i = 0; i < items; ++i, ++seq) {
        const int slot = seq % WIDE_RING;
        mbarrier_wait(empty + 8 * slot, ((seq / WIDE_RING) & 1) ^ 1);
        const uint32_t dst = ring + slot * WIDE_SLOT_BYTES;
        if (i < atoms) {
          copier.copy(dst, k_head + i * WIDE_ATOM, sk.n, t * BK, n, d - i * WIDE_ATOM);
        } else {
          const int col = c0 + (i - atoms) * WIDE_ATOM;
          copier.copy(dst, v_head + col, sv.n, t * BK, n, d - col);
        }
        cp_async_commit();
        if (seq >= WIDE_LAG) {
          cp_async_wait<WIDE_LAG>();  // slot seq - WIDE_LAG has landed
          fence_proxy_async();
          mbarrier_arrive(full + 8 * ((seq - WIDE_LAG) % WIDE_RING));
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int s = seq < WIDE_LAG ? 0 : seq - WIDE_LAG; s < seq; ++s)
      mbarrier_arrive(full + 8 * (s % WIDE_RING));
    return;
  }

  // The consumer: this block's 64 query rows into the Q atoms, once.
  for (int a = 0; a < atoms; ++a)
    copier.copy(base + a * WIDE_SLOT_BYTES, q_head + a * WIDE_ATOM, sq.n, row0, n,
                d - a * WIDE_ATOM);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1, WG_THREADS);  // the Q atoms are this warpgroup's alone

  RowState<CW> st;
  st.init();
  const int quad = threadIdx.x & 3;
  int seq = 0;
  for (int t = 0; t < tiles; ++t) {
    float s[BK / 2];
    for (int a = 0; a < atoms; ++a, ++seq) {
      const int slot = seq % WIDE_RING;
      mbarrier_wait(full + 8 * slot, (seq / WIDE_RING) & 1);
      const uint32_t q_addr = base + a * WIDE_SLOT_BYTES;
      const uint32_t k_addr = ring + slot * WIDE_SLOT_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WIDE_ATOM / 16; ++kk)
        wgmma_ss_n64(s, k_major_desc<WIDE_ATOM>(q_addr, kk), k_major_desc<WIDE_ATOM>(k_addr, kk),
                     a > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      mbarrier_arrive(empty + 8 * slot);
    }
    const int k0 = t * BK;
    softmax_step_with<CW>(
        s,
        [&](int j) {
          const int key = k0 + 8 * j + 2 * quad;
          return make_float2(key_bias(mask_row, key, n), key_bias(mask_row, key + 1, n));
        },
        scale_log2, st);
    uint32_t p[BK / 16][4];
    pack_weights(s, p);
    // Each V atom is one 64-column piece of P . V.
    auto pv_atom = [&](float (&o)[WIDE_ATOM / 2]) {
      const int slot = seq % WIDE_RING;
      mbarrier_wait(full + 8 * slot, (seq / WIDE_RING) & 1);
      pv_product<WIDE_ATOM>(p, ring + slot * WIDE_SLOT_BYTES, o);
      wgmma_wait<0>();
      fence_operands(o);
      mbarrier_arrive(empty + 8 * slot);
      ++seq;
    };
    pv_atom(columns<0, WIDE_ATOM>(st.o));
    if constexpr (V_ATOMS > 1) pv_atom(columns<64, WIDE_ATOM>(st.o));
    if constexpr (V_ATOMS > 2) pv_atom(columns<128, WIDE_ATOM>(st.o));
    if constexpr (V_ATOMS > 3) pv_atom(columns<192, WIDE_ATOM>(st.o));
  }

  const long long pitch = (long long)heads * d;
  store_output<CW>(st, out + ((long long)b * n + row0) * pitch + (long long)h * d + c0, pitch,
                   row0, n, d - c0);
}

template <int CW>
cudaError_t launch_wide_cw(const __nv_bfloat16* q, const __nv_bfloat16* k,
                           const __nv_bfloat16* v, const uint8_t* mask, __nv_bfloat16* out,
                           Strides sq, Strides sk, Strides sv, int b, int heads, int n, int d,
                           cudaStream_t stream) {
  auto kernel = attention_wide_kernel<CW>;
  const size_t smem = wide_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + WG_ROWS - 1) / WG_ROWS, heads * wide_column_blocks(d), b);
  kernel<<<grid, WIDE_THREADS, smem, stream>>>(q, k, v, mask, out, sq, sk, sv, n, heads, d,
                                               LOG2E / sqrtf((float)d));
  return cudaGetLastError();
}

// Launches the wide kernel for head width d (a multiple of 8 from 256 to
// WIDE_MAX_D); rows must be 16-byte aligned.
inline cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* mask,
                               void* out, Strides sq, Strides sk, Strides sv, int b, int heads,
                               int n, int d, cudaStream_t stream) {
  if (d % 8 != 0 || d < 8 || d > WIDE_MAX_D) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (wide_block_width(d)) {
    case 192: return launch_wide_cw<192>(qb, kb, vb, m, o, sq, sk, sv, b, heads, n, d, stream);
    case 256: return launch_wide_cw<256>(qb, kb, vb, m, o, sq, sk, sv, b, heads, n, d, stream);
    default:  return cudaErrorInvalidValue;  // d below 256: attention_mma.cuh's step
  }
}

// bf16 attention on strided q, k, v [b, heads, n, d] (d a multiple of 8 up
// to WIDE_MAX_D; 16-byte-aligned rows), output [b, n, heads, d]: the tile
// step at the smallest tile width that holds the head up to 256, the wide
// kernel above.
inline cudaError_t launch_strided(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, Strides sq, Strides sk, Strides sv, int b,
                                  int heads, int n, int d, cudaStream_t s) {
  if (d <= 32) return launch_tile<32>(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
  if (d <= 64) return launch_tile<64>(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
  if (d <= 128) return launch_tile<128>(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
  if (d <= 192) return launch_tile<192>(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
  if (d <= 256) return launch_tile<256>(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
  return launch_wide(q, k, v, mask, out, sq, sk, sv, b, heads, n, d, s);
}

}  // namespace vv_mma
