// The float32 attention of both kernels (flash_attention.cu, and
// fused_rope_attention.cu's second pass), on Hopper's tensor cores in
// split TF32 ("tf32x3").
//
// Serves the float32 variant of the two TPU kernels the port replaces:
// flash_attention (vietvoice_tts_tpu/ops/pallas/flash_attention.py:53) and
// fused_qkv_rope_attention (vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123,
// whose q and k fused_rope_attention.cu rotates into scratch first). Same
// function: logits = q . k^T / sqrt(d) + key bias (0 for a valid key, -1e30
// for a padded one, -inf past the end), float32 softmax over all keys,
// P . V, output written once divided by the row sum. Strided q, k, v
// [B, H, N, d] (unit stride along d, 16-byte-aligned rows), d any multiple
// of 8 up to 1024; output [B, N, H, d].
//
// Split TF32. The tensor cores take float32 operands only as TF32 (11
// significant bits). Each operand x is split into hi = rna(x) and
// lo = rna(x - hi) (cvt.rna.tf32.f32: round to nearest, ties away from
// zero; on an H100 the same bits as adding 0x1000 and clearing the low 13
// bits, the emulation's rule); |x - hi| <= 2^-11 |x| and
// |x - hi - lo| <= 2^-22 |x|. Each product a . b is lo(a) hi(b) +
// hi(a) lo(b) + hi(a) hi(b), the small terms first, accumulated in
// float32: the dropped lo . lo and the two residuals leave about
// 3 x 2^-22 |a||b| per term, against 2^-24 for a float32 product. Both
// products of the attention are split so: S = Q . K^T and O += P . V, P
// the unnormalized float32 weights.
//
// Bound on an H100: 4 B H N^2 d flops (N the valid keys), three TF32
// products each, against the 495 TFLOP/s of TF32: max(bytes / 3.35 TB/s,
// 3 flops / 495 TFLOP/s), operations at every serving shape. SIMT float32
// (67 TFLOP/s) bounds the same call 2.5x higher.
//
// Layout. Everything wgmma reads is K-major (for 32-bit types it takes both
// operands that way only): rows of 128 bytes (32 floats) in the hardware's
// 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), eight
// rows a core-matrix group, groups 1024 bytes apart; a k8 slice is 32 bytes
// of every row. Shared memory is cut into 16 KB slots, each the hi part
// (8 KB) then the lo part (8 KB) of one item:
//
//   Q or K atom  [64 rows][32 columns] of q (query rows) or k (keys);
//   V atom       [32 columns][64 keys]: V transposed, as two [32][32]
//                key halves, so that keys are the contiguous axis.
//
// A block is two warpgroups and owns 64 query rows and one block of at most
// 128 output columns (CW, a multiple of 32; heads wider than 128 run in
// column blocks, each of which computes S anew: 1.5x the flops at d 256,
// 2.5x at 512). Q atoms stay in shared memory as far as they fit beside the
// ring (all of them up to d = 320, the first 10 above; 14 slots in all).
// The producer warpgroup stages the other items through a ring of slots in
// the order the consumer takes them: per key tile of 64 keys, the K atom
// of each resident Q atom, the Q and K atoms of each other, then the
// CW / 32 V atoms. Each producer thread loads its share of an item (four
// 16-byte chunks) into registers AHEAD items before the item's turn; when
// the item's slot is free it splits them and stores hi and lo: a Q or K
// chunk as it lies, V transposed (a thread holds four keys of one permuted
// group for four columns, one chunk of each of four transposed rows). An
// item is handed over on the slot's mbarrier ("full"); the consumer hands
// it back ("empty") when its wgmma have completed. Splitting in the
// producer repeats the split of a K or V atom for every query block and
// column block that reads it. While the kernel was designed, switching
// parts of it off in turn on an H100 showed the producer's loads, splits
// and stores, more than the products, setting its pace.
//
// The consumer: S (64 x 64, 32 registers a thread) += three wgmma
// m64n64k8 per k8 slice of each atom, Q and K from shared memory, one
// commit group for each pair of atoms; the online softmax of
// attention_mma.cuh in the log2 domain (the scale 1/sqrt(d) on the float32
// logits, folded with log2 e; running max and sum); then P split in
// registers and O += three wgmma m64n32k8 per 8 keys per V atom, P the
// register A operand, all V atoms one group. The accumulator gives a thread
// keys 2t and 2t + 1 of every 8 (t = lane % 4) where a TF32 A fragment
// wants t and t + 4, so the keys of each group of eight are permuted when V
// is transposed into its slot (key 2j at position j, 2j + 1 at j + 4): P
// goes to the tensor cores with no shuffle.
//
// Why wgmma at every width and no mma.sync path: with Q resident as far as
// it fits and the rest restaged, every width fits (at most 224 KB).
// Registers: a consumer thread holds CW / 2 output floats, 32 logits and 64
// split weights (ptxas: up to 226 a thread at CW = 128); at CW = 32 two
// blocks share an SM, 128 registers a thread.
//
// Graph safety: no atomics (the same inputs give the same bits, so a CUDA
// graph's replay equals the eager call), no allocation, every launch
// checked. Rows past N and columns past d are loaded as zeros (0 x NaN
// would be NaN) and never stored.

#pragma once

#include "attention_mma.cuh"

namespace vv_tf32 {

using vv_mma::BK;
using vv_mma::Strides;
using vv_mma::WG_ROWS;
using vv_mma::WG_THREADS;

constexpr int THREADS = 2 * WG_THREADS;      // a consumer and a producer warpgroup
constexpr int ATOM = 32;                     // float32 columns (or keys) of a 128-byte row
constexpr uint32_t ROW_BYTES = 128;
constexpr uint32_t HALF = 64 * ROW_BYTES;    // 8 KB: the hi (or lo) part of a slot
constexpr uint32_t SLOT = 2 * HALF;          // 16 KB
constexpr uint32_t V_KEY_HALF = ATOM * ROW_BYTES;  // [32 columns][32 keys] of a V part
constexpr int MAX_COLS = 128;                // output columns of a block, at most
constexpr int SLOTS = 14;                    // 224 KB: the ring and the resident Q atoms
constexpr int MAX_D = 1024;
constexpr int AHEAD = 2;                     // items a producer thread holds in registers
static_assert(BK == 64 && WG_ROWS == 64, "64-row items");

// Slots in the ring and resident Q atoms, 14 in all at most (224 KB of the
// 227 a block may have). Up to d = 32 four slots (80 KB with Q), so that two
// blocks share an SM; above, Q resident as far as it fits beside a ring of
// 8, 6 or 4 slots: all of Q up to d = 320 (ring 8 to 192, 6 to 256, 4 to
// 320), then the first 10 atoms, the rest restaged with every key tile.
inline int ring_slots(int d) {
  const int atoms = (d + ATOM - 1) / ATOM;
  return d <= ATOM ? 4 : atoms <= 6 ? 8 : atoms <= 8 ? 6 : 4;
}
inline int resident_atoms(int d) {
  const int atoms = (d + ATOM - 1) / ATOM;
  const int room = SLOTS - ring_slots(d);
  return atoms < room ? atoms : room;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint4 ld_shared_16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled region.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return static_cast<uint32_t>(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// K-major descriptor of the 8-row groups starting at addr (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return vv_mma::make_desc(addr, 16, 8 * ROW_BYTES, 1);
}

// d[32] (+)= A[64 x 8] . B[64 x 8]^T in TF32, both K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[16] += A[64 x 8] (TF32 register fragments) . B[32 x 8]^T, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- the split ----------------------------------------------------------------

// x rounded to TF32 (nearest, ties away from zero), low 13 bits zero. On
// an H100 this equals the bit arithmetic (add 0x1000, clear the low 13
// bits) for every finite x (probe 4 of attention_mma_probe.cu and its card
// test); inf stays inf, nan stays nan.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // exact: hi is within 2^-11 |x| of x
}
__device__ __forceinline__ void split4(uint4 x, uint4& hi, uint4& lo) {
  split(__uint_as_float(x.x), hi.x, lo.x);
  split(__uint_as_float(x.y), hi.y, lo.y);
  split(__uint_as_float(x.z), hi.z, lo.z);
  split(__uint_as_float(x.w), hi.w, lo.w);
}

// ---- staging an item: one producer thread's part, of WG_THREADS ---------------

// A thread's share of one item: four 16-byte chunks of float32, loaded
// from global memory into registers some items ahead of the item's turn.
struct Chunks {
  uint4 x[4];
};

// Rows (Q, K): thread t takes chunk t % 8 of rows t / 8 + 16 p, eight
// threads to a 128-byte row. V: thread t takes columns 4 c .. 4 c + 3 of
// the four keys that one 16-byte chunk of a transposed row holds, keys
// 8 g + o, + 2, + 4, + 6 of key half h (positions 8 g + 4 o .. + 3 after the
// permutation), with (g, o) = (t % 8 / 2, t % 2), c = t / 8 % 8 and
// h = t / 64: its stores are four 16-byte chunks of hi and four of lo, and
// the eight threads that store into one 128-byte row hold its eight chunks.
struct Stager {
  int t;
  __device__ __forceinline__ explicit Stager(int thread) : t(thread) {}

  __device__ __forceinline__ int v_chunk() const { return (t >> 3) & 7; }
  __device__ __forceinline__ int v_key(int i) const {  // i-th of the thread's keys
    return 32 * (t >> 6) + 8 * ((t & 7) >> 1) + (t & 1) + 2 * i;
  }

  // Rows r0 .. r0 + 63 of a 32-column window (row i at src + i * pitch);
  // rows >= n and columns >= cols (may be <= 0) are zeros.
  __device__ __forceinline__ void load_rows(Chunks& in, const float* src, long long pitch,
                                            int r0, int n, int cols) const {
    const int c = t & 7;
    const int r = t >> 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int row = r + 16 * p;
      in.x[p] = r0 + row < n && 4 * c < cols
                    ? __ldg(reinterpret_cast<const uint4*>(src + (long long)(r0 + row) * pitch +
                                                           4 * c))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // Splits them into the slot: hi at each row's swizzled chunk, lo 8 KB on.
  __device__ __forceinline__ void store_rows(uint32_t slot, const Chunks& in) const {
    const int c = t & 7;
    const int r = t >> 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t addr = slot + swizzled(r + 16 * p, c);
      uint4 hi, lo;
      split4(in.x[p], hi, lo);
      vv_mma::st_shared_16(addr, hi);
      vv_mma::st_shared_16(addr + HALF, lo);
    }
  }

  // Keys r0 .. r0 + 63 of a 32-column window of V (this thread's four),
  // zeros as load_rows.
  __device__ __forceinline__ void load_cols(Chunks& in, const float* src, long long pitch,
                                            int r0, int n, int cols) const {
    const int c = v_chunk();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = v_key(i);
      in.x[i] = r0 + key < n && 4 * c < cols
                    ? __ldg(reinterpret_cast<const uint4*>(src + (long long)(r0 + key) * pitch +
                                                           4 * c))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // Splits them into the V layout: column j of key half h at row j of that
  // half, the keys of each group of eight permuted (2i -> i, 2i + 1 -> i + 4),
  // so this thread's four keys are one chunk of each of its four rows.
  __device__ __forceinline__ void store_cols(uint32_t slot, const Chunks& in) const {
    const int c = v_chunk();
    const uint32_t half = slot + (t >> 6) * V_KEY_HALF;
    const int chunk = t & 7;  // 2 g + o: positions 8 g + 4 o .. + 3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 col = j == 0   ? make_uint4(in.x[0].x, in.x[1].x, in.x[2].x, in.x[3].x)
                        : j == 1 ? make_uint4(in.x[0].y, in.x[1].y, in.x[2].y, in.x[3].y)
                        : j == 2 ? make_uint4(in.x[0].z, in.x[1].z, in.x[2].z, in.x[3].z)
                                 : make_uint4(in.x[0].w, in.x[1].w, in.x[2].w, in.x[3].w);
      uint4 hi, lo;
      split4(col, hi, lo);
      const uint32_t addr = half + swizzled(4 * c + j, chunk);
      vv_mma::st_shared_16(addr, hi);
      vv_mma::st_shared_16(addr + HALF, lo);
    }
  }

  // The resident Q, all atoms in flight at once: start_rows copies a row
  // item's raw chunks into the slot's hi part by cp.async, finish_rows
  // splits them in place once they have landed.
  __device__ __forceinline__ void start_rows(uint32_t slot, const float* src, long long pitch,
                                             int r0, int n, int cols) const {
    const int c = t & 7;
    const int r = t >> 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int row = r + 16 * p;
      const bool valid = r0 + row < n && 4 * c < cols;
      vv_mma::cp_async_16(slot + swizzled(row, c),
                          valid ? src + (long long)(r0 + row) * pitch + 4 * c : src, valid);
    }
  }
  __device__ __forceinline__ void finish_rows(uint32_t slot) const {
    const int c = t & 7;
    const int r = t >> 3;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t addr = slot + swizzled(r + 16 * p, c);
      uint4 hi, lo;
      split4(ld_shared_16(addr), hi, lo);
      vv_mma::st_shared_16(addr, hi);
      vv_mma::st_shared_16(addr + HALF, lo);
    }
  }
};

// ---- the consumer's two products ----------------------------------------------

// Issues s (+)= Q . K^T over the 32 columns of one atom: the Q slot at q,
// the K slot at k; accumulate 0 starts s anew. The caller fences before and
// commits and waits after.
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t q, uint32_t k,
                                         int accumulate) {
#pragma unroll
  for (int kk = 0; kk < ATOM / 8; ++kk) {
    const uint32_t off = 32 * kk;
    wgmma_tf32_ss_n64(s, desc(q + HALF + off), desc(k + off), (accumulate || kk > 0) ? 1 : 0);
    wgmma_tf32_ss_n64(s, desc(q + off), desc(k + HALF + off), 1);
    wgmma_tf32_ss_n64(s, desc(q + off), desc(k + off), 1);
  }
}

// The same for one atom, waited for.
__device__ __forceinline__ void qk_atom(float (&s)[BK / 2], uint32_t q, uint32_t k,
                                        int accumulate) {
  vv_mma::wgmma_fence();
  qk_issue(s, q, k, accumulate);
  vv_mma::wgmma_commit();
  vv_mma::wgmma_wait<0>();
  vv_mma::fence_operands(s);
}

// The weights in s (accumulator layout) split into the TF32 A fragments of
// P . V, 8 keys a fragment: registers 0..3 are (row g, key 2t), (g + 8, 2t),
// (g, 2t + 1), (g + 8, 2t + 1) of keys 8 kk .. 8 kk + 7, which the fragment
// reads as its columns t, t, t + 4, t + 4.
__device__ __forceinline__ void split_weights(const float (&s)[BK / 2],
                                              uint32_t (&hi)[BK / 8][4],
                                              uint32_t (&lo)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split(s[4 * kk + 0], hi[kk][0], lo[kk][0]);
    split(s[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split(s[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split(s[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// Issues o += P . V for the 32 output columns of the V slot at v. The
// caller fences before (fence_weights) and commits and waits after.
__device__ __forceinline__ void pv_issue(float (&o)[ATOM / 2], uint32_t (&hi)[BK / 8][4],
                                         uint32_t (&lo)[BK / 8][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t b = v + (kk >> 2) * V_KEY_HALF + 32 * (kk & 3);
    wgmma_tf32_rs_n32(o, lo[kk], desc(b));
    wgmma_tf32_rs_n32(o, hi[kk], desc(b + HALF));
    wgmma_tf32_rs_n32(o, hi[kk], desc(b));
  }
}

// Orders the softmax's writes of the accumulator and of the weights before
// the wgmma of P . V.
template <int N>
__device__ __forceinline__ void fence_weights(float (&o)[N], uint32_t (&hi)[BK / 8][4],
                                              uint32_t (&lo)[BK / 8][4]) {
  vv_mma::fence_operands(o);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    vv_mma::fence_operands(hi[kk]);
    vv_mma::fence_operands(lo[kk]);
  }
  vv_mma::wgmma_fence();
}

// Normalizes and stores the consumer's rows: dst is row row0's first output
// column, pitch the distance between rows; rows >= n and columns >= cols (a
// multiple of 8, may be <= 0) are not stored.
template <int CW>
__device__ __forceinline__ void store_rows(vv_mma::RowState<CW>& st, float* dst,
                                           long long pitch, int row0, int n, int cols) {
  const int t = threadIdx.x % WG_THREADS;
  const int quad = t & 3;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = r + 8 * h;
    if (row0 + row < n) {
      float* out_row = dst + row * pitch + 2 * quad;
#pragma unroll
      for (int c = 0; c < CW / 8; ++c)
        if (8 * c < cols)
          *reinterpret_cast<float2*>(out_row + 8 * c) =
              make_float2(st.o[4 * c + 2 * h] * inv, st.o[4 * c + 2 * h + 1] * inv);
    }
  }
}

// ---- the kernel -----------------------------------------------------------------

// Grid: (query blocks of 64, heads x column blocks, batch). CW: output
// columns of a block; RING: slots in the ring (ring_slots); resident: Q
// atoms staged once (resident_atoms).
template <int CW, int RING>
__global__ void __launch_bounds__(THREADS, CW == ATOM ? 2 : 1)
attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ mask,  // [B, N] or null
                      float* __restrict__ out,           // [B, N, H, d]
                      Strides sq, Strides sk, Strides sv, int n, int heads, int d,
                      float scale_log2, int resident) {
  static_assert(CW % ATOM == 0 && CW <= MAX_COLS, "whole V atoms, at most 128 columns");
  constexpr int V_ATOMS = CW / ATOM;
  // While the consumer waits for an item it holds at most three others (the
  // tile's V atoms before it, or an atom's Q while it waits for the K); the
  // producer, which fills slots in order, needs one more.
  static_assert(RING >= V_ATOMS && RING >= 2, "a free slot for the item the consumer waits for");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (vv_mma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int atoms = (d + ATOM - 1) / ATOM;
  const uint32_t ring = base;
  const uint32_t q_res = ring + RING * SLOT;
  const uint32_t full = q_res + resident * SLOT;
  const uint32_t empty = full + 8 * RING;
  const uint32_t q_full = empty + 8 * RING;

  const int col_blocks = gridDim.y / heads;
  const int h = blockIdx.y / col_blocks;
  const int c0 = (blockIdx.y % col_blocks) * CW;  // this block's first output column
  const int row0 = blockIdx.x * WG_ROWS;
  const int b = blockIdx.z;
  const float* q_head = q + b * sq.b + h * sq.h;
  const float* k_head = k + b * sk.b + h * sk.h;
  const float* v_head = v + b * sv.b + h * sv.h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (long long)b * n;
  const int tiles = (n + BK - 1) / BK;
  // A key tile's items: the K atom of each of the first `resident` atoms,
  // then the Q and the K atom of each other, then the V atoms.
  const int qk_items = 2 * atoms - resident;
  const int items = qk_items + V_ATOMS;
  const int wg = threadIdx.x / WG_THREADS;

  // full[s]: the producer's 128 threads have written slot s. empty[s]: the
  // consumer's 128 threads are done with it. q_full: the resident Q is in.
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      vv_mma::mbarrier_init(full + 8 * s, WG_THREADS);
      vv_mma::mbarrier_init(empty + 8 * s, WG_THREADS);
    }
    vv_mma::mbarrier_init(q_full, WG_THREADS);
    vv_mma::fence_mbarrier_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (wg == 1) {
    // The producer. Item i of key tile t is sequence number t * items + i,
    // in slot seq % RING.
    const Stager stage(threadIdx.x % WG_THREADS);
    for (int a = 0; a < resident; ++a)
      stage.start_rows(q_res + a * SLOT, q_head + a * ATOM, sq.n, row0, n, d - a * ATOM);
    vv_mma::cp_async_commit();
    vv_mma::cp_async_wait<0>();
    for (int a = 0; a < resident; ++a) stage.finish_rows(q_res + a * SLOT);
    vv_mma::fence_proxy_async();
    vv_mma::mbarrier_arrive(q_full);
    // Item seq's chunks are loaded AHEAD items before its turn, so an item
    // waits for its slot, not for its loads (on an H100 2 ahead was faster
    // than 3, 4, 6, 8 or 12). Loads and stores each walk the items in order,
    // so each keeps its own (key tile, item) and divides nothing.
    int load_t = 0, load_i = 0, store_i = 0;
    auto load = [&](Chunks& in) {
      if (load_i < qk_items) {
        const int j = load_i - resident;  // items since the last resident atom's K
        const int a = j < 0 ? load_i : resident + (j >> 1);
        if (j >= 0 && (j & 1) == 0)
          stage.load_rows(in, q_head + a * ATOM, sq.n, row0, n, d - a * ATOM);
        else
          stage.load_rows(in, k_head + a * ATOM, sk.n, load_t * BK, n, d - a * ATOM);
      } else {
        const int col = c0 + (load_i - qk_items) * ATOM;
        stage.load_cols(in, col < d ? v_head + col : v_head, sv.n, load_t * BK, n, d - col);
      }
      if (++load_i == items) {
        load_i = 0;
        ++load_t;
      }
    };
    auto store = [&](const Chunks& in, int seq) {
      const int slot_i = seq % RING;
      const uint32_t slot = ring + slot_i * SLOT;
      vv_mma::mbarrier_wait(empty + 8 * slot_i, ((seq / RING) & 1) ^ 1);
      if (store_i < qk_items)
        stage.store_rows(slot, in);
      else
        stage.store_cols(slot, in);
      if (++store_i == items) store_i = 0;
      vv_mma::fence_proxy_async();
      vv_mma::mbarrier_arrive(full + 8 * slot_i);
    };
    const int total = tiles * items;
    Chunks ahead[AHEAD];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j)
      if (j < total) load(ahead[j]);
    for (int first = 0; first < total; first += AHEAD) {
#pragma unroll
      for (int j = 0; j < AHEAD; ++j) {
        const int seq = first + j;
        if (seq < total) {
          store(ahead[j], seq);
          if (seq + AHEAD < total) load(ahead[j]);
        }
      }
    }
    return;
  }

  // The consumer.
  vv_mma::mbarrier_wait(q_full, 0);
  auto take = [&](int seq) {
    const int slot_i = seq % RING;
    vv_mma::mbarrier_wait(full + 8 * slot_i, (seq / RING) & 1);
    return ring + slot_i * SLOT;
  };
  auto give = [&](int seq) { vv_mma::mbarrier_arrive(empty + 8 * (seq % RING)); };

  vv_mma::RowState<CW> st;
  st.init();
  const int quad = threadIdx.x & 3;
  int seq = 0;
  for (int t = 0; t < tiles; ++t) {
    // No mbarrier wait (a spin loop) and no run-time condition between the
    // wgmma of one group: ptxas would serialize every wgmma of the kernel
    // (C7520). So S is one group an atom, its slots taken before it and
    // handed back after it. (Two atoms a group, where their number is even,
    // was slower on an H100.)
    float s[BK / 2];
    for (int a = 0; a < atoms; ++a) {
      const bool restaged = a >= resident;
      const int q_seq = seq;
      if (restaged) ++seq;
      const int k_seq = seq++;
      const uint32_t q_addr = restaged ? take(q_seq) : q_res + a * SLOT;
      qk_atom(s, q_addr, take(k_seq), a > 0);
      if (restaged) give(q_seq);
      give(k_seq);
    }
    const int k0 = t * BK;
    vv_mma::softmax_step_with<CW>(
        s,
        [&](int j) {
          const int key = k0 + 8 * j + 2 * quad;
          return make_float2(vv_mma::key_bias(mask_row, key, n),
                             vv_mma::key_bias(mask_row, key + 1, n));
        },
        scale_log2, st);
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    split_weights(s, p_hi, p_lo);
    // P . V: the tile's V slots all taken, then every V atom's products as
    // one group.
    uint32_t v_addr[V_ATOMS];
#pragma unroll
    for (int j = 0; j < V_ATOMS; ++j) v_addr[j] = take(seq + j);
    fence_weights(st.o, p_hi, p_lo);
    pv_issue(vv_mma::columns<0, ATOM>(st.o), p_hi, p_lo, v_addr[0]);
    if constexpr (V_ATOMS > 1) pv_issue(vv_mma::columns<32, ATOM>(st.o), p_hi, p_lo, v_addr[1]);
    if constexpr (V_ATOMS > 2) pv_issue(vv_mma::columns<64, ATOM>(st.o), p_hi, p_lo, v_addr[2]);
    if constexpr (V_ATOMS > 3) pv_issue(vv_mma::columns<96, ATOM>(st.o), p_hi, p_lo, v_addr[3]);
    vv_mma::wgmma_commit();
    vv_mma::wgmma_wait<0>();
    vv_mma::fence_operands(st.o);
#pragma unroll
    for (int j = 0; j < V_ATOMS; ++j) give(seq + j);
    seq += V_ATOMS;
  }

  const long long pitch = (long long)heads * d;
  store_rows<CW>(st, out + ((long long)b * n + row0) * pitch + (long long)h * d + c0, pitch,
                 row0, n, d - c0);
}

// Column blocks that cover a head of width d: one up to 128 columns, else
// the fewest of at most 128, each the narrowest multiple of 32 that covers
// d / blocks.
inline int column_blocks(int d) { return (d + MAX_COLS - 1) / MAX_COLS; }
inline int block_width(int d) {
  const int blocks = column_blocks(d);
  const int cols = (d + blocks - 1) / blocks;
  return (cols + ATOM - 1) / ATOM * ATOM;
}
inline size_t smem_bytes(int d) {
  const int ring = ring_slots(d);
  return (size_t)(ring + resident_atoms(d)) * SLOT + (2 * ring + 1) * 8 + 1024;
}

template <int CW, int RING>
cudaError_t launch_cw(const float* q, const float* k, const float* v, const uint8_t* mask,
                      float* out, Strides sq, Strides sk, Strides sv, int b, int heads, int n,
                      int d, cudaStream_t stream) {
  auto kernel = attention_tf32_kernel<CW, RING>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + WG_ROWS - 1) / WG_ROWS, heads * column_blocks(d), b);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, mask, out, sq, sk, sv, n, heads, d,
                                          vv_mma::LOG2E / sqrtf((float)d), resident_atoms(d));
  return cudaGetLastError();
}

// float32 attention on strided q, k, v [b, heads, n, d] (d a multiple of 8
// up to MAX_D; 16-byte-aligned rows), output [b, n, heads, d].
inline cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                          void* out, Strides sq, Strides sk, Strides sv, int b, int heads,
                          int n, int d, cudaStream_t s) {
  if (d < 8 || d > MAX_D || d % 8 != 0) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  // The (block width, ring) pairs that occur for d = 8 .. 1024.
  switch (block_width(d) * 100 + ring_slots(d)) {
    case 3204:  return launch_cw<32, 4>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 6408:  return launch_cw<64, 8>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 9608:  return launch_cw<96, 8>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 9604:  return launch_cw<96, 4>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 12808: return launch_cw<128, 8>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 12806: return launch_cw<128, 6>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    case 12804: return launch_cw<128, 4>(qf, kf, vf, m, o, sq, sk, sv, b, heads, n, d, s);
    default:    return cudaErrorInvalidValue;
  }
}

}  // namespace vv_tf32
