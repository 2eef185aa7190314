// The tensor-core tile step shared by the bfloat16 paths of the package's
// attention kernels (flash_attention.cu, fused_rope_attention.cu).
// attention_strided.cuh runs it on strided q, k, v, and holds the kernel for
// head widths above 256, built from the pieces here; the float32 paths
// (attention_tf32.cuh) take its PTX wrappers, mbarriers and softmax step.
//
// One warpgroup (128 threads, four warps) owns 64 query rows and walks the
// key axis in tiles of BK = 64 keys. Both matrix products of a tile run on
// Hopper's tensor cores through wgmma (sm_90a only), with float32
// accumulators held in registers:
//
//   S = Q . K^T      A = the Q tile [64, D] and B = the K tile [BK, D], both
//                    read from shared memory. D is the contraction axis and
//                    is contiguous in both ("K-major"): nothing is
//                    transposed. D / 16 instructions m64n64k16.
//   softmax          on the accumulator fragments, in registers. A thread
//                    holds two rows (lane / 4 and lane / 4 + 8 of its warp's
//                    16) and pairs of neighbouring columns, so a row's max is
//                    two xor-shuffles inside the quad. Scale and key bias go
//                    on the float32 logits, folded with log2(e):
//                    p = exp2(s * scale * log2e + bias * log2e - m).
//   O += P . V       A = P from registers: the accumulator layout of S is the
//                    A-fragment layout of the next wgmma, 16 keys at a time,
//                    so pairs of p are rounded to bf16x2 and handed over with
//                    no trip through shared memory and no barrier. B = the V
//                    tile [BK, D] as it was loaded: its contraction axis
//                    (keys) is the row axis and D is contiguous ("MN-major"),
//                    which the instruction's trans-b bit reads in place.
//                    BK / 16 instructions m64n{D}k16, in pieces of at most
//                    128 output columns (D = 192: 128 + 64; 256: 128 + 128).
//
// Head widths. D is the tile's compile-time width: 32, 64, 128, 192 or 256.
// A head of true width d <= D (any multiple of 8) is served by the smallest
// such D: columns d..D of the Q, K and V tiles are zero-filled by the copies
// (as rows past the sequence end are), so they add nothing to Q . K^T, and
// P . V's extra output columns are computed on zeros and never stored. A
// width that is not a tile width costs the padding's flops: d 72 runs both
// products at 128, 1.78x its own.
//
// Rounding. p is rounded to bfloat16 for P . V (the tensor cores take no
// float32 operand at this rate), as the TPU kernels round it. The row sum l
// is taken in float32 from p before that rounding, as a float32 softmax
// would take it. m, l and the output accumulator stay float32.
//
// Shared-memory layout of a [64, D] bf16 tile, the one a wgmma matrix
// descriptor describes with a swizzle: columns are cut into atoms of 64
// elements (128 bytes; 32 elements = 64 bytes at D = 32); the tile is stored
// atom column by atom column, each a dense [64] x 128-byte (64-byte) array,
// and inside it the 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// (c ^ ((r / 2) % 4) for 64-byte rows). That is the hardware's 128-byte
// (64-byte) swizzle; it spreads the eight rows of a core matrix over all
// banks. The same bytes serve as K-major operand (Q, K) and as MN-major
// operand (V). Tiles start on 1024-byte boundaries.
//
// Padding. K and V rows past the sequence end must be zeros in shared memory
// (cp_async_16 zero-fills), never stale data: 0 x NaN is NaN. bias holds 0
// for a valid key, PAD_BIAS * log2e for a padded one and -inf past the end;
// the first tile always holds key 0, whose logit is finite, so the running
// max is finite from the first tile on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vv_mma {

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // query rows per warpgroup
constexpr int BK = 64;           // keys per shared-memory tile
constexpr int TILE_ROWS = 64;    // rows of every shared-memory tile (Q, K, V)
static_assert(WG_ROWS == TILE_ROWS && BK == TILE_ROWS, "one tile shape for Q, K and V");
constexpr float PAD_BIAS = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Batch, head and frame strides of one operand, in elements.
struct Strides {
  long long b, h, n;
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (source size
// 0: nothing is read, src only has to be an address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// wgmma reads shared memory through the asynchronous proxy: a thread's own
// writes (st.shared, completed cp.async) are ordered before it by this fence,
// and a barrier then publishes them to the other threads' wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and named barriers: hand-over of tiles between warpgroups
// that run different code (a producer and consumers), with no block-wide
// barrier. An mbarrier is 8 bytes of shared memory; `bar` is its address.

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(arrivals) : "memory");
}
// Makes the initialized barriers visible; follow with a block-wide barrier.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Release: what this thread wrote before is visible to a thread that waits.
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Waits until the barrier's phase of the given parity has completed. A
// barrier that has completed no phase yet counts as having completed one of
// parity 1. A wait that sees no progress for seconds traps: a fault in the
// hand-over then fails the launch and cannot hang the card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}
// Barrier `id` (1..15; 0 is __syncthreads) among `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Orders this thread's register writes (accumulators, A fragments) before
// the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving a use of a register that an in-flight
// wgmma owns across the fence or wait beside which this is placed.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}
template <typename T, int N>
__device__ __forceinline__ void fence_operands(T (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(x[i]);
}

// 2^x on the special-function unit (ex2.approx: relative error 2^-22, far
// below the bf16 rounding the weights get; -inf gives 0). exp2f() wraps the
// same instruction in range handling that a softmax does not need.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the tile layout and its descriptors ----------------------------------

template <int D>
struct TileLayout {
  static_assert(D == 32 || D % 64 == 0, "head_dim 32 or a multiple of 64");
  static constexpr int ATOM_ELEMS = D >= 64 ? 64 : 32;      // columns per atom
  static constexpr int ATOM_BYTES = ATOM_ELEMS * 2;         // 128 or 64
  static constexpr int ATOM_CHUNKS = ATOM_BYTES / 16;       // 8 or 4
  static constexpr int ROW_CHUNKS = D / 8;                  // 16-byte chunks per row
  static constexpr uint32_t SWIZZLE = D >= 64 ? 1u : 2u;    // descriptor layout type
  static constexpr uint32_t GROUP_BYTES = 8 * ATOM_BYTES;   // eight rows of an atom column

  static constexpr uint32_t ATOM_COLUMN_BYTES = TILE_ROWS * ATOM_BYTES;
  static constexpr uint32_t BYTES = TILE_ROWS * D * 2;      // one tile

  // Byte offset of the 16-byte chunk holding columns [8 * chunk, 8 * chunk + 8)
  // of row r.
  __device__ static __forceinline__ uint32_t offset(int r, int chunk) {
    const int atom = chunk / ATOM_CHUNKS;
    const int c = chunk % ATOM_CHUNKS;
    const int x = D >= 64 ? (r & 7) : ((r >> 1) & 3);
    return static_cast<uint32_t>(atom * ATOM_COLUMN_BYTES + r * ATOM_BYTES + ((c ^ x) << 4));
  }
};

// A thread's part in copying [64, D] tiles from global memory with NT
// threads. A sweep covers SWEEP columns of all 64 rows: the whole row where
// the NT threads divide its 16-byte chunks, else one atom at a time (D =
// 192). In a sweep a thread copies the same chunk column of rows row,
// row + ROWS_PER_PASS, ... The passes are a multiple of eight rows apart, so
// the swizzle term of the offset is the same in every pass and all
// addressing is done once.
template <int D, int NT>
struct TileCopier {
  using L = TileLayout<D>;
  static constexpr int SWEEP = NT % L::ROW_CHUNKS == 0 ? D : L::ATOM_ELEMS;
  static constexpr int SWEEPS = D / SWEEP;
  static constexpr int SWEEP_CHUNKS = SWEEP / 8;
  static constexpr uint32_t SWEEP_BYTES = (SWEEP / L::ATOM_ELEMS) * L::ATOM_COLUMN_BYTES;
  static constexpr int ROWS_PER_PASS = NT / SWEEP_CHUNKS;
  static constexpr int PASSES = TILE_ROWS / ROWS_PER_PASS;
  static_assert(NT % SWEEP_CHUNKS == 0 && ROWS_PER_PASS % 8 == 0 &&
                TILE_ROWS % ROWS_PER_PASS == 0, "whole passes of whole row groups");
  int row;          // this thread's row in the first pass
  int col;          // first column of its chunk in the first sweep
  uint32_t offset;  // of that chunk in the tile
  // t: this thread's index among the NT that copy.
  __device__ __forceinline__ explicit TileCopier(int t)
      : row(t / SWEEP_CHUNKS),
        col(8 * (t % SWEEP_CHUNKS)),
        offset(L::offset(t / SWEEP_CHUNKS, t % SWEEP_CHUNKS)) {}

  // Starts the copy of rows r0 .. r0 + 63 of a head's operand (row i at
  // src + i * pitch, in elements) into the tile at dst; rows >= n and
  // columns >= cols (a multiple of 8) are zero-filled.
  __device__ __forceinline__ void copy(uint32_t dst, const __nv_bfloat16* src,
                                       long long pitch, int r0, int n, int cols = D) const {
    const __nv_bfloat16* from = src + (r0 + row) * pitch + col;
#pragma unroll
    for (int w = 0; w < SWEEPS; ++w) {
      const bool col_valid = col + w * SWEEP < cols;
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        const bool valid = col_valid && r0 + row + i * ROWS_PER_PASS < n;
        cp_async_16(dst + offset + w * SWEEP_BYTES + i * ROWS_PER_PASS * L::ATOM_BYTES,
                    valid ? from + w * SWEEP + i * ROWS_PER_PASS * pitch : src, valid);
      }
    }
  }
};

// The 64-bit shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t leading_bytes,
                                              uint32_t stride_bytes, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// Slice kk (16 columns) of a K-major tile at `addr`, for
// either operand of S = Q . K^T. With a swizzle the leading offset is not
// used; the stride offset steps from one group of eight rows to the next.
// Inside an atom a slice is 32 bytes further on.
template <int D>
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr, int kk) {
  using L = TileLayout<D>;
  const int atom = (kk * 16) / L::ATOM_ELEMS;
  const int within = (kk * 32) % L::ATOM_BYTES;
  return make_desc(addr + atom * L::ATOM_COLUMN_BYTES + within, 16, L::GROUP_BYTES,
                   L::SWIZZLE);
}

// Keys [16 * kk, 16 * kk + 16) of the V tile [BK, D] at `addr` as the
// MN-major B operand of O += P . V: the stride offset steps from one group of
// eight keys to the next, the leading offset from one atom column (64 output
// columns) to the next.
template <int D>
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, int kk) {
  using L = TileLayout<D>;
  return make_desc(addr + kk * 16 * L::ATOM_BYTES, L::ATOM_COLUMN_BYTES, L::GROUP_BYTES,
                   L::SWIZZLE);
}

// ---- wgmma, one wrapper per instruction shape -----------------------------

// d[32] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
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

// d[16] += A[64 x 16] (register fragments) . B[16 x 32], B MN-major in shared
// memory (the trans-b bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A[64 x 16] (register fragments) . B[16 x 64], B MN-major in shared
// memory (the trans-b bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += A[64 x 16] (register fragments) . B[16 x 128], B MN-major in shared
// memory (the trans-b bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 32 || N == 64 || N == 128, "output widths with a wrapper");
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (N == 128) wgmma_rs_n128(d, a, desc_b);
}

// Output columns [FIRST, FIRST + N) of an accumulator in the layout of a
// wider one: a thread's part of them is a contiguous run of N / 2 floats.
template <int FIRST, int N, int M>
__device__ __forceinline__ float (&columns(float (&o)[M]))[N / 2] {
  static_assert(FIRST % 8 == 0 && FIRST / 2 + N / 2 <= M, "columns inside the accumulator");
  return *reinterpret_cast<float(*)[N / 2]>(&o[FIRST / 2]);
}

// ---- the two products -----------------------------------------------------

// s = Q . K^T for this warpgroup's 64 rows (Q tile at q_addr) and
// the BK keys of the tile at k_addr. Starts the wgmma, commits and waits.
// Every slice is issued, the zero columns past a head's width too: a wgmma
// under a run-time condition makes ptxas fence the registers of every
// product before it (warning C7519).
template <int D>
__device__ __forceinline__ void qk_product(uint32_t q_addr, uint32_t k_addr,
                                           float (&s)[BK / 2]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, k_major_desc<D>(q_addr, kk), k_major_desc<D>(k_addr, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
}

// Rounds the weights in s (accumulator layout) to the bf16x2 A fragments of
// the next product, 16 keys to a fragment.
__device__ __forceinline__ void pack_weights(const float (&s)[BK / 2],
                                             uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      p[kk][i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
}

// o += P . V with the V tile at v_addr. Starts and commits; the caller waits
// (wgmma_wait<0>, then fence_operands(o)) before it touches o or overwrites
// the tile.
template <int D>
__device__ __forceinline__ void pv_product(uint32_t (&p)[BK / 16][4], uint32_t v_addr,
                                           float (&o)[D / 2]) {
  fence_operands(o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) fence_operands(p[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (D <= 128) {
      wgmma_rs<D>(o, p[kk], mn_major_desc<D>(v_addr, kk));
    } else {
      // Columns 0..127 (atoms 0 and 1), then the rest from atom 2 on.
      wgmma_rs<128>(columns<0, 128>(o), p[kk], mn_major_desc<D>(v_addr, kk));
      wgmma_rs<D - 128>(columns<128, D - 128>(o), p[kk],
                        mn_major_desc<D>(v_addr + 2 * TileLayout<D>::ATOM_COLUMN_BYTES, kk));
    }
  }
  wgmma_commit();
}

// ---- online softmax on the accumulator fragments --------------------------

// Running state of a thread's two query rows: row (lane / 4) of its warp's
// 16 at index 0, that row + 8 at index 1.
template <int D>
struct RowState {
  float m[2];      // running max of the logits (log2 domain)
  float l[2];      // this thread's share of the running sum of p (float32 p)
  float o[D / 2];  // unnormalized output, accumulator layout
  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }
};

// Turns the raw products in s into weights p = exp2(logit - m_new) in place,
// updates m and l and rescales o. bias_pair(j) gives the key biases (log2
// domain) of this thread's two columns 8 j + 2 (lane % 4) and the next. No
// wgmma may be in flight on st.o.
template <int D, typename BiasPair>
__device__ __forceinline__ void softmax_step_with(float (&s)[BK / 2], BiasPair bias_pair,
                                                  float scale_log2, RowState<D>& st) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 bj = bias_pair(j);
    s[4 * j + 0] = fmaf(s[4 * j + 0], scale_log2, bj.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, bj.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, bj.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, bj.y);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float alpha = fast_exp2(st.m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = fast_exp2(s[4 * j + 2 * h] - m_new);
      const float p1 = fast_exp2(s[4 * j + 2 * h + 1] - m_new);
      s[4 * j + 2 * h] = p0;
      s[4 * j + 2 * h + 1] = p1;
      sum += p0 + p1;
    }
    st.m[h] = m_new;
    st.l[h] = st.l[h] * alpha + sum;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      st.o[4 * c + 2 * h] *= alpha;
      st.o[4 * c + 2 * h + 1] *= alpha;
    }
  }
}

// The same with the tile's BK key biases in shared memory at bias.
template <int D>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], const float* bias,
                                             float scale_log2, RowState<D>& st) {
  const int quad = threadIdx.x & 3;
  softmax_step_with<D>(
      s, [&](int j) { return *reinterpret_cast<const float2*>(bias + 8 * j + 2 * quad); },
      scale_log2, st);
}

// One staged key tile: both products around the softmax step. The caller
// has published the tile (fence_proxy_async, barrier) and does not overwrite
// it before its next barrier.
template <int D>
__device__ __forceinline__ void tile_step(uint32_t q_addr, uint32_t k_addr, uint32_t v_addr,
                                          const float* bias, float scale_log2,
                                          RowState<D>& st) {
  float s[BK / 2];
  qk_product<D>(q_addr, k_addr, s);
  softmax_step<D>(s, bias, scale_log2, st);
  uint32_t p[BK / 16][4];
  pack_weights(s, p);
  pv_product<D>(p, v_addr, st.o);
  wgmma_wait<0>();
  fence_operands(st.o);
}

// Normalizes and stores a warpgroup's rows: row0 is the sequence row of the
// warpgroup's first query, dst the address of that row's first output column
// and pitch the distance between rows, in elements. Rows >= n and columns
// >= cols (a multiple of 8) are not stored.
template <int D>
__device__ __forceinline__ void store_output(RowState<D>& st, __nv_bfloat16* dst,
                                             long long pitch, int row0, int n, int cols = D) {
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
      __nv_bfloat16* out_row = dst + row * pitch + 2 * quad;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        if (8 * c < cols)
          *reinterpret_cast<__nv_bfloat162*>(out_row + 8 * c) = __floats2bfloat162_rn(
              st.o[4 * c + 2 * h] * inv, st.o[4 * c + 2 * h + 1] * inv);
    }
  }
}

// Key bias of one key in the log2 domain.
__device__ __forceinline__ float key_bias(const uint8_t* mask_row, int key, int n) {
  if (key >= n) return -INFINITY;
  return (mask_row == nullptr || mask_row[key]) ? 0.f : PAD_BIAS * LOG2E;
}

}  // namespace vv_mma
