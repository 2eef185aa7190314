// Fused RoPE attention read straight from the packed QKV projection.
//
// Replaces the Pallas TPU kernel fused_qkv_rope_attention
// (vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123, bodies _kernel
// :89 and _kernel_pair :96). Same function: for batch b and head h, q is read
// at column h*D of qkv [B, N, 3*H*D], k at (H+h)*D and v at (2H+h)*D; the
// half-split (NeoX) RoPE is applied to q and k on load, the logits are scaled
// by 1/sqrt(D), keys are biased by 0 (valid) or -1e30 (padding), and the
// softmax runs over the full key axis. The output [B, N, H*D] is written at
// column h*D, so the DiT's out-projection reads it with no transpose.
//
// What bounds it on an H100: at serving shapes (N = 256..2048, D = 128) the
// two products are 4*B*H*N^2*D flops against 3*B*N*H*D*2 bytes of input,
// i.e. hundreds of flops per byte: operations, not bytes.
//
// Head widths: D = 64 and every multiple of 128 up to 1024, the TPU kernel's
// (its D % 128 == 0 one head per grid cell, its D = 64 head pairs) up to the
// width whose Q rows still fit in shared memory (attention_strided.cuh).
//
// Two variants, chosen from (dtype, head_dim) alone:
//
// "wgmma": bfloat16 (the serving type). At D = 64 and 128 both products run
//   on the tensor cores (attention_mma.cuh says how). A block is three
//   warpgroups, 384 threads, for 128 query rows: two consumers, 64 query
//   rows each, which do nothing but the two products and the softmax, and
//   one producer, which feeds them key tiles through a ring of four stages.
//   RoPE cannot ride on an asynchronous copy, so the producer's threads load
//   the raw halves of k (columns c and c + D/2, 16 bytes each) with their cos
//   and sin, rotate in float32, round once to bfloat16 (the bits the plain
//   version's k carries) and store into the layout the wgmma descriptors
//   read; V goes beside it by cp.async as it lies. Each consumer rotates its
//   own 64 query rows the same way, once. Stages change hands through
//   mbarriers (full: the producer's 128 threads have written; empty: the
//   consumers' 256 threads have read), so there is no block-wide barrier in
//   the loop, the consumers drift apart and one's softmax runs under the
//   other's products, and the rotation, which every block repeats for all N
//   keys of its head, is off the consumers' path. Both consumers share every
//   rotated tile: 128-row blocks halve the rotation and the shared-memory
//   traffic against 64-row ones. Measured against the same kernel without
//   the producer (two warpgroups that also rotate, one barrier a tile): 9-14%
//   faster at every 8 x 128 shape, 17% at (2; 512, 16 x 64), 7% slower at
//   (16; 1024, 16 x 64) (H100, 700 W). 1/sqrt(D) is applied to the float32
//   logits, not folded into q: 1/sqrt(128) is no power of two, and a scaled q
//   would not be a bfloat16 number. The weights are rounded to bfloat16 for
//   P . V, as the TPU kernel rounds them.
//
// "tf32x3": float32, at every width in two passes (below). The attention
//   pass runs both products on the tensor cores in split TF32
//   (attention_tf32.cuh: each operand split into two TF32 parts, three
//   products, float32 accumulation and softmax). 1/sqrt(D) is applied to the
//   float32 logits.
//
// Two passes: bfloat16 from D = 256, float32 at every D. The first
//   (rope_bf16_kernel, rope_f32_kernel) rotates q and k of every head once,
//   in float32, each product and the sum rounded as separate PyTorch
//   operations round them, then once to the input type (so the same bits as
//   the producer above and the plain version) and writes them to a scratch
//   buffer [2, B, N, H, D] that the wrapper allocates. The second is
//   attention on the rotated q and k and on v where it lies in qkv:
//   flash_attention.cu's own (bf16: attention_strided.cuh, at D = 256 the
//   tile step at width 256, two warpgroups of 64 query rows; above, 64-row
//   blocks, one per column block of at most 256 output columns, Q resident,
//   K and V streamed through a ring; float32: attention_tf32.cuh). Why not
//   rotate inside the tile loop as the bf16 kernel does at D <= 128: RoPE
//   pairs column c with c + D/2, so a streamed chunk of K would have to be
//   built from two distant column ranges, and every query block (and every
//   column block) would rotate all N keys again; a row rotated once costs
//   one extra write and read of q and k (2 x 2 x B*N*H*D elements, in L2 at
//   serving shapes) and none of that. In float32 the split into TF32 parts
//   happens in the attention pass's producer, so a rotating producer there
//   would also have to split: the one pass over the scratch is what float32
//   pays for keeping one float32 attention for both kernels.
//
// Design, both variants. The TPU kernel held all N keys of a head in VMEM and
// ran a two-pass exact softmax; shared memory here holds 64 keys at a time,
// so a block walks the key axis in 64-key tiles with an online softmax
// (running max and sum, rescaling the accumulator), which computes the same
// function within rounding. Ragged N is masked in-kernel: keys past N get
// -inf (no weight at all), query rows past N are computed on zeros and not
// stored. The TPU kernel's head-pair layout for D = 64 was a lane-tiling
// device of the TPU and is not needed: D is a template parameter. No atomics
// and no split over keys across blocks: the same inputs give the same bits.

#include <algorithm>

#include "attention_mma.cuh"
#include "attention_strided.cuh"
#include "attention_tf32.cuh"

namespace {

using vv_mma::Strides;

// ---- the tensor-core variant (bfloat16) ------------------------------------

namespace mma = vv_mma;

constexpr int MMA_CONSUMERS = 2;  // consumer warpgroups, 64 query rows each
constexpr int MMA_THREADS = (MMA_CONSUMERS + 1) * mma::WG_THREADS;  // + the producer
constexpr int MMA_BQ = MMA_CONSUMERS * mma::WG_ROWS;                // queries per block
constexpr int MMA_STAGES = 4;                                       // K/V tiles in the ring

// Shared memory of one block: the Q tiles (one per consumer), a ring of
// K tiles, V tiles and key biases, and two mbarriers per stage; 1024 bytes of
// slack to start on a 1024-byte boundary.
template <int D>
struct MmaSmem {
  static constexpr uint32_t TILE = mma::TileLayout<D>::BYTES;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + MMA_CONSUMERS * TILE;
  static constexpr uint32_t V = K + MMA_STAGES * TILE;
  static constexpr uint32_t BIAS = V + MMA_STAGES * TILE;
  static constexpr uint32_t FULL = BIAS + MMA_STAGES * mma::BK * sizeof(float);
  static constexpr uint32_t EMPTY = FULL + MMA_STAGES * 8;
  static constexpr size_t BYTES = EMPTY + MMA_STAGES * 8 + 1024;
};

// x * cos + rotate_half(x) * sin with (x1, x2) -> (-x2, x1) on two
// neighbouring bf16 columns of the low half (x1) and of the high half (x2):
// each product and the sum rounded to float32 as separate PyTorch operations
// round them, then once to bfloat16.
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void rotate_word(uint32_t x1, uint32_t x2, uint32_t c1, uint32_t c2,
                                            uint32_t s1, uint32_t s2, uint32_t& out1,
                                            uint32_t& out2) {
  const float2 a = unpack_bf16x2(x1), b = unpack_bf16x2(x2);
  const float2 ca = unpack_bf16x2(c1), cb = unpack_bf16x2(c2);
  const float2 sa = unpack_bf16x2(s1), sb = unpack_bf16x2(s2);
  out1 = pack_bf16x2(__fadd_rn(__fmul_rn(a.x, ca.x), __fmul_rn(-b.x, sa.x)),
                     __fadd_rn(__fmul_rn(a.y, ca.y), __fmul_rn(-b.y, sa.y)));
  out2 = pack_bf16x2(__fadd_rn(__fmul_rn(b.x, cb.x), __fmul_rn(a.x, sb.x)),
                     __fadd_rn(__fmul_rn(b.y, cb.y), __fmul_rn(a.y, sb.y)));
}

// Eight columns c .. c + 7 and their partners c + D/2 .. of one row.
__device__ __forceinline__ void rotate_chunk(uint4 x1, uint4 x2, uint4 c1, uint4 c2, uint4 s1,
                                             uint4 s2, uint4& lo, uint4& hi) {
  rotate_word(x1.x, x2.x, c1.x, c2.x, s1.x, s2.x, lo.x, hi.x);
  rotate_word(x1.y, x2.y, c1.y, c2.y, s1.y, s2.y, lo.y, hi.y);
  rotate_word(x1.z, x2.z, c1.z, c2.z, s1.z, s2.z, lo.z, hi.z);
  rotate_word(x1.w, x2.w, c1.w, c2.w, s1.w, s2.w, lo.w, hi.w);
}

// A warpgroup thread's share of a batch of raw rows of q or k: two pairs of
// 16-byte chunks, columns [8c, 8c + 8) and the same D/2 further on, with
// their cos and sin (24 registers a pair). Pair p of a batch is row
// p / (D/16), chunk p % (D/16); a batch is 256 pairs, i.e. ROWS rows (32 at
// D = 128, 64 at D = 64), and a tile of 64 rows is BATCHES of them.
template <int D>
struct RawRows {
  static constexpr int PAIRS_PER_ROW = D / 16;
  static constexpr int PAIRS = 2;
  static constexpr int ROWS = PAIRS * mma::WG_THREADS / PAIRS_PER_ROW;
  static constexpr int BATCHES = mma::TILE_ROWS / ROWS;
  static_assert(ROWS * BATCHES == mma::TILE_ROWS, "whole batches in a tile");
  uint4 x[PAIRS][2], cos[PAIRS][2], sin[PAIRS][2];

  // Rows r0 .. r0 + ROWS - 1 of the sequence, by thread t of the warpgroup;
  // src is the head's column 0 of row 0 and pitch the distance between rows,
  // in elements. Rows >= n load nothing and rotate to zeros.
  __device__ __forceinline__ void load(int t, const __nv_bfloat16* __restrict__ src,
                                       long long pitch,
                                       const __nv_bfloat16* __restrict__ cos_t,
                                       const __nv_bfloat16* __restrict__ sin_t, int r0,
                                       int n) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = t + i * mma::WG_THREADS;
      const int row = r0 + p / PAIRS_PER_ROW;
      const int col = 8 * (p % PAIRS_PER_ROW);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = col + half * (D / 2);
        if (row < n) {
          x[i][half] = __ldg(reinterpret_cast<const uint4*>(src + row * pitch + c));
          cos[i][half] = __ldg(reinterpret_cast<const uint4*>(cos_t + (long long)row * D + c));
          sin[i][half] = __ldg(reinterpret_cast<const uint4*>(sin_t + (long long)row * D + c));
        } else {
          x[i][half] = cos[i][half] = sin[i][half] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }

  // x * cos + rotate_half(x) * sin (rotate_word), stored as rows
  // first_row .. of the tile at `tile`.
  __device__ __forceinline__ void rotate_and_store(int t, uint32_t tile, int first_row) const {
    using L = mma::TileLayout<D>;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = t + i * mma::WG_THREADS;
      const int r = first_row + p / PAIRS_PER_ROW;
      const int chunk = p % PAIRS_PER_ROW;
      uint4 lo, hi;
      rotate_chunk(x[i][0], x[i][1], cos[i][0], cos[i][1], sin[i][0], sin[i][1], lo, hi);
      mma::st_shared_16(tile + L::offset(r, chunk), lo);
      mma::st_shared_16(tile + L::offset(r, chunk + PAIRS_PER_ROW), hi);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
fused_rope_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ cos_t,
                                const __nv_bfloat16* __restrict__ sin_t,
                                const uint8_t* __restrict__ mask,
                                __nv_bfloat16* __restrict__ out,
                                int n, int heads, float scale_log2) {
  using S = MmaSmem<D>;
  using Raw = RawRows<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias = reinterpret_cast<float*>(smem_raw + (base - raw) + S::BIAS);

  const int wg = threadIdx.x / mma::WG_THREADS;
  const int t_wg = threadIdx.x % mma::WG_THREADS;  // index within the warpgroup
  const int q0 = blockIdx.x * MMA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long pitch = 3LL * heads * D;
  const __nv_bfloat16* rows = qkv + (long long)b * n * pitch;
  const __nv_bfloat16* q_head = rows + h * D;
  const __nv_bfloat16* k_head = rows + (heads + h) * D;
  const __nv_bfloat16* v_head = rows + (2 * heads + h) * D;
  const uint8_t* mask_row = mask + (long long)b * n;
  const int tiles = (n + mma::BK - 1) / mma::BK;

  // full[s]: the producer's 128 threads have written stage s. empty[s]: the
  // consumers' 256 threads are done reading it.
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < MMA_STAGES; ++s) {
      mma::mbarrier_init(base + S::FULL + 8 * s, mma::WG_THREADS);
      mma::mbarrier_init(base + S::EMPTY + 8 * s, MMA_CONSUMERS * mma::WG_THREADS);
    }
    mma::fence_mbarrier_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (wg == MMA_CONSUMERS) {
    // The producer: for each key tile, rotate K into the ring, copy V beside
    // it, write the key biases, and hand the stage over. The raw K is loaded
    // before the wait for the stage, so the loads are in flight while the
    // consumers still read what the stage held. (Loading half a tile further
    // ahead was tried and was slower, 0.34 against 0.27 ms at B = 16,
    // N = 1024, 8 heads of 128 on an H100: it needs more registers than the
    // 168 a thread of a 384-thread block can have.)
    const mma::TileCopier<D, mma::WG_THREADS> copier(t_wg);
    for (int t = 0; t < tiles; ++t) {
      const int stage = t % MMA_STAGES;
      const uint32_t phase = (t / MMA_STAGES) & 1;
      Raw raw_k[Raw::BATCHES];
#pragma unroll
      for (int i = 0; i < Raw::BATCHES; ++i)
        raw_k[i].load(t_wg, k_head, pitch, cos_t, sin_t, t * mma::BK + i * Raw::ROWS, n);
      mma::mbarrier_wait(base + S::EMPTY + 8 * stage, phase ^ 1);
      copier.copy(base + S::V + stage * S::TILE, v_head, pitch, t * mma::BK, n);
      mma::cp_async_commit();
      if (t_wg < mma::BK)
        bias[stage * mma::BK + t_wg] = mma::key_bias(mask_row, t * mma::BK + t_wg, n);
#pragma unroll
      for (int i = 0; i < Raw::BATCHES; ++i)
        raw_k[i].rotate_and_store(t_wg, base + S::K + stage * S::TILE, i * Raw::ROWS);
      mma::cp_async_wait<0>();
      mma::fence_proxy_async();
      mma::mbarrier_arrive(base + S::FULL + 8 * stage);
    }
    return;
  }

  // A consumer: rotate this warpgroup's 64 query rows into its Q tile, then
  // take the key tiles as they are handed over.
  const int row0 = q0 + wg * mma::WG_ROWS;
  const uint32_t q_addr = base + S::Q + wg * S::TILE;
  {
    Raw raw_q;
#pragma unroll
    for (int i = 0; i < Raw::BATCHES; ++i) {
      raw_q.load(t_wg, q_head, pitch, cos_t, sin_t, row0 + i * Raw::ROWS, n);
      raw_q.rotate_and_store(t_wg, q_addr, i * Raw::ROWS);
    }
  }
  mma::fence_proxy_async();
  mma::named_barrier(1 + wg, mma::WG_THREADS);  // the Q tile is this warpgroup's alone

  mma::RowState<D> st;
  st.init();
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % MMA_STAGES;
    const uint32_t phase = (t / MMA_STAGES) & 1;
    mma::mbarrier_wait(base + S::FULL + 8 * stage, phase);
    mma::tile_step<D>(q_addr, base + S::K + stage * S::TILE, base + S::V + stage * S::TILE,
                      bias + stage * mma::BK, scale_log2, st);
    mma::mbarrier_arrive(base + S::EMPTY + 8 * stage);
  }

  const long long out_pitch = (long long)heads * D;
  mma::store_output<D>(st, out + ((long long)b * n + row0) * out_pitch + h * D, out_pitch,
                       row0, n);
}

template <int D>
cudaError_t launch_mma(const void* qkv, const void* cos_t, const void* sin_t,
                       const void* mask, void* out, int b, int n, int heads,
                       cudaStream_t stream) {
  auto kernel = fused_rope_attention_mma_kernel<D>;
  constexpr size_t smem = MmaSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + MMA_BQ - 1) / MMA_BQ, heads, b);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const __nv_bfloat16*>(sin_t), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), n, heads, mma::LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

// ---- two passes: RoPE once, then flash_attention.cu's attention -----------

constexpr int ROPE_THREADS = 256;

// rot[w, b, i, h, :] = RoPE(q (w = 0) or k (w = 1) of head h at row i of
// batch b). bfloat16: one thread per pair of 16-byte chunks (columns c .. c+7
// and c + D/2 ..), rotated as the producer above rotates them.
__global__ void __launch_bounds__(ROPE_THREADS)
rope_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ cos_t,
                 const __nv_bfloat16* __restrict__ sin_t, __nv_bfloat16* __restrict__ rot,
                 int b, int n, int heads, int d) {
  const int pairs = d / 16;
  const long long total = 2LL * b * n * heads * pairs;
  for (long long i = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * ROPE_THREADS) {
    const int c = 8 * (int)(i % pairs);
    long long r = i / pairs;  // ((w * b + bb) * n + row) * heads + h
    const int h = (int)(r % heads);
    const long long w_row = r / heads;  // (w * b + bb) * n + row
    const int row = (int)(w_row % n);
    const long long w_b = w_row / n;
    const int bb = (int)(w_b % b);
    const int w = (int)(w_b / b);
    const __nv_bfloat16* src = qkv + ((long long)bb * n + row) * 3 * heads * d + (w * heads + h) * d;
    const long long t = (long long)row * d + c;
    uint4 lo, hi;
    rotate_chunk(__ldg(reinterpret_cast<const uint4*>(src + c)),
                 __ldg(reinterpret_cast<const uint4*>(src + c + d / 2)),
                 __ldg(reinterpret_cast<const uint4*>(cos_t + t)),
                 __ldg(reinterpret_cast<const uint4*>(cos_t + t + d / 2)),
                 __ldg(reinterpret_cast<const uint4*>(sin_t + t)),
                 __ldg(reinterpret_cast<const uint4*>(sin_t + t + d / 2)), lo, hi);
    __nv_bfloat16* dst = rot + r * d;
    *reinterpret_cast<uint4*>(dst + c) = lo;
    *reinterpret_cast<uint4*>(dst + c + d / 2) = hi;
  }
}

// float32: one thread per element; grid (b * n rows, column blocks of
// heads * d, q or k), so a thread's indices are one division each.
__global__ void __launch_bounds__(ROPE_THREADS)
rope_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, float* __restrict__ rot, int b, int n,
                int heads, int d) {
  const int hd = heads * d;
  const int col = blockIdx.y * ROPE_THREADS + threadIdx.x;  // h * d + c
  if (col >= hd) return;
  const int row = blockIdx.x;  // bb * n + i
  const int w = blockIdx.z;    // 0: q, 1: k
  const int c = col % d;
  const int half = d / 2;
  const float* src = qkv + (long long)row * 3 * hd + w * hd + col;
  const float x = src[0];
  const float partner = src[c < half ? half : -half];
  const float rotated = c < half ? -partner : partner;
  const long long t = (long long)(row % n) * d + c;
  // Rounded as x * cos + rotate_half(x) * sin rounds in PyTorch: each
  // product, then the sum (nvcc would contract them into an FMA).
  rot[((long long)w * b * n + row) * hd + col] =
      __fadd_rn(__fmul_rn(x, cos_t[t]), __fmul_rn(rotated, sin_t[t]));
}

// Pass 1 into scratch [2, b, n, heads, d], pass 2 on it.
template <typename T>
cudaError_t launch_two_passes(const void* qkv, const void* cos_t, const void* sin_t,
                              const void* mask, void* out, void* scratch, int b, int n,
                              int heads, int d, cudaStream_t stream) {
  const T* src = static_cast<const T*>(qkv);
  T* rot = static_cast<T*>(scratch);
  if constexpr (sizeof(T) == 2) {
    const long long work = 2LL * b * n * heads * (d / 16);
    const int blocks =
        (int)std::min<long long>((work + ROPE_THREADS - 1) / ROPE_THREADS, 132 * 16);
    rope_bf16_kernel<<<blocks, ROPE_THREADS, 0, stream>>>(
        src, static_cast<const T*>(cos_t), static_cast<const T*>(sin_t), rot, b, n, heads, d);
  } else {
    if ((long long)b * n > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(b * n, (heads * d + ROPE_THREADS - 1) / ROPE_THREADS, 2);
    rope_f32_kernel<<<grid, ROPE_THREADS, 0, stream>>>(
        src, static_cast<const T*>(cos_t), static_cast<const T*>(sin_t), rot, b, n, heads, d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long row = (long long)heads * d;  // rotated rows: [.., n, heads, d]
  const Strides s_rot{(long long)n * row, d, row};
  const Strides s_v{3LL * n * row, d, 3 * row};
  const T* q_rot = rot;
  const T* k_rot = rot + (long long)b * n * row;
  const T* v = src + 2 * row;
  if constexpr (sizeof(T) == 2)
    return mma::launch_strided(q_rot, k_rot, v, mask, out, s_rot, s_rot, s_v, b, heads, n, d,
                               stream);
  else
    return vv_tf32::launch(q_rot, k_rot, v, mask, out, s_rot, s_rot, s_v, b, heads, n, d,
                           stream);
}

}  // namespace

// The variant that serves (head_dim, dtype; 0 = float32, 1 = bfloat16):
// 1 = "wgmma", 2 = "tf32x3", -1 = no kernel. head_dim 64, or a multiple of
// 128 up to 1024.
extern "C" int vv_fused_rope_attention_variant(int head_dim, int dtype) {
  const bool served = head_dim == 64 ||
                      (head_dim % 128 == 0 && head_dim >= 128 && head_dim <= mma::WIDE_MAX_D);
  if ((dtype != 0 && dtype != 1) || !served) return -1;
  return dtype == 1 ? 1 : 2;
}

// dtype: 0 = float32, 1 = bfloat16. qkv [b, n, 3*heads*head_dim], cos/sin
// [n, head_dim] in the same dtype, mask [b, n] uint8 (nonzero = valid key),
// out [b, n, heads*head_dim]; all contiguous on the current device. scratch:
// in float32, and in bfloat16 for head_dim >= 256, room for
// [2, b, n, heads, head_dim] elements of the dtype (the rotated q and k),
// else unused (may be null). Both variants need qkv and scratch on 16-byte
// boundaries, bfloat16 also cos and sin (cudaErrorMisalignedAddress
// otherwise).
// Returns a cudaError_t (0 on success).
extern "C" int vv_fused_rope_attention(const void* qkv, const void* cos_t,
                                       const void* sin_t, const void* mask,
                                       void* out, void* scratch, int b, int n, int heads,
                                       int head_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int variant = vv_fused_rope_attention_variant(head_dim, dtype);
  if (variant < 0) return (int)cudaErrorInvalidValue;
  const bool two_passes = variant == 2 || head_dim >= 256;
  if (two_passes && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // 16-byte loads: every address the kernels derive is a multiple of 16
  // bytes from these.
  auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(qkv) || misaligned(scratch) ||
      (variant == 1 && (misaligned(cos_t) || misaligned(sin_t))))
    return (int)cudaErrorMisalignedAddress;
  if (variant == 2)
    return (int)launch_two_passes<float>(qkv, cos_t, sin_t, mask, out, scratch, b, n, heads,
                                         head_dim, s);
  if (two_passes)
    return (int)launch_two_passes<__nv_bfloat16>(qkv, cos_t, sin_t, mask, out, scratch, b, n,
                                                 heads, head_dim, s);
  if (head_dim == 128)
    return (int)launch_mma<128>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
  return (int)launch_mma<64>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
}
