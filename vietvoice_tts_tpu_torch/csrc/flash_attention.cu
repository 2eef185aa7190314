// Exact-softmax attention on unpacked q, k, v [B, H, N, D], no RoPE.
//
// Replaces the Pallas TPU kernel flash_attention
// (vietvoice_tts_tpu/ops/pallas/flash_attention.py:53, body _attn_kernel :29).
// Same function: logits = q . k^T * D^-1/2 + key bias (0 for a valid key,
// -1e30 for a padded one), float32 softmax over the full key axis, P . V with
// float32 accumulation, output in q's dtype. The scale is applied to the
// logits, as the TPU kernel applies it, not folded into q.
//
// It serves the DiT's split-heads route: head shapes that the fused RoPE
// kernel (fused_rope_attention.cu) does not take. There q and k are fresh
// tensors after RoPE and v is a view into the packed QKV projection, so each
// operand comes with its own batch, head and frame strides (in elements;
// unit stride along D) and v needs no copy. The output is written in
// [B, N, H, D] memory order, so merging the heads back to [B, N, H*D] is a
// free reshape.
//
// What bounds it on an H100: 4*B*H*N^2*D flops against 4*B*H*N*D elements
// moved, i.e. N flops per element: operations, not bytes, at every serving
// shape (N >= 256). At small D the exp per logit weighs more: D = 32 spends
// one exp for every 64 multiply-adds, and the SM's 16 exp a cycle then cost
// more cycles than its tensor cores need for the products.
//
// Two variants, chosen from (dtype, head_dim) alone:
//
// "wgmma": bfloat16 at D = 32, 64, 128, the serving type. Both products run
//   on the tensor cores (attention_mma.cuh says how). A block is two
//   warpgroups, 128 query rows, which share every K/V tile. q, k and v are
//   copied as they lie, strides and all, by 16-byte cp.async into bf16 tiles
//   in the layout the wgmma descriptors read; the tiles form a ring (two
//   stages at D = 128, three below), and the copy of a later tile is in flight
//   while a tile is computed. One barrier per tile. The weights are rounded
//   to bfloat16 for P . V, as the TPU kernel rounds them. Rows must be 16-byte
//   aligned (base pointers, and strides that are multiples of 8 elements).
//
// "simt": float32 at every D, and bfloat16 at D = 96 and 256 (no serving
//   shape; still to move to the tensor cores). float32 arithmetic on the SIMT
//   pipes (67 TFLOP/s peak), float32 tiles in shared memory, one block of 256
//   threads per 64 query rows (attention_tile.cuh); the softmax weights stay
//   float32. At D = 256 the tiles take 209 KB of the SM's 227 KB.
//
// Design, both variants. The TPU kernel keeps a whole head's K and V (up to
// 2048 x D) in VMEM, blocks over queries only and runs a two-pass softmax, so
// block_q must divide N. Shared memory here holds 64 keys at a time: a block
// walks the key axis in 64-key tiles with an online softmax, which computes
// the same function within rounding. Any N: keys past N get a bias of -inf
// (no weight at all), query rows past N are computed on zeros and not
// stored. No atomics and no split over keys across blocks: the same inputs
// give the same bits.

#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace {

using namespace vv_attention;

// Batch, head and frame strides of one operand, in elements.
struct Strides {
  long long b, h, n;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ mask,  // [B, N] or null
                       T* __restrict__ out,               // [B, N, H, D]
                       Strides sq, Strides sk, Strides sv,
                       int n, int heads, float scale) {
  constexpr int LD = Tiles<D>::LD;
  constexpr int CPT = Tiles<D>::CPT;
  extern __shared__ float smem[];
  const Tiles<D> tiles(smem);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q_head = q + b * sq.b + h * sq.h;
  const T* k_head = k + b * sk.b + h * sk.h;
  const T* v_head = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = q0 + r;
    tiles.q[r * LD + c] = row < n ? to_f32(q_head[row * sq.n + c]) : 0.f;
  }

  RowState<D> st;
  st.init();

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D;
      const int c = idx % D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < n) {
        kv = to_f32(k_head[key * sk.n + c]);
        vv = to_f32(v_head[key * sv.n + c]);
      }
      tiles.k[r * LD + c] = kv;
      tiles.v[r * D + c] = vv;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      float bias = -INFINITY;
      if (key < n)
        bias = (mask == nullptr || mask[(long long)b * n + key]) ? 0.f : PAD_BIAS;
      tiles.bias[tid] = bias;
    }
    __syncthreads();
    tile_step<D>(tiles, scale, tx, ty, st);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      const float inv = 1.f / st.l[i];
      T* dst = out + (((long long)b * n + row) * heads + h) * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dst[tx + 16 * c] = from_f32<T>(st.acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, Strides sq, Strides sk,
                   Strides sv, int b, int heads, int n, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = Tiles<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, heads, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), sq, sk, sv, n, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---- the tensor-core variant (bfloat16) ------------------------------------

namespace mma = vv_mma;

constexpr int MMA_WARPGROUPS = 2;
constexpr int MMA_THREADS = MMA_WARPGROUPS * mma::WG_THREADS;
constexpr int MMA_BQ = MMA_WARPGROUPS * mma::WG_ROWS;  // queries per block

// Shared memory of one block: the Q tiles (one per warpgroup), a ring of
// STAGES K tiles and V tiles, the ring's key biases; 1024 bytes of slack to
// start on a 1024-byte boundary.
template <int D>
struct MmaSmem {
  using L = mma::TileLayout<D>;
  static constexpr int STAGES = D >= 128 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = L::BYTES;
  static constexpr uint32_t KV_BYTES = L::BYTES;
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + MMA_WARPGROUPS * Q_BYTES;
  static constexpr uint32_t V = K + STAGES * KV_BYTES;
  static constexpr uint32_t BIAS = V + STAGES * KV_BYTES;
  static constexpr size_t BYTES = BIAS + STAGES * mma::BK * sizeof(float) + 1024;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const uint8_t* __restrict__ mask,  // [B, N] or null
                           __nv_bfloat16* __restrict__ out,   // [B, N, H, D]
                           Strides sq, Strides sk, Strides sv,
                           int n, int heads, float scale_log2) {
  using S = MmaSmem<D>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* bias = reinterpret_cast<float*>(smem_raw + (base - raw) + S::BIAS);

  const int tid = threadIdx.x;
  const int wg = tid / mma::WG_THREADS;
  const int q0 = blockIdx.x * MMA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_head = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* k_head = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* v_head = v + b * sv.b + h * sv.h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + (long long)b * n;
  const int tiles = (n + mma::BK - 1) / mma::BK;

  const mma::TileCopier<D, MMA_THREADS> copier(tid);
  auto load_kv = [&](int t) {
    const int stage = t % STAGES;
    copier.copy(base + S::K + stage * S::KV_BYTES, k_head, sk.n, t * mma::BK, n);
    copier.copy(base + S::V + stage * S::KV_BYTES, v_head, sv.n, t * mma::BK, n);
    if (tid < mma::BK)
      bias[stage * mma::BK + tid] = mma::key_bias(mask_row, t * mma::BK + tid, n);
  };

  // The two Q tiles are one [128, D] copy: warpgroup w's tile is rows
  // 64 w .. 64 w + 63, stored as a tile of 64 rows of its own.
#pragma unroll
  for (int w = 0; w < MMA_WARPGROUPS; ++w)
    copier.copy(base + S::Q + w * S::Q_BYTES, q_head, sq.n, q0 + w * mma::WG_ROWS, n);
  // One commit group per tile, empty past the last tile, so that "all but
  // the newest STAGES - 2 groups" always means "tile t has landed".
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) load_kv(t);
    mma::cp_async_commit();
  }

  mma::RowState<D> st;
  st.init();
  const uint32_t q_addr = base + S::Q + wg * S::Q_BYTES;

  for (int t = 0; t < tiles; ++t) {
    mma::cp_async_wait<STAGES - 2>();
    mma::fence_proxy_async();
    __syncthreads();  // tile t is complete; everyone is done with tile t - 1
    if (t + STAGES - 1 < tiles) load_kv(t + STAGES - 1);  // into tile t - 1's stage
    mma::cp_async_commit();
    const int stage = t % STAGES;
    mma::tile_step<D>(q_addr, base + S::K + stage * S::KV_BYTES,
                      base + S::V + stage * S::KV_BYTES, bias + stage * mma::BK,
                      scale_log2, st);
  }

  const int row0 = q0 + wg * mma::WG_ROWS;
  const long long pitch = (long long)heads * D;
  mma::store_output<D>(st, out + ((long long)b * n + row0) * pitch + h * D, pitch, row0, n);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask,
                       void* out, Strides sq, Strides sk, Strides sv, int b, int heads,
                       int n, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D>;
  constexpr size_t smem = MmaSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + MMA_BQ - 1) / MMA_BQ, heads, b);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), sq, sk, sv, n, heads,
      mma::LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

// True when every row of an operand starts on a 16-byte boundary.
bool rows_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.n % 8 == 0;
}

// The float32 kernel at every head dim it has.
cudaError_t launch_f32(int head_dim, const void* q, const void* k, const void* v,
                       const void* mask, void* out, Strides sq, Strides sk, Strides sv,
                       int b, int heads, int n, cudaStream_t s) {
  switch (head_dim) {
    case 32:  return launch<float, 32>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 64:  return launch<float, 64>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 96:  return launch<float, 96>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 128: return launch<float, 128>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 256: return launch<float, 256>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// The variant that serves (head_dim, dtype; 0 = float32, 1 = bfloat16):
// 1 = "wgmma", 0 = "simt", -1 = no kernel.
extern "C" int vv_flash_attention_variant(int head_dim, int dtype) {
  const bool simt_dim = head_dim == 32 || head_dim == 64 || head_dim == 96 ||
                        head_dim == 128 || head_dim == 256;
  if ((dtype != 0 && dtype != 1) || !simt_dim) return -1;
  return dtype == 1 && (head_dim == 32 || head_dim == 64 || head_dim == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v are [b, heads, n, head_dim]
// views with unit stride along head_dim; strides holds nine element strides
// (batch, head, frame of q, then of k, then of v). mask is [b, n] uint8
// (nonzero = valid key), contiguous, or null for no padding. out is
// [b, n, heads, head_dim], contiguous. All on the current device.
// The tensor-core variant needs 16-byte-aligned rows
// (cudaErrorMisalignedAddress otherwise).
// Returns a cudaError_t (0 on success).
extern "C" int vv_flash_attention(const void* q, const void* k, const void* v,
                                  const void* mask, void* out,
                                  const long long* strides, int b, int heads,
                                  int n, int head_dim, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const int variant = vv_flash_attention_variant(head_dim, dtype);
  if (variant == 1) {
    if (!rows_aligned(q, sq) || !rows_aligned(k, sk) || !rows_aligned(v, sv))
      return (int)cudaErrorMisalignedAddress;
    switch (head_dim) {
      case 32: return (int)launch_mma<32>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
      case 64: return (int)launch_mma<64>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
      default: return (int)launch_mma<128>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    }
  }
  if (variant == 0 && dtype == 0)
    return (int)launch_f32(head_dim, q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
  // bfloat16 on the SIMT tile step: only the head dims without a
  // tensor-core variant are built.
  if (variant == 0 && head_dim == 96)
    return (int)launch<__nv_bfloat16, 96>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
  if (variant == 0 && head_dim == 256)
    return (int)launch<__nv_bfloat16, 256>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
  return (int)cudaErrorInvalidValue;
}
