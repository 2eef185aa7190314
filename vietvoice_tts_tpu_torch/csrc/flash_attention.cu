// Exact-softmax attention on unpacked q, k, v [B, H, N, D], no RoPE.
//
// Replaces the Pallas TPU kernel flash_attention
// (vietvoice_tts_tpu/ops/pallas/flash_attention.py:53, body _attn_kernel :29).
// Same function: logits = q . k^T * D^-1/2 + key bias (0 for a valid key,
// -1e30 for a padded one), float32 softmax over the full key axis, P . V with
// float32 accumulation, output in q's dtype. The scale is applied to the
// logits, as the TPU kernel applies it, not folded into q. The TPU kernel
// takes any D; this one takes every multiple of 8 up to 1024 (rows of 16
// bytes in bf16) and raises on the rest.
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
// "wgmma": bfloat16, the serving type, at every D. Both products run on the
//   tensor cores (attention_strided.cuh, on attention_mma.cuh's tile step).
//   Up to D = 256 the tile width is the smallest of 32, 64, 128, 192, 256
//   that holds D, the columns past D zero-filled (D 72 and 96 run at 128); a
//   block is two warpgroups, 128 query rows, which share every K/V tile, and
//   q, k and v are copied as they lie, strides and all, by 16-byte cp.async
//   into a ring of bf16 tiles. Above 256: 64-row blocks, one per column
//   block of at most 256 output columns, Q resident and K and V streamed
//   through a ring by a producer warpgroup. The weights are rounded to
//   bfloat16 for P . V, as the TPU kernel rounds them. Rows must be 16-byte
//   aligned (base pointers, and strides that are multiples of 8 elements).
//
// "simt": float32 at every D. float32 arithmetic on the SIMT pipes (67
//   TFLOP/s peak), float32 tiles in shared memory, one block of 256 threads
//   per 64 query rows (attention_tile.cuh); the softmax weights stay
//   float32. D = 32, 64 and 96 have a kernel each, whose whole q, k and v
//   tiles sit in shared memory; every other D runs in blocks of 128 output
//   columns with q and k streamed 64 columns at a time. At 128 and 256 the
//   latter is the faster (0.84x and 0.76x of a kernel of their own on an
//   H100, whose 116 and 214 KB of tiles let one block run per SM, against
//   83 KB and two), at 32, 64 and 96 the slower (2.1-2.6x, 1.4x, 1.2x).
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
#include "attention_strided.cuh"
#include "attention_tile.cuh"

namespace {

using namespace vv_attention;

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

// ---- the tensor-core variant (bfloat16): attention_strided.cuh -------------

namespace mma = vv_mma;

// True when every row of an operand starts on a 16-byte boundary.
bool rows_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.n % 8 == 0;
}

// The float32 kernels: one per head dim that has its own, the column-blocked
// one for every other (the header says why 128 and 256 are among those).
cudaError_t launch_f32(int head_dim, const void* q, const void* k, const void* v,
                       const void* mask, void* out, Strides sq, Strides sk, Strides sv,
                       int b, int heads, int n, cudaStream_t s) {
  switch (head_dim) {
    case 32:  return launch<float, 32>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 64:  return launch<float, 64>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 96:  return launch<float, 96>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    default:
      return launch_tile_wide(static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
                              static_cast<float*>(out), sq, sk, sv, b, heads, n, head_dim, s);
  }
}

}  // namespace

// The variant that serves (head_dim, dtype; 0 = float32, 1 = bfloat16):
// 1 = "wgmma", 0 = "simt", -1 = no kernel. Every head_dim that is a multiple
// of 8 (16-byte bf16 rows) up to 1024 has one.
extern "C" int vv_flash_attention_variant(int head_dim, int dtype) {
  if ((dtype != 0 && dtype != 1) || head_dim < 8 || head_dim > mma::WIDE_MAX_D ||
      head_dim % 8 != 0)
    return -1;
  return dtype;
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
    return (int)mma::launch_strided(q, k, v, mask, out, sq, sk, sv, b, heads, n, head_dim, s);
  }
  if (variant == 0)
    return (int)launch_f32(head_dim, q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 column-blocked kernel (attention_tile.cuh) at any head_dim a
// multiple of 8 up to 1024, the widths with a kernel of their own included;
// arguments as vv_flash_attention's, float32 only. The package reaches this
// kernel through vv_flash_attention at the widths without one; this entry
// lets a caller time it against those kernels at the widths they serve.
extern "C" int vv_flash_attention_f32_blocked(const void* q, const void* k, const void* v,
                                              const void* mask, void* out,
                                              const long long* strides, int b, int heads,
                                              int n, int head_dim, void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535 ||
      vv_flash_attention_variant(head_dim, 0) != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_tile_wide(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      Strides{strides[0], strides[1], strides[2]}, Strides{strides[3], strides[4], strides[5]},
      Strides{strides[6], strides[7], strides[8]}, b, heads, n, head_dim,
      static_cast<cudaStream_t>(stream));
}
