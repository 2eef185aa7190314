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
// "tf32x3": float32 at every D. Both products on the tensor cores in split
//   TF32 (attention_tf32.cuh): each operand split into two TF32 parts and
//   every product taken as lo.hi + hi.lo + hi.hi with float32 accumulation,
//   about 2^-21 relative per product; the softmax and its weights stay
//   float32. Blocks of 64 query rows and at most 128 output columns, Q in
//   shared memory as far as it fits (all of it up to D = 320), K, V and the
//   rest of Q split and staged by a producer warpgroup. Rows must be
//   16-byte aligned too (strides multiples of 4 elements).
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
#include "attention_tf32.cuh"

namespace {

namespace mma = vv_mma;
using mma::Strides;

// True when every row of an operand starts on a 16-byte boundary
// (elements: 8 for bfloat16, 4 for float32).
bool rows_aligned(const void* p, Strides s, int elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % elems == 0 && s.h % elems == 0 &&
         s.n % elems == 0;
}

}  // namespace

// The variant that serves (head_dim, dtype; 0 = float32, 1 = bfloat16):
// 1 = "wgmma", 2 = "tf32x3", -1 = no kernel. Every head_dim that is a
// multiple of 8 (16-byte bf16 rows) up to 1024 has one.
extern "C" int vv_flash_attention_variant(int head_dim, int dtype) {
  if ((dtype != 0 && dtype != 1) || head_dim < 8 || head_dim > mma::WIDE_MAX_D ||
      head_dim % 8 != 0)
    return -1;
  return dtype == 1 ? 1 : 2;
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v are [b, heads, n, head_dim]
// views with unit stride along head_dim; strides holds nine element strides
// (batch, head, frame of q, then of k, then of v). mask is [b, n] uint8
// (nonzero = valid key), contiguous, or null for no padding. out is
// [b, n, heads, head_dim], contiguous. All on the current device. Both
// variants copy 16 bytes at a time: rows must be 16-byte aligned
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
  if (variant < 0) return (int)cudaErrorInvalidValue;
  const int elems = variant == 1 ? 8 : 4;
  if (!rows_aligned(q, sq, elems) || !rows_aligned(k, sk, elems) || !rows_aligned(v, sv, elems))
    return (int)cudaErrorMisalignedAddress;
  if (variant == 1)
    return (int)mma::launch_strided(q, k, v, mask, out, sq, sk, sv, b, heads, n, head_dim, s);
  return (int)vv_tf32::launch(q, k, v, mask, out, sq, sk, sv, b, heads, n, head_dim, s);
}
