// Exact-softmax attention on unpacked q, k, v [B, H, N, D], no RoPE.
//
// Replaces the Pallas TPU kernel flash_attention
// (vietvoice_tts_tpu/ops/pallas/flash_attention.py:53, body _attn_kernel :29).
// Same function: logits = q . k^T * D^-1/2 + key bias (0 for a valid key,
// -1e30 for a padded one), float32 softmax over the full key axis, P . V with
// float32 accumulation, output in q's dtype. The scale is applied to the
// logits, as the TPU kernel applies it, not folded into q. The softmax
// weights stay float32 for P . V (the package's convention, shared with the
// plain PyTorch version); the TPU kernel rounds them to v's dtype first.
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
// shape (N >= 256). This version uses the float32 SIMT pipes (67 TFLOP/s
// peak), not the tensor cores, and computes in float32 for bf16 and f32
// input alike. At small D the exp per logit weighs more: D = 32 spends one
// exp for every 64 multiply-adds.
//
// Design. The TPU kernel keeps a whole head's K and V (up to 2048 x D) in
// VMEM, blocks over queries only and runs a two-pass softmax, so block_q
// must divide N. Shared memory here holds 64 keys at a time: one block of
// 256 threads per (64-query tile, head, batch) walks the key axis in 64-key
// tiles with an online softmax (attention_tile.cuh, shared with the fused
// RoPE kernel), which computes the same function within rounding. Any N:
// keys past N get a bias of -inf (no weight at all), query rows past N are
// computed on zeros and not stored. D is a template parameter (32, 64, 96,
// 128, 256); at D = 256 the tiles take 209 KB of the SM's 227 KB, one block
// per SM.
//
// Later work: tensor cores (wgmma), TMA loads and a deeper key pipeline.

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

template <typename T>
cudaError_t launch_head_dim(int head_dim, const void* q, const void* k,
                            const void* v, const void* mask, void* out,
                            Strides sq, Strides sk, Strides sv, int b,
                            int heads, int n, cudaStream_t s) {
  switch (head_dim) {
    case 32:  return launch<T, 32>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 64:  return launch<T, 64>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 96:  return launch<T, 96>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 128: return launch<T, 128>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    case 256: return launch<T, 256>(q, k, v, mask, out, sq, sk, sv, b, heads, n, s);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v are [b, heads, n, head_dim]
// views with unit stride along head_dim; strides holds nine element strides
// (batch, head, frame of q, then of k, then of v). mask is [b, n] uint8
// (nonzero = valid key), contiguous, or null for no padding. out is
// [b, n, heads, head_dim], contiguous. All on the current device.
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
  if (dtype == 0)
    return (int)launch_head_dim<float>(head_dim, q, k, v, mask, out, sq, sk,
                                       sv, b, heads, n, s);
  if (dtype == 1)
    return (int)launch_head_dim<__nv_bfloat16>(head_dim, q, k, v, mask, out,
                                               sq, sk, sv, b, heads, n, s);
  return (int)cudaErrorInvalidValue;
}
