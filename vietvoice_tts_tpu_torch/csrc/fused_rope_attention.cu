// Fused RoPE attention read straight from the packed QKV projection.
//
// Replaces the Pallas TPU kernel fused_qkv_rope_attention
// (vietvoice_tts_tpu/ops/pallas/fused_rope_attention.py:123, bodies _kernel
// :89 and _kernel_pair :96). Same function: for batch b and head h, q is read
// at column h*D of qkv [B, N, 3*H*D], k at (H+h)*D and v at (2H+h)*D; the
// half-split (NeoX) RoPE is applied to q and k on load, 1/sqrt(D) is folded
// into q, keys are biased by 0 (valid) or -1e30 (padding), and the softmax
// runs over the full key axis. The output [B, N, H*D] is written at column
// h*D, so the DiT's out-projection reads it with no transpose.
//
// What bounds it on an H100: at serving shapes (N = 256..2048, D = 128) the
// two products are 4*B*H*N^2*D flops against 3*B*N*H*D*2 bytes of input,
// i.e. hundreds of flops per byte -- compute-bound. This first version uses
// the float32 SIMT pipes (about 67 TFLOP/s peak), not the tensor cores, and
// computes in float32 for bf16 and f32 input alike; only q and k are rounded
// to the input dtype after RoPE, as the plain version rounds them.
//
// Design. One block of 256 threads per (64-query tile, head, batch). The
// TPU kernel held all N keys of a head in VMEM and ran a two-pass exact
// softmax; shared memory here holds 64 keys at a time, so the block walks
// the key axis in 64-key tiles with an online softmax (running max and sum,
// rescaling the accumulator), which computes the same function within
// rounding. Q (RoPE'd, scaled), K (RoPE'd) and V tiles are staged in shared
// memory as float32; the tile step itself (logits, softmax update, P.V, and
// how threads share a tile) is attention_tile.cuh, which flash_attention.cu
// uses too. Ragged N is masked in-kernel: keys past N get -inf (no weight
// at all), query rows past N are computed on zeros and not stored.
// The TPU kernel's head-pair layout for D = 64 was a lane-tiling device of
// the TPU and is not needed: D is a template parameter (64 or 128).
//
// Later work: tensor cores (wgmma), TMA loads and a deeper key pipeline.

#include "attention_tile.cuh"

namespace {

using namespace vv_attention;

// Row `row` of a head's q or k with RoPE applied, element c: computed in
// float32 and rounded once to T, as the plain version does (so bf16 q and k
// carry the same bits on both paths).
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* __restrict__ src,
                                           const T* __restrict__ cos_t,
                                           const T* __restrict__ sin_t,
                                           int row, int c) {
  constexpr int HALF = D / 2;
  const float x = to_f32(src[c]);
  const float partner = to_f32(src[c < HALF ? c + HALF : c - HALF]);
  const float rot = c < HALF ? -partner : partner;
  const long t = (long)row * D + c;
  return to_f32(from_f32<T>(x * to_f32(cos_t[t]) + rot * to_f32(sin_t[t])));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fused_rope_attention_kernel(const T* __restrict__ qkv,
                            const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t,
                            const uint8_t* __restrict__ mask,
                            T* __restrict__ out,
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
  const long row_stride = 3L * heads * D;
  const T* base = qkv + (long)b * n * row_stride;
  const int q_col = h * D;
  const int k_col = (heads + h) * D;
  const int v_col = (2 * heads + h) * D;

  // 1/sqrt(D) is folded into q here, so the tile step scales logits by 1.
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = q0 + r;
    float val = 0.f;
    if (row < n) {
      val = rope_elem<T, D>(base + (long)row * row_stride + q_col, cos_t,
                            sin_t, row, c) * scale;
    }
    tiles.q[r * LD + c] = val;
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
        const T* row_ptr = base + (long)key * row_stride;
        kv = rope_elem<T, D>(row_ptr + k_col, cos_t, sin_t, key, c);
        vv = to_f32(row_ptr[v_col + c]);
      }
      tiles.k[r * LD + c] = kv;
      tiles.v[r * D + c] = vv;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      tiles.bias[tid] = key >= n ? -INFINITY
                                 : (mask[(long)b * n + key] ? 0.f : PAD_BIAS);
    }
    __syncthreads();
    tile_step<D>(tiles, 1.0f, tx, ty, st);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      const float inv = 1.f / st.l[i];
      T* dst = out + ((long)b * n + row) * heads * D + h * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dst[tx + 16 * c] = from_f32<T>(st.acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* cos_t, const void* sin_t,
                   const void* mask, void* out, int b, int n, int heads,
                   cudaStream_t stream) {
  auto kernel = fused_rope_attention_kernel<T, D>;
  constexpr size_t smem = Tiles<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, heads, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(cos_t),
      static_cast<const T*>(sin_t), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), n, heads, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv [b, n, 3*heads*head_dim], cos/sin
// [n, head_dim] in the same dtype, mask [b, n] uint8 (nonzero = valid key),
// out [b, n, heads*head_dim]; all contiguous on the current device.
// Returns a cudaError_t (0 on success).
extern "C" int vv_fused_rope_attention(const void* qkv, const void* cos_t,
                                       const void* sin_t, const void* mask,
                                       void* out, int b, int n, int heads,
                                       int head_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || heads <= 0 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(qkv, cos_t, sin_t, mask, out, b, n, heads, s);
  return (int)cudaErrorInvalidValue;
}
