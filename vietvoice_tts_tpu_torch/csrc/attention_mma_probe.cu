// Single-tile probes of the two wgmma products in attention_mma.cuh (bf16)
// and in attention_tf32.cuh (split TF32), for the tests on the card: each
// runs one warpgroup on one tile and writes the raw float32 accumulator, so
// a wrong descriptor, swizzle, fragment layout or key permutation shows in
// the product itself and not through a softmax. No part of the package
// calls these.

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

namespace mma = vv_mma;

// Copies a dense [64, D] bf16 matrix into the tile layout at `dst`.
template <int D>
__device__ void stage_tile(uint32_t dst, const __nv_bfloat16* src) {
  const mma::TileCopier<D, mma::WG_THREADS> copier(threadIdx.x);
  copier.copy(dst, src, D, 0, mma::TILE_ROWS);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  mma::fence_proxy_async();
  __syncthreads();
}

// Row and first column of accumulator register 4 j + 2 h of this thread.
__device__ __forceinline__ void fragment_coords(int j, int h, int& row, int& col) {
  const int t = threadIdx.x;
  row = (t >> 5) * 16 + ((t & 31) >> 2) + 8 * h;
  col = 8 * j + 2 * (t & 3);
}

// out [64, BK] float32 = q [64, D] . k [BK, D]^T.
template <int D>
__global__ void __launch_bounds__(mma::WG_THREADS)
probe_qk_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k, float* out) {
  using L = mma::TileLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_addr = base, k_addr = base + L::BYTES;
  stage_tile<D>(q_addr, q);
  stage_tile<D>(k_addr, k);
  float s[mma::BK / 2];
  mma::qk_product<D>(q_addr, k_addr, s);
#pragma unroll
  for (int j = 0; j < mma::BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(j, h, row, col);
      out[row * mma::BK + col] = s[4 * j + 2 * h];
      out[row * mma::BK + col + 1] = s[4 * j + 2 * h + 1];
    }
}

// out [64, D] float32 = bf16(p [64, BK] float32) . v [BK, D].
template <int D>
__global__ void __launch_bounds__(mma::WG_THREADS)
probe_pv_kernel(const float* p, const __nv_bfloat16* v, float* out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_u32(smem_raw);
  const uint32_t v_addr = (raw + 1023u) & ~1023u;
  stage_tile<D>(v_addr, v);
  float s[mma::BK / 2];
#pragma unroll
  for (int j = 0; j < mma::BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(j, h, row, col);
      s[4 * j + 2 * h] = p[row * mma::BK + col];
      s[4 * j + 2 * h + 1] = p[row * mma::BK + col + 1];
    }
  uint32_t frag[mma::BK / 16][4];
  mma::pack_weights(s, frag);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mma::pv_product<D>(frag, v_addr, o);
  mma::wgmma_wait<0>();
  mma::fence_operands(o);
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(c, h, row, col);
      out[row * D + col] = o[4 * c + 2 * h];
      out[row * D + col + 1] = o[4 * c + 2 * h + 1];
    }
}

// out [64, 64] = split(q [64, 32]) . split(k [64, 32])^T: one Q atom and one
// K atom, staged and split as the producer stages them.
__global__ void __launch_bounds__(mma::WG_THREADS)
probe_tf32_qk_kernel(const float* q, const float* k, float* out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (mma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const vv_tf32::Stager stage(threadIdx.x);
  stage.start_rows(base, q, vv_tf32::ATOM, 0, mma::TILE_ROWS, vv_tf32::ATOM);
  stage.start_rows(base + vv_tf32::SLOT, k, vv_tf32::ATOM, 0, mma::TILE_ROWS, vv_tf32::ATOM);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  stage.finish_rows(base);
  stage.finish_rows(base + vv_tf32::SLOT);
  mma::fence_proxy_async();
  __syncthreads();
  float s[mma::BK / 2];
  vv_tf32::qk_atom(s, base, base + vv_tf32::SLOT, 0);
#pragma unroll
  for (int j = 0; j < mma::BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(j, h, row, col);
      out[row * mma::BK + col] = s[4 * j + 2 * h];
      out[row * mma::BK + col + 1] = s[4 * j + 2 * h + 1];
    }
}

// out [64, 32] = split(p [64, 64]) . split(v [64, 32]): one V atom,
// transposed and permuted as the producer stages it, P split in registers.
__global__ void __launch_bounds__(mma::WG_THREADS)
probe_tf32_pv_kernel(const float* p, const float* v, float* out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (mma::smem_u32(smem_raw) + 1023u) & ~1023u;
  const vv_tf32::Stager stage(threadIdx.x);
  vv_tf32::Chunks in;
  stage.load_cols(in, v, vv_tf32::ATOM, 0, mma::BK, vv_tf32::ATOM);
  stage.store_cols(base, in);
  mma::fence_proxy_async();
  __syncthreads();
  float s[mma::BK / 2];
#pragma unroll
  for (int j = 0; j < mma::BK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(j, h, row, col);
      s[4 * j + 2 * h] = p[row * mma::BK + col];
      s[4 * j + 2 * h + 1] = p[row * mma::BK + col + 1];
    }
  uint32_t hi[mma::BK / 8][4], lo[mma::BK / 8][4];
  vv_tf32::split_weights(s, hi, lo);
  float o[vv_tf32::ATOM / 2];
#pragma unroll
  for (int i = 0; i < vv_tf32::ATOM / 2; ++i) o[i] = 0.f;
  vv_tf32::fence_weights(o, hi, lo);
  vv_tf32::pv_issue(o, hi, lo, base);
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::fence_operands(o);
#pragma unroll
  for (int c = 0; c < vv_tf32::ATOM / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row, col;
      fragment_coords(c, h, row, col);
      out[row * vv_tf32::ATOM + col] = o[4 * c + 2 * h];
      out[row * vv_tf32::ATOM + col + 1] = o[4 * c + 2 * h + 1];
    }
}

// hi[i], lo[i] = the split of x[i] (vv_tf32::split), i < n.
__global__ void probe_tf32_split_kernel(const float* x, uint32_t* hi, uint32_t* lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vv_tf32::split(x[i], hi[i], lo[i]);
}

cudaError_t launch_tf32(int product, const void* a, const void* b, void* out,
                        cudaStream_t stream) {
  const size_t smem = 2 * vv_tf32::SLOT + 1024;
  auto kernel = product == 2 ? probe_tf32_qk_kernel : probe_tf32_pv_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, mma::WG_THREADS, smem, stream>>>(static_cast<const float*>(a),
                                               static_cast<const float*>(b),
                                               static_cast<float*>(out));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int product, const void* a, const void* b, void* out, cudaStream_t stream) {
  using L = mma::TileLayout<D>;
  const size_t smem = 2 * L::BYTES + 1024;
  cudaError_t err = cudaSuccess;
  if (product == 0) {
    auto kernel = probe_qk_kernel<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, mma::WG_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(out));
  } else {
    auto kernel = probe_pv_kernel<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, mma::WG_THREADS, smem, stream>>>(
        static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// product 0: a = q [64, head_dim] bf16, b = k [64, head_dim] bf16,
// out [64, 64] float32 = q . k^T. product 1: a = p [64, 64] float32 (rounded
// to bf16 in the kernel), b = v [64, head_dim] bf16, out [64, head_dim]
// float32 = p . v. head_dim 32, 64 or 128. Split TF32, head_dim 32 (one
// atom): product 2, a = q [64, 32], b = k [64, 32] float32, out [64, 64] =
// q . k^T; product 3, a = p [64, 64], b = v [64, 32] float32, out [64, 32] =
// p . v. Product 4: the split of a = x [head_dim] float32 into b = hi and
// out = lo, [head_dim] 32-bit patterns each. All contiguous on the current
// device. Returns a cudaError_t (0 on success).
extern "C" int vv_attention_mma_probe(int product, const void* a, const void* b, void* out,
                                      int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (product == 2 || product == 3)
    return head_dim == vv_tf32::ATOM ? (int)launch_tf32(product, a, b, out, s)
                                     : (int)cudaErrorInvalidValue;
  if (product == 4) {
    if (head_dim <= 0) return (int)cudaErrorInvalidValue;
    probe_tf32_split_kernel<<<(head_dim + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<uint32_t*>(const_cast<void*>(b)),
        static_cast<uint32_t*>(out), head_dim);
    return (int)cudaGetLastError();
  }
  if (product != 0 && product != 1) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 32:  return (int)launch<32>(product, a, b, out, s);
    case 64:  return (int)launch<64>(product, a, b, out, s);
    case 128: return (int)launch<128>(product, a, b, out, s);
    default:  return (int)cudaErrorInvalidValue;
  }
}
