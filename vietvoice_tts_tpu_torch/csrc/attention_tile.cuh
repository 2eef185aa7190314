// The online-softmax tile step shared by the package's attention kernels
// (fused_rope_attention.cu, flash_attention.cu).
//
// A block of THREADS = 16 x 16 threads owns BQ = 64 query rows and walks the
// key axis in tiles of BK = 64 keys. Each kernel stages its own tiles in
// shared memory as float32 (that is where the two differ: one reads the
// packed QKV projection and applies RoPE, the other reads strided q, k, v);
// tile_step() then does what both have in common for one staged tile:
//
//   s = (q . k) * scale + key bias        64 x 64 logits, 4 x 4 per thread
//   m, l, acc <- online softmax update    running max, running sum, rescale
//   acc += p . v                          D / 16 output columns per thread
//
// Thread (ty, tx) owns query rows ty + 16*i (i < 4); for the logits, key
// columns tx + 16*j (j < 4); for the output, value columns tx + 16*c
// (c < D/16). A row's 16 owners are one half-warp, so row max and row sum
// are four xor-shuffles. Rows of the q and k tiles are padded by one float,
// so that the 16 threads reading 16 different key rows hit 16 different
// banks. All arithmetic is float32 on the SIMT pipes.
//
// tile_step() serves the head widths that have a kernel of their own (the
// whole q, k and v tiles sit in shared memory). Any other width
// takes attention_tile_wide_kernel below: a block owns 64 query rows and one
// block of WIDE_COLS output columns, q and k stream through shared memory 64
// columns at a time for the logits, which are recomputed for every column
// block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vv_attention {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int ROWS = 4;       // query rows (and key columns) per thread
constexpr float PAD_BIAS = -1e30f;

// Batch, head and frame strides of one operand, in elements.
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's cast
}

// Shared-memory layout of one block, in floats:
// q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1], key bias [BK].
template <int D>
struct Tiles {
  static constexpr int LD = D + 1;    // padded row pitch of the q and k tiles
  static constexpr int LDP = BK + 1;  // padded row pitch of the probability tile
  static constexpr int CPT = D / 16;  // output columns per thread
  static constexpr size_t BYTES =
      sizeof(float) * (BQ * LD + BK * LD + BK * D + BQ * LDP + BK);
  float* q;
  float* k;
  float* v;
  float* p;
  float* bias;
  __device__ explicit Tiles(float* smem)
      : q(smem), k(q + BQ * LD), v(k + BK * LD), p(v + BK * D), bias(p + BQ * LDP) {}
};

// Running softmax state of a thread's four query rows and CPT output
// columns.
template <int CPT>
struct RowAcc {
  float m[ROWS];         // running max of the logits
  float l[ROWS];         // running sum of exp(logit - m)
  float acc[ROWS][CPT];  // unnormalized output
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }
  }
};
template <int D>
using RowState = RowAcc<Tiles<D>::CPT>;

// s += q . k over `cols` columns of a q tile and a k tile of row pitch LD.
template <int LD>
__device__ __forceinline__ void add_logits(const float* q, const float* k, int cols, int tx,
                                           int ty, float (&s)[ROWS][ROWS]) {
#pragma unroll 8
  for (int d = 0; d < cols; ++d) {
    float qv[ROWS], kv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) qv[i] = q[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) kv[j] = k[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < ROWS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// The online-softmax update on the raw logits s, then acc += p . v with the
// v tile's CPT * 16 columns at row pitch VLD. p is the [BQ][BK + 1]
// probability tile; bias the tile's BK key biases.
template <int CPT, int VLD>
__device__ __forceinline__ void softmax_pv(float (&s)[ROWS][ROWS], const float* bias, float* p,
                                           const float* v, float scale, int tx, int ty,
                                           RowAcc<CPT>& st) {
  constexpr int LDP = BK + 1;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      s[i][j] = s[i][j] * scale + bias[tx + 16 * j];
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[i], mx);
    const float alpha = expf(st.m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const float pj = expf(s[i][j] - m_new);
      p[(ty + 16 * i) * LDP + tx + 16 * j] = pj;
      rs += pj;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    st.l[i] = st.l[i] * alpha + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) st.acc[i][c] *= alpha;
  }
  __syncthreads();  // the probability tile is complete

#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float pv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) pv[i] = p[(ty + 16 * i) * LDP + kk];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float vv = v[kk * VLD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) st.acc[i][c] = fmaf(pv[i], vv, st.acc[i][c]);
    }
  }
}

// One staged key tile: logits, online-softmax update, P.V. The caller has
// synchronized after staging the tile and synchronizes again before it
// overwrites k, v or bias. bias holds 0 for a valid key, PAD_BIAS for a
// padded one and -inf past the end of the sequence; the first tile always
// holds key 0, whose logit is finite, so the running max is finite.
template <int D>
__device__ __forceinline__ void tile_step(const Tiles<D>& t, float scale,
                                          int tx, int ty, RowState<D>& st) {
  float s[ROWS][ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < ROWS; ++j) s[i][j] = 0.f;
  add_logits<Tiles<D>::LD>(t.q, t.k, D, tx, ty, s);
  softmax_pv<Tiles<D>::CPT, D>(s, t.bias, t.p, t.v, scale, tx, ty, st);
}

// ---- any head width: column blocks, q and k streamed ------------------------

constexpr int WIDE_COLS = 128;  // output columns per block
constexpr int WIDE_CHUNK = 64;  // columns of q and k per pass of the logits

// Shared-memory layout of one block, in floats: q and k chunks
// [64][WIDE_CHUNK + 1], v [BK][WIDE_COLS], p [BQ][BK + 1], key bias [BK].
struct WideTiles {
  static constexpr int LD = WIDE_CHUNK + 1;
  static constexpr size_t BYTES =
      sizeof(float) * (BQ * LD + BK * LD + BK * WIDE_COLS + BQ * (BK + 1) + BK);
  float* q;
  float* k;
  float* v;
  float* p;
  float* bias;
  __device__ explicit WideTiles(float* smem)
      : q(smem), k(q + BQ * LD), v(k + BK * LD), p(v + BK * WIDE_COLS),
        bias(p + BQ * (BK + 1)) {}
};

// Attention on strided q, k, v [B, H, N, d] (float32) at any head width d,
// output [B, N, H, d]. Grid: (query blocks, heads x column blocks, batch).
// Logits are scaled by `scale`; mask is [B, N] or null.
__global__ void __launch_bounds__(THREADS)
attention_tile_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ mask,
                           float* __restrict__ out, Strides sq, Strides sk, Strides sv,
                           int n, int heads, int d, float scale) {
  constexpr int CPT = WIDE_COLS / 16;
  extern __shared__ float smem[];
  const WideTiles t(smem);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col_blocks = gridDim.y / heads;
  const int h = blockIdx.y / col_blocks;
  const int c0 = (blockIdx.y % col_blocks) * WIDE_COLS;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.z;
  const float* q_head = q + b * sq.b + h * sq.h;
  const float* k_head = k + b * sk.b + h * sk.h;
  const float* v_head = v + b * sv.b + h * sv.h;

  RowAcc<CPT> st;
  st.init();
  for (int k0 = 0; k0 < n; k0 += BK) {
    float s[ROWS][ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < ROWS; ++j) s[i][j] = 0.f;
    for (int cc = 0; cc < d; cc += WIDE_CHUNK) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      for (int idx = tid; idx < BQ * WIDE_CHUNK; idx += THREADS) {
        const int r = idx / WIDE_CHUNK;
        const int col = cc + idx % WIDE_CHUNK;
        const bool in = col < d;
        t.q[r * WideTiles::LD + idx % WIDE_CHUNK] =
            in && q0 + r < n ? q_head[(q0 + r) * sq.n + col] : 0.f;
        t.k[r * WideTiles::LD + idx % WIDE_CHUNK] =
            in && k0 + r < n ? k_head[(k0 + r) * sk.n + col] : 0.f;
      }
      __syncthreads();
      add_logits<WideTiles::LD>(t.q, t.k, WIDE_CHUNK, tx, ty, s);
    }
    for (int idx = tid; idx < BK * WIDE_COLS; idx += THREADS) {
      const int r = idx / WIDE_COLS;
      const int col = c0 + idx % WIDE_COLS;
      t.v[idx] = col < d && k0 + r < n ? v_head[(k0 + r) * sv.n + col] : 0.f;
    }
    if (tid < BK) {
      const int key = k0 + tid;
      t.bias[tid] = key >= n ? -INFINITY
                             : (mask == nullptr || mask[(long long)b * n + key] ? 0.f : PAD_BIAS);
    }
    __syncthreads();
    softmax_pv<CPT, WIDE_COLS>(s, t.bias, t.p, t.v, scale, tx, ty, st);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
      const float inv = 1.f / st.l[i];
      float* dst = out + (((long long)b * n + row) * heads + h) * d;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = c0 + tx + 16 * c;
        if (col < d) dst[col] = st.acc[i][c] * inv;
      }
    }
  }
}

inline cudaError_t launch_tile_wide(const float* q, const float* k, const float* v,
                                    const uint8_t* mask, float* out, Strides sq, Strides sk,
                                    Strides sv, int b, int heads, int n, int d,
                                    cudaStream_t stream) {
  constexpr size_t smem = WideTiles::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tile_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int col_blocks = (d + WIDE_COLS - 1) / WIDE_COLS;
  const dim3 grid((n + BQ - 1) / BQ, heads * col_blocks, b);
  attention_tile_wide_kernel<<<grid, THREADS, smem, stream>>>(
      q, k, v, mask, out, sq, sk, sv, n, heads, d, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace vv_attention
