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

// Running softmax state of a thread's four query rows.
template <int D>
struct RowState {
  float m[ROWS];                   // running max of the logits
  float l[ROWS];                   // running sum of exp(logit - m)
  float acc[ROWS][Tiles<D>::CPT];  // unnormalized output
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < Tiles<D>::CPT; ++c) acc[i][c] = 0.f;
    }
  }
};

// One staged key tile: logits, online-softmax update, P.V. The caller has
// synchronized after staging the tile and synchronizes again before it
// overwrites k, v or bias. bias holds 0 for a valid key, PAD_BIAS for a
// padded one and -inf past the end of the sequence; the first tile always
// holds key 0, whose logit is finite, so the running max is finite.
template <int D>
__device__ __forceinline__ void tile_step(const Tiles<D>& t, float scale,
                                          int tx, int ty, RowState<D>& st) {
  constexpr int LD = Tiles<D>::LD;
  constexpr int LDP = Tiles<D>::LDP;
  constexpr int CPT = Tiles<D>::CPT;

  float s[ROWS][ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < ROWS; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[ROWS], kv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) qv[i] = t.q[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) kv[j] = t.k[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < ROWS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      s[i][j] = s[i][j] * scale + t.bias[tx + 16 * j];
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
      const float p = expf(s[i][j] - m_new);
      t.p[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      rs += p;
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
    for (int i = 0; i < ROWS; ++i) pv[i] = t.p[(ty + 16 * i) * LDP + kk];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float vv = t.v[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) st.acc[i][c] = fmaf(pv[i], vv, st.acc[i][c]);
    }
  }
}

}  // namespace vv_attention
