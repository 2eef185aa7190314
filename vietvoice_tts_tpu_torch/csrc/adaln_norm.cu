// The DiT block's gated residual and modulated LayerNorm in one pass.
//
// Replaces no TPU kernel. The JAX DiT leaves this chain to XLA, which fuses
// it on the TPU (vietvoice_tts_tpu/models/dit.py:368-372); eager PyTorch
// inside a CUDA graph fuses nothing, and the port's plain chain was about 18
// launches a block, each a pass over the residual stream. One launch here
// computes, for each row of the residual stream h [B, N, dim]:
//
//   h' = h + round(round(g) * x)               the gated residual
//   u  = round(LN(h') * (1 + sc) + sh)         the modulated norm
//
// in three forms, chosen by which pointers are null: (a) norm only (u from
// h), (b) residual then norm (writes h' and u), (c) residual only. g, sc
// and sh are float32 rows of the hoisted AdaLN modulations, one per batch
// row or one for the whole batch (row stride 0), read where they lie.
//
// Numerics are the plain chain's (ops/kernels/adaln_norm.py:
// adaln_norm_reference). h' rounds where PyTorch's eager ops round: g to
// the compute dtype, the product, then the sum, each once and with no fused
// multiply-add, so h' is bit-identical to the chain's. LayerNorm: float32
// statistics over the row held in registers (two passes: the mean, then the
// mean square of the deviations), eps 1e-6, no affine; with norm_bf16 the
// values are rounded to bfloat16 before the statistics and the normalised
// value after them, as F.layer_norm in bfloat16 rounds. The modulation is
// float32 and u is rounded once, to the compute dtype or (the final norm)
// kept in float32. PyTorch's LayerNorm sums in another order (Welford), so
// u may differ from the chain's in its last bit.
//
// What bounds it on an H100: bytes. Form (b) in bfloat16 reads h and x and
// writes h' and u, 8 bytes an element, where the chain it replaces moved
// about 46 (float32 round trips around each norm). Design: one block per
// row; each thread holds VPT 16-byte vectors of the row in registers, so
// h' is read from memory once and the statistics cost no second read; warp
// shuffles and one shared-memory step per statistic; nothing is allocated.
// The launch shape (threads, VPT) comes from the width and dtype
// (adaln_norm.py:launch_shape): at most 256 threads, the fewest vectors a
// thread that keep a block within that. Rows must be 16-byte aligned.
//
// A plain C entry point, loaded with ctypes (ops/kernels/build.py builds
// this file into build/ at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kMaxThreads = 256;

struct Args {
  const void* h;
  const void* x;
  const float* g;
  const float* sc;
  const float* sh;
  void* h_out;
  void* u;
  // Element strides: batch and frame of h and x, batch of g, sc and sh.
  long long h_sb, h_sn, x_sb, x_sn, g_sb, sc_sb, sh_sb;
  int frames, dim;
  bool u_f32, norm_bf16;
};

__device__ __forceinline__ float round_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// N float32 values in 16-byte pieces.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// One 16-byte vector of a row of T, widened to float32, and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static float round(float a) { return a; }
  __device__ static void load(const float* p, float (&v)[N]) { load_f32(p, v); }
  __device__ static void store(float* p, const float (&v)[N]) { store_f32(p, v); }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float round(float a) { return round_bf16(a); }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // little-endian: element 2k in the low half
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The sum of s over the block, in every thread (the same bits in each: every
// thread adds the warps' partial sums in one order). blockDim.x is a
// multiple of 32.
__device__ __forceinline__ float block_sum(float s, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < int(blockDim.x >> 5); ++w) t += partial[w];
  return t;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxThreads) adaln_norm_kernel(const Args a) {
  using V = Vec<T>;
  constexpr int N = V::N;
  __shared__ float partial[2][kMaxThreads / 32];
  const long long row = blockIdx.x;
  const long long b = row / a.frames, n = row % a.frames;
  const T* h = static_cast<const T*>(a.h) + b * a.h_sb + n * a.h_sn;

  float v[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * N;
    if (c < a.dim) V::load(h + c, v[i]);
  }

  if (a.x != nullptr) {
    const T* x = static_cast<const T*>(a.x) + b * a.x_sb + n * a.x_sn;
    const float* g = a.g + b * a.g_sb;
    T* h_out = static_cast<T*>(a.h_out) + row * a.dim;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (threadIdx.x + i * blockDim.x) * N;
      if (c < a.dim) {
        float xv[N], gv[N];
        V::load(x + c, xv);
        load_f32(g + c, gv);
#pragma unroll
        for (int e = 0; e < N; ++e)
          v[i][e] = V::round(__fadd_rn(v[i][e], V::round(__fmul_rn(V::round(gv[e]), xv[e]))));
        V::store(h_out + c, v[i]);
      }
    }
  }
  if (a.u == nullptr) return;

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if ((threadIdx.x + i * blockDim.x) * N < a.dim) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (a.norm_bf16) v[i][e] = round_bf16(v[i][e]);
        s += v[i][e];
      }
    }
  }
  const float mean = block_sum(s, partial[0]) / a.dim;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if ((threadIdx.x + i * blockDim.x) * N < a.dim) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(q, partial[1]) / a.dim + kEps);

  const float* sc = a.sc + b * a.sc_sb;
  const float* sh = a.sh + b * a.sh_sb;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = (threadIdx.x + i * blockDim.x) * N;
    if (c < a.dim) {
      float scv[N], shv[N], o[N];
      load_f32(sc + c, scv);
      load_f32(sh + c, shv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float y = (v[i][e] - mean) * rstd;
        if (a.norm_bf16) y = round_bf16(y);
        o[e] = __fadd_rn(__fmul_rn(y, __fadd_rn(1.f, scv[e])), shv[e]);
      }
      if (a.u_f32)
        store_f32(static_cast<float*>(a.u) + row * a.dim + c, o);
      else
        V::store(static_cast<T*>(a.u) + row * a.dim + c, o);
    }
  }
}

template <typename T>
int launch(const Args& a, int rows, int threads, int vpt, cudaStream_t s) {
  switch (vpt) {
    case 1: adaln_norm_kernel<T, 1><<<rows, threads, 0, s>>>(a); break;
    case 2: adaln_norm_kernel<T, 2><<<rows, threads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of h, x, h_out and of u unless u_f32.
// h and x are [batch, frames, dim] with unit stride along dim; g, sc and sh
// float32 [batch or 1, dim] rows, unit stride along dim. strides holds seven
// element strides: batch and frame of h, then of x, then the batch stride
// of g, sc and sh (0 broadcasts one row). h_out and u are [batch, frames,
// dim], contiguous. x, g and h_out are all given (residual) or all null;
// sc, sh and u likewise (norm); at least one of the two. threads (a
// multiple of 32 up to 256) times vpt (1 or 2) 16-byte vectors must
// cover dim, a multiple of 8. Every row 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int vv_adaln_norm(const void* h, const void* x, const void* g, const void* sc,
                             const void* sh, void* h_out, void* u, const long long* strides,
                             int batch, int frames, int dim, int dtype, int u_f32,
                             int norm_bf16, int threads, int vpt, void* stream) {
  const bool residual = x != nullptr, norm = u != nullptr;
  const long long elems = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || batch <= 0 || frames <= 0 || dim <= 0 || dim % 8 != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)threads * vpt * elems < dim || (long long)batch * frames > 0x7fffffffLL ||
      residual != (g != nullptr) || residual != (h_out != nullptr) ||
      norm != (sc != nullptr) || norm != (sh != nullptr) || !(residual || norm))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.h = h;
  a.x = x;
  a.g = static_cast<const float*>(g);
  a.sc = static_cast<const float*>(sc);
  a.sh = static_cast<const float*>(sh);
  a.h_out = h_out;
  a.u = u;
  a.h_sb = strides[0];
  a.h_sn = strides[1];
  a.x_sb = strides[2];
  a.x_sn = strides[3];
  a.g_sb = strides[4];
  a.sc_sb = strides[5];
  a.sh_sb = strides[6];
  a.frames = frames;
  a.dim = dim;
  a.u_f32 = u_f32 != 0;
  a.norm_bf16 = norm_bf16 != 0;
  const int rows = batch * frames;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(a, rows, threads, vpt, s)
                    : launch<float>(a, rows, threads, vpt, s);
}
