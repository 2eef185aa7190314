// Memset and memcpy nodes of a captured CUDA graph rewritten as kernel nodes.
//
// Replaces no TPU kernel. It serves runtime/graphs.py, the port of the JAX
// core's compiled-program cache: each chunk program and the train step are
// captured as CUDA graphs, and at some shapes cuBLAS puts cudaMemsetAsync
// calls into a capture (its GEMMs zero a workspace before they accumulate
// into it), and the train step copies between device buffers. Each becomes
// a memset or memcpy node. A graph that held memset nodes held the host in
// its launch for up to 82% of the graph's device time on an H100
// (PERF.md), where an all-kernel graph's launch returns in under a
// millisecond. So between capture and instantiation every memset node is
// replaced by a kernel node of fill_rows, and every memcpy node between
// linear memory a kernel can reach by one of copy_rows, with the node's
// parameters and edges: the same bytes are written in the same place of the
// graph's order, so a replay stays bit-identical to the captured program.
// The GEMMs keep cuBLAS's algorithms.
//
// What bounds both kernels: bytes. fill_rows writes rows in 16-byte stores
// where a 16-byte chunk lies inside the row, bytes at a row's ragged ends.
// A memset's value repeats every elementSize bytes from the row's start,
// and a row starts at a multiple of elementSize, so the byte at address a is
// byte (a mod 4) of the value replicated to 32 bits: no store needs the
// row's phase. copy_rows moves 16- or 4-byte words where both rows and the
// length allow, else bytes.
//
// A plain C entry point, loaded with ctypes (ops/kernels/build.py builds
// this file into build/ at first use).

#include <cuda_runtime.h>

#include <stdint.h>

#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocksX = 4096;
constexpr unsigned kMaxBlocksY = 65535;

__global__ void fill_rows(char* dst, size_t pitch, uint32_t pattern,
                          size_t row_bytes, size_t height) {
  const uint4 word = make_uint4(pattern, pattern, pattern, pattern);
  for (size_t row = blockIdx.y; row < height; row += gridDim.y) {
    const uintptr_t start = reinterpret_cast<uintptr_t>(dst + row * pitch);
    const uintptr_t end = start + row_bytes;
    const uintptr_t first = start & ~uintptr_t(15);
    const size_t chunks = (end - first + 15) / 16;
    for (size_t c = size_t(blockIdx.x) * blockDim.x + threadIdx.x; c < chunks;
         c += size_t(gridDim.x) * blockDim.x) {
      const uintptr_t lo = first + 16 * c, hi = lo + 16;
      if (lo >= start && hi <= end) {
        *reinterpret_cast<uint4*>(lo) = word;
      } else {
        for (uintptr_t a = lo > start ? lo : start; a < (hi < end ? hi : end); ++a)
          *reinterpret_cast<uint8_t*>(a) = uint8_t(pattern >> (8 * (a & 3)));
      }
    }
  }
}

// Copies `planes` planes of `height` rows of row_bytes each. Rows whose
// addresses and length share 16-byte (else 4-byte) alignment move in words
// of that size; others byte by byte.
__global__ void copy_rows(char* dst, size_t dst_pitch, size_t dst_plane,
                          const char* src, size_t src_pitch, size_t src_plane,
                          size_t row_bytes, size_t height, size_t planes) {
  const size_t rows = height * planes;
  for (size_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t z = r / height, y = r % height;
    char* d = dst + z * dst_plane + y * dst_pitch;
    const char* s = src + z * src_plane + y * src_pitch;
    const uintptr_t mix = reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s) |
                          row_bytes;
    const size_t step = size_t(gridDim.x) * blockDim.x;
    const size_t first = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (mix % 16 == 0) {
      for (size_t i = first; i < row_bytes / 16; i += step)
        reinterpret_cast<uint4*>(d)[i] = reinterpret_cast<const uint4*>(s)[i];
    } else if (mix % 4 == 0) {
      for (size_t i = first; i < row_bytes / 4; i += step)
        reinterpret_cast<uint32_t*>(d)[i] = reinterpret_cast<const uint32_t*>(s)[i];
    } else {
      for (size_t i = first; i < row_bytes; i += step) d[i] = s[i];
    }
  }
}

// fill_rows's grid for rows of row_bytes: enough blocks for a row's 16-byte
// chunks (grid-stride beyond kMaxBlocksX), a block row per row up to
// kMaxBlocksY; at least one block either way.
dim3 fill_grid(size_t row_bytes, size_t height) {
  const size_t chunks = row_bytes / 16 + 2;  // a row's 16-byte chunks, at most
  const size_t x = (chunks + kThreads - 1) / kThreads;
  return dim3(unsigned(x < kMaxBlocksX ? x : kMaxBlocksX),
              unsigned(height < 1 ? 1 : height < kMaxBlocksY ? height : kMaxBlocksY), 1);
}

// The value of a memset of elementSize bytes, replicated to 32 bits.
bool replicate(unsigned value, unsigned element_size, uint32_t* pattern) {
  switch (element_size) {
    case 1: *pattern = (value & 0xffu) * 0x01010101u; return true;
    case 2: *pattern = (value & 0xffffu) * 0x00010001u; return true;
    case 4: *pattern = value; return true;
    default: return false;
  }
}

cudaError_t edges_of(cudaGraphNode_t node, bool incoming,
                     std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
#if CUDART_VERSION >= 13000
  // A null edgeData asks for default edges only (cudaErrorLossyQuery if
  // an edge carries data): a capture on one stream has no other kind.
  cudaError_t err = incoming ? cudaGraphNodeGetDependencies(node, nullptr, nullptr, &n)
                             : cudaGraphNodeGetDependentNodes(node, nullptr, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  if (n == 0) return cudaSuccess;
  return incoming ? cudaGraphNodeGetDependencies(node, out->data(), nullptr, &n)
                  : cudaGraphNodeGetDependentNodes(node, out->data(), nullptr, &n);
#else
  cudaError_t err = incoming ? cudaGraphNodeGetDependencies(node, nullptr, &n)
                             : cudaGraphNodeGetDependentNodes(node, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  if (n == 0) return cudaSuccess;
  return incoming ? cudaGraphNodeGetDependencies(node, out->data(), &n)
                  : cudaGraphNodeGetDependentNodes(node, out->data(), &n);
#endif
}

cudaError_t add_edge(cudaGraph_t graph, cudaGraphNode_t from, cudaGraphNode_t to) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddDependencies(graph, &from, &to, nullptr, 1);
#else
  return cudaGraphAddDependencies(graph, &from, &to, 1);
#endif
}

// `node` replaced by a kernel node of `kp` with the same edges; `node` is
// destroyed.
cudaError_t swap_in_kernel(cudaGraph_t graph, cudaGraphNode_t node,
                           const cudaKernelNodeParams& kp) {
  std::vector<cudaGraphNode_t> deps, dependents;
  cudaError_t err;
  if ((err = edges_of(node, true, &deps)) != cudaSuccess) return err;
  if ((err = edges_of(node, false, &dependents)) != cudaSuccess) return err;
  cudaGraphNode_t kernel;
  err = cudaGraphAddKernelNode(&kernel, graph, deps.data(), deps.size(), &kp);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t d : dependents)
    if ((err = add_edge(graph, kernel, d)) != cudaSuccess) return err;
  return cudaGraphDestroyNode(node);
}

// A memset node → a fill_rows node.
cudaError_t replace_memset(cudaGraph_t graph, cudaGraphNode_t node) {
  cudaMemsetParams p;
  cudaError_t err = cudaGraphMemsetNodeGetParams(node, &p);
  if (err != cudaSuccess) return err;
  uint32_t pattern = 0;
  if (!replicate(p.value, p.elementSize, &pattern)) return cudaErrorInvalidValue;
  const uintptr_t dst = reinterpret_cast<uintptr_t>(p.dst);
  if (dst % p.elementSize || (p.height > 1 && p.pitch % p.elementSize))
    return cudaErrorMisalignedAddress;
  char* out = static_cast<char*>(p.dst);
  size_t pitch = p.pitch;
  size_t row_bytes = p.width * p.elementSize;
  size_t height = p.height;
  void* args[] = {&out, &pitch, &pattern, &row_bytes, &height};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(fill_rows);
  kp.gridDim = fill_grid(row_bytes, height);
  kp.blockDim = dim3(kThreads, 1, 1);
  kp.kernelParams = args;
  return swap_in_kernel(graph, node, kp);
}

// Where a kernel on the current device reaches `ptr`: device and managed
// memory as they are, page-locked host memory through its device mapping;
// null for pageable host memory.
cudaError_t device_address(const void* ptr, const void** out) {
  cudaPointerAttributes a;
  cudaError_t err = cudaPointerGetAttributes(&a, ptr);
  if (err != cudaSuccess) return err;
  *out = a.type == cudaMemoryTypeUnregistered ? nullptr : a.devicePointer;
  return cudaSuccess;
}

// A memcpy node between linear memory → a copy_rows node. *replaced is
// false (and the node kept) where a side is a CUDA array or pageable host
// memory, which no kernel reaches.
cudaError_t replace_memcpy(cudaGraph_t graph, cudaGraphNode_t node, bool* replaced) {
  *replaced = false;
  cudaMemcpy3DParms p;
  cudaError_t err = cudaGraphMemcpyNodeGetParams(node, &p);
  if (err != cudaSuccess) return err;
  if (p.srcArray || p.dstArray) return cudaSuccess;
  const void *src_base, *dst_base;
  if ((err = device_address(p.srcPtr.ptr, &src_base)) != cudaSuccess) return err;
  if ((err = device_address(p.dstPtr.ptr, &dst_base)) != cudaSuccess) return err;
  if (!src_base || !dst_base) return cudaSuccess;
  const char* src = static_cast<const char*>(src_base) +
      ((p.srcPos.z * p.srcPtr.ysize + p.srcPos.y) * p.srcPtr.pitch + p.srcPos.x);
  char* dst = static_cast<char*>(const_cast<void*>(dst_base)) +
      ((p.dstPos.z * p.dstPtr.ysize + p.dstPos.y) * p.dstPtr.pitch + p.dstPos.x);
  size_t dst_pitch = p.dstPtr.pitch, dst_plane = p.dstPtr.pitch * p.dstPtr.ysize;
  size_t src_pitch = p.srcPtr.pitch, src_plane = p.srcPtr.pitch * p.srcPtr.ysize;
  size_t row_bytes = p.extent.width, height = p.extent.height, planes = p.extent.depth;
  void* args[] = {&dst, &dst_pitch, &dst_plane, &src, &src_pitch, &src_plane,
                  &row_bytes, &height, &planes};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(copy_rows);
  kp.gridDim = fill_grid(row_bytes / 4, height * planes);
  kp.blockDim = dim3(kThreads, 1, 1);
  kp.kernelParams = args;
  if ((err = swap_in_kernel(graph, node, kp)) != cudaSuccess) return err;
  *replaced = true;
  return cudaSuccess;
}

}  // namespace

// Replace every memset node of `graph` (a cudaGraph_t, captured and not yet
// instantiated) by a kernel node that writes the same bytes, and every
// memcpy node between linear memory that a kernel reaches by a kernel node
// that copies the same bytes, each with the same dependencies and
// dependents. counts[0] is set to the memset nodes replaced, counts[1] to
// the memcpy nodes. Call with the graph's device current. Returns a
// cudaError_t (0 on success); on an error the graph may be part-rewritten
// and must not be instantiated.
extern "C" int vv_graph_rewrite(void* graph, int* counts) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  counts[0] = counts[1] = 0;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && (err = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) return (int)err;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return (int)err;
    if (type == cudaGraphNodeTypeMemset) {
      if ((err = replace_memset(g, node)) != cudaSuccess) return (int)err;
      ++counts[0];
    } else if (type == cudaGraphNodeTypeMemcpy) {
      bool replaced;
      if ((err = replace_memcpy(g, node, &replaced)) != cudaSuccess) return (int)err;
      counts[1] += replaced;
    }
  }
  return (int)cudaSuccess;
}
