// Device marks of the serving tracer (repro_torch/core/spans.py).
//
// Replaces no TPU kernel: the reference package has no device marks. It was
// added so that the time between two points of the model step can be read
// from inside a captured CUDA graph, where no host code runs at replay.
//
// A mark is a one-thread kernel: it reads %globaltimer and writes (code,
// time) into a ring in device memory at the index it takes with an atomic
// bump of a device cursor, as the executor bumps its epoch words on the card.
// Captured into a graph, a stamp is one kernel node that every replay runs;
// the host reads the ring once, at export. The cursor counts on past the
// ring's capacity, so the host knows how many records were lost.
//
// Bound on an H100: launch latency. The work is one atomic and one 16-byte
// store.
#include "primitives.cuh"

#include <vector>

namespace msccl {

// ring: [capacity][2] words (code, %globaltimer ns); cursor: one word.
__global__ void span_stamp_kernel(unsigned long long* ring, unsigned long long* cursor,
                                  unsigned long long capacity, unsigned long long code) {
  const unsigned long long t = global_ns();
  const unsigned long long i = atomicAdd(cursor, 1ull);
  if (i < capacity) {
    ring[2 * i] = code;
    ring[2 * i + 1] = t;
  }
}

}  // namespace msccl

extern "C" {

// One stamp of `code` on `stream`. Returns the launch's cudaError_t (0 on
// success).
int span_stamp_launch(void* ring, void* cursor, long long capacity, long long code,
                      void* stream) {
  if (ring == nullptr || cursor == nullptr || capacity < 1 || code < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  msccl::span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), static_cast<unsigned long long*>(cursor),
      static_cast<unsigned long long>(capacity), static_cast<unsigned long long>(code));
  return static_cast<int>(cudaGetLastError());
}

// The nodes of a captured graph (cudaGraph_t), in the order the graph lists
// them: six words a node, at most `max_nodes` of them, into `out`: the node's
// cudaGraphNodeType; 1 for a stamp kernel node, else 0; and for a kernel node
// whose parameters the runtime reads, its function's address, its grid and
// block sizes (x * y * z) and its dynamic shared memory (-1 each for another
// node, or a kernel of a module the runtime does not know, as cuBLAS's).
// `count` receives the number of nodes. Returns 0 or the cudaError_t of
// listing the nodes.
int span_graph_nodes(void* graph, long long* out, int max_nodes, int* count) {
  *count = 0;
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> all(n);
  if (n && (err = cudaGraphGetNodes(g, all.data(), &n)) != cudaSuccess)
    return static_cast<int>(err);
  *count = static_cast<int>(n);
  const void* stamp = reinterpret_cast<const void*>(&msccl::span_stamp_kernel);
  for (size_t i = 0; i < n && i < static_cast<size_t>(max_nodes); ++i) {
    long long* w = out + 6 * i;
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(all[i], &type) != cudaSuccess) {
      cudaGetLastError();
      type = cudaGraphNodeTypeCount;
    }
    w[0] = static_cast<long long>(type);
    w[1] = 0;
    w[2] = w[3] = w[4] = w[5] = -1;
    cudaKernelNodeParams p;
    if (type != cudaGraphNodeTypeKernel ||
        cudaGraphKernelNodeGetParams(all[i], &p) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    w[1] = p.func == stamp;
    w[2] = static_cast<long long>(reinterpret_cast<uintptr_t>(p.func));
    w[3] = static_cast<long long>(p.gridDim.x) * p.gridDim.y * p.gridDim.z;
    w[4] = static_cast<long long>(p.blockDim.x) * p.blockDim.y * p.blockDim.z;
    w[5] = p.sharedMemBytes;
  }
  return 0;
}

const char* spans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
