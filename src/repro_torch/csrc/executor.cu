// DSL executor kernel: interprets a compiled collective plan over
// put / signal / wait primitives, every rank of the axis in one launch.
//
// Replaces the TPU kernel repro/core/executor.py:PallasExecutor._kernel
// (pallas_call at repro/core/executor.py:822). The host side
// (repro_torch/core/executor.py:encode) resolves every IndexExpr per rank
// into an int32 table [n][ops][8]; rank r's block walks row r in order.
//
// Design:
// * nb blocks per rank, launched cooperatively so all of them are resident
//   at once: blocks spin on each other's flags and would deadlock otherwise.
//   Block (g, m, b) plays member m of group g and owns tile b of every chunk
//   (contiguous, 16-byte-aligned bounds, the last tile takes the tail:
//   primitives.cuh:tile). PUT, COPY, REDUCE and ZERO are elementwise over a
//   chunk and keep an element's offset, so tile b's instruction stream is the
//   rank's stream restricted to tile b: blocks of different tiles never touch
//   the same element and need no ordering between them.
// * Buffers arrive as a table of per-rank base pointers. On one card they
//   all point into one allocation; a multi-card launch can fill the same
//   table with peer pointers.
// * Each put owns one flag slot at its receiver, one word per tile
//   ([receiver][slot][tile]), written by the sender's block b with the
//   launch's epoch. Slots never alias, so the reference's rotation over 4
//   DMA semaphore pairs and its wrap barrier are gone, and replays need no
//   memset.
// * The epoch lives in device memory, one word per block of the launch
//   (zeroed when the wrapper binds the flags): thread 0 of each block bumps
//   its own word (never to 0) and shares it through shared memory. Every
//   block runs once per launch, so the words stay equal, and stream order
//   carries them to the next launch, eager or a CUDA-graph replay. Nothing
//   of the launch comes from the host but the plan, so a captured launch
//   replays with a fresh epoch each time.
// * No entry or exit barrier: the reference needs start_barrier /
//   device_barrier (primitives.py:224-303) because a peer device may not
//   have entered the kernel yet or may still read; here one launch holds
//   every rank and stream order separates launches. A BARRIER instruction
//   is a rendezvous of block b of every member ([barrier][member][tile]
//   flags): no block touches another tile, so that orders everything the
//   barrier orders.
// * REDUCE left-folds its operands in declaration order and rounds to the
//   buffer type after each add, exactly like `acc + v` on torch tensors, so
//   the kernel is bit-equal to TorchExecutor in bf16 as well as f32; each
//   vector step issues all its operand loads before the adds.
// * The wrapper picks nb (about one 16-byte vector a thread of a chunk, at
//   most what the occupancy query keeps resident over all ranks;
//   core/executor.py:blocks_per_rank) for blocks of 256 threads. The launch
//   is cudaLaunchKernelEx with the cooperative attribute, which a stream
//   capture records as a cooperative kernel node.
//
// * A group view: one launch can run the same plan over `groups` disjoint
//   groups of n ranks, rank block g * n + m playing member m of group g,
//   which is rank g % stride + m * stride + (g / stride) * n * stride of the
//   buffer table; each group has its own flags. stride 1 gives contiguous
//   groups (the local axis of a node-major grid), stride L the ranks of one
//   local index across nodes (the node axis), read in place, with no
//   transposing copy. One group at stride 1 is the plain single-axis launch.
//
// * Tracing: a second instantiation of the same body stamps every op of
//   every block (%globaltimer and clock64(), thread 0, between two
//   __syncthreads()) into a device array; the untraced kernel keeps its
//   parameters and code. The wrapper launches the traced kernel only outside
//   a CUDA-graph capture, and dsl_executor_graph_nodes counts the two kinds
//   apart, so a captured decode step holds untraced nodes alone.
//
// Bound on an H100 SXM: the bytes moved through HBM (each input read once,
// each output written once, at 3.35 TB/s), and at decode sizes (a few to a
// few hundred KB) the launch latency and the flag round trips, which run in
// parallel over the blocks of a rank but are not hidden.
#include "primitives.cuh"

#include <string.h>

#include <vector>

namespace msccl {

constexpr int kMaxBufs = 8;       // MAX_BUFFERS
constexpr int kMaxGridRanks = 16; // MAX_RANKS: ranks of all groups of one launch
constexpr int kMaxOperands = 32;  // MAX_OPERANDS
constexpr int kFields = 8;        // FIELDS
constexpr int kMaxThreads = 512;  // threads a block, at most

enum : int { OP_NOP = 0, OP_PUT = 1, OP_WAIT = 2, OP_COPY = 3, OP_REDUCE = 4,
             OP_BARRIER = 5, OP_ZERO = 6 };

struct BufTable {
  void* p[kMaxBufs][kMaxGridRanks];  // [buffer id][rank] -> rank's base pointer
};

template <typename B>
__device__ __forceinline__ void zero(B* dst, long long count) {
  for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = B(0);
}

// The kernel's body, for the untraced kernel (kTrace false: the kernel the
// plans run, instruction for instruction) and the traced one. With kTrace,
// thread 0 of each block stamps every op of its row: after a __syncthreads()
// before the op and another after it (so the stamps bracket every thread's
// part of the op), it writes %globaltimer and clock64() into
// stamps[block][op] = {global start, global end, clock start, clock end}.
// The host turns them into one event per op and rank (core/trace.py): the
// earliest start over the rank's blocks is the op's issue, the latest end
// its completion.
template <typename T, bool kTrace>
__device__ __forceinline__ void executor_body(
    const BufTable& bufs, const int* __restrict__ ops, int n_ops,
    const int* __restrict__ opnds, int opnds_per_rank, unsigned* flags, int n_flags,
    int group_flags, unsigned* __restrict__ epochs, long long chunk_elems, int n, int stride,
    int nb, unsigned long long* __restrict__ stamps) {
  using B = typename Elem<T>::B;
  __shared__ const B* s_src[kMaxOperands];
  __shared__ unsigned s_epoch;
  if (threadIdx.x == 0) {  // this launch's epoch: the block's word, bumped
    const unsigned e = epochs[blockIdx.x] % 0xFFFFFFFFu + 1u;
    epochs[blockIdx.x] = e;
    s_epoch = e;
  }
  __syncthreads();
  const unsigned epoch = s_epoch;
  const int rank_block = blockIdx.x / nb, b = blockIdx.x % nb;
  const int g = rank_block / n, me = rank_block % n;  // group, member
  const int* row = ops + static_cast<long long>(me) * n_ops * kFields;
  const int* my_opnds = opnds + static_cast<long long>(me) * opnds_per_rank * 2;
  flags += static_cast<long long>(g) * group_flags;
  unsigned* bar_flags = flags + static_cast<long long>(n) * n_flags * nb;
  const int rank0 = g % stride + (g / stride) * n * stride;  // member 0's rank
  long long lo, hi;
  tile(chunk_elems, 16 / sizeof(B), b, nb, lo, hi);
  const long long len = hi - lo;
  // tile b of chunk c of `member`'s buffer
  auto chunk = [&](int buf, int member, int c) -> B* {
    return static_cast<B*>(bufs.p[buf][rank0 + member * stride]) +
           static_cast<long long>(c) * chunk_elems + lo;
  };
  // flag word of put slot `slot` at `member`, tile b
  auto put_flag = [&](int member, int slot) -> unsigned* {
    return flags + (static_cast<long long>(member) * n_flags + slot) * nb + b;
  };

  for (int i = 0; i < n_ops; ++i) {
    unsigned long long* st = nullptr;
    if constexpr (kTrace) {
      __syncthreads();
      if (threadIdx.x == 0) {
        st = stamps + (static_cast<long long>(blockIdx.x) * n_ops + i) * 4;
        st[0] = global_ns();
        st[2] = static_cast<unsigned long long>(clock64());
      }
    }
    const int* f = row + i * kFields;
    switch (f[0]) {
      case OP_PUT: {  // [op, src_buf, src_chunk, dst_buf, dst_chunk, peer, nchunks, flag]
        const int peer = f[5];
        for (int j = 0; j < f[6]; ++j)
          put(chunk(f[3], peer, f[4] + j), chunk(f[1], me, f[2] + j), len);
        signal(put_flag(peer, f[7]), epoch);
        break;
      }
      case OP_WAIT:
        wait(put_flag(me, f[7]), epoch);
        break;
      case OP_COPY:
        for (int j = 0; j < f[6]; ++j) put(chunk(f[3], me, f[4] + j), chunk(f[1], me, f[2] + j), len);
        __syncthreads();
        break;
      case OP_REDUCE: {  // [op, operand_start, operand_count, dst_buf, dst_chunk, ...]
        if (threadIdx.x < f[2]) {
          const int* o = my_opnds + 2 * (f[1] + threadIdx.x);
          s_src[threadIdx.x] = chunk(o[0], me, o[1]);
        }
        __syncthreads();
        reduce<T>(chunk(f[3], me, f[4]), s_src, f[2], len);
        __syncthreads();
        break;
      }
      case OP_BARRIER:
        barrier(bar_flags + static_cast<long long>(f[7]) * n * nb + b, me, n, epoch, nb);
        break;
      case OP_ZERO:
        for (int j = 0; j < f[6]; ++j) zero(chunk(f[3], me, f[4] + j), len);
        __syncthreads();
        break;
      default:  // OP_NOP pads shorter rows
        break;
    }
    if constexpr (kTrace) {
      __syncthreads();
      if (threadIdx.x == 0) {
        st[1] = global_ns();
        st[3] = static_cast<unsigned long long>(clock64());
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dsl_executor_kernel(BufTable bufs, const int* __restrict__ ops, int n_ops,
                    const int* __restrict__ opnds, int opnds_per_rank,
                    unsigned* flags, int n_flags, int group_flags,
                    unsigned* __restrict__ epochs, long long chunk_elems, int n,
                    int stride, int nb) {
  executor_body<T, false>(bufs, ops, n_ops, opnds, opnds_per_rank, flags, n_flags, group_flags,
                          epochs, chunk_elems, n, stride, nb, nullptr);
}

// The traced instantiation: the same body with the stamps. It is launched
// only outside a CUDA-graph capture (core/executor.py: CudaExecutor.
// launch_traced), so a captured graph holds untraced nodes alone.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dsl_executor_traced_kernel(BufTable bufs, const int* __restrict__ ops, int n_ops,
                           const int* __restrict__ opnds, int opnds_per_rank,
                           unsigned* flags, int n_flags, int group_flags,
                           unsigned* __restrict__ epochs, long long chunk_elems, int n,
                           int stride, int nb, unsigned long long* __restrict__ stamps) {
  executor_body<T, true>(bufs, ops, n_ops, opnds, opnds_per_rank, flags, n_flags, group_flags,
                         epochs, chunk_elems, n, stride, nb, stamps);
}

// One thread reads %globaltimer in a tight loop for `spin_ns`: the least
// step between two different readings is the timer's tick on this card,
// and the clock64() cycles over the same span give the SM clock.
// out = {tick ns, span ns, span cycles, readings that changed}.
__global__ void timer_probe_kernel(long long spin_ns, unsigned long long* out) {
  if (threadIdx.x != 0) return;
  const long long c0 = clock64();
  const unsigned long long g0 = global_ns();
  unsigned long long prev = g0, g = g0, tick = ~0ull, changes = 0;
  while ((g = global_ns()) - g0 < static_cast<unsigned long long>(spin_ns)) {
    if (g != prev) {
      if (g - prev < tick) tick = g - prev;
      prev = g;
      ++changes;
    }
  }
  const long long c1 = clock64();
  out[0] = tick;
  out[1] = g - g0;
  out[2] = static_cast<unsigned long long>(c1 - c0);
  out[3] = changes;
}

}  // namespace msccl

namespace msccl {

// The kernel of `dtype` (the traced one with kTrace), nullptr for an
// unknown code.
template <bool kTrace>
const void* executor_fn(int dtype) {
  if constexpr (kTrace) return MSCCL_BY_DTYPE(dtype, dsl_executor_traced_kernel);
  else return MSCCL_BY_DTYPE(dtype, dsl_executor_kernel);
}

template <bool kTrace>
int max_blocks(int dtype, int threads) {
  const void* fn = executor_fn<kTrace>(dtype);
  int dev = 0, sms = 0, per_sm = 0;
  if (fn == nullptr || threads < 32 || threads > kMaxThreads ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <bool kTrace>
int launch(const void* table, int dtype, int n, int groups, int stride, const int* ops,
           int n_ops, const int* opnds, int opnds_per_rank, unsigned* flags, int n_flags,
           int group_flags, unsigned* epochs, long long chunk_elems, int nb, int threads,
           unsigned long long* stamps, void* stream) {
  if (n < 1 || groups < 1 || stride < 1 || groups % stride || n * groups > kMaxGridRanks ||
      nb < 1 || threads > kMaxThreads || epochs == nullptr || (kTrace && stamps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BufTable t;
  memcpy(&t, table, sizeof(t));
  void* args[] = {&t, &ops, &n_ops, &opnds, &opnds_per_rank, &flags, &n_flags,
                  &group_flags, &epochs, &chunk_elems, &n, &stride, &nb, &stamps};
  return launch_cooperative(executor_fn<kTrace>(dtype), n * groups * nb, threads, args, stream);
}

}  // namespace msccl

extern "C" {

// The most blocks of the executor kernel for `dtype` at `threads` that the
// card keeps resident at once (the cooperative launch's limit); 0 on an
// error. The traced kernel asks its own function: it may need more
// registers, and its launch must fit its own limit.
int dsl_executor_max_blocks(int dtype, int threads) {
  return msccl::max_blocks<false>(dtype, threads);
}

int dsl_executor_max_blocks_traced(int dtype, int threads) {
  return msccl::max_blocks<true>(dtype, threads);
}

// Launch one replay over `groups` groups of n ranks (the group view above),
// nb blocks a rank. `table` is a host array of kMaxBufs * kMaxGridRanks base
// pointers ([buffer][rank]); ops/opnds/flags/epochs are device pointers, flags
// `group_flags` words a group ([member][slot][tile] put flags, then
// [barrier][member][tile]), epochs one word per block (n * groups * nb).
// Returns the launch's cudaError_t (0 on success).
int dsl_executor_launch(const void* table, int dtype, int n, int groups, int stride,
                        const int* ops, int n_ops, const int* opnds, int opnds_per_rank,
                        unsigned* flags, int n_flags, int group_flags, unsigned* epochs,
                        long long chunk_elems, int nb, int threads, void* stream) {
  return msccl::launch<false>(table, dtype, n, groups, stride, ops, n_ops, opnds, opnds_per_rank,
                              flags, n_flags, group_flags, epochs, chunk_elems, nb, threads,
                              nullptr, stream);
}

// The same launch of the traced kernel; `stamps` is a device array of
// n * groups * nb * n_ops * 4 words (see executor_body).
int dsl_executor_launch_traced(const void* table, int dtype, int n, int groups, int stride,
                               const int* ops, int n_ops, const int* opnds, int opnds_per_rank,
                               unsigned* flags, int n_flags, int group_flags, unsigned* epochs,
                               long long chunk_elems, int nb, int threads,
                               unsigned long long* stamps, void* stream) {
  return msccl::launch<true>(table, dtype, n, groups, stride, ops, n_ops, opnds, opnds_per_rank,
                             flags, n_flags, group_flags, epochs, chunk_elems, nb, threads,
                             stamps, stream);
}

// Launch the timer probe (one block) on `stream`; `out` is a device array of
// 4 words (see timer_probe_kernel).
int dsl_executor_timer_probe(long long spin_ns, unsigned long long* out, void* stream) {
  msccl::timer_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(spin_ns, out);
  return static_cast<int>(cudaGetLastError());
}

// Walk a captured graph (cudaGraph_t) and count its kernel nodes of the
// untraced executor kernel (any element type), of those the ones whose
// launch carries the cooperative attribute, and the nodes of the traced
// kernel (none, where tracing stays out of captures). Nodes of other
// kernels (PyTorch's, cuBLAS's) are skipped, an error of their query
// included. Returns 0 or the cudaError_t of listing the nodes.
int dsl_executor_graph_nodes(void* graph, int* nodes, int* cooperative, int* traced) {
  using namespace msccl;
  *nodes = *cooperative = *traced = 0;
  size_t count = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> all(count);
  if (count && (err = cudaGraphGetNodes(g, all.data(), &count)) != cudaSuccess)
    return static_cast<int>(err);
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    cudaKernelNodeParams p;
    if (cudaGraphNodeGetType(node, &type) != cudaSuccess || type != cudaGraphNodeTypeKernel ||
        cudaGraphKernelNodeGetParams(node, &p) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    bool ours = false, tr = false;
    for (int code = 0; code < 4; ++code) {
      ours |= p.func == executor_fn<false>(code);
      tr |= p.func == executor_fn<true>(code);
    }
    *traced += tr;
    if (!ours) continue;
    ++*nodes;
    cudaLaunchAttributeValue v;
    if (cudaGraphKernelNodeGetAttribute(node, cudaLaunchAttributeCooperative, &v) == cudaSuccess &&
        v.cooperative)
      ++*cooperative;
    cudaGetLastError();
  }
  return 0;
}

const char* dsl_executor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
