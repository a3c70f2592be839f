// DSL executor kernel: interprets a compiled collective plan over
// put / signal / wait primitives, every rank of the axis in one launch.
//
// Replaces the TPU kernel repro/core/executor.py:PallasExecutor._kernel
// (pallas_call at repro/core/executor.py:822). The host side
// (repro_torch/core/executor.py:encode) resolves every IndexExpr per rank
// into an int32 table [n][ops][8]; rank r's block walks row r in order.
//
// Design (this slice's simple form):
// * One block per rank, launched cooperatively so all n blocks are resident
//   at once — rank blocks spin on each other's flags and would deadlock
//   otherwise. One block per rank is the first thing a later optimisation
//   changes (several blocks per rank, or warp-specialised puts).
// * Buffers arrive as a table of per-rank base pointers. On one card they
//   all point into one allocation; a multi-card launch can fill the same
//   table with peer pointers.
// * Each put owns one flag slot at its receiver and writes it with the
//   launch's epoch (a counter the wrapper bumps per launch). Slots never
//   alias, so the reference's rotation over 4 DMA semaphore pairs and its
//   wrap barrier are gone, and replays need no memset.
// * No entry or exit barrier: the reference needs start_barrier /
//   device_barrier (primitives.py:224-303) because a peer device may not
//   have entered the kernel yet or may still read; here one launch holds
//   every rank and stream order separates launches. BARRIER instructions
//   inside a program still rendezvous through epoch-tagged flags.
// * REDUCE left-folds its operands in declaration order and rounds to the
//   buffer type after each add, exactly like `acc + v` on torch tensors, so
//   the kernel is bit-equal to TorchExecutor in bf16 as well as f32.
//
// * A group view: one launch can run the same plan over `groups` disjoint
//   groups of n ranks, block g * n + m playing member m of group g, which is
//   rank g % stride + m * stride + (g / stride) * n * stride of the buffer
//   table; each group has its own flags. stride 1 gives contiguous groups
//   (the local axis of a node-major grid), stride L the ranks of one local
//   index across nodes (the node axis), read in place, with no transposing
//   copy. One group at stride 1 is the plain single-axis launch.
//
// Bound on an H100 SXM: the bytes moved through HBM (each input read once,
// each output written once, at 3.35 TB/s), and at decode sizes (a few to a
// few hundred KB) the launch latency and the flag round trips, which one
// block per rank does nothing to hide.
#include "primitives.cuh"

#include <string.h>

namespace msccl {

constexpr int kMaxBufs = 8;       // MAX_BUFFERS
constexpr int kMaxGridRanks = 16; // MAX_RANKS: ranks of all groups of one launch
constexpr int kMaxOperands = 32;  // MAX_OPERANDS
constexpr int kFields = 8;        // FIELDS

enum : int { OP_NOP = 0, OP_PUT = 1, OP_WAIT = 2, OP_COPY = 3, OP_REDUCE = 4,
             OP_BARRIER = 5, OP_ZERO = 6 };

struct BufTable {
  void* p[kMaxBufs][kMaxGridRanks];  // [buffer id][rank] -> rank's base pointer
};

template <typename B>
__device__ __forceinline__ void zero(B* dst, long long count) {
  for (long long i = threadIdx.x; i < count; i += blockDim.x) dst[i] = B(0);
}

template <typename T>
__global__ void __launch_bounds__(1024)
dsl_executor_kernel(BufTable bufs, const int* __restrict__ ops, int n_ops,
                    const int* __restrict__ opnds, int opnds_per_rank,
                    unsigned* flags, int n_flags, int group_flags, unsigned epoch,
                    long long chunk_elems, int n, int stride) {
  using B = typename Elem<T>::B;
  __shared__ const B* s_src[kMaxOperands];
  const int g = blockIdx.x / n, me = blockIdx.x % n;  // group, member
  const int* row = ops + static_cast<long long>(me) * n_ops * kFields;
  const int* my_opnds = opnds + static_cast<long long>(me) * opnds_per_rank * 2;
  flags += static_cast<long long>(g) * group_flags;
  unsigned* bar_flags = flags + static_cast<long long>(n) * n_flags;
  const int rank0 = g % stride + (g / stride) * n * stride;  // member 0's rank
  auto chunk = [&](int buf, int member, int c) -> B* {
    return static_cast<B*>(bufs.p[buf][rank0 + member * stride]) +
           static_cast<long long>(c) * chunk_elems;
  };

  for (int i = 0; i < n_ops; ++i) {
    const int* f = row + i * kFields;
    switch (f[0]) {
      case OP_PUT: {  // [op, src_buf, src_chunk, dst_buf, dst_chunk, peer, nchunks, flag]
        const int peer = f[5];
        put(chunk(f[3], peer, f[4]), chunk(f[1], me, f[2]), f[6] * chunk_elems);
        signal(flags + static_cast<long long>(peer) * n_flags + f[7], epoch);
        break;
      }
      case OP_WAIT:
        wait(flags + static_cast<long long>(me) * n_flags + f[7], epoch);
        break;
      case OP_COPY:
        put(chunk(f[3], me, f[4]), chunk(f[1], me, f[2]), f[6] * chunk_elems);
        __syncthreads();
        break;
      case OP_REDUCE: {  // [op, operand_start, operand_count, dst_buf, dst_chunk, ...]
        if (threadIdx.x < f[2]) {
          const int* o = my_opnds + 2 * (f[1] + threadIdx.x);
          s_src[threadIdx.x] = chunk(o[0], me, o[1]);
        }
        __syncthreads();
        reduce<T>(chunk(f[3], me, f[4]), s_src, f[2], chunk_elems);
        __syncthreads();
        break;
      }
      case OP_BARRIER:
        barrier(bar_flags + static_cast<long long>(f[7]) * n, me, n, epoch);
        break;
      case OP_ZERO:
        zero(chunk(f[3], me, f[4]), f[6] * chunk_elems);
        __syncthreads();
        break;
      default:  // OP_NOP pads shorter rows
        break;
    }
  }
}

}  // namespace msccl

extern "C" {

// Launch one replay over `groups` groups of n ranks (the group view above).
// `table` is a host array of kMaxBufs * kMaxGridRanks base pointers
// ([buffer][rank]); ops/opnds/flags are device pointers, flags
// `group_flags` words a group. Returns the launch's cudaError_t (0 on
// success).
int dsl_executor_launch(const void* table, int dtype, int n, int groups, int stride,
                        const int* ops, int n_ops, const int* opnds, int opnds_per_rank,
                        unsigned* flags, int n_flags, int group_flags, unsigned epoch,
                        long long chunk_elems, int threads, void* stream) {
  using namespace msccl;
  if (n < 1 || groups < 1 || stride < 1 || groups % stride || n * groups > kMaxGridRanks ||
      threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  BufTable t;
  memcpy(&t, table, sizeof(t));
  void* args[] = {&t, &ops, &n_ops, &opnds, &opnds_per_rank, &flags,
                  &n_flags, &group_flags, &epoch, &chunk_elems, &n, &stride};
  const void* fn;
  switch (dtype) {
    case 0: fn = reinterpret_cast<const void*>(&dsl_executor_kernel<float>); break;
    case 1: fn = reinterpret_cast<const void*>(&dsl_executor_kernel<__nv_bfloat16>); break;
    case 2: fn = reinterpret_cast<const void*>(&dsl_executor_kernel<__half>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  // cooperative: the launch fails instead of deadlocking when the rank
  // blocks cannot all be resident at once
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(n * groups), dim3(threads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* dsl_executor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
