// Ring AllGather, every rank of the axis in one launch.
//
// Replaces the TPU kernel repro/kernels/allgather_ring.py:ag_ring_kernel
// (pallas_call at :57). n - 1 dependent steps: at step i rank me forwards
// row block (me - i) mod n of its output into the same row block of next's
// output, sets next's step-i flag, and waits for its own step-i flag from
// prev before it forwards that block at step i + 1.
//
// Design as in allpairs_2pa.cu: cooperative launch of `nb` blocks per rank,
// each owning one contiguous tile of every row block and its own flags
// [receiver][step][block]; 16-byte vector puts through L2 (ld.global.cg, as
// the forwarded tile was written by prev's block on another SM);
// release/acquire flags tagged with a per-workspace epoch; no entry or exit
// barrier. Step 0 forwards straight from the input, which equals row block
// me of the output.
//
// Bound on an H100: HBM bytes (each rank reads its chunk once and writes n);
// the ring adds n - 1 flag round trips in series and moves every forwarded
// tile through HBM twice more (read back by the next rank), which is what
// makes it lose to all-pairs on one card.
#include "primitives.cuh"

namespace msccl {

// x: [n][count]; out: [n][n][count] (rank, row block); flags [n][n-1][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
ag_ring_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out,
               unsigned* flags, long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const int nxt = (me + 1) % n;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* mine = x + me * count;
  B* my_out = out + static_cast<long long>(me) * n * count;
  B* next_out = out + static_cast<long long>(nxt) * n * count;

  put(my_out + me * count + lo, mine + lo, hi - lo);
  for (int i = 0; i < n - 1; ++i) {
    const int slot = (me - i + n) % n;
    const B* src = i == 0 ? mine : my_out + slot * count;
    put(next_out + slot * count + lo, src + lo, hi - lo);
    signal(flags + (static_cast<long long>(nxt) * (n - 1) + i) * nb + b, epoch);
    wait(flags + (static_cast<long long>(me) * (n - 1) + i) * nb + b, epoch);
  }
}

}  // namespace msccl

extern "C" {

// x: [n][count]; out: [n][n][count]; flags: [n][n-1][blocks] (at least one
// word). Returns the launch's cudaError_t (0 on success).
int allgather_ring_launch(const void* x, void* out, unsigned* flags, int dtype, int n,
                          long long count, int blocks, unsigned epoch, int threads,
                          void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, ag_ring_kernel), n * blocks, threads, args,
                            stream);
}

const char* allgather_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
