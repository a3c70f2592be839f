// All-pairs AllToAll, every rank of the axis in one launch: the MoE
// expert-parallel dispatch and combine.
//
// Replaces the TPU kernel repro/kernels/alltoall.py: a2a_kernel (pallas_call
// at :59, all_to_all_pallas). Block c of rank me's buffer goes to rank c as
// its block me: out[c][me] = x[me][c], a row-block transpose across ranks.
//
// Design as ag_2pa_kernel in allpairs_2pa.cu: a cooperative launch of `nb`
// blocks per rank, each owning one contiguous tile of every block and its own
// flags [receiver][sender][block]. Rank me walks the peers in the reference's
// rotated order me, me + 1, ... (i == 0 is its own block, the reference's
// local copy) and puts block `peer` into slot [me] of the peer's output with
// 16-byte vector stores (scalar for an unaligned tail), then release-signals
// the peers and acquire-waits for their n - 1 deliveries: the reference's
// receiver-side wait. The flags carry a per-workspace epoch that grows every
// launch, so nothing is reset between calls. The reference's entry and exit
// barriers order launches on different devices; one launch holds every rank
// here, and stream order separates consecutive launches, so the waits are
// the whole completion contract.
//
// Bound on an H100: HBM bytes. Every rank reads its n blocks once and writes
// n blocks: 2 * n * n * count elements over 3.35 TB/s.
#include "primitives.cuh"

namespace msccl {

// x: [n][n][count] (rank, block); out: [n][n][count] (rank, sender);
// flags: [n][n][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
a2a_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out, unsigned* flags,
           long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* mine = x + static_cast<long long>(me) * n * count;  // my n blocks
  for (int i = 0; i < n; ++i) {  // i == 0: my own block into my slot [me]
    const int peer = (me + i) % n;
    put(out + (static_cast<long long>(peer) * n + me) * count + lo, mine + peer * count + lo,
        hi - lo);
  }
  signal_peers(flags, me, n, b, nb, epoch);
  wait_peers(flags, me, n, b, nb, epoch);
}

}  // namespace msccl

extern "C" {

// x: [n][n][count]; out: [n][n][count]; flags: [n][n][blocks]. Returns the
// launch's cudaError_t (0 on success).
int all_to_all_launch(const void* x, void* out, unsigned* flags, int dtype, int n,
                      long long count, int blocks, unsigned epoch, int threads, void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, a2a_kernel), n * blocks, threads, args,
                            stream);
}

const char* alltoall_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
