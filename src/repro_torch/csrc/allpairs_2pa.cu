// All-pairs ReduceScatter and AllGather, the two phases of 2PA AllReduce,
// every rank of the axis in one launch each.
//
// Replaces the TPU kernels repro/kernels/reducescatter_2pa.py:
// rs_allpairs_kernel (pallas_call at :96) and ag_allpairs_kernel
// (pallas_call at :118). 2PA AllReduce is RS then AG: two launches, as the
// reference makes two pallas_calls.
//
// * ReduceScatter: rank me puts its contribution to chunk c into rank c's
//   slot [me], waits for its n - 1 slots and folds chunk me rotated from
//   itself (x[me][me] + slot[me+1] + ... + slot[me-1]), rounding after each
//   add as the reference does.
// * AllGather: rank me puts its chunk straight into row block [me] of every
//   rank's output (its own included), then signals; each rank waits for its
//   n - 1 arrivals. No rank reads what it received inside the launch, so the
//   waits only keep the reference's completion contract.
//
// Design as in allreduce_1pa.cu's HB path: cooperative launch of `nb`
// blocks per rank, each owning one contiguous tile of every chunk and its
// own flags [receiver][sender][block]; 16-byte vector puts; release/acquire
// flags tagged with a per-workspace epoch, so nothing is reset between
// launches; no entry or exit barrier (one launch holds every rank).
//
// Bound on an H100: HBM bytes. RS reads n chunks and writes one per rank;
// AG reads one chunk and writes n per rank.
#include "primitives.cuh"

namespace msccl {

// x: [n][n][count] (rank, chunk); out: [n][count]; scratch [n][n][count]
// (receiver, sender); flags [n][n][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
rs_2pa_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
              typename Elem<T>::B* scratch, unsigned* flags, long long count, int n, int nb,
              unsigned epoch) {
  using B = typename Elem<T>::B;
  __shared__ const B* s_src[kMaxRanks];
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* mine = x + static_cast<long long>(me) * n * count;  // my n chunks

  for (int i = 1; i < n; ++i) {
    const int peer = (me + i) % n;
    put(scratch + (static_cast<long long>(peer) * n + me) * count + lo, mine + peer * count + lo,
        hi - lo);
  }
  signal_peers(flags, me, n, b, nb, epoch);
  wait_peers(flags, me, n, b, nb, epoch);
  const int t = threadIdx.x;
  if (t < n) {
    const int peer = (me + t) % n;
    s_src[t] = t == 0 ? mine + me * count + lo
                      : scratch + (static_cast<long long>(me) * n + peer) * count + lo;
  }
  __syncthreads();
  reduce<T>(out + me * count + lo, s_src, n, hi - lo);
}

// x: [n][count]; out: [n][n][count] (rank, row block); flags [n][n][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
ag_2pa_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out,
              unsigned* flags, long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* mine = x + me * count;
  for (int i = 0; i < n; ++i) {  // i == 0: my own row block
    const int peer = (me + i) % n;
    put(out + (static_cast<long long>(peer) * n + me) * count + lo, mine + lo, hi - lo);
  }
  signal_peers(flags, me, n, b, nb, epoch);
  wait_peers(flags, me, n, b, nb, epoch);
}

}  // namespace msccl

extern "C" {

// x: [n][n][count]; out: [n][count]; scratch: [n][n][count]; flags:
// [n][n][blocks]. Returns the launch's cudaError_t (0 on success).
int reduce_scatter_2pa_launch(const void* x, void* out, void* scratch, unsigned* flags, int dtype,
                              int n, long long count, int blocks, unsigned epoch, int threads,
                              void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &scratch, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, rs_2pa_kernel), n * blocks, threads, args,
                            stream);
}

// x: [n][count]; out: [n][n][count]; flags: [n][n][blocks].
int all_gather_2pa_launch(const void* x, void* out, unsigned* flags, int dtype, int n,
                          long long count, int blocks, unsigned epoch, int threads,
                          void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, ag_2pa_kernel), n * blocks, threads, args,
                            stream);
}

const char* allpairs_2pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
