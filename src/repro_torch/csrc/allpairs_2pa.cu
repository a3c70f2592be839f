// All-pairs ReduceScatter and AllGather, the two phases of 2PA AllReduce,
// every rank of the axis in one launch each.
//
// Replaces the TPU kernels repro/kernels/reducescatter_2pa.py:
// rs_allpairs_kernel (pallas_call at :96) and ag_allpairs_kernel
// (pallas_call at :118). 2PA AllReduce is RS then AG: two launches, as the
// reference makes two pallas_calls.
//
// * ReduceScatter: rank me puts its contribution to chunk c into rank c's
//   slot [me] and folds chunk me rotated from itself (x[me][me] +
//   slot[me+1] + ... + slot[me-1]), rounding after each add as the
//   reference does. Two protocols, picked by the wrapper from a rank's
//   input bytes (kernels/reducescatter_2pa.py:LL_MAX_BYTES), with the same
//   fold, so both are bit-equal to the plain version:
//   - LL (small sizes): the contribution goes as LL packets (primitives.cuh:
//     LLPacket, 4 data bytes and the launch's epoch in one 8-byte store) into
//     rank c's packet slot [me]; rank c's threads spin on each packet and
//     fold as the packets arrive. Each thread owns one packet word of the
//     chunk; there is no signal, no fence and no __syncthreads on the path.
//     The launch and one packet's trip are the whole latency.
//   - HB: 16-byte vector puts into rank c's element slot [me], then one
//     release flag per (peer, block); the receiver acquire-spins on its
//     n - 1 flags and folds its tile from the slots.
// * AllGather: rank me stores its chunk into row block [me] of its own
//   output and sends it to row block [me] of every peer's; each rank waits
//   for its n - 1 arrivals. Two protocols, picked by the wrapper from a
//   rank's input bytes (kernels/reducescatter_2pa.py:AG_LL_MAX_BYTES):
//   - LL (small sizes): each thread owns one packet word of the chunk, puts
//     it as an LL packet into packet slot [me] of each peer, then loads the
//     n - 1 packets of its word back to back (their trips overlap), spins
//     only on one not there yet, and stores each data word into row block
//     [peer]. Packet arrival is the wait; there is no signal, no fence and
//     no __syncthreads on the path.
//   - HB: 16-byte vector puts straight into row block [me] of every rank's
//     output, then one release flag per (peer, block) and the acquire-spins
//     on the n - 1 flags; no rank reads what it received inside the launch,
//     so the waits only keep the reference's completion contract. A packet
//     carries 4 data bytes in 8, so HB wins once bandwidth, not the
//     latency of the flag round trip, sets the time.
//
// Design: cooperative launch of `nb` blocks per rank, each owning one
// contiguous tile of every chunk and (HB) its own flags [receiver][sender]
// [block]; release/acquire flags and packets tagged with a per-workspace
// epoch, so nothing is reset between launches; no entry or exit barrier
// (one launch holds every rank).
//
// Bound on an H100: HBM bytes. RS reads n chunks and writes one per rank;
// AG reads one chunk and writes n per rank. At decode sizes (tens of KB) the
// launch and one synchronisation, which LL shortens to one packet's trip.
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

// x: [n][n][count] (rank, chunk); out: [n][count]; pk: [receiver][sender]
// [words] packets, a word of chunk c being load_word's 4 bytes of it.
template <typename T>
__global__ void __launch_bounds__(1024)
rs_2pa_ll_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 LLPacket* pk, long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  constexpr int per_word = 4 / sizeof(B);
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const long long words = (count + per_word - 1) / per_word;
  long long lo, hi;
  tile(words, 1, b, nb, lo, hi);
  const B* mine = x + static_cast<long long>(me) * n * count;  // my n chunks

  // fan-out: word w of my contribution to chunk peer into peer's slot [me]
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    for (int i = 1; i < n; ++i) {
      const int peer = (me + i) % n;
      put_ll(pk + (static_cast<long long>(peer) * n + me) * words + w,
             load_word<T>(mine + peer * count, count, w), epoch);
    }
  }
  // rotated fold of chunk me. The n - 1 packets of a word are loaded back
  // to back, so their trips overlap; only a packet that was not there yet
  // is then waited for.
  const LLPacket* slots = pk + static_cast<long long>(me) * n * words;
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    unsigned d[kMaxRanks], f[kMaxRanks];
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i)
      if (i < n) ld_ll(slots + static_cast<long long>((me + i) % n) * words + w, d[i], f[i]);
    unsigned acc = load_word<T>(mine + me * count, count, w);
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i) {
      if (i < n) {
        const LLPacket* p = slots + static_cast<long long>((me + i) % n) * words + w;
        acc = add_word<T>(acc, f[i] == epoch ? d[i] : read_ll(p, epoch));
      }
    }
    store_word<T>(out + me * count, count, w, acc);
  }
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

// x: [n][count]; out: [n][n][count] (rank, row block); pk: [receiver]
// [sender][words] packets, a word being load_word's 4 bytes of a chunk.
template <typename T>
__global__ void __launch_bounds__(1024)
ag_2pa_ll_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 LLPacket* pk, long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  constexpr int per_word = 4 / sizeof(B);
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const long long words = (count + per_word - 1) / per_word;
  long long lo, hi;
  tile(words, 1, b, nb, lo, hi);
  const B* mine = x + me * count;
  B* rows = out + static_cast<long long>(me) * n * count;  // my n row blocks

  // fan-out: word w of my chunk into every peer's slot [me], and into my
  // own row block [me]
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    const unsigned v = load_word<T>(mine, count, w);
    for (int i = 1; i < n; ++i) {
      const int peer = (me + i) % n;
      put_ll(pk + (static_cast<long long>(peer) * n + me) * words + w, v, epoch);
    }
    store_word<T>(rows + me * count, count, w, v);
  }
  // each peer's packet of word w into row block [peer]; the packets were
  // sent at the same time, so once the first has arrived the rest mostly
  // have too (loading all n - 1 before the first wait measured no faster)
  const LLPacket* slots = pk + static_cast<long long>(me) * n * words;
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    for (int i = 1; i < n; ++i) {
      const int peer = (me + i) % n;
      store_word<T>(rows + peer * count, count, w,
                    read_ll(slots + static_cast<long long>(peer) * words + w, epoch));
    }
  }
}

}  // namespace msccl

extern "C" {

// x: [n][n][count]; out: [n][count]; for LL (use_ll) `slots` holds
// [n][n][words] packets, for HB [n][n][count] elements and `flags`
// [n][n][blocks]. Returns the launch's cudaError_t (0 on success).
int reduce_scatter_2pa_launch(const void* x, void* out, void* slots, unsigned* flags, int dtype,
                              int n, long long count, int blocks, int use_ll, unsigned epoch,
                              int threads, void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (use_ll) {
    void* args[] = {&x, &out, &slots, &count, &n, &blocks, &epoch};
    return launch_cooperative(MSCCL_BY_DTYPE(dtype, rs_2pa_ll_kernel), n * blocks, threads, args,
                              stream);
  }
  void* args[] = {&x, &out, &slots, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, rs_2pa_kernel), n * blocks, threads, args,
                            stream);
}

// x: [n][count]; out: [n][n][count]; for LL (use_ll) `sync` holds
// [n][n][words] packets, for HB [n][n][blocks] flags.
int all_gather_2pa_launch(const void* x, void* out, void* sync, int dtype, int n,
                          long long count, int blocks, int use_ll, unsigned epoch, int threads,
                          void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &sync, &count, &n, &blocks, &epoch};
  return launch_cooperative(use_ll ? MSCCL_BY_DTYPE(dtype, ag_2pa_ll_kernel)
                                   : MSCCL_BY_DTYPE(dtype, ag_2pa_kernel),
                            n * blocks, threads, args, stream);
}

const char* allpairs_2pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
