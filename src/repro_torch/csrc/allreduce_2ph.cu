// Two-phase hierarchical AllReduce (2PH) over nn nodes of L local ranks,
// every rank of the grid in one launch.
//
// Replaces the TPU kernel repro/kernels/allreduce_2ph.py: ar_2ph_kernel
// (:36, pallas_call at :132, all_reduce_2ph). Ranks are stacked node-major:
// rank r = node * L + lme holds L chunks of `count` elements.
//
// * phase 1, ReduceScatter along `local`: rank r puts its chunk p into local
//   peer (node, p)'s slot [lme], waits for its L - 1 slots and folds chunk
//   lme rotated from itself (x[lme] + slot[lme+1] + ... + slot[lme-1]),
//   staged in out[lme];
// * phase 2, AllReduce along `node` on 1/L of the data: the partial goes to
//   node peers (n', lme) (ranks at stride L) into their slot [node]; the
//   fold starts from my node's partial and adds nodes node+1 ... node-1;
// * phase 3, AllGather along `local`: out[lme] into every local peer's
//   out[lme].
// Every add rounds to the element type (Elem<T>::add), so the kernel is
// bit-equal to the plain version and the reference in f32 and bf16.
//
// Design, as allpairs_2pa.cu: a cooperative launch of `nb` blocks per rank,
// block b owning one contiguous tile of every chunk; 16-byte vector puts;
// release/acquire flags tagged with a per-workspace epoch. Owning a tile
// makes the three phases a per-tile dataflow: block b's phase-2 put waits
// only on block b's phase-1 fold of its peers, so there is no grid-wide
// barrier. Each phase has its own flag set [receiver][sender][block], so a
// fast peer's phase-3 put can never satisfy a slow rank's phase-1 wait (the
// reference's separate semaphore pairs), and back-to-back launches are kept
// apart by the epoch. Spin-waits need every block resident: the wrapper caps
// nb by allreduce_2ph_max_blocks (the occupancy query).
//
// Bound on an H100: HBM bytes, each rank's input read once and output written
// once (3.35 TB/s). The kernel moves more: every rank also writes and reads
// (L - 1) / L of its data through the phase-1 slots and (nn - 1) / L through
// the phase-2 slots, and reads its staged chunk back for phase 2 and 3.
#include "primitives.cuh"

namespace msccl {

constexpr int kMaxRanks2ph = 16;  // allreduce_2ph.MAX_RANKS: up to 4 x 4

// Once the block's puts are issued, release-store `epoch` into flag
// [peer][my_idx][b] of every other member of my group (members first +
// j * stride, j < k, mine j = my_idx).
__device__ __forceinline__ void signal_group(unsigned* flags, int first, int stride, int k,
                                             int my_idx, int b, int nb, unsigned epoch) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < k - 1) {
    const int peer = first + ((my_idx + 1 + t) % k) * stride;
    __threadfence();
    st_release(flags + (static_cast<long long>(peer) * k + my_idx) * nb + b, epoch);
  }
}

// Acquire-spin until every other member of my group has signalled flag
// [me][j][b].
__device__ __forceinline__ void wait_group(const unsigned* flags, int me, int k, int my_idx, int b,
                                           int nb, unsigned epoch) {
  const int t = threadIdx.x;
  if (t < k - 1) {
    const int j = (my_idx + 1 + t) % k;
    spin_until(flags + (static_cast<long long>(me) * k + j) * nb + b, epoch);
    __threadfence();
  }
  __syncthreads();
}

// x, out: [nn * L][L][count]; slots: [nn * L][L][count] (receiver, local
// sender); node_slots: [nn * L][nn][count] (receiver, node sender); flags:
// phase 1 [R][L][nb], phase 2 [R][nn][nb], phase 3 [R][L][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
ar_2ph_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out,
              typename Elem<T>::B* slots, typename Elem<T>::B* node_slots, unsigned* flags,
              long long count, int nn, int L, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  __shared__ const B* s_src[kMaxRanks2ph];
  const int r = blockIdx.x / nb, b = blockIdx.x % nb;
  const int node = r / L, lme = r % L, R = nn * L;
  unsigned* flags1 = flags;
  unsigned* flags2 = flags1 + static_cast<long long>(R) * L * nb;
  unsigned* flags3 = flags2 + static_cast<long long>(R) * nn * nb;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const long long len = hi - lo;
  const B* mine = x + static_cast<long long>(r) * L * count;  // my L chunks
  B* staged = out + (static_cast<long long>(r) * L + lme) * count + lo;
  const int t = threadIdx.x;

  // ---- phase 1: ReduceScatter along `local` ----
  for (int i = 1; i < L; ++i) {
    const int p = (lme + i) % L;
    put(slots + ((static_cast<long long>(node) * L + p) * L + lme) * count + lo,
        mine + p * count + lo, len);
  }
  signal_group(flags1, node * L, 1, L, lme, b, nb, epoch);
  wait_group(flags1, r, L, lme, b, nb, epoch);
  if (t < L)
    s_src[t] = t == 0 ? mine + lme * count + lo
                      : slots + (static_cast<long long>(r) * L + (lme + t) % L) * count + lo;
  __syncthreads();
  reduce<T>(staged, s_src, L, len);
  __syncthreads();  // the staged partial is complete before it is put

  // ---- phase 2: AllReduce along `node` on my chunk ----
  for (int i = 1; i < nn; ++i) {
    const int peer = ((node + i) % nn) * L + lme;
    put(node_slots + (static_cast<long long>(peer) * nn + node) * count + lo, staged, len);
  }
  signal_group(flags2, lme, L, nn, node, b, nb, epoch);
  wait_group(flags2, r, nn, node, b, nb, epoch);
  if (t < nn)
    s_src[t] = t == 0 ? staged
                      : node_slots + (static_cast<long long>(r) * nn + (node + t) % nn) * count +
                            lo;
  __syncthreads();
  reduce<T>(staged, s_src, nn, len);  // in place: each element is read, then written
  __syncthreads();

  // ---- phase 3: AllGather along `local` ----
  for (int i = 1; i < L; ++i) {
    const int peer = node * L + (lme + i) % L;
    put(out + (static_cast<long long>(peer) * L + lme) * count + lo, staged, len);
  }
  signal_group(flags3, node * L, 1, L, lme, b, nb, epoch);
  wait_group(flags3, r, L, lme, b, nb, epoch);
}

}  // namespace msccl

extern "C" {

// The most blocks of ar_2ph_kernel<dtype> at `threads` that the card keeps
// resident at once (the cooperative launch's limit); 0 on an error.
int allreduce_2ph_max_blocks(int dtype, int threads) {
  using namespace msccl;
  const void* fn = MSCCL_BY_DTYPE(dtype, ar_2ph_kernel);
  int dev = 0, sms = 0, per_sm = 0;
  if (fn == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// x, out: [nn * L][L][count]; slots: [nn * L][L][count]; node_slots:
// [nn * L][nn][count]; flags: [nn * L][2 L + nn][blocks], zero before the
// first launch. Returns the launch's cudaError_t (0 on success).
int allreduce_2ph_launch(const void* x, void* out, void* slots, void* node_slots,
                         unsigned* flags, int dtype, int nn, int L, long long count, int blocks,
                         unsigned epoch, int threads, void* stream) {
  using namespace msccl;
  if (nn < 1 || L < 1 || nn * L > kMaxRanks2ph || blocks < 1 || count < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &slots, &node_slots, &flags, &count, &nn, &L, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, ar_2ph_kernel), nn * L * blocks, threads,
                            args, stream);
}

const char* allreduce_2ph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
