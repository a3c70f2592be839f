// Two-phase hierarchical AllReduce (2PH) over nn nodes of L local ranks,
// every rank of the grid in one launch.
//
// Replaces the TPU kernel repro/kernels/allreduce_2ph.py: ar_2ph_kernel
// (:36, pallas_call at :132, all_reduce_2ph). Ranks are stacked node-major:
// rank r = node * L + lme holds L chunks of `count` elements.
//
// The reference's three phases, with every rank's buffers on one card, so a
// rank reads a peer's buffer (a get, the paper's MemoryChannel read) where
// the reference puts into a slot:
// * entry (prim.start_barrier): each block release-stores its entry flag and
//   waits for the same block of every local peer before reading their input;
// * phase 1, ReduceScatter along `local`, as gets: block b of rank (node,
//   lme) reads tile b of chunk lme from the x of every local peer and folds
//   it in the reference's order, x[(node, lme)] first, then lme+1 ... lme-1,
//   into its partial (a scratch of one chunk a rank), then flags it;
// * phase 2, AllReduce along `node` on 1/L of the data: the block reads its
//   node peers' partials of the same tile and folds its own first, then
//   nodes node+1 ... node-1; the sum goes from registers into out[...][lme]
//   of itself and of its L - 1 local peers, which is the reference's
//   phase-3 AllGather;
// * phase 3, completion (wait_recv_into): one release flag per (rank,
//   block) after the stores, and the waits on the local peers' flags.
// Every add rounds to the element type (Elem<T>::add), so the kernel is
// bit-equal to the plain version and the reference in f32 and bf16.
//
// Design: a cooperative launch of `nb` blocks per rank, block b owning one
// contiguous tile of every chunk, so the phases are a per-tile dataflow with
// no grid-wide barrier. A tile goes in sub-tiles of `sub` elements, and
// phase 2 of a sub-tile runs after phase 1 of the next: the wait on the node
// peers' partials is hidden behind the block's own gets, and a partial is
// read back while it is still in L2. The partial is never folded in place,
// so a node peer never reads one being overwritten. Each flag set (entry,
// ready [rank][block][sub-tile], done) is its own, so a fast rank's later
// flag never satisfies a slow rank's earlier wait, and back-to-back launches
// are kept apart by the epoch. Spin-waits need every block resident: the
// wrapper caps nb by allreduce_2ph_max_blocks (the occupancy query).
//
// Bound on an H100: HBM bytes, each rank's input read once and output written
// once (3.35 TB/s). By its own count a rank reads D + nn D / L (its input's
// L tiles, nn partials) and writes D / L + D (its partial, L out tiles), D
// being a rank's input bytes: 2.75 D at 2 x 4, against 5.5 D when phase 1
// went through slots and the chunk was staged in `out`
// (kernels/allreduce_2ph.py:traffic_bytes).
#include "primitives.cuh"

namespace msccl {

constexpr int kMaxRanks2ph = 16;  // allreduce_2ph.MAX_RANKS: up to 4 x 4

// x, out: [nn * L][L][count]; part: [nn * L][count], rank r's partial of
// chunk r % L; flags: entry [R][nb], ready [R][nb][ksub], done [R][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
ar_2ph_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out,
              typename Elem<T>::B* part, unsigned* flags, long long count, int nn, int L, int nb,
              long long sub, int ksub, unsigned epoch) {
  using B = typename Elem<T>::B;
  // each phase its own operand tables: phase 1 of sub-tile k + 1 fills
  // its table while slower threads may still fold sub-tile k - 1
  __shared__ const B* s_get[kMaxRanks2ph];
  __shared__ const B* s_part[kMaxRanks2ph];
  __shared__ B* s_out[kMaxRanks2ph];
  const int r = blockIdx.x / nb, b = blockIdx.x % nb;
  const int node = r / L, lme = r % L, R = nn * L;
  const int t = threadIdx.x;
  unsigned* entry = flags;
  unsigned* ready = entry + static_cast<long long>(R) * nb;
  unsigned* done = ready + static_cast<long long>(R) * nb * ksub;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const int nk = static_cast<int>((hi - lo + sub - 1) / sub);
  B* mine = part + static_cast<long long>(r) * count;

  // ---- entry: block b of every local peer has entered ----
  if (t == 0) st_release(entry + static_cast<long long>(r) * nb + b, epoch);
  if (t < L - 1) spin_until(entry + static_cast<long long>(node * L + (lme + 1 + t) % L) * nb + b,
                            epoch);
  __syncthreads();

  // ---- phase 1 on sub-tile k: local gets, folded into my partial ----
  auto phase1 = [&](int k) {
    const long long a = lo + k * sub, len = min(sub, hi - a);
    if (t < L)
      s_get[t] = x + (static_cast<long long>(node * L + (lme + t) % L) * L + lme) * count + a;
    __syncthreads();
    reduce<T>(mine + a, s_get, L, len);
    __syncthreads();  // the block's partial stores are issued before the flag
    if (t == 0) {
      __threadfence();
      st_release(ready + (static_cast<long long>(r) * nb + b) * ksub + k, epoch);
    }
  };
  // ---- phase 2 on sub-tile k: node peers' partials, the sum into every
  // local rank's out[...][lme] ----
  auto phase2 = [&](int k) {
    const long long a = lo + k * sub, len = min(sub, hi - a);
    __syncthreads();  // the previous phase-2 fold no longer reads its tables
    if (t < nn - 1) {
      const int peer = ((node + 1 + t) % nn) * L + lme;
      spin_until(ready + (static_cast<long long>(peer) * nb + b) * ksub + k, epoch);
      __threadfence();
    }
    if (t < nn) s_part[t] = part + static_cast<long long>(((node + t) % nn) * L + lme) * count + a;
    if (t < L) s_out[t] = out + (static_cast<long long>(node * L + (lme + t) % L) * L + lme) * count + a;
    __syncthreads();
    reduce<T>(s_out, L, s_part, nn, len);
  };
  for (int k = 0; k <= nk; ++k) {
    if (k < nk) phase1(k);
    if (k > 0) phase2(k - 1);
  }

  // ---- phase 3: completion, every local peer's tile b has arrived ----
  __syncthreads();
  if (t == 0) {
    __threadfence();
    st_release(done + static_cast<long long>(r) * nb + b, epoch);
  }
  if (t < L - 1) {
    spin_until(done + static_cast<long long>(node * L + (lme + 1 + t) % L) * nb + b, epoch);
    __threadfence();
  }
  __syncthreads();
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

// x, out: [nn * L][L][count]; part: [nn * L][count]; flags: [nn * L][blocks]
// [ksub + 2], zero before the first launch; sub: elements a sub-tile, a
// multiple of 16 bytes; ksub: the most sub-tiles a block's tile holds
// (kernels/allreduce_2ph.py:scratch_geometry). Returns the launch's
// cudaError_t (0 on success).
int allreduce_2ph_launch(const void* x, void* out, void* part, unsigned* flags, int dtype, int nn,
                         int L, long long count, int blocks, long long sub, int ksub,
                         unsigned epoch, int threads, void* stream) {
  using namespace msccl;
  if (nn < 1 || L < 1 || nn * L > kMaxRanks2ph || blocks < 1 || count < 0 || sub < 1 ||
      ksub < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &part, &flags, &count, &nn, &L, &blocks, &sub, &ksub, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, ar_2ph_kernel), nn * L * blocks, threads,
                            args, stream);
}

const char* allreduce_2ph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
