// One-phase all-pairs AllReduce (1PA), LL or HB protocol, every rank of the
// axis in one launch.
//
// Replaces the TPU kernel repro/kernels/allreduce_1pa.py:ar_1pa_kernel
// (pallas_call at :101). Each rank puts its whole buffer into every peer's
// slot [me], waits for its n - 1 slots, and folds them rotated from itself:
// rank r computes x[r] + x[r+1] + ... + x[r-1], rounded to the element type
// after each add, so different ranks may differ in the last bit, exactly as
// the reference does.
//
// Design:
// * Ranks are blocks of one cooperative launch (all resident: they spin on
//   each other). Each rank runs `nb` blocks; block b owns one contiguous
//   tile of the buffer, in every slot, and has its own flags.
// * LL (use_ll): the paper's packets (primitives.cuh: LLPacket) — 4 data
//   bytes and the launch's epoch in one 8-byte store. A receiving thread
//   spins on each packet it folds; nothing else synchronises, so there is
//   no signal, no fence and no __syncthreads on the path. The TPU kernel had
//   to imitate this with a second flag descriptor per put.
// * HB: a 16-byte vector copy of the tile into each peer's slot, then one
//   release flag per (peer, block); the receiver acquire-spins on its n - 1
//   flags and folds the tile.
// * Flag freshness: the wrapper bumps a per-workspace epoch every launch, so
//   a packet or flag left by an earlier launch never matches. The reference's
//   `step` argument is kept for signature parity only.
// * No entry or exit barrier: one launch holds every rank and stream order
//   separates calls (the reference's start_barrier/device_barrier).
//
// Bound on an H100: each rank's buffer read once and written once through
// HBM; at decode sizes (tens of KB) the launch and one flag round trip,
// which is what LL shortens.
#include "primitives.cuh"

namespace msccl {

// Word w of a rank's buffer as LL carries it: one 4-byte element, or the
// 2-byte elements 2w and 2w + 1 (zero past the end of an odd count).
template <typename T>
__device__ __forceinline__ unsigned load_word(const typename Elem<T>::B* p, long long count,
                                              long long w) {
  if constexpr (sizeof(typename Elem<T>::B) == 4) {
    return p[w];
  } else {
    const unsigned lo = p[2 * w];
    const unsigned hi = 2 * w + 1 < count ? p[2 * w + 1] : 0u;
    return lo | (hi << 16);
  }
}

template <typename T>
__device__ __forceinline__ unsigned add_word(unsigned a, unsigned b) {
  using B = typename Elem<T>::B;
  if constexpr (sizeof(B) == 4) {
    return Elem<T>::add(a, b);
  } else {
    const unsigned lo = Elem<T>::add(static_cast<B>(a & 0xFFFFu), static_cast<B>(b & 0xFFFFu));
    const unsigned hi = Elem<T>::add(static_cast<B>(a >> 16), static_cast<B>(b >> 16));
    return lo | (hi << 16);
  }
}

template <typename T>
__device__ __forceinline__ void store_word(typename Elem<T>::B* p, long long count, long long w,
                                           unsigned v) {
  using B = typename Elem<T>::B;
  if constexpr (sizeof(B) == 4) {
    p[w] = v;
  } else {
    p[2 * w] = static_cast<B>(v & 0xFFFFu);
    if (2 * w + 1 < count) p[2 * w + 1] = static_cast<B>(v >> 16);
  }
}

// x, out: [n][count]; pk: [receiver][sender][words] packets.
template <typename T>
__global__ void __launch_bounds__(1024)
ar_1pa_ll_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 LLPacket* pk, long long count, int n, int nb, unsigned epoch) {
  using B = typename Elem<T>::B;
  constexpr int per_word = 4 / sizeof(B);
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const long long words = (count + per_word - 1) / per_word;
  long long lo, hi;
  tile(words, 1, b, nb, lo, hi);
  const B* mine = x + me * count;

  // fan-out: every word of my tile into slot [me] of every peer
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    const unsigned v = load_word<T>(mine, count, w);
    for (int i = 1; i < n; ++i) {
      const int peer = (me + i) % n;
      put_ll(pk + (static_cast<long long>(peer) * n + me) * words + w, v, epoch);
    }
  }
  // rotated fold. The n - 1 packets of a word are loaded back to back, so
  // their round trips overlap; only a packet that was not there yet is
  // then waited for.
  const LLPacket* slots = pk + static_cast<long long>(me) * n * words;
  for (long long w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    unsigned d[kMaxRanks], f[kMaxRanks];
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i)
      if (i < n) ld_ll(slots + static_cast<long long>((me + i) % n) * words + w, d[i], f[i]);
    unsigned acc = load_word<T>(mine, count, w);
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

// x, out: [n][count]; scratch: [receiver][sender][count]; flags [n][n][nb].
template <typename T>
__global__ void __launch_bounds__(1024)
ar_1pa_hb_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 typename Elem<T>::B* scratch, unsigned* flags, long long count, int n, int nb,
                 unsigned epoch) {
  using B = typename Elem<T>::B;
  __shared__ const B* s_src[kMaxRanks];
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* mine = x + me * count;

  for (int i = 1; i < n; ++i) {
    const int peer = (me + i) % n;
    put(scratch + (static_cast<long long>(peer) * n + me) * count + lo, mine + lo, hi - lo);
  }
  signal_peers(flags, me, n, b, nb, epoch);
  wait_peers(flags, me, n, b, nb, epoch);
  const int t = threadIdx.x;
  if (t < n) {
    const int peer = (me + t) % n;
    s_src[t] = t == 0 ? mine + lo
                      : scratch + (static_cast<long long>(me) * n + peer) * count + lo;
  }
  __syncthreads();
  reduce<T>(out + me * count + lo, s_src, n, hi - lo);
}

}  // namespace msccl

extern "C" {

// One launch of every rank: x and out are [n][count] element buffers; for
// LL `slots` holds [n][n][words] packets, for HB [n][n][count] elements and
// `flags` [n][n][blocks]. Returns the launch's cudaError_t (0 on success).
int allreduce_1pa_launch(const void* x, void* out, void* slots, unsigned* flags, int dtype, int n,
                         long long count, int blocks, int use_ll, unsigned epoch, int threads,
                         void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (use_ll) {
    void* args[] = {&x, &out, &slots, &count, &n, &blocks, &epoch};
    return launch_cooperative(MSCCL_BY_DTYPE(dtype, ar_1pa_ll_kernel), n * blocks, threads, args,
                              stream);
  }
  void* args[] = {&x, &out, &slots, &flags, &count, &n, &blocks, &epoch};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, ar_1pa_hb_kernel), n * blocks, threads, args,
                            stream);
}

const char* allreduce_1pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
