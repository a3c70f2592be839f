// Check kernels of the channel layer's device side (channels.cuh): a
// PortChannel put and a FusedReduceChannel all-reduce, every rank of the
// axis in one launch.
//
// Replaces no TPU kernel: the reference's PortChannel and FusedReduceChannel
// (repro/core/channels.py:134, :145) have no caller and no pallas_call of
// their own, and no path of the port calls these entry points either. They
// exist so that the channels' device side is built, launched and held
// against the plain models (repro_torch/core/channels.py) on the card.
//
// * port_put: block b of rank me puts tile b of x[me] into its slot in rank
//   (me + 1) % n's region through the block's PortChannel (TMA bulk copies
//   issued by thread 0), flushes and signals; then it waits for its own
//   flag and copies its slot (from rank (me - 1) % n) to out[me] with all
//   its threads. A second instantiation puts with the block's
//   threads (msccl::put, the SM copy) instead, for comparison.
// * fused_reduce: FusedReduceChannel.broadcast of tile b, then reduce: an
//   all-reduce through the channel, folded in the reference's order.
//
// Design: cooperative launch of nb blocks a rank (every block spins on
// another's flag, so all must be resident); tiles of 16-byte multiples
// (msccl::tile); release/acquire flags one a (receiver[, sender], block);
// the epoch lives on the card, one word a block bumped by the kernel as
// csrc/executor.cu's, so a CUDA graph replays the launch with a fresh epoch.
//
// Bound on an H100: HBM bytes, each input read once and each output written
// once (2 n D for both entry points). The put moves 4 n D (the slot written
// and read back); the reduce n D + (n - 1) n D twice + n D.
#include "channels.cuh"

namespace msccl {

// this launch's epoch: the block's word, bumped
__device__ __forceinline__ unsigned next_epoch(unsigned* epochs) {
  __shared__ unsigned s_epoch;
  if (threadIdx.x == 0) {
    const unsigned e = epochs[blockIdx.x] % 0xFFFFFFFFu + 1u;
    epochs[blockIdx.x] = e;
    s_epoch = e;
  }
  __syncthreads();
  return s_epoch;
}

// x, out: [n][count]; slots: [n][stride] bytes (rank r's slot, written by
// rank (r - 1) % n); flags: [n][nb]; epochs: [n * nb].
template <typename T, bool kTma>
__device__ __forceinline__ void port_put_body(const typename Elem<T>::B* __restrict__ x,
                                              typename Elem<T>::B* out, unsigned char* slots,
                                              long long stride, unsigned* flags,
                                              unsigned* epochs, long long count, int n,
                                              int nb) {
  using B = typename Elem<T>::B;
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const int peer = (me + 1) % n, prev = (me + n - 1) % n;
  const unsigned epoch = next_epoch(epochs);
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  const B* src = x + me * count;
  B* dst = slot_for(slots + peer * stride, src);
  if constexpr (kTma) {
    __shared__ PortStaging staging;
    PortChannel ch(&staging);
    if (threadIdx.x == 0) {
      ch.init();
      ch.put(reinterpret_cast<unsigned char*>(dst + lo),
             reinterpret_cast<const unsigned char*>(src + lo),
             (hi - lo) * static_cast<long long>(sizeof(B)));
      ch.flush();
    }
  } else {
    put(dst + lo, src + lo, hi - lo);
  }
  signal(flags + static_cast<long long>(peer) * nb + b, epoch);
  wait(flags + static_cast<long long>(me) * nb + b, epoch);
  const B* mine = slot_for(slots + me * stride, x + prev * count);
  put(out + me * count + lo, mine + lo, hi - lo);
}

// x, out: [n][count]; slots: [n][n][stride] bytes; flags: [n][n][nb];
// epochs: [n * nb].
template <typename T>
__global__ void __launch_bounds__(1024)
fused_reduce_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* out,
                    unsigned char* slots, long long stride, unsigned* flags,
                    unsigned* epochs, long long count, int n, int nb) {
  using B = typename Elem<T>::B;
  __shared__ PortStaging staging;
  const int me = blockIdx.x / nb, b = blockIdx.x % nb;
  const unsigned epoch = next_epoch(epochs);
  long long lo, hi;
  tile(count, 16 / sizeof(B), b, nb, lo, hi);
  PortChannel ch(&staging);
  if (threadIdx.x == 0) ch.init();
  FusedReduceChannel<T> fr{slots, stride, flags, me, n, b, nb};
  fr.broadcast(ch, x + me * count, lo, hi, epoch);
  fr.reduce(out, x, count, lo, hi, epoch);
}

template <typename T>
__global__ void __launch_bounds__(1024) port_put_tma(const typename Elem<T>::B* __restrict__ x,
                             typename Elem<T>::B* out, unsigned char* slots, long long stride,
                             unsigned* flags, unsigned* epochs, long long count, int n,
                             int nb) {
  port_put_body<T, true>(x, out, slots, stride, flags, epochs, count, n, nb);
}

template <typename T>
__global__ void __launch_bounds__(1024) port_put_sm(const typename Elem<T>::B* __restrict__ x,
                            typename Elem<T>::B* out, unsigned char* slots, long long stride,
                            unsigned* flags, unsigned* epochs, long long count, int n,
                            int nb) {
  port_put_body<T, false>(x, out, slots, stride, flags, epochs, count, n, nb);
}

}  // namespace msccl

extern "C" {

// x, out: [n][count] elements of dtype; slots: n * stride bytes (stride a
// multiple of 16, 16 bytes more than a rank's payload); flags: n * blocks
// words; epochs: n * blocks words, zeroed once. tma = 0 puts with the
// block's threads. Returns the launch's cudaError_t (0 on success).
int port_put_launch(const void* x, void* out, void* slots, long long stride, unsigned* flags,
                    unsigned* epochs, int dtype, int n, long long count, int blocks, int tma,
                    int threads, void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1 || (stride & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &slots, &stride, &flags, &epochs, &count, &n, &blocks};
  const void* fn = tma ? MSCCL_BY_DTYPE(dtype, port_put_tma) : MSCCL_BY_DTYPE(dtype, port_put_sm);
  return launch_cooperative(fn, n * blocks, threads, args, stream);
}

// x, out: [n][count]; slots: n * n * stride bytes; flags: n * n * blocks
// words; epochs: n * blocks words, zeroed once.
int fused_reduce_launch(const void* x, void* out, void* slots, long long stride,
                        unsigned* flags, unsigned* epochs, int dtype, int n, long long count,
                        int blocks, int threads, void* stream) {
  using namespace msccl;
  if (n < 1 || n > kMaxRanks || blocks < 1 || (stride & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &out, &slots, &stride, &flags, &epochs, &count, &n, &blocks};
  return launch_cooperative(MSCCL_BY_DTYPE(dtype, fused_reduce_kernel), n * blocks, threads,
                            args, stream);
}

const char* channels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
