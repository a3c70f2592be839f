// Device-side primitives of the paper's channel layer (§4.1-4.2) for ranks
// that live as blocks of one launch on one Hopper card.
//
// Port of repro/core/primitives.py. On the TPU a put is a remote DMA whose
// semaphore counts bytes; here every rank's buffers are global memory of the
// same card, so a put is a block-wide copy into the peer's slot and
// synchronization is release/acquire flags, one per delivery.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace msccl {

constexpr int kMaxRanks = 8;  // rank blocks one launch holds (MAX_RANKS)

// A spin that outlives this many nanoseconds is a broken program or a
// non-resident peer; the kernel traps instead of hanging the card.
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

// Element type -> the unsigned word that carries its bits, and the exact
// add the reductions fold with: floats add in f32 and round to the element
// type after every add (as `acc + v` on torch tensors), integers wrap.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using B = unsigned int;
  static __device__ __forceinline__ float to_f(B b) { return __uint_as_float(b); }
  static __device__ __forceinline__ B from_f(float f) { return __float_as_uint(f); }
  static __device__ __forceinline__ B add(B a, B b) { return from_f(to_f(a) + to_f(b)); }
};
template <> struct Elem<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ float to_f(B b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ B from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
  static __device__ __forceinline__ B add(B a, B b) { return from_f(to_f(a) + to_f(b)); }
};
template <> struct Elem<__half> {
  using B = unsigned short;
  static __device__ __forceinline__ float to_f(B b) { return __half2float(__ushort_as_half(b)); }
  static __device__ __forceinline__ B from_f(float f) { return __half_as_ushort(__float2half(f)); }
  static __device__ __forceinline__ B add(B a, B b) { return from_f(to_f(a) + to_f(b)); }
};
template <> struct Elem<int> {
  using B = unsigned int;
  static __device__ __forceinline__ B add(B a, B b) { return a + b; }
};

// Loads bypass L1 (ld.global.cg): a slot may have been written by another
// SM's block, and each byte is read once anyway.
__device__ __forceinline__ unsigned short ld_cg(const unsigned short* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned int ld_cg(const unsigned int* p) { return __ldcg(p); }
__device__ __forceinline__ uint4 ld_cg(const uint4* p) { return __ldcg(p); }

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A spin that timed out: report it and trap (the launch fails with an
// error instead of hanging the card).
__device__ __noinline__ void spin_timeout(const void* flag, unsigned epoch, unsigned saw) {
  printf("msccl: block %d thread %d timed out on flag %p (want epoch %u, saw %u)\n",
         blockIdx.x, threadIdx.x, flag, epoch, saw);
  __trap();
}

// Acquire-spin of one thread until *flag == epoch (bounded, see above).
__device__ __forceinline__ void spin_until(const unsigned* flag, unsigned epoch) {
  if (ld_acquire(flag) == epoch) return;
  const unsigned long long t0 = global_ns();
  for (unsigned it = 1;; ++it) {
    if (ld_acquire(flag) == epoch) return;
    if ((it & 1023u) == 0 && global_ns() - t0 > kSpinTimeoutNs)
      spin_timeout(flag, epoch, ld_acquire(flag));
  }
}

// put — primitives.put / MemoryChannel.put: one-sided write of `count`
// elements from my slot into the peer's slot. Threads tid of nthreads (all
// of the block by default) copy with 16-byte vector stores when both ends
// are 16-byte aligned, four vectors a thread loaded before any is stored (the
// loads are in flight together), and finish the tail with scalar stores.
// Also serves the local COPY.
template <typename B>
__device__ __forceinline__ void put(B* dst, const B* src, long long count, int tid,
                                    int nthreads) {
  constexpr int V = 16 / sizeof(B), U = 4;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long nv = count / V;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nv; i += static_cast<long long>(U) * nthreads) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * nthreads < nv) v[u] = ld_cg(s + i + u * nthreads);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * nthreads < nv) d[i + u * nthreads] = v[u];
    }
    done = nv * V;
  }
  for (long long i = done + tid; i < count; i += nthreads) dst[i] = ld_cg(src + i);
}

template <typename B>
__device__ __forceinline__ void put(B* dst, const B* src, long long count) {
  put(dst, src, count, threadIdx.x, blockDim.x);
}

// signal — primitives.signal: once every thread's stores of the put are
// issued (bar.sync orders them before thread 0's next operations), one
// thread release-stores the delivery's flag at GPU scope with this launch's
// epoch. The release carries the block's stores; no separate fence.
__device__ __forceinline__ void signal(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, epoch);
}

// wait — primitives.wait / wait_recv_into: one thread acquire-spins on the
// delivery's flag, then (bar.sync) the block proceeds and may read the slot.
__device__ __forceinline__ void wait(const unsigned* flag, unsigned epoch) {
  if (threadIdx.x == 0) spin_until(flag, epoch);
  __syncthreads();
}

// flush — primitives.flush: puts are plain stores that complete before
// their signal, so there is nothing to drain.
__device__ __forceinline__ void flush() {}

// barrier — primitives.device_barrier: every rank block release-stores its
// own epoch-tagged flag flags[me * stride], then acquires all n of them
// (stride > 1 interleaves the flags of several tiles' barriers).
__device__ __forceinline__ void barrier(unsigned* flags, int me, int n, unsigned epoch,
                                        int stride = 1) {
  __syncthreads();
  if (threadIdx.x == 0) {
    st_release(flags + static_cast<long long>(me) * stride, epoch);
    for (int j = 0; j < n; ++j) spin_until(flags + static_cast<long long>(j) * stride, epoch);
  }
  __syncthreads();
}

// --- LL protocol (paper §4.2.2) -------------------------------------------
// A packet is 4 data bytes and a 4-byte flag, written by ONE 8-byte store:
// a receiver that reads the launch's epoch in the flag word reads the data
// word of the same store, so LL needs no separate signal and no fence. The
// layout is repro_torch/core/channels.py:pack_ll's int32 {data, flag} pair;
// a 2-byte element type packs two elements per data word.
struct alignas(8) LLPacket {
  unsigned data;
  unsigned flag;
};

__device__ __forceinline__ void put_ll(LLPacket* p, unsigned data, unsigned epoch) {
  asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(data), "r"(epoch)
               : "memory");
}

__device__ __forceinline__ void ld_ll(const LLPacket* p, unsigned& data, unsigned& flag) {
  asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(data), "=r"(flag)
               : "l"(p)
               : "memory");
}

// read_ll — MemoryChannel.read_ll: spin on the packet until its flag is
// this launch's epoch (bounded, as spin_until), return its data word.
__device__ __forceinline__ unsigned read_ll(const LLPacket* p, unsigned epoch) {
  unsigned d, f;
  ld_ll(p, d, f);
  if (f == epoch) return d;
  const unsigned long long t0 = global_ns();
  for (unsigned it = 1;; ++it) {
    ld_ll(p, d, f);
    if (f == epoch) return d;
    if ((it & 1023u) == 0 && global_ns() - t0 > kSpinTimeoutNs) spin_timeout(p, epoch, f);
  }
}

// Word w of a buffer as LL carries it: one 4-byte element, or the
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

// --- fan-out synchronisation of the collective kernels ---------------------
// Flags are laid out [receiver][sender or step][block]; slot (me + 1 + t) % n
// is signalled or waited by thread t, so the n - 1 peers go in parallel.

// Once the block's puts are issued, release-store `epoch` into flag
// [peer][me][b] of every peer.
__device__ __forceinline__ void signal_peers(unsigned* flags, int me, int n, int b, int nb,
                                             unsigned epoch) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n - 1) {
    const int peer = (me + 1 + t) % n;
    __threadfence();
    st_release(flags + (static_cast<long long>(peer) * n + me) * nb + b, epoch);
  }
}

// Acquire-spin until every peer's block b has signalled flag [me][peer][b].
__device__ __forceinline__ void wait_peers(const unsigned* flags, int me, int n, int b, int nb,
                                           unsigned epoch) {
  const int t = threadIdx.x;
  if (t < n - 1) {
    const int peer = (me + 1 + t) % n;
    spin_until(flags + (static_cast<long long>(me) * n + peer) * nb + b, epoch);
    __threadfence();
  }
  __syncthreads();
}

// dsts[j] = srcs[0] + srcs[1] + ... (left fold, rounded per add),
// elementwise, for each of the ndst destinations (the sum goes from
// registers to all of them); `srcs` and `dsts` live in shared memory. Each
// vector step loads its operands kBatch at a time, all of a batch before
// its adds, so the loads are in flight together; the fold order is
// unchanged.
template <typename T>
__device__ __forceinline__ void reduce(typename Elem<T>::B* const* dsts, int ndst,
                                       const typename Elem<T>::B* const* srcs,
                                       int k, long long count) {
  using B = typename Elem<T>::B;
  constexpr int V = 16 / sizeof(B);
  constexpr int kBatch = 8;
  bool aligned = true;
  for (int j = 0; j < ndst; ++j) aligned &= (reinterpret_cast<uintptr_t>(dsts[j]) & 15) == 0;
  for (int j = 0; j < k; ++j) aligned &= (reinterpret_cast<uintptr_t>(srcs[j]) & 15) == 0;
  long long done = 0;
  if (aligned) {
    const long long nv = count / V;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      union U { uint4 v; B e[V]; };
      U acc;
      acc.v = ld_cg(reinterpret_cast<const uint4*>(srcs[0]) + i);
      for (int j0 = 1; j0 < k; j0 += kBatch) {
        U o[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (j0 + u < k) o[u].v = ld_cg(reinterpret_cast<const uint4*>(srcs[j0 + u]) + i);
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (j0 + u < k) {
#pragma unroll
            for (int e = 0; e < V; ++e) acc.e[e] = Elem<T>::add(acc.e[e], o[u].e[e]);
          }
      }
      for (int j = 0; j < ndst; ++j) reinterpret_cast<uint4*>(dsts[j])[i] = acc.v;
    }
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < count; i += blockDim.x) {
    B acc = ld_cg(srcs[0] + i);
    for (int j = 1; j < k; ++j) acc = Elem<T>::add(acc, ld_cg(srcs[j] + i));
    for (int j = 0; j < ndst; ++j) dsts[j][i] = acc;
  }
}

// dst = srcs[0] + srcs[1] + ..., the one-destination fold.
template <typename T>
__device__ __forceinline__ void reduce(typename Elem<T>::B* dst,
                                       const typename Elem<T>::B* const* srcs,
                                       int k, long long count) {
  reduce<T>(&dst, 1, srcs, k, count);
}

// Block b of nb owns units [lo, hi) of `count`: contiguous tiles whose
// bounds are multiples of `align` units (16 bytes for element copies), so
// every block of a rank moves the same tile of every peer's buffer.
__device__ __forceinline__ void tile(long long count, int align, int b, int nb,
                                     long long& lo, long long& hi) {
  const long long units = (count + align - 1) / align;
  const long long per = (units + nb - 1) / nb;
  lo = min(count, b * per * align);
  hi = min(count, (b + 1) * per * align);
}

// Cooperative launch: it fails instead of deadlocking when the blocks,
// which spin on each other's flags, cannot all be resident at once. It goes
// through cudaLaunchKernelEx with the cooperative attribute, which a stream
// capture records as a kernel node that keeps the attribute, so a CUDA-graph
// replay launches it cooperatively too. Returns the launch's cudaError_t (0
// on success).
inline int launch_cooperative(const void* fn, int blocks, int threads, void** args,
                              void* stream) {
  if (fn == nullptr || threads < 32 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next launch
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The element type of a dtype code (repro_torch/kernels/comm_utils.py:
// DTYPE_CODES) -> the kernel instantiated for it; nullptr for an unknown code.
#define MSCCL_BY_DTYPE(code, KERNEL)                                        \
  ((code) == 0   ? reinterpret_cast<const void*>(&KERNEL<float>)            \
   : (code) == 1 ? reinterpret_cast<const void*>(&KERNEL<__nv_bfloat16>)    \
   : (code) == 2 ? reinterpret_cast<const void*>(&KERNEL<__half>)           \
   : (code) == 3 ? reinterpret_cast<const void*>(&KERNEL<int>)              \
                 : nullptr)

}  // namespace msccl
