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

// A spin that outlives this many nanoseconds is a broken program or a
// non-resident peer; the kernel traps instead of hanging the card.
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

// Element type -> the unsigned word that carries its bits, and the exact
// conversions the reductions round through.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using B = unsigned int;
  static __device__ __forceinline__ float to_f(B b) { return __uint_as_float(b); }
  static __device__ __forceinline__ B from_f(float f) { return __float_as_uint(f); }
};
template <> struct Elem<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ float to_f(B b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ B from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
};
template <> struct Elem<__half> {
  using B = unsigned short;
  static __device__ __forceinline__ float to_f(B b) { return __half2float(__ushort_as_half(b)); }
  static __device__ __forceinline__ B from_f(float f) { return __half_as_ushort(__float2half(f)); }
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

// Acquire-spin of one thread until *flag == epoch (bounded, see above).
__device__ __forceinline__ void spin_until(const unsigned* flag, unsigned epoch) {
  if (ld_acquire(flag) == epoch) return;
  const unsigned long long t0 = global_ns();
  for (unsigned it = 1;; ++it) {
    if (ld_acquire(flag) == epoch) return;
    if ((it & 1023u) == 0 && global_ns() - t0 > kSpinTimeoutNs) {
      printf("dsl_executor: rank block %d timed out on flag %p "
             "(want epoch %u, saw %u)\n",
             blockIdx.x, flag, epoch, ld_acquire(flag));
      __trap();
    }
  }
}

// put — primitives.put / MemoryChannel.put: one-sided write of `count`
// elements from my slot into the peer's slot. All threads of the block copy
// with 16-byte vector stores when both ends are 16-byte aligned, and finish
// the tail with scalar stores. Also serves the local COPY.
template <typename B>
__device__ __forceinline__ void put(B* dst, const B* src, long long count) {
  constexpr int V = 16 / sizeof(B);
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long nv = count / V;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d[i] = ld_cg(s + i);
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = ld_cg(src + i);
}

// signal — primitives.signal: once every thread's stores of the put are
// issued (bar.sync), one thread fences at GPU scope and release-stores the
// delivery's flag with this launch's epoch.
__device__ __forceinline__ void signal(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, epoch);
  }
}

// wait — primitives.wait / wait_recv_into: one thread acquire-spins on the
// delivery's flag, then the block proceeds and may read the slot.
__device__ __forceinline__ void wait(const unsigned* flag, unsigned epoch) {
  if (threadIdx.x == 0) {
    spin_until(flag, epoch);
    __threadfence();
  }
  __syncthreads();
}

// flush — primitives.flush: puts are plain stores that complete before
// their signal, so there is nothing to drain.
__device__ __forceinline__ void flush() {}

// barrier — primitives.device_barrier: every rank block release-stores its
// own epoch-tagged flag, then waits for all n of them.
__device__ __forceinline__ void barrier(unsigned* flags, int me, int n, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flags + me, epoch);
    for (int j = 0; j < n; ++j) spin_until(flags + j, epoch);
    __threadfence();
  }
  __syncthreads();
}

}  // namespace msccl
