// The rest of the paper's channel layer (§3.2.1) for ranks that live as
// blocks of one launch on one Hopper card: PortChannel and
// FusedReduceChannel (the reference's SwitchChannel).
//
// Port of repro/core/channels.py:PortChannel (:134) and :FusedReduceChannel
// (:145). MemoryChannel's device side is primitives.cuh (put / signal / wait,
// LL packets).
//
// * PortChannel — the paper moves a PortChannel's data on the DMA engines,
//   driven by a CPU proxy through a request FIFO, so that no GPU thread
//   copies. The reference has no proxy (TPU cores enqueue their own DMAs,
//   repro/core/primitives.py:16) and neither has the port: Hopper's
//   counterpart inside a kernel is the SM's bulk-copy unit (TMA,
//   cp.async.bulk). One elected thread stages a tile through shared memory
//   (bulk_load, completing on an mbarrier) and writes it to the peer's slot
//   (bulk_store), kPortStages chunks in flight; the block's other threads
//   stay free. flush() is cp.async.bulk.wait_group 0 and a proxy fence: the
//   async proxy's writes are complete and ordered before the generic-proxy
//   release of the signal that follows, and the source may be reused.
// * FusedReduceChannel — the paper reduces in the NVSwitch (NVLS multimem).
//   multimem needs a multicast object over NVSwitch across GPUs, and the
//   ranks of one card have none; as the reference does over ICI, peers push
//   their chunks into per-sender slots and the receiver reduces them on
//   arrival: broadcast() is one staged load and n - 1 bulk stores (the
//   chunk is read once), reduce() waits for the n - 1 flags and folds
//   local + slot[me+1] + slot[me+2] + ... in that order, rounding after
//   every add (Elem<T>::add), as the reference's fori_loop(1, n).
//
// Bulk copies take 16-byte aligned ends and a multiple of 16 bytes; a put
// copies the bytes before its source's first and after its last 16-byte
// boundary with the electing thread's own stores, so a destination must
// share its source's address modulo 16 (the callers offset each slot by the
// sender's misalignment, repro_torch/kernels/channels.py:slot_stride).
#pragma once

#include "hopper.cuh"

namespace msccl {

constexpr int kPortStages = 4;     // chunks in flight a block
constexpr int kPortChunk = 8192;   // bytes a chunk (a multiple of 16)

// A block's staging for its PortChannel puts, in shared memory.
struct PortStaging {
  alignas(128) unsigned char buf[kPortStages][kPortChunk];
  uint64_t bar[kPortStages];
};

// cp.async.bulk shared -> global without its own commit: a chunk's stores
// to several destinations go in one bulk group
__device__ __forceinline__ void bulk_store_nc(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(hopper::smem_u32(src)), "r"(bytes)
               : "memory");
}

// Every method but the constructor is called by ONE thread of the block (the
// elected one); signal and wait are primitives.cuh's block-wide ones.
struct PortChannel {
  PortStaging* st;
  unsigned phases = 0;   // bit s: parity of stage s's next completion

  // `st` is the block's staging; the elected thread initialises its barriers
  __device__ __forceinline__ explicit PortChannel(PortStaging* staging) : st(staging) {}

  __device__ __forceinline__ void init() {
    for (int s = 0; s < kPortStages; ++s) hopper::mbar_init(&st->bar[s], 1);
    hopper::mbar_init_fence();
  }

  // put — PortChannel.put: `bytes` from `src` to each of the `ndst`
  // destinations (a broadcast reads the source once). Returns once every
  // copy is issued; flush() waits for them.
  __device__ __forceinline__ void put(unsigned char* const* dsts, int ndst,
                                      const unsigned char* src, long long bytes) {
    const long long head =
        min(bytes, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
    const long long mid = (bytes - head) & ~15ll;
    for (long long i = 0; i < head; ++i)
      for (int k = 0; k < ndst; ++k) dsts[k][i] = src[i];
    for (long long i = head + mid; i < bytes; ++i)
      for (int k = 0; k < ndst; ++k) dsts[k][i] = src[i];
    const long long nch = (mid + kPortChunk - 1) / kPortChunk;
    auto len = [&](long long c) {
      return static_cast<unsigned>(min(static_cast<long long>(kPortChunk), mid - c * kPortChunk));
    };
    auto load = [&](long long c) {
      const int s = static_cast<int>(c % kPortStages);
      hopper::mbar_expect_tx(&st->bar[s], len(c));
      hopper::bulk_load(st->buf[s], src + head + c * kPortChunk, len(c), &st->bar[s]);
    };
    for (long long c = 0; c < min(nch, static_cast<long long>(kPortStages)); ++c) load(c);
    for (long long c = 0; c < nch; ++c) {
      const int s = static_cast<int>(c % kPortStages);
      hopper::mbar_wait(&st->bar[s], (phases >> s) & 1u);
      phases ^= 1u << s;
      for (int k = 0; k < ndst; ++k)
        bulk_store_nc(dsts[k] + head + c * kPortChunk, st->buf[s], len(c));
      hopper::bulk_commit();
      // refill the stage of chunk c - 1 once its stores have read it
      const long long next = c - 1 + kPortStages;
      if (c >= 1 && next < nch) {
        hopper::bulk_wait<1, true>();
        load(next);
      }
    }
  }

  __device__ __forceinline__ void put(unsigned char* dst, const unsigned char* src,
                                      long long bytes) {
    put(&dst, 1, src, bytes);
  }

  // flush — every bulk store of this thread has completed, and its writes
  // are ordered before this thread's next generic-proxy operations (the
  // signal's release)
  __device__ __forceinline__ void flush() {
    hopper::bulk_wait<0, false>();
    hopper::fence_proxy_async();
  }
};

// The slot at `base` for a sender whose data starts at `src`: offset by the
// source's misalignment, so the put's bulk part is 16-byte aligned at both
// ends. `base` itself is 16-byte aligned.
template <typename B>
__device__ __forceinline__ B* slot_for(unsigned char* base, const B* src) {
  return reinterpret_cast<B*>(base + (reinterpret_cast<uintptr_t>(src) & 15));
}

// FusedReduceChannel over the n rank blocks b of one launch. Slots are
// [receiver][sender][stride bytes]; flags [receiver][sender][block].
template <typename T>
struct FusedReduceChannel {
  using B = typename Elem<T>::B;
  unsigned char* slots;
  long long stride;
  unsigned* flags;
  int me, n, b, nb;

  __device__ __forceinline__ unsigned char* slot(int receiver, int sender) const {
    return slots + (static_cast<long long>(receiver) * n + sender) * stride;
  }

  // broadcast — my chunk [lo, hi) of `src` into slot [peer][me] of every
  // peer through the block's PortChannel (one staged load, n - 1 stores),
  // flushed, then one flag a peer
  __device__ __forceinline__ void broadcast(PortChannel& ch, const B* src, long long lo,
                                            long long hi, unsigned epoch) {
    if (threadIdx.x == 0 && n > 1) {
      unsigned char* dsts[kMaxRanks];
      for (int i = 1; i < n; ++i)
        dsts[i - 1] = reinterpret_cast<unsigned char*>(slot_for(slot((me + i) % n, me), src) + lo);
      ch.put(dsts, n - 1, reinterpret_cast<const unsigned char*>(src + lo),
             (hi - lo) * static_cast<long long>(sizeof(B)));
      ch.flush();
    }
    signal_peers(flags, me, n, b, nb, epoch);
  }

  // reduce — wait for the n - 1 arrivals, then out = local + slot[me+1] +
  // slot[me+2] + ... over [lo, hi); `x` is the rank-stacked input ([n][count])
  // the senders' slots were offset by
  __device__ __forceinline__ void reduce(B* out, const B* x, long long count, long long lo,
                                         long long hi, unsigned epoch) {
    __shared__ const B* srcs[kMaxRanks];
    wait_peers(flags, me, n, b, nb, epoch);
    if (threadIdx.x == 0) {
      srcs[0] = x + me * count + lo;
      for (int i = 1; i < n; ++i) {
        const int from = (me + i) % n;
        srcs[i] = slot_for(slot(me, from), x + from * count) + lo;
      }
    }
    __syncthreads();
    msccl::reduce<T>(out + me * count + lo, srcs, n, hi - lo);
  }
};

}  // namespace msccl
