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
// Design: one thread-block cluster per tile, slots in distributed shared
// memory. The reference keeps its slots and flags in the peers' VMEM; here
// they live in the receivers' shared memory.
// * The grid is n x tiles with cluster (n, 1, 1): cluster t holds rank r's
//   block for tile t at cluster rank r. A block waits only for the blocks of
//   its own cluster, which the hardware schedules together, so the grid need
//   not be resident as a whole (no cooperative launch, no cap on blocks).
// * Slot [s] holds sender s's tile at the same offset in every block of the
//   cluster. The wrapper (kernels/allreduce_1pa.py:geometry) sizes the tile
//   so that n slots fit one block's shared memory.
// * HB: the sender's thread 0 issues one bulk copy of its tile from global
//   memory, multicast into slot [me] of every block of the cluster (itself
//   included); each copy completes its bytes on the receiver's mbarrier, on
//   which the receiver expected n tiles' bytes: put, signal and wait in one
//   hardware operation. Bulk copies need 16-byte sizes and addresses; when
//   a rank's buffer is not a multiple of 16 bytes (or x or out is not
//   16-byte aligned), the tile goes element by element through st.shared::
//   cluster into every block instead, published by a cluster barrier.
// * LL: the paper's 8-byte {data, flag} packets, each one 64-bit store
//   (mapa + st.shared::cluster) into the peer's slot; the receiver spins on
//   its own shared memory. Shared memory holds whatever an earlier kernel
//   left there, so each block resets its slots' flag words before the
//   opening cluster barrier, and the flag is a constant: no host epoch.
// * The opening cluster barrier is the reference's start_barrier: after
//   mbarrier.init and its fence (HB) or the flag reset (LL, a release), no
//   peer writes into a block before it is ready. The closing one is its
//   device_barrier: no block leaves while a peer still writes into its shared
//   memory. A block arrives at it once every byte meant for it has landed
//   (HB: before the fold; LL: after it), relaxed, since the mbarrier or the
//   flags already ordered the data, and waits on it after the fold. The fold
//   runs from shared memory in registers and stores out once. Nothing is
//   kept in global memory between launches: no workspace, no flags.
// * Programmatic dependent launch: the block's set-up overlaps the previous
//   kernel's tail; griddepcontrol.wait comes before the first read of x and
//   every global write (out may be memory the caching allocator just took
//   back from a kernel still running), launch_dependents after the last read
//   of x.
//
// Bound on an H100: each rank's buffer read once and written once through
// HBM; at decode sizes (tens of KB) the launch and one cluster barrier.
#include "hopper.cuh"

namespace msccl {

constexpr int kSlot0 = 16;          // the mbarrier, then the slots
constexpr unsigned kLLFlag = 1u;    // a packet's flag word once it has landed

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

// an arrival that orders no memory access (a release costs a GPU-scope
// MEMBAR): for barriers whose data is already ordered by an mbarrier or a
// packet's flag
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// the shared::cluster address of shared address `a` in cluster block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t a, unsigned long long v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t a, unsigned short v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(a), "h"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_packet(uint32_t a) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.shared::cta.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}

// The data word of the packet at shared address `a`, once its flag is
// kLLFlag (bounded, as spin_until).
__device__ __forceinline__ unsigned wait_packet(uint32_t a, unsigned long long v) {
  if (static_cast<unsigned>(v >> 32) == kLLFlag) return static_cast<unsigned>(v);
  const unsigned long long t0 = global_ns();
  for (unsigned it = 1;; ++it) {
    v = ld_packet(a);
    if (static_cast<unsigned>(v >> 32) == kLLFlag) return static_cast<unsigned>(v);
    if ((it & 1023u) == 0 && global_ns() - t0 > kSpinTimeoutNs)
      spin_timeout(nullptr, kLLFlag, static_cast<unsigned>(v >> 32));
  }
}

// LL. x, out: [n][count]; the block's tile is elements [lo, lo + tile_elems)
// of every rank; slot s is `slot_bytes` of packets, one a 4-byte word.
template <typename T>
__global__ void __launch_bounds__(1024)
ar_1pa_ll_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 long long count, long long tile_elems, int slot_bytes) {
  using B = typename Elem<T>::B;
  constexpr int per_word = 4 / sizeof(B);
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = cluster_size(), me = cluster_rank();
  const long long lo = (blockIdx.x / n) * tile_elems;
  const long long elems = min(count - lo, tile_elems);
  const int words = static_cast<int>((elems + per_word - 1) / per_word);
  const uint32_t slots = hopper::smem_u32(smem) + kSlot0;
  const uint32_t own = slots + me * slot_bytes;

  for (int i = threadIdx.x; i < n * (slot_bytes / 8); i += blockDim.x)
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(slots + i * 8 + 4), "r"(0u) : "memory");
  cluster_sync();
  griddep_wait();

  // fan-out: every word of my tile as a packet into slot [me] of every peer,
  // and its data word into my own slot [me] for the fold
  uint32_t remote[kMaxRanks];
#pragma unroll
  for (int i = 1; i < kMaxRanks; ++i)
    if (i < n) remote[i] = mapa(own, (me + i) % n);
  const B* mine = x + me * count + lo;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const unsigned v = load_word<T>(mine, elems, w);
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(own + w * 8), "r"(v) : "memory");
    const unsigned long long pk = v | (static_cast<unsigned long long>(kLLFlag) << 32);
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i)
      if (i < n) st_cluster(remote[i] + w * 8, pk);
  }
  griddep_launch_dependents();

  // rotated fold. The n - 1 packets of a word are loaded back to back; only
  // one that was not there yet is then waited for.
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long p[kMaxRanks];
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i)
      if (i < n) p[i] = ld_packet(slots + ((me + i) % n) * slot_bytes + w * 8);
    unsigned acc;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(acc) : "r"(own + w * 8) : "memory");
#pragma unroll
    for (int i = 1; i < kMaxRanks; ++i)
      if (i < n)
        acc = add_word<T>(acc, wait_packet(slots + ((me + i) % n) * slot_bytes + w * 8, p[i]));
    store_word<T>(out + me * count + lo, elems, w, acc);
  }
  // every packet into this block has landed: the closing barrier orders no
  // data, it only keeps each block until its peers' stores are in
  cluster_arrive_relaxed();
  cluster_wait();
}

// HB. As the LL kernel; slot s is `slot_bytes` of elements. `bulk`: every
// tile is a multiple of 16 bytes on 16-byte aligned addresses of x and out.
template <typename T>
__global__ void __launch_bounds__(1024)
ar_1pa_hb_kernel(const typename Elem<T>::B* __restrict__ x, typename Elem<T>::B* __restrict__ out,
                 long long count, long long tile_elems, int slot_bytes, int bulk) {
  using B = typename Elem<T>::B;
  constexpr int V = 16 / sizeof(B);
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = cluster_size(), me = cluster_rank();
  const long long lo = (blockIdx.x / n) * tile_elems;
  const long long elems = min(count - lo, tile_elems);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const B* src[kMaxRanks];              // slot [me + i], rotated
#pragma unroll
  for (int i = 0; i < kMaxRanks; ++i)
    if (i < n) src[i] = reinterpret_cast<const B*>(smem + kSlot0 + ((me + i) % n) * slot_bytes);
  B* const own = reinterpret_cast<B*>(smem + kSlot0 + me * slot_bytes);
  const B* mine = x + me * count + lo;

  if (bulk && threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_expect_tx(bar, static_cast<unsigned>(n * elems * sizeof(B)));
    hopper::mbar_init_fence();
  }
  // the mbarrier's fence already released its init to the cluster
  cluster_arrive_relaxed();
  cluster_wait();
  griddep_wait();
  if (bulk) {
    if (threadIdx.x == 0)
      hopper::bulk_load_multicast(own, mine, static_cast<unsigned>(elems * sizeof(B)), bar,
                                  static_cast<uint16_t>((1u << n) - 1));
    hopper::mbar_wait(bar, 0);
  } else {
    const uint32_t a = hopper::smem_u32(own);
    for (long long e = threadIdx.x; e < elems; e += blockDim.x) {
      const B v = mine[e];
      for (int r = 0; r < n; ++r) st_cluster(mapa(a, r) + static_cast<uint32_t>(e * sizeof(B)), v);
    }
    cluster_sync();
  }
  griddep_launch_dependents();
  // every byte into this block has landed (its mbarrier, or the barrier
  // above): the closing barrier only keeps each block until its peers' are in
  cluster_arrive_relaxed();

  B* dst = out + me * count + lo;
  long long done = 0;
  if (bulk) {
    union U { uint4 v; B e[V]; };
    const long long nv = elems / V;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      U acc;
      acc.v = reinterpret_cast<const uint4*>(src[0])[i];
#pragma unroll
      for (int j = 1; j < kMaxRanks; ++j) {
        if (j < n) {
          U o;
          o.v = reinterpret_cast<const uint4*>(src[j])[i];
#pragma unroll
          for (int e = 0; e < V; ++e) acc.e[e] = Elem<T>::add(acc.e[e], o.e[e]);
        }
      }
      reinterpret_cast<uint4*>(dst)[i] = acc.v;
    }
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < elems; i += blockDim.x) {
    B acc = src[0][i];
#pragma unroll
    for (int j = 1; j < kMaxRanks; ++j)
      if (j < n) acc = Elem<T>::add(acc, src[j][i]);
    dst[i] = acc;
  }
  cluster_wait();
}

// Nothing: the launch floor of a geometry (chip_smoke.py times it).
__global__ void ar_1pa_empty_kernel() {}

inline const void* pick(int dtype, int use_ll) {
  return use_ll ? MSCCL_BY_DTYPE(dtype, ar_1pa_ll_kernel) : MSCCL_BY_DTYPE(dtype, ar_1pa_hb_kernel);
}

constexpr int kSmemMax = 232448;    // 227 KB: one block's shared memory on an H100

// cudaLaunchKernelEx of `fn` over `grid` blocks in clusters of n, with
// programmatic stream serialization where `pdl`
inline int launch_clusters(const void* fn, int n, long long grid, int threads, int smem,
                           void** args, void* stream, int pdl) {
  if (fn == nullptr || n < 1 || n > kMaxRanks || grid < n || grid % n || grid > 0x7FFFFFFF ||
      threads < 32 || threads > 1024 || smem < 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = pdl != 0;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next launch
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace msccl

extern "C" {

// Once per (dtype, protocol, n, shared memory): allow the kernel kSmemMax
// bytes of dynamic shared memory and ask how many clusters of n blocks with
// `smem` bytes each the card can hold at once (*clusters; 0: none, the shape
// is not schedulable). Returns the cudaError_t of the queries.
int allreduce_1pa_prepare(int dtype, int use_ll, int n, int smem, int threads, int* clusters) {
  using namespace msccl;
  const void* fn = pick(dtype, use_ll);
  if (fn == nullptr || n < 1 || n > kMaxRanks || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *clusters = 0;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}

// One launch of every rank: x and out are [n][count] element buffers; the
// grid is n * tiles blocks in clusters of n, tile t elements [t *
// tile_elems, (t + 1) * tile_elems) of every rank, each block `smem` bytes
// of shared memory holding n slots of `slot_bytes` after the mbarrier.
// `pdl`: programmatic dependent launch (every call of the wrapper asks for
// it; 0 only to time the difference). Returns the launch's
// cudaError_t (0 on success).
int allreduce_1pa_launch(const void* x, void* out, int dtype, int n, long long count,
                         long long tile_elems, int tiles, int slot_bytes, int smem, int use_ll,
                         int threads, void* stream, int pdl) {
  using namespace msccl;
  if (count < 1 || tile_elems < 1 || tiles < 1 || (tiles - 1) * tile_elems >= count ||
      tiles * tile_elems < count)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = static_cast<long long>(n) * tiles;
  if (use_ll) {
    void* args[] = {&x, &out, &count, &tile_elems, &slot_bytes};
    return launch_clusters(pick(dtype, 1), n, grid, threads, smem, args, stream, pdl);
  }
  const long long esz = dtype == 1 || dtype == 2 ? 2 : 4;
  int bulk = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0 &&
             (count * esz) % 16 == 0 && (tile_elems * esz) % 16 == 0;
  void* args[] = {&x, &out, &count, &tile_elems, &slot_bytes, &bulk};
  return launch_clusters(pick(dtype, 0), n, grid, threads, smem, args, stream, pdl);
}

// The empty kernel over the same grid, clusters, threads, shared memory and
// launch attributes.
int allreduce_1pa_empty_launch(int n, int tiles, int smem, int threads, void* stream) {
  using namespace msccl;
  cudaError_t err =
      cudaFuncSetAttribute(reinterpret_cast<const void*>(&ar_1pa_empty_kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* none[] = {nullptr};
  return launch_clusters(reinterpret_cast<const void*>(&ar_1pa_empty_kernel), n,
                         static_cast<long long>(n) * tiles, threads, smem, none, stream, 1);
}

const char* allreduce_1pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
