// AllGather-matmul: out[r] = concat_s(x[s]) @ w[r] for every rank r, the
// transfer of the activations overlapped with the product, every rank in one
// launch.
//
// Replaces the TPU kernel repro/kernels/collective_matmul.py:
// ag_matmul_kernel (:41, pallas_call at :99, allgather_matmul). x is
// [n][rows][K] (rank r's shard at x[r]), w [K][F] shared or [n][K][F] per
// rank, out [n][n * rows][F], f32 accumulation cast once to the output type.
//
// Every kernel here walks a list of items in one global order with a
// persistent cooperative grid (block b takes items b, b + grid, ...). An item
// waits only on items earlier in the order, and every block walks its items
// in order with all blocks resident, so the earliest unfinished item can
// always run: no deadlock, though the grid is smaller than the work.
//
// bf16 in: two regimes, picked by the wrapper from the gathered rows n * rows
// (kernels/collective_matmul.py:regime).
// * Prefill (n * rows > 64): the reference's ring schedule. Items F(0), then
//   for each step i: F(i + 1), C(i). F(i) forwards, for every rank and
//   128-row tile, slot (r - i) mod n to rank r + 1's gather buffer (flag per
//   receiver, slot and row tile, epoch-tagged); C(i) computes, for every
//   rank, row tile and 256-column tile, that tile of slot (r - i) mod n's
//   product. The forward of step i + 1 is listed before the products of step
//   i, so transfers run ahead of the tensor cores, as the reference issues
//   the next put before this step's matmul.
// * Decode (n * rows <= 64): all-pairs. Items: n * n puts (sender s's rows
//   into receiver r's gather buffer, one flag per (receiver, sender)), then
//   one product per (rank, 64-column tile, k-split) that waits for its n
//   arrivals and reads its tile of w[r] once for all n * rows rows: w, the
//   bytes that bound decode, is read once a call instead of once a slot.
//   The splits fill the SMs; when there is more than one, each writes its f32
//   partial and the last to finish (an integer counter) sums them in split
//   order, so the result does not change from run to run.
//
// The product (both regimes) is a Hopper GEMM: one producer thread issues
// TMA loads of the x tile (K-major) and the w tile (MN-major) into a ring of
// shared-memory stages, 128-byte swizzled, completed on mbarriers; consumer
// warpgroups issue wgmma.mma_async (bf16 in, f32 accumulators in registers)
// and release each stage on an mbarrier. The producer issues an item's w
// tiles before it waits for the item's arrival flags, and waits for them
// before it issues any x tile; x rows, F and K past their ends are
// zero-filled by TMA, never padded in the tensors.
// * Prefill: 128 x 256 tiles, two consumer warpgroups of 64 rows, 4 stages
//   of 64-deep k (225 KB of shared memory with the bounce buffers below, one
//   block an SM). The epilogue goes through the warpgroup's x rows of the
//   item's last stage, which the consumers keep until the tile is out:
//   fragments into shared memory, 16-byte row vectors out to global memory
//   (whole 128-byte lines, where fragment stores write 16-byte pieces of
//   eight rows at a time). A ring forward (one contiguous run of 128 rows) is copied by a second
//   thread of the producer warp with bulk copies through two 16 KB bounce
//   buffers, under the consumers' products.
// * Decode: 64 x 64 tiles, one consumer warpgroup, 6 stages (97 KB, two
//   blocks an SM); the small puts are copied by the consumer threads, whose
//   products wait for them anyway.
// Gather buffers are read by TMA (the async proxy) and written by bulk
// stores or st.global: writers fence.proxy.async before their release,
// readers after their acquire.
//
// f32 in: the ring schedule with true f32 FMAs (the tensor cores would round
// to TF32) on 64 x 64 tiles, each thread 4 x 4 outputs (no main-path shape).
//
// Bound on an H100: at prefill, the operations (2 n (n rows) K F FLOP over
// 989 TFLOP/s in bf16, 67 in f32); at decode, the bytes of x, w and out over
// 3.35 TB/s.
//
// TMA descriptors are encoded on the host at each launch by the driver's
// cuTensorMapEncodeTiled, looked up with dlopen/dlsym in the driver library
// the process already holds (libcuda.so.1): the library links no libcuda.
// The mbarrier, TMA, descriptor and wgmma helpers are hopper.cuh's.
#include "hopper.cuh"

namespace agmm {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 cast_out<bf16>(float v) { return __float2bfloat16(v); }

// item -> (forward or product, step, index within the step), in the ring
// order F(0), then F(i + 1), C(i) for each step i.
__device__ __forceinline__ bool locate(int item, int n, int n_fwd, int n_mm, bool& fwd, int& step,
                                       int& rem) {
  if (n > 1) {
    if (item < n_fwd) {
      fwd = true, step = 0, rem = item;
      return true;
    }
    item -= n_fwd;
  }
  for (int i = 0; i < n; ++i) {
    if (i + 1 <= n - 2) {
      if (item < n_fwd) {
        fwd = true, step = i + 1, rem = item;
        return true;
      }
      item -= n_fwd;
    }
    if (item < n_mm) {
      fwd = false, step = i, rem = item;
      return true;
    }
    item -= n_mm;
  }
  return false;
}

// ===========================================================================
// f32 in: SIMT FMAs on the ring schedule
// ===========================================================================
constexpr int kSimtThreads = 256;

struct SimtArgs {
  const float* x;    // [n][rows][K]
  const float* w;    // [K][F], or [n][K][F] (w_stride = K * F)
  void* out;         // [n][n * rows][F]
  float* xbuf;       // [n][n][rows][K] gather buffers (receiver, slot)
  unsigned* flags;   // [n][n][row tiles] arrival flags (receiver, slot, tile)
  long long w_stride;
  int n, rows, K, F;
  int tiles_m, tiles_n;  // row tiles a chunk, column tiles of F
  unsigned epoch;
};

// 64 x 64 tiles; a is kept transposed in shared memory so a thread's 4 rows
// are one float4.
struct SimtGemm {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr size_t kSmem = sizeof(float) * BK * (LDA + LDB);

  // o[0:m, col0:col0+BN) = a[0:m, 0:K) @ w[0:K, col0:col0+BN); a, o of row
  // stride K and F, w of row stride F.
  template <typename TOut>
  __device__ static void run(unsigned char* smem, const float* a, int m, const float* w, int K,
                             int F, int col0, TOut* o) {
    float* sa = reinterpret_cast<float*>(smem);  // [BK][LDA], a transposed
    float* sb = sa + BK * LDA;                   // [BK][LDB]
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;  // rows ty*4.., cols tx + 16 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BM * BK; i += kSimtThreads) {
        const int r = i / BK, k = i % BK;
        sa[k * LDA + r] = r < m && k0 + k < K ? a[static_cast<size_t>(r) * K + k0 + k] : 0.f;
      }
      for (int i = tid; i < BK * BN; i += kSimtThreads) {
        const int k = i / BN, c = i % BN;
        sb[k * LDB + c] =
            k0 + k < K && col0 + c < F ? w[static_cast<size_t>(k0 + k) * F + col0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(sa + k * LDA + ty * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = sb[k * LDB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ar[i], b, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col < F) o[static_cast<size_t>(r) * F + col] = cast_out<TOut>(acc[i][j]);
      }
    }
  }
};

template <typename TOut>
__global__ void __launch_bounds__(kSimtThreads, 2) ag_matmul_simt_kernel(SimtArgs a) {
  using G = SimtGemm;
  using B = msccl::Elem<float>::B;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, T = a.tiles_m, C = a.tiles_n;
  const int n_fwd = n * T, n_mm = n * T * C;
  const int items = (n - 1) * n_fwd + n * n_mm;
  const long long chunk = static_cast<long long>(a.rows) * a.K;
  TOut* out = static_cast<TOut*>(a.out);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    bool fwd;
    int step, rem;
    if (!locate(item, n, n_fwd, n_mm, fwd, step, rem)) break;
    int r, t, c = 0;
    if (fwd) {
      r = rem / T, t = rem % T;
    } else {
      r = rem / (T * C), t = (rem / C) % T, c = rem % C;
    }
    const int slot = (r - step + n) % n;
    const int row0 = t * G::BM, m = min(G::BM, a.rows - row0);
    // my copy of chunk `slot`: my own input at step 0, else the gather buffer
    // once its rows have arrived
    const float* src =
        slot == r ? a.x + r * chunk : a.xbuf + (static_cast<long long>(r) * n + slot) * chunk;
    if (slot != r) msccl::wait(a.flags + (static_cast<long long>(r) * n + slot) * T + t, a.epoch);
    if (fwd) {
      const int nxt = (r + 1) % n;
      msccl::put(reinterpret_cast<B*>(a.xbuf + (static_cast<long long>(nxt) * n + slot) * chunk +
                                      static_cast<long long>(row0) * a.K),
                 reinterpret_cast<const B*>(src + static_cast<long long>(row0) * a.K),
                 static_cast<long long>(m) * a.K);
      msccl::signal(a.flags + (static_cast<long long>(nxt) * n + slot) * T + t, a.epoch);
    } else {
      TOut* o = out + ((static_cast<long long>(r) * n + slot) * a.rows + row0) * a.F;
      G::run<TOut>(smem, src + static_cast<long long>(row0) * a.K, m, a.w + r * a.w_stride, a.K,
                   a.F, c * G::BN, o);
    }
    __syncthreads();  // shared memory and the flag word are free for the next item
  }
}

// ===========================================================================
// bf16 in: TMA + wgmma
// ===========================================================================

struct TmaArgs {
  CUtensorMap x_map;     // x {K, rows, n}
  CUtensorMap xbuf_map;  // prefill {K, rows, n * n} (receiver, slot); decode {K, n * rows, n}
  CUtensorMap w_map;     // w {F, K, n or 1}
  const bf16* x;         // [n][rows][K]
  bf16* xbuf;            // gather buffers, the maps' layout
  void* out;             // [n][n * rows][F]
  float* part;           // decode, splits > 1: [n][tiles_n][splits][64][64] f32 partials
  unsigned* flags;       // prefill [n][n][tiles_m]; decode [n][n] (receiver, sender)
  unsigned* counters;    // decode: [n][tiles_n] finished splits, 0 between launches
  int n, rows, K, F;
  int tiles_m, tiles_n;  // prefill row tiles a chunk; column tiles of F
  int splits, kt_split;  // decode: k-splits, k-tiles a split
  int w_per_rank;
  unsigned epoch;
};

constexpr int kBK = 64;  // k a stage: one 128-byte swizzle row of bf16

// kFwd: bytes of each of the two bounce buffers the ring's forwards pass
// through (0: no forwards)
template <int kWG, int kBN, int kStages, int kFwd>
struct Cfg {
  static constexpr int BM = 64 * kWG, BN = kBN;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
  static constexpr int kABytes = BM * kBK * 2, kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr size_t kSmem =
      1024 + size_t(kStages) * kStageBytes + 2 * size_t(kFwd) + (2 * kStages + 2) * 8;
};

using Prefill = Cfg<2, 256, 4, 16384>;
using Decode = Cfg<1, 64, 6, 0>;

// One item of the walk.
struct Work {
  bool product;  // else a copy: a ring forward or a decode put
  int r;         // rank whose gather buffer receives (copy) or whose product this is
  int slot;      // prefill: chunk slot; decode copy: sender
  int nxt;       // prefill forward: receiving rank
  int t, c;      // prefill row tile; column tile
  int k0, k1;    // product: k-tiles [k0, k1)
  int split;     // decode product: k-split
};

template <bool kDecode>
__device__ __forceinline__ int item_count(const TmaArgs& a) {
  const int n = a.n;
  if (kDecode) return n * n + n * a.tiles_n * a.splits;
  return (n - 1) * n * a.tiles_m + n * n * a.tiles_m * a.tiles_n;
}

template <bool kDecode>
__device__ __forceinline__ Work locate_item(const TmaArgs& a, int item) {
  Work w{};
  const int n = a.n, kt = (a.K + kBK - 1) / kBK;
  if (kDecode) {
    if (item < n * n) {
      w.product = false, w.r = item / n, w.slot = item % n;
    } else {
      const int rem = item - n * n, per_r = a.tiles_n * a.splits;
      w.product = true, w.r = rem / per_r, w.c = (rem % per_r) / a.splits;
      w.split = rem % a.splits;
      w.k0 = w.split * a.kt_split, w.k1 = min(kt, w.k0 + a.kt_split);
    }
    return w;
  }
  const int T = a.tiles_m, C = a.tiles_n;
  bool fwd;
  int step, rem;
  locate(item, n, n * T, n * T * C, fwd, step, rem);
  w.product = !fwd;
  if (fwd) {
    w.r = rem / T, w.t = rem % T;
  } else {
    w.r = rem / (T * C), w.t = (rem / C) % T, w.c = rem % C;
  }
  w.slot = (w.r - step + n) % n;
  w.nxt = (w.r + 1) % n;
  w.k0 = 0, w.k1 = kt;
  return w;
}

// The consumers' named barrier (id 1): the producer warp never joins it.
template <int kThreadsIn>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreadsIn) : "memory");
}

// One consumer warpgroup's named barrier (ids 2, 3; 1 is all consumers').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// Decode's consumers: copy `count` bf16 from src to dst, then release
// `flag` with the epoch (as msccl::signal: the barrier orders every copying
// thread's stores before the release). The async proxy (TMA) reads what
// this writes, so every writer fences the proxies first.
template <int kConsumers>
__device__ __forceinline__ void copy_and_signal(bf16* dst, const bf16* src, long long count,
                                                unsigned* flag, unsigned epoch) {
  using B = msccl::Elem<bf16>::B;
  msccl::put(reinterpret_cast<B*>(dst), reinterpret_cast<const B*>(src), count, threadIdx.x,
             kConsumers);
  fence_proxy_async();
  consumers_sync<kConsumers>();
  if (threadIdx.x == 0) msccl::st_release(flag, epoch);
}

template <int kWG, int kBN, int kStages, int kFwd, bool kDecode, typename TOut>
__global__ void __launch_bounds__(Cfg<kWG, kBN, kStages, kFwd>::kThreads, kDecode ? 2 : 1)
    ag_matmul_tma_kernel(const __grid_constant__ TmaArgs a) {
  using G = Cfg<kWG, kBN, kStages, kFwd>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes and wgmma descriptors want 1024-byte aligned
  // stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* bounce = smem + kStages * G::kStageBytes;  // [2][kFwd]
  uint64_t* full = reinterpret_cast<uint64_t*>(bounce + 2 * kFwd);
  uint64_t* empty = full + kStages;
  uint64_t* fwd_bar = empty + kStages;  // [2]: a bounce buffer's load landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);           // the producer's expect_tx arrival + the bytes
      mbar_init(&empty[s], 4 * kWG);    // one arrival per consumer warp
    }
    mbar_init(&fwd_bar[0], 1);
    mbar_init(&fwd_bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int n = a.n, items = item_count<kDecode>(a);
  const long long chunk = static_cast<long long>(a.rows) * a.K;  // elements of one shard

  if (!kDecode && threadIdx.x == G::kConsumers + 1) {
    // ---- forwarder (lane 1 of the producer warp): the ring's forwards, by
    // bulk copies through two bounce buffers, under the block's products ----
    unsigned ph[2] = {0, 0};
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Work w = locate_item<kDecode>(a, item);
      if (w.product) continue;
      const int row0 = w.t * G::BM;
      const long long off = static_cast<long long>(row0) * a.K;
      const long long bytes = 2LL * min(G::BM, a.rows - row0) * a.K;  // one contiguous run
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (w.slot == w.r ? a.x + w.r * chunk
                         : a.xbuf + (static_cast<long long>(w.r) * n + w.slot) * chunk) + off);
      unsigned char* dst = reinterpret_cast<unsigned char*>(
          a.xbuf + (static_cast<long long>(w.nxt) * n + w.slot) * chunk + off);
      unsigned* flag = a.flags + (static_cast<long long>(w.nxt) * n + w.slot) * a.tiles_m + w.t;
      if (w.slot != w.r) {
        msccl::spin_until(a.flags + (static_cast<long long>(w.r) * n + w.slot) * a.tiles_m + w.t,
                          a.epoch);
        fence_proxy_async();
      }
      for (long long o = 0, j = 0; o < bytes; o += kFwd, ++j) {
        const int b = j & 1;
        const unsigned len = static_cast<unsigned>(min(static_cast<long long>(kFwd), bytes - o));
        bulk_wait<1, true>();  // buffer b's previous store has read it
        mbar_expect_tx(&fwd_bar[b], len);
        bulk_load(bounce + b * kFwd, src + o, len, &fwd_bar[b]);
        mbar_wait(&fwd_bar[b], ph[b]);
        ph[b] ^= 1;
        bulk_store(dst + o, bounce + b * kFwd, len);
      }
      bulk_wait<0, false>();  // the forward is written
      fence_proxy_async();
      __threadfence();
      msccl::st_release(flag, a.epoch);
    }
    return;
  }
  if (threadIdx.x >= G::kConsumers) {
    // ---- producer: one thread issues every TMA load of the block ----
    if (threadIdx.x != G::kConsumers) return;
    uint32_t it = 0;  // k-tiles this block has loaded so far
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Work w = locate_item<kDecode>(a, item);
      if (!w.product) continue;
      const int nk = w.k1 - w.k0, pre = min(kStages, nk);
      const int wz = a.w_per_rank ? w.r : 0;
      auto stage = [&](int j) { return smem + ((it + j) % kStages) * G::kStageBytes; };
      auto bar = [&](int j) { return &full[(it + j) % kStages]; };
      auto acquire = [&](int j) {
        mbar_wait(&empty[(it + j) % kStages], (((it + j) / kStages) & 1) ^ 1);
        mbar_expect_tx(bar(j), G::kStageBytes);
      };
      auto load_w = [&](int j) {
#pragma unroll
        for (int h = 0; h < kBN / 64; ++h)
          tma_load(stage(j) + G::kABytes + h * (kBK * 128), &a.w_map, bar(j),
                   w.c * kBN + h * 64, (w.k0 + j) * kBK, wz);
      };
      auto load_x = [&](int j) {
        if (kDecode)
          tma_load(stage(j), &a.xbuf_map, bar(j), (w.k0 + j) * kBK, 0, w.r);
        else if (w.slot == w.r)
          tma_load(stage(j), &a.x_map, bar(j), (w.k0 + j) * kBK, w.t * G::BM, w.r);
        else
          tma_load(stage(j), &a.xbuf_map, bar(j), (w.k0 + j) * kBK, w.t * G::BM, w.r * n + w.slot);
      };
      // w needs no arrival: its first tiles are in flight while the rows arrive
      for (int j = 0; j < pre; ++j) {
        acquire(j);
        load_w(j);
      }
      if (kDecode) {
        for (int s = 0; s < n; ++s) msccl::spin_until(a.flags + w.r * n + s, a.epoch);
        fence_proxy_async();
      } else if (w.slot != w.r) {
        msccl::spin_until(a.flags + (static_cast<long long>(w.r) * n + w.slot) * a.tiles_m + w.t,
                          a.epoch);
        fence_proxy_async();
      }
      for (int j = 0; j < pre; ++j) load_x(j);
      for (int j = pre; j < nk; ++j) {
        acquire(j);
        load_w(j);
        load_x(j);
      }
      it += nk;
    }
    return;
  }

  // ---- consumers: copies, and the wgmma of every product item ----
  constexpr int kC = G::kConsumers;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  __shared__ int s_last;
  uint32_t it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Work w = locate_item<kDecode>(a, item);
    if (!w.product) {
      if (kDecode)  // sender w.slot's rows into receiver w.r's buffer
        copy_and_signal<kC>(a.xbuf + (static_cast<long long>(w.r) * n + w.slot) * chunk,
                        a.x + w.slot * chunk, chunk, a.flags + w.r * n + w.slot, a.epoch);
      continue;  // a ring forward is the forwarder's
    }

    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    const int nk = w.k1 - w.k0;
    for (int j = 0; j < nk; ++j) {
      const int s = (it + j) % kStages;
      mbar_wait(&full[s], ((it + j) / kStages) & 1);
      const unsigned char* st = smem + s * G::kStageBytes;
      const uint64_t da = desc_k_major(st + wg * 64 * 128);
      const uint64_t db = desc_mn_major(st + G::kABytes, kBK * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 16 k a wgmma: 32 bytes of an x row, 16 w rows
        Wgmma<kBN>::template ss<1>(acc, da + 2 * kk, db + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done with their stage
      if (j > 0 && lane == 0) mbar_arrive(&empty[(it + j - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const int last = (it + nk - 1) % kStages;
    it += nk;

    // ---- epilogue: D fragment (row, col) of this thread ----
    const int lr0 = wg * 64 + warp * 16 + lane / 4, lc0 = 2 * (lane % 4);
    if (!kDecode) {
      // staged through this warpgroup's x rows of the item's last stage,
      // which only its own (finished) wgmma read and which the consumers
      // keep until the tile is out: 128-byte-wide column chunks go to shared
      // memory as fragments (16-byte granules XOR-swizzled by row, so the
      // fragment stores are conflict-free), then to global memory as 16-byte
      // row vectors
      const int row0 = w.t * G::BM, m = min(G::BM, a.rows - row0);
      TOut* o = static_cast<TOut*>(a.out) +
                ((static_cast<long long>(w.r) * n + w.slot) * a.rows + row0 + wg * 64) * a.F;
      constexpr int kCw = 128 / sizeof(TOut), kVec = 16 / sizeof(TOut);  // chunk, vector width
      unsigned char* staging = smem + last * G::kStageBytes + wg * 64 * 128;
      auto at = [&](int row, int col) {  // byte of (row, col) of a chunk
        const int byte = col * static_cast<int>(sizeof(TOut));
        return staging + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15);
      };
      const int t = threadIdx.x % 128, lr = lr0 - wg * 64;
#pragma unroll
      for (int cc = 0; cc < kBN / kCw; ++cc) {
#pragma unroll
        for (int jj = 0; jj < kCw / 8; ++jj) {
          const int j = cc * (kCw / 8) + jj;
          store2<TOut>(reinterpret_cast<TOut*>(at(lr, 8 * jj + lc0)), acc[4 * j], acc[4 * j + 1]);
          store2<TOut>(reinterpret_cast<TOut*>(at(lr + 8, 8 * jj + lc0)), acc[4 * j + 2],
                       acc[4 * j + 3]);
        }
        warpgroup_sync(wg);
        for (int v = t; v < 64 * 8; v += 128) {
          const int row = v / 8, col = w.c * kBN + cc * kCw + (v % 8) * kVec;
          if (wg * 64 + row < m && col < a.F)
            *reinterpret_cast<uint4*>(o + static_cast<long long>(row) * a.F + col) =
                *reinterpret_cast<const uint4*>(at(row, (v % 8) * kVec));
        }
        warpgroup_sync(wg);
      }
      // the stage's next contents come by TMA (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[last]);
      continue;
    }
    if (lane == 0) mbar_arrive(&empty[last]);
    const int M = n * a.rows;  // gathered rows, <= 64
    if (a.splits == 1) {
      TOut* o = static_cast<TOut*>(a.out) + static_cast<long long>(w.r) * M * a.F;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = w.c * kBN + 8 * j + lc0;
        if (col >= a.F) continue;
        if (lr0 < M) store2<TOut>(o + static_cast<long long>(lr0) * a.F + col, acc[4 * j], acc[4 * j + 1]);
        if (lr0 + 8 < M)
          store2<TOut>(o + static_cast<long long>(lr0 + 8) * a.F + col, acc[4 * j + 2], acc[4 * j + 3]);
      }
      continue;
    }
    // split-K: my f32 partial, then the last split of the tile sums all of
    // them in split order
    float* tile_part = a.part + (static_cast<long long>(w.r) * a.tiles_n + w.c) * a.splits * 64 * 64;
    float* mine = tile_part + w.split * 64 * 64;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int lc = 8 * j + lc0;
      if (lr0 < M) store2<float>(mine + lr0 * 64 + lc, acc[4 * j], acc[4 * j + 1]);
      if (lr0 + 8 < M) store2<float>(mine + (lr0 + 8) * 64 + lc, acc[4 * j + 2], acc[4 * j + 3]);
    }
    consumers_sync<kC>();
    unsigned* counter = a.counters + w.r * a.tiles_n + w.c;
    if (threadIdx.x == 0) {
      __threadfence();
      s_last = atomicAdd(counter, 1u) == static_cast<unsigned>(a.splits - 1);
    }
    consumers_sync<kC>();
    if (s_last) {
      __threadfence();
      TOut* o = static_cast<TOut*>(a.out) + static_cast<long long>(w.r) * M * a.F;
      for (int i = threadIdx.x; i < M * 64; i += kC) {
        const int lr = i / 64, col = w.c * 64 + i % 64;
        if (col >= a.F) continue;
        float v = __ldcg(tile_part + i);
        for (int s = 1; s < a.splits; ++s) v += __ldcg(tile_part + s * 64 * 64 + i);
        o[static_cast<long long>(lr) * a.F + col] = cast_out<TOut>(v);
      }
      if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// The most blocks of `fn` (with `smem` bytes of dynamic shared memory) the
// card keeps resident at once: every block waits on others' flags.
inline cudaError_t resident_blocks(const void* fn, int threads, size_t smem, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  blocks = sms * per_sm;
  if (e == cudaSuccess && blocks < 1) e = cudaErrorCooperativeLaunchTooLarge;
  return e;
}

// cooperative launch of min(items, resident) blocks
template <typename A>
inline int launch(const void* fn, int threads, size_t smem, long long items, A& args,
                  void* stream) {
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  cudaError_t e = resident_blocks(fn, threads, smem, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(items < cap ? items : cap);
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), kargs, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next launch
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tile rows and columns of an (in dtype, regime) pair (0 f32, 1 bf16;
// regime 0 prefill, 1 decode; f32 in has one regime); false for an unknown
// pair.
inline bool tile_of(int in_dtype, int regime, int& bm, int& bn) {
  if (in_dtype == 0) {
    bm = SimtGemm::BM, bn = SimtGemm::BN;
  } else if (in_dtype == 1 && (regime == 0 || regime == 1)) {
    bm = regime ? Decode::BM : Prefill::BM, bn = regime ? Decode::BN : Prefill::BN;
  } else {
    return false;
  }
  return true;
}

template <bool kDecode, typename TOut>
const void* tma_kernel() {
  if (kDecode)
    return reinterpret_cast<const void*>(&ag_matmul_tma_kernel<1, 64, 6, 0, true, TOut>);
  return reinterpret_cast<const void*>(&ag_matmul_tma_kernel<2, 256, 4, 16384, false, TOut>);
}

}  // namespace agmm

extern "C" {

// x: [n][rows][K]; w: [K][F] (w_per_rank 0) or [n][K][F]; out: [n][n*rows][F];
// xbuf: n * n * rows * K elements of x's type (gather buffers); flags: [n][n]
// [ceil(rows / 64)] (the ring: a flag per tile of 64 or 128 rows) or [n][n]
// (decode), zero before the first launch; part: decode with splits > 1,
// [n][ceil(F / 64)][splits][64][64] f32; counters: decode, [n][ceil(F / 64)],
// zero before the first launch.
// dtypes 0 f32, 1 bf16 (x and w alike); regime 0 prefill (the ring), 1
// decode (all-pairs; bf16, n * rows <= 64), with `splits` k-splits of
// `kt_split` 64-deep k-tiles. bf16 needs K and F multiples of 8 and 16-byte
// aligned tensors. Returns the launch's cudaError_t.
int ag_matmul_launch(const void* x, const void* w, void* out, void* xbuf, unsigned* flags,
                     float* part, unsigned* counters, int in_dtype, int out_dtype, int n, int rows,
                     int K, int F, int w_per_rank, int regime, int splits, int kt_split,
                     unsigned epoch, void* stream) {
  using namespace agmm;
  int bm, bn;
  if (n < 1 || rows < 1 || K < 1 || F < 1 || out_dtype < 0 || out_dtype > 1 ||
      !tile_of(in_dtype, regime, bm, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = (rows + bm - 1) / bm, tiles_n = (F + bn - 1) / bn;
  if (in_dtype == 0) {
    SimtArgs a{static_cast<const float*>(x), static_cast<const float*>(w), out,
               static_cast<float*>(xbuf), flags, w_per_rank ? static_cast<long long>(K) * F : 0LL,
               n, rows, K, F, tiles_m, tiles_n, epoch};
    const long long items = static_cast<long long>(n - 1) * n * tiles_m +
                            static_cast<long long>(n) * n * tiles_m * tiles_n;
    const void* fn = out_dtype == 0 ? reinterpret_cast<const void*>(&ag_matmul_simt_kernel<float>)
                                    : reinterpret_cast<const void*>(&ag_matmul_simt_kernel<bf16>);
    return launch(fn, kSimtThreads, SimtGemm::kSmem, items, a, stream);
  }
  const int kt = (K + kBK - 1) / kBK;
  const bool decode = regime == 1;
  if (K % 8 || F % 8 ||
      (decode && (n * rows > Decode::BM || splits < 1 || kt_split < 1 ||
                  static_cast<long long>(splits) * kt_split < kt ||
                  static_cast<long long>(splits - 1) * kt_split >= kt)))
    return static_cast<int>(cudaErrorInvalidValue);
  TmaArgs a{};
  const uint64_t uK = K, uF = F, un = n, urows = rows;
  bool ok = make_map(&a.x_map, x, uK, urows, un, kBK, bm) &&
            make_map(&a.w_map, w, uF, uK, w_per_rank ? un : 1, 64, kBK);
  ok = ok && (decode ? make_map(&a.xbuf_map, xbuf, uK, un * urows, un, kBK, bm)
                     : make_map(&a.xbuf_map, xbuf, uK, urows, un * un, kBK, bm));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.xbuf = static_cast<bf16*>(xbuf);
  a.out = out, a.part = part, a.flags = flags, a.counters = counters;
  a.n = n, a.rows = rows, a.K = K, a.F = F;
  a.tiles_m = tiles_m, a.tiles_n = tiles_n;
  a.splits = decode ? splits : 1, a.kt_split = decode ? kt_split : kt;
  a.w_per_rank = w_per_rank, a.epoch = epoch;
  if (decode) {
    const long long items = static_cast<long long>(n) * n + static_cast<long long>(n) * tiles_n * splits;
    const void* fn = out_dtype == 0 ? tma_kernel<true, float>() : tma_kernel<true, bf16>();
    return launch(fn, Decode::kThreads, Decode::kSmem, items, a, stream);
  }
  const long long items = static_cast<long long>(n - 1) * n * tiles_m +
                          static_cast<long long>(n) * n * tiles_m * tiles_n;
  const void* fn = out_dtype == 0 ? tma_kernel<false, float>() : tma_kernel<false, bf16>();
  return launch(fn, Prefill::kThreads, Prefill::kSmem, items, a, stream);
}

const char* collective_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
