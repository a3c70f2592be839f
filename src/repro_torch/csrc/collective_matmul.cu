// AllGather-matmul: out[r] = concat_s(x[s]) @ w[r] for every rank r, the
// ring transfer of one chunk overlapped with the product of another, every
// rank in one launch.
//
// Replaces the TPU kernel repro/kernels/collective_matmul.py:
// ag_matmul_kernel (:41, pallas_call at :99, allgather_matmul). It keeps the
// reference's ring schedule: at step i rank me forwards chunk slot =
// (me - i) mod n into rank me+1's gather buffer with a one-sided store and a
// release flag, and multiplies that chunk into output row block `slot`; a
// chunk's rows are read only after their arrival flag.
//
// Design. The work is a list of items in one global order, walked by a
// persistent cooperative grid (block b takes items b, b + grid, ...):
//   F(0), then for each step i: F(i + 1), C(i)
// where F(i) forwards, for every rank and 128-row tile, slot (r - i) mod n
// to rank r + 1 (flag per receiver, slot and row tile, epoch-tagged), and
// C(i) computes, for every rank, row tile and 128-column tile, that tile of
// slot (r - i) mod n's product. An item waits only on items earlier in the
// order, and every block walks its items in order with all blocks resident,
// so the earliest unfinished item can always run: no deadlock, though the
// grid is smaller than the work. The forward of step i + 1 is listed before
// the products of step i, so transfers run ahead of the tensor cores, as the
// reference issues the next put before this step's matmul.
//
// The product is computed in the kernel's own body:
// * bf16 in: mma.sync m16n8k16 (f32 accumulate) on 128 x 128 tiles, 8 warps
//   of 64 x 32, 64-deep k-steps through a 3-stage cp.async pipeline (105 KB
//   of shared memory, two blocks an SM); x's fragments by ldmatrix, w's by
//   ldmatrix.trans (the helpers of mma_bf16.cuh, shared with
//   flash_attention.cu). Rows past a chunk's end (decode's 2 rows a rank),
//   columns past F and k past K are zero-filled by cp.async, never padded in
//   the tensors.
// * f32 in: true f32 FMAs (the tensor cores would round to TF32) on 64 x 64
//   tiles, each thread 4 x 4 outputs.
// The f32 accumulator is cast once to the output type.
//
// Bound on an H100: at prefill, the operations (2 n (n rows) K F FLOP over
// 989 TFLOP/s in bf16, 67 in f32); at decode, the bytes of x, w and out over
// 3.35 TB/s. Neither kernel uses wgmma or TMA yet: a first, simple form.
#include "mma_bf16.cuh"
#include "primitives.cuh"

namespace agmm {

using bf16 = __nv_bfloat16;
using namespace frag;
constexpr int kThreads = 256;

struct Args {
  const void* x;     // [n][rows][K]
  const void* w;     // [K][F], or [n][K][F] (w_stride = K * F)
  void* out;         // [n][n * rows][F]
  void* xbuf;        // [n][n][rows][K] gather buffers (receiver, slot)
  unsigned* flags;   // [n][n][row tiles] arrival flags (receiver, slot, tile)
  long long w_stride;
  int n, rows, K, F;
  int tiles_m, tiles_n;  // row tiles a chunk, column tiles of F
  unsigned epoch;
};

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

template <typename TIn> struct Gemm;

// bf16: mma.sync on a 128 x 128 tile, 3-stage cp.async pipeline.
template <> struct Gemm<bf16> {
  static constexpr int BM = 128, BN = 128, BK = 64, S = 3;
  static constexpr int LDA = BK + 8, LDB = BN + 8;  // 16-byte pad: conflict-free fragments
  static constexpr int kStage = BM * LDA + BK * LDB;
  static constexpr size_t kSmem = sizeof(bf16) * S * kStage;

  // o[0:m, col0:col0+BN) = a[0:m, 0:K) @ w[0:K, col0:col0+BN); a, o of row
  // stride K and F, w of row stride F.
  template <typename TOut>
  __device__ static void run(unsigned char* smem, const bf16* a, int m, const bf16* w, int K,
                             int F, int col0, TOut* o) {
    bf16* base = reinterpret_cast<bf16*>(smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3, wm = warp >> 2, wn = warp & 3;  // g, t4: C fragment
    const int kt_n = (K + BK - 1) / BK;
    auto load = [&](int stage, int k0) {
      bf16* sa = base + stage * kStage;
      bf16* sb = sa + BM * LDA;
      for (int i = tid; i < BM * (BK / 8); i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = r < m && k0 + c < K;
        cp_async16(sa + r * LDA + c, ok ? a + static_cast<size_t>(r) * K + k0 + c : a, ok);
      }
      for (int i = tid; i < BK * (BN / 8); i += kThreads) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < K && col0 + c < F;
        cp_async16(sb + r * LDB + c, ok ? w + static_cast<size_t>(k0 + r) * F + col0 + c : w, ok);
      }
    };
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) acc[mi][nb][0] = acc[mi][nb][1] = acc[mi][nb][2] = acc[mi][nb][3] = 0.f;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < kt_n) load(s, s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < kt_n; ++kt) {
      cp_async_wait<S - 2>();
      __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
      if (kt + S - 1 < kt_n) load((kt + S - 1) % S, (kt + S - 1) * BK);
      cp_async_commit();
      const bf16* sa = base + (kt % S) * kStage;
      const bf16* sb = sa + BM * LDA;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                      sa + (wm * 64 + mi * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
        // lanes 0-15 address k rows ks*16 + lane at columns nb*8, lanes 16-31
        // the same rows at nb*8 + 8: b0, b1 of n-blocks nb and nb + 1
        const bf16* vr = sb + (ks * 16 + (lane & 15)) * LDB + wn * 32 + (lane >> 4) * 8;
#pragma unroll
        for (int nb = 0; nb < 4; nb += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, vr + nb * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][nb], af[mi][0], af[mi][1], af[mi][2], af[mi][3], b0, b1);
            mma_bf16(acc[mi][nb + 1], af[mi][0], af[mi][1], af[mi][2], af[mi][3], b2, b3);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r0 = wm * 64 + mi * 16 + g;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = col0 + wn * 32 + nb * 8 + 2 * t4;
        if (col >= F) continue;
        if (r0 < m) store2<TOut>(o + static_cast<size_t>(r0) * F + col, acc[mi][nb][0], acc[mi][nb][1]);
        if (r0 + 8 < m)
          store2<TOut>(o + static_cast<size_t>(r0 + 8) * F + col, acc[mi][nb][2], acc[mi][nb][3]);
      }
    }
  }
};

// f32: SIMT FMAs on a 64 x 64 tile; a is kept transposed in shared memory so
// a thread's 4 rows are one float4.
template <> struct Gemm<float> {
  static constexpr int BM = 64, BN = 64, BK = 16;
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr size_t kSmem = sizeof(float) * BK * (LDA + LDB);

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
      for (int i = tid; i < BM * BK; i += kThreads) {
        const int r = i / BK, k = i % BK;
        sa[k * LDA + r] = r < m && k0 + k < K ? a[static_cast<size_t>(r) * K + k0 + k] : 0.f;
      }
      for (int i = tid; i < BK * BN; i += kThreads) {
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

// item -> (forward or product, step, index within the step), in the order
// F(0), then F(i + 1), C(i) for each step i.
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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2) ag_matmul_kernel(Args a) {
  using G = Gemm<TIn>;
  using B = typename msccl::Elem<TIn>::B;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, T = a.tiles_m, C = a.tiles_n;
  const int n_fwd = n * T, n_mm = n * T * C;
  const int items = (n - 1) * n_fwd + n * n_mm;
  const long long chunk = static_cast<long long>(a.rows) * a.K;
  const TIn* x = static_cast<const TIn*>(a.x);
  TIn* xbuf = static_cast<TIn*>(a.xbuf);
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
    const TIn* src = slot == r ? x + r * chunk : xbuf + (static_cast<long long>(r) * n + slot) * chunk;
    if (slot != r) msccl::wait(a.flags + (static_cast<long long>(r) * n + slot) * T + t, a.epoch);
    if (fwd) {
      const int nxt = (r + 1) % n;
      msccl::put(reinterpret_cast<B*>(xbuf + (static_cast<long long>(nxt) * n + slot) * chunk +
                                      static_cast<long long>(row0) * a.K),
                 reinterpret_cast<const B*>(src + static_cast<long long>(row0) * a.K),
                 static_cast<long long>(m) * a.K);
      msccl::signal(a.flags + (static_cast<long long>(nxt) * n + slot) * T + t, a.epoch);
    } else {
      const TIn* wr = static_cast<const TIn*>(a.w) + r * a.w_stride;
      TOut* o = out + ((static_cast<long long>(r) * n + slot) * a.rows + row0) * a.F;
      G::template run<TOut>(smem, src + static_cast<long long>(row0) * a.K, m, wr, a.K, a.F,
                            c * G::BN, o);
    }
    __syncthreads();  // shared memory and the flag word are free for the next item
  }
}

template <typename TIn, typename TOut>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(&ag_matmul_kernel<TIn, TOut>);
}

// (kernel, dynamic shared memory, tile rows, tile columns) of a dtype pair
// (0 f32, 1 bf16); false for a pair the kernels do not take.
inline bool pick(int in_dtype, int out_dtype, const void*& fn, size_t& smem, int& bm, int& bn) {
  if (in_dtype == 1) {
    fn = out_dtype == 0 ? kernel_fn<bf16, float>() : out_dtype == 1 ? kernel_fn<bf16, bf16>() : nullptr;
    smem = Gemm<bf16>::kSmem, bm = Gemm<bf16>::BM, bn = Gemm<bf16>::BN;
  } else if (in_dtype == 0) {
    fn = out_dtype == 0 ? kernel_fn<float, float>() : out_dtype == 1 ? kernel_fn<float, bf16>() : nullptr;
    smem = Gemm<float>::kSmem, bm = Gemm<float>::BM, bn = Gemm<float>::BN;
  } else {
    fn = nullptr;
  }
  if (fn == nullptr) return false;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem)) == cudaSuccess;
}

}  // namespace agmm

extern "C" {

// Tile rows and columns of the kernel for a dtype pair (the wrapper sizes
// the flags by the row tiles); 0 for a pair the kernels do not take.
int ag_matmul_tile(int in_dtype, int out_dtype, int* bm, int* bn) {
  using namespace agmm;
  const void* fn;
  size_t smem;
  if (!pick(in_dtype, out_dtype, fn, smem, *bm, *bn)) return 0;
  return 1;
}

// x: [n][rows][K]; w: [K][F] (w_per_rank 0) or [n][K][F]; out: [n][n*rows][F];
// xbuf: [n][n][rows][K]; flags: [n][n][ceil(rows / bm)], zero before the first
// launch; dtypes 0 f32, 1 bf16 (x and w alike). bf16 needs K % 16 == 0 and
// F % 8 == 0 and 16-byte aligned tensors. Returns the launch's cudaError_t.
int ag_matmul_launch(const void* x, const void* w, void* out, void* xbuf, unsigned* flags,
                     int in_dtype, int out_dtype, int n, int rows, int K, int F, int w_per_rank,
                     unsigned epoch, void* stream) {
  using namespace agmm;
  const void* fn;
  size_t smem;
  int bm, bn;
  if (n < 1 || rows < 1 || K < 1 || F < 1 || !pick(in_dtype, out_dtype, fn, smem, bm, bn) ||
      (in_dtype == 1 && (K % 16 || F % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w, out, xbuf, flags, w_per_rank ? static_cast<long long>(K) * F : 0LL, n, rows, K,
         F, (rows + bm - 1) / bm, (F + bn - 1) / bn, epoch};
  const long long items = static_cast<long long>(n - 1) * n * a.tiles_m +
                          static_cast<long long>(n) * n * a.tiles_m * a.tiles_n;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // every block resident (they wait on each other's flags), no more blocks
  // than items
  const int grid = static_cast<int>(items < static_cast<long long>(sms) * per_sm
                                        ? items
                                        : static_cast<long long>(sms) * per_sm);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* collective_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
