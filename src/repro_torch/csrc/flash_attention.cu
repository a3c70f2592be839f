// Flash attention forward: causal, sliding-window or bidirectional attention
// over whole sequences from position 0, grouped-query heads read in place.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py: _fa_kernel (:37,
// pallas_call at :111, flash_attention). One block per (batch x head, 64-row
// query block); KV tiles stream through shared memory while the running max,
// denominator and accumulator stay in f32 registers (the online-softmax
// recurrence). KV tiles wholly outside the causal limit or the window are
// never visited (the reference's lo/hi block range), so a sliding-window layer
// costs O(s * window), not O(s^2). Masking is the reference's: rel = q_pos -
// k_pos, causal keeps rel >= 0, a window keeps rel < window, masked logits are
// -1e30, the output is acc / max(l, 1e-30). Keys past a ragged s are masked
// and query rows past it never stored. Query head i reads KV head
// i / (h / h_kv), so broadcast K/V are never materialised.
//
// Bound on an H100: at the model shapes, tensor-core operations (4 * hd per
// unmasked (query, key) pair and head over 989 TFLOP/s in bf16); at short s,
// the bytes of q, k, v read once and o written once over 3.35 TB/s.
//
// Two kernels, chosen by the element type:
// * bf16 - fa_mma_kernel: 4 warps, 16 query rows each. S = Q K^T and O += P V
//   run on the tensor cores by mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   the S accumulator fragment is the A fragment of P V, so P stays in
//   registers; V's fragments come by ldmatrix.trans. Q, K and V tiles sit in
//   shared memory, loaded by cp.async with zero fill past s, rows padded by 16
//   bytes so every fragment load is free of bank conflicts.
// * f32 - fa_simt_kernel: true f32 FMAs (the tensor cores would round to
//   TF32). 256 threads, each owning 4 query rows x hd / 16 output columns,
//   tiles held as f32 in shared memory and read as float4.
// Neither pipelines its tile loads nor uses wgmma/TMA yet: a first, simple
// kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace fa {

using namespace frag;
using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;  // query rows per block, both kernels

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int h, hkv, s;
  int causal;
  int window;  // 0: none
  float scale;
};

// KV tiles [lo, hi) of `bk` keys that the query block at q_start visits.
__device__ __forceinline__ void block_range(const Args& a, int q_start, int bk, int& lo,
                                            int& hi) {
  lo = a.window > 0 ? max(q_start - (a.window - 1), 0) / bk : 0;
  hi = a.causal ? min(q_start + kBQ - 1, a.s - 1) / bk + 1 : (a.s + bk - 1) / bk;
}

__device__ __forceinline__ bool keep(const Args& a, int qp, int kp) {
  const int rel = qp - kp;
  return kp < a.s && (!a.causal || rel >= 0) && (a.window <= 0 || rel < a.window);
}

// Base pointers of this block's head: q/o rows of (batch, head), k/v rows of
// its KV head.
template <typename T>
struct Heads {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  __device__ Heads(const Args& a, int bh, int hd) {
    const int bi = bh / a.h, kvh = (bh % a.h) / (a.h / a.hkv);
    const size_t qo = static_cast<size_t>(bh) * a.s * hd;
    const size_t kv = (static_cast<size_t>(bi) * a.hkv + kvh) * a.s * hd;
    q = static_cast<const T*>(a.q) + qo;
    k = static_cast<const T*>(a.k) + kv;
    v = static_cast<const T*>(a.v) + kv;
    o = static_cast<T*>(a.o) + qo;
  }
};

__device__ __forceinline__ float shfl_xor(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------
template <int HD>
struct SimtCfg {
  static constexpr int kThreads = 256;
  static constexpr int kBK = HD <= 128 ? 32 : 16;  // keys per tile
  static constexpr int kLD = HD + 4;   // float row: 16-byte aligned, float4 reads conflict-free
  static constexpr int kLDP = kBK + 4;
  static constexpr size_t kSmem = sizeof(float) * (kBQ * kLD + 2 * kBK * kLD + kBQ * kLDP);
};

// rows [row0, row0 + ROWS) of a (s, HD) f32 matrix into dst (row stride LD),
// times mul; rows past s are zero.
template <int HD, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int row0, int s,
                                         float mul, int tid) {
  constexpr int kPerRow = HD / 4;
  for (int i = tid; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < s) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(256) fa_simt_kernel(Args a) {
  using C = SimtCfg<HD>;
  constexpr int BK = C::kBK, LD = C::kLD, LDP = C::kLDP, NJ = HD / 16, KJ = BK / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kBQ][LD], q * scale
  float* sk = sq + kBQ * LD;                        // [BK][LD]
  float* sv = sk + BK * LD;                         // [BK][LD]
  float* sp = sv + BK * LD;                         // [kBQ][LDP], probabilities
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;  // rows ty*4.., cols tx + 16 j
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;    // longest blocks first
  const Heads<float> p(a, blockIdx.x, HD);

  load_f32<HD, kBQ, LD, 256>(sq, p.q, q_start, a.s, a.scale, tid);
  int lo, hi;
  block_range(a, q_start, BK, lo, hi);
  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }
  for (int kb = lo; kb < hi; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_f32<HD, BK, LD, 256>(sk, p.k, k_start, a.s, 1.f, tid);
    load_f32<HD, BK, LD, 256>(sv, p.v, k_start, a.s, 1.f, tid);
    __syncthreads();
    float sc[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sq + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_start + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (!keep(a, qp, k_start + tx + 16 * j)) sc[i][j] = kNeg;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, shfl_xor(mx, off));  // the half warp
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pr = expf(sc[i][j] - m_new);
        sp[(ty * 4 + i) * LDP + tx + 16 * j] = pr;
        rs += pr;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) rs += shfl_xor(rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // sp complete
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sp + (ty * 4 + i) * LDP + kk);
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const float* vc = sv + kk * LD + tx + 16 * c;
        const float v0 = vc[0], v1 = vc[LD], v2 = vc[2 * LD], v3 = vc[3 * LD];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q_start + ty * 4 + i;
    if (qr >= a.s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NJ; ++c) p.o[static_cast<size_t>(qr) * HD + tx + 16 * c] = acc[i][c] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------
template <int HD>
struct MmaCfg {
  static constexpr int kThreads = 128;
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // keys per tile
  static constexpr int kLD = HD + 8;  // bf16 row: 16-byte aligned, fragment loads conflict-free
  static constexpr size_t kSmem = sizeof(bf16) * (kBQ + 2 * kBK) * kLD;
};

// rows [row0, row0 + ROWS) of a (s, HD) bf16 matrix into dst (row stride LD)
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src, int row0, int s, int tid) {
  constexpr int kPerRow = HD / 8;
  for (int i = tid; i < ROWS * kPerRow; i += 128) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    const bool ok = row0 + r < s;
    cp_async16(dst + r * LD + c, ok ? src + static_cast<size_t>(row0 + r) * HD + c : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(128) fa_mma_kernel(Args a) {
  using C = MmaCfg<HD>;
  // S n-blocks per tile, k-steps of S, n-blocks of O
  constexpr int BK = C::kBK, LD = C::kLD, NB = BK / 8, KS = HD / 16, OB = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* sk = sq + kBQ * LD;                      // [BK][LD]
  bf16* sv = sk + BK * LD;                       // [BK][LD]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest blocks first
  const Heads<bf16> p(a, blockIdx.x, HD);
  const int r0 = warp * 16 + g;  // block row of accumulator elements 0, 1 (2, 3: r0 + 8)
  const int qp0 = q_start + r0, qp1 = qp0 + 8;

  load_bf16<HD, kBQ, LD>(sq, p.q, q_start, a.s, tid);  // waited for with the first tile
  int lo, hi;
  block_range(a, q_start, BK, lo, hi);
  float oacc[OB][4];
#pragma unroll
  for (int nb = 0; nb < OB; ++nb) oacc[nb][0] = oacc[nb][1] = oacc[nb][2] = oacc[nb][3] = 0.f;
  // running max of rows qp0, qp1; this thread's share of their denominators
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  for (int kb = lo; kb < hi; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_bf16<HD, BK, LD>(sk, p.k, k_start, a.s, tid);
    load_bf16<HD, BK, LD>(sv, p.v, k_start, a.s, tid);
    cp_async_wait_all();
    __syncthreads();

    float sacc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const bf16* qa = sq + r0 * LD + ks * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD), a2 = ld32(qa + 8),
                     a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const bf16* kr = sk + (j * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(sacc[j], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int kp = k_start + j * 8 + 2 * t;
      sacc[j][0] = keep(a, qp0, kp) ? sacc[j][0] * a.scale : kNeg;
      sacc[j][1] = keep(a, qp0, kp + 1) ? sacc[j][1] * a.scale : kNeg;
      sacc[j][2] = keep(a, qp1, kp) ? sacc[j][2] * a.scale : kNeg;
      sacc[j][3] = keep(a, qp1, kp + 1) ? sacc[j][3] * a.scale : kNeg;
      mx0 = fmaxf(mx0, fmaxf(sacc[j][0], sacc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[j][2], sacc[j][3]));
    }
    // the 4 threads of a row group hold the row between them
    mx0 = fmaxf(mx0, shfl_xor(mx0, 1));
    mx0 = fmaxf(mx0, shfl_xor(mx0, 2));
    mx1 = fmaxf(mx1, shfl_xor(mx1, 1));
    mx1 = fmaxf(mx1, shfl_xor(mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[NB][2];  // P in bf16 pairs: [j][0] row qp0, [j][1] row qp1
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float p0 = expf(sacc[j][0] - mn0), p1 = expf(sacc[j][1] - mn0);
      const float p2 = expf(sacc[j][2] - mn1), p3 = expf(sacc[j][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j][0] = pack_bf16(p0, p1);
      pa[j][1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int nb = 0; nb < OB; ++nb) {
      oacc[nb][0] *= al0;
      oacc[nb][1] *= al0;
      oacc[nb][2] *= al1;
      oacc[nb][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pa[2 * kk][0], a1 = pa[2 * kk][1], a2 = pa[2 * kk + 1][0],
                     a3 = pa[2 * kk + 1][1];
      // lanes 0-15 address keys kk*16 + lane at columns nb*8, lanes 16-31 the same
      // keys at nb*8 + 8: b0, b1 of n-blocks nb and nb + 1
      const bf16* vr = sv + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int nb = 0; nb < OB; nb += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vr + nb * 8);
        mma_bf16(oacc[nb], a0, a1, a2, a3, b0, b1);
        mma_bf16(oacc[nb + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
  l0 += shfl_xor(l0, 1);
  l0 += shfl_xor(l0, 2);
  l1 += shfl_xor(l1, 1);
  l1 += shfl_xor(l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nb = 0; nb < OB; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (qp0 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(p.o + static_cast<size_t>(qp0) * HD + col) =
          __floats2bfloat162_rn(oacc[nb][0] / d0, oacc[nb][1] / d0);
    if (qp1 < a.s)
      *reinterpret_cast<__nv_bfloat162*>(p.o + static_cast<size_t>(qp1) * HD + col) =
          __floats2bfloat162_rn(oacc[nb][2] / d1, oacc[nb][3] / d1);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, dim3 grid, const Args& a, cudaStream_t stream) {
  if (dtype == 0)
    return launch(fa_simt_kernel<HD>, grid, SimtCfg<HD>::kThreads, SimtCfg<HD>::kSmem, a, stream);
  return launch(fa_mma_kernel<HD>, grid, MmaCfg<HD>::kThreads, MmaCfg<HD>::kSmem, a, stream);
}

}  // namespace fa

extern "C" {

// q, out: [b][h][s][hd]; k, v: [b][h_kv][s][hd], contiguous and 16-byte
// aligned; dtype 0 f32, 1 bf16; window 0: none. Returns the launch's
// cudaError_t (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int b, int h, int hkv, int s, int hd, int causal, int window,
                           void* stream) {
  using namespace fa;
  if (b < 1 || h < 1 || hkv < 1 || h % hkv || s < 1 || window < 0 || (dtype != 0 && dtype != 1) ||
      (s + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, h, hkv, s, causal, window,
               static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return static_cast<int>(launch_hd<32>(dtype, grid, a, st));
    case 64: return static_cast<int>(launch_hd<64>(dtype, grid, a, st));
    case 80: return static_cast<int>(launch_hd<80>(dtype, grid, a, st));
    case 96: return static_cast<int>(launch_hd<96>(dtype, grid, a, st));
    case 128: return static_cast<int>(launch_hd<128>(dtype, grid, a, st));
    case 256: return static_cast<int>(launch_hd<256>(dtype, grid, a, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
