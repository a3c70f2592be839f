// Flash attention forward: causal, sliding-window or bidirectional attention
// over whole sequences from position 0, grouped-query heads read in place.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py: _fa_kernel (:37,
// pallas_call at :111, flash_attention). One block per (batch x head, query
// block); KV tiles stream through shared memory while the running max,
// denominator and accumulator stay in f32 registers (the online-softmax
// recurrence). KV tiles wholly outside the causal limit or the window are
// never visited (the reference's lo/hi block range), so a sliding-window layer
// costs O(s * window), not O(s^2). Masking is the reference's: rel = q_pos -
// k_pos, causal keeps rel >= 0, a window keeps rel < window, the output is
// acc / max(l, 1e-30). Keys past a ragged s are masked and query rows past it
// never stored. Query head i reads KV head i / (h / h_kv), so broadcast K/V
// are never materialised.
//
// Bound on an H100: at the model shapes, tensor-core operations (4 * hd per
// unmasked (query, key) pair and head over 989 TFLOP/s in bf16); at short s,
// the bytes of q, k, v read once and o written once over 3.35 TB/s.
//
// Two kernels, chosen by the element type:
// * bf16 - fa_wgmma_kernel, warp-specialised, 384 threads: one producer
//   warpgroup, of which one thread issues every TMA load (Q once, then K and
//   V tiles into a ring of two shared-memory stages with full and empty
//   mbarriers, K and V released apart), and two consumer warpgroups of 64
//   query rows each, so a block covers 128 rows (setmaxnreg moves registers
//   from the producer to the consumers). Per KV tile a consumer warpgroup
//   runs S = Q K^T as wgmma.mma_async with both operands in shared memory
//   (K-major), the softmax in f32 registers, and O += P V as a wgmma with P
//   in registers as bf16 (the S accumulator fragment is the A fragment of
//   P V) and V an MN-major operand. S of tile j and P V of tile j - 1 are
//   issued together, so tile j's softmax runs under tile j - 1's product;
//   the two warpgroups' softmaxes and products also overlap each other. The
//   softmax works in base 2: ex2.approx of one FMA, logit * scale * log2(e)
//   - the scaled running max, row maxima and sums in four independent
//   chains; the accumulator is rescaled on every tile (alpha is 1 where the
//   max did not move). Masked logits are -inf (a row's max stays -inf only
//   while all its keys so far are masked; it is then taken as 0, so no
//   inf - inf arises). Tiles are of three classes per 128-row query block
//   (kernels/flash_attention.py:tile_class mirrors it): outside block_range,
//   never loaded; interior (every key < s, wholly before the block's first
//   row when causal, wholly inside the window of its last row), which runs
//   no mask; the rest (the causal diagonal, the window's lower edge, the
//   ragged end of s), masked element by element. Query blocks run longest
//   first. O leaves through shared memory (the warpgroup's own Q rows) and
//   TMA stores. hd 32 keeps 64-byte swizzled rows (32 bf16), every other
//   head dim 128-byte rows (64 bf16) and as many column boxes as hd needs.
// * f32 - fa_simt_kernel: true f32 FMAs (the tensor cores would round to
//   TF32). 256 threads, 64 query rows a block, each thread owning 4 query
//   rows x hd / 16 output columns, tiles held as f32 in shared memory and
//   read as float4, loads not pipelined.
//
// Where the bf16 kernel is delicate:
// 1. Ragged s. Every tensor map is 3-D, {hd, s, b * h} for q and o and
//    {hd, s, b * h_kv} for k and v, so rows past s inside a head read as TMA
//    zero fill, never as the next head's rows; their keys are masked, and
//    the TMA store drops query rows past s.
// 2. Head dims off the 64-column box (80, 96): the last box is partly zero
//    fill; S issues only hd / 16 k-steps, P V runs wgmma with N = hd, and
//    the store drops the fill columns.
// 3. hd 256: the O accumulator alone is 128 f32 registers a consumer thread,
//    so its KV tile is 64 keys (S: 32 registers), and Q (64 KB) and two
//    stages of K and V (64 KB each) fit 227 KB; each tile is loaded as four
//    64-column boxes (a box row is at most 128 bytes under the swizzle).
// 4. Accumulator fences (hopper.cuh fence_acc, fence_frag) around each
//    wgmma stage, so the compiler neither reads S or O nor reuses P's
//    registers while a product is in flight. And ptxas serialises every
//    wgmma of a kernel (each waited for before the next issues: the
//    tensor cores then idle under every softmax) on any of: a wgmma near a
//    branch it cannot prove warp-uniform (C7520: hence warpgroup_index, a
//    PTX-loop mbar_wait and a predicated mbar_arrive_if), a call (C7510),
//    or a register a pending wgmma reads written before it is waited for
//    (C7513: hence P is packed only after P V is done). Build logs show
//    these as ptxas "Potential Performance Loss" notes.
// 5. Host cost: the four tensor maps are encoded on every call (a few us),
//    beside a launch of tens to hundreds of us at prefill.
#include "hopper.cuh"

#include <math.h>

namespace fa {

using namespace hopper;

constexpr float kNeg = -1e30f;  // masked logit of the f32 kernel, as the reference's

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

// KV tiles [lo, hi) of `bk` keys that the query block of `bq` rows at
// q_start visits.
__device__ __forceinline__ void block_range(int s, int causal, int window, int q_start, int bq,
                                            int bk, int& lo, int& hi) {
  lo = window > 0 ? max(q_start - (window - 1), 0) / bk : 0;
  hi = causal ? min(q_start + bq - 1, s - 1) / bk + 1 : (s + bk - 1) / bk;
}

__device__ __forceinline__ bool keep(int s, int causal, int window, int qp, int kp) {
  const int rel = qp - kp;
  return kp < s && (!causal || rel >= 0) && (window <= 0 || rel < window);
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
constexpr int kSimtBQ = 64;  // query rows a block of the f32 kernel

template <int HD>
struct SimtCfg {
  static constexpr int kThreads = 256;
  static constexpr int kBK = HD <= 128 ? 32 : 16;  // keys per tile
  static constexpr int kLD = HD + 4;   // float row: 16-byte aligned, float4 reads conflict-free
  static constexpr int kLDP = kBK + 4;
  static constexpr size_t kSmem = sizeof(float) * (kSimtBQ * kLD + 2 * kBK * kLD + kSimtBQ * kLDP);
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
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kSimtBQ][LD], q * scale
  float* sk = sq + kSimtBQ * LD;                        // [BK][LD]
  float* sv = sk + BK * LD;                         // [BK][LD]
  float* sp = sv + BK * LD;                         // [kSimtBQ][LDP], probabilities
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;  // rows ty*4.., cols tx + 16 j
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kSimtBQ;    // longest blocks first
  const Heads<float> p(a, blockIdx.x, HD);

  load_f32<HD, kSimtBQ, LD, 256>(sq, p.q, q_start, a.s, a.scale, tid);
  int lo, hi;
  block_range(a.s, a.causal, a.window, q_start, kSimtBQ, BK, lo, hi);
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
        if (!keep(a.s, a.causal, a.window, qp, k_start + tx + 16 * j)) sc[i][j] = kNeg;
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
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kBQ = 128;         // query rows a block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kStages = 2;       // K/V stages in flight
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 <= 65536

template <int HD>
struct WgCfg {
  static constexpr int kSw = HD == 32 ? 64 : 128;  // swizzle: bytes of a box row
  static constexpr int kBoxCols = kSw / 2;         // bf16 columns of a box
  static constexpr int kBoxes = (HD + kBoxCols - 1) / kBoxCols;
  static constexpr int kBK = HD > 128 ? 64 : 128;  // keys of a KV tile
  static constexpr int kQBox = kBQ * kSw, kKVBox = kBK * kSw;  // bytes of one box
  static constexpr int kQBytes = kBoxes * kQBox, kKVBytes = kBoxes * kKVBox;
  // 1024 bytes of alignment slack, Q, K and V stages, 1 + 4 * kStages mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * static_cast<size_t>(kKVBytes) + 8 * (1 + 4 * kStages);
  static_assert(HD % 16 == 0 && kBoxCols % 16 == 0, "k-steps of 16 inside a box");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct TmaArgs {
  CUtensorMap q_map;  // q {hd, s, b * h}, boxes {kBoxCols, kBQ}
  CUtensorMap k_map;  // k {hd, s, b * h_kv}, boxes {kBoxCols, kBK}
  CUtensorMap v_map;  // v, as k
  CUtensorMap o_map;  // o {hd, s, b * h}, boxes {kBoxCols, 64}: a warpgroup's rows
  int h, hkv, s, causal, window;
  float scale_log2;   // hd^-0.5 * log2(e)
};

// 2^x by the SFU (ex2.approx, flushing denormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Wait at named barrier `id` until `count` threads have.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) fa_wgmma_kernel(const __grid_constant__ TmaArgs a) {
  using C = WgCfg<HD>;
  constexpr int BK = C::kBK, kSw = C::kSw, kSteps = C::kBoxCols / 16;  // k-steps a box
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA boxes and wgmma descriptors want 1024-byte aligned tiles
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sk = sq + C::kQBytes;             // [kStages][kKVBytes]
  unsigned char* sv = sk + kStages * C::kKVBytes;  // [kStages][kKVBytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;       // [kStages] each
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);  // the producer's expect_tx arrival + the bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest blocks first
  int lo, hi;
  block_range(a.s, a.causal, a.window, q_start, kBQ, BK, lo, hi);
  const int nt = hi - lo;
  const int wg = warpgroup_index();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load of the block ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      const int kvh = (bh / a.h) * a.hkv + (bh % a.h) / (a.h / a.hkv);
      mbar_expect_tx(q_full, C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(sq + x * C::kQBox, &a.q_map, q_full, x * C::kBoxCols, q_start, bh);
      for (int j = 0; j < nt; ++j) {
        const int st = j % kStages, k0 = (lo + j) * BK;
        const unsigned free_ph = ((j / kStages) & 1) ^ 1;  // the stage's last readers are done
        mbar_wait(&k_empty[st], free_ph);
        mbar_expect_tx(&k_full[st], C::kKVBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sk + st * C::kKVBytes + x * C::kKVBox, &a.k_map, &k_full[st],
                   x * C::kBoxCols, k0, kvh);
        mbar_wait(&v_empty[st], free_ph);
        mbar_expect_tx(&v_full[st], C::kKVBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sv + st * C::kKVBytes + x * C::kKVBox, &a.v_map, &v_full[st],
                   x * C::kBoxCols, k0, kvh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) ----
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q_start + wg * 64 + warp * 16 + lane / 4;  // fragment rows row0, row0 + 8
    const int col0 = 2 * (lane % 4);                            // fragment columns col0, col0 + 1
    const float c = a.scale_log2;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // running max (raw logits) and this thread's share of the denominator
    // of rows row0, row0 + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[BK / 2];           // S of the current tile
    uint32_t pa[BK / 16][4];    // P of the current tile, bf16 A fragments
    const uint64_t dq = desc_k_major<kSw>(sq + wg * 64 * kSw);

    // S = Q K_j^T (box x, 16-column step w of q's and k's rows), and O +=
    // P V_j (16 keys a k-step, kSw-byte rows of V): issued and committed,
    // not waited for. Their tiles are waited for, and the descriptors
    // made, before the wgmma fence: ptxas serialises wgmmas between which
    // other instructions define a wgmma's inputs (C7513).
    auto wait_k = [&](int j) { mbar_wait(&k_full[j % kStages], (j / kStages) & 1); };
    auto wait_v = [&](int j) { mbar_wait(&v_full[j % kStages], (j / kStages) & 1); };
    auto desc_k = [&](int j) { return desc_k_major<kSw>(sk + (j % kStages) * C::kKVBytes); };
    auto desc_v = [&](int j) {
      return desc_mn_major<kSw>(sv + (j % kStages) * C::kKVBytes, C::kKVBox);
    };
    auto scores = [&](uint64_t dk) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int x = kk / kSteps, w = kk % kSteps;
        Wgmma<BK>::template ss<0>(sc, dq + ((x * C::kQBox + w * 32) >> 4),
                                  dk + ((x * C::kKVBox + w * 32) >> 4), kk > 0);
      }
      wgmma_commit();
    };
    auto product = [&](uint64_t dv, uint32_t(&p)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::template rs<1>(o, p[kk], dv + ((kk * 16 * kSw) >> 4), 1);
      wgmma_commit();
    };
    // the online softmax of tile j's scores (in sc): mask (tiles that are
    // not interior only), running max, P = exp2(S c - max c) in f32 back
    // into sc and into the row sums, alpha for the accumulator
    auto softmax = [&](int j) {
      const int k0 = (lo + j) * BK;
      const bool interior = k0 + BK <= a.s && (!a.causal || k0 + BK - 1 <= q_start) &&
                            (a.window <= 0 || q_start + kBQ - 1 - k0 < a.window);
      if (!interior) {
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8) {
          const int kp = k0 + 8 * n8 + col0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!keep(a.s, a.causal, a.window, row0 + (e & 2) * 4, kp + (e & 1)))
              sc[4 * n8 + e] = -INFINITY;
        }
      }
      // row maxima and sums in 4 independent chains each (a single chain
      // of BK / 4 dependent operations would leave the warp waiting on
      // latency)
      float mp[2][4], ms[2], mx[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) mp[0][i] = mp[1][i] = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
        mp[0][n8 % 4] = fmaxf(mp[0][n8 % 4], fmaxf(sc[4 * n8], sc[4 * n8 + 1]));
        mp[1][n8 % 4] = fmaxf(mp[1][n8 % 4], fmaxf(sc[4 * n8 + 2], sc[4 * n8 + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])), m[r]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 threads of a row group hold the row between them
        mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 1));
        mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 2));
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * c;
        alpha[r] = ex2(fmaf(m[r], c, -ms[r]));  // 0 while m is -inf
        m[r] = mx[r];
      }
      float rs[2][4] = {};
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
        const float p0 = ex2(fmaf(sc[4 * n8], c, -ms[0]));
        const float p1 = ex2(fmaf(sc[4 * n8 + 1], c, -ms[0]));
        const float p2 = ex2(fmaf(sc[4 * n8 + 2], c, -ms[1]));
        const float p3 = ex2(fmaf(sc[4 * n8 + 3], c, -ms[1]));
        rs[0][n8 % 4] += p0 + p1;
        rs[1][n8 % 4] += p2 + p3;
        sc[4 * n8] = p0;
        sc[4 * n8 + 1] = p1;
        sc[4 * n8 + 2] = p2;
        sc[4 * n8 + 3] = p3;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
    };
    // P in bf16 A fragments: rows row0 (registers 0, 2) and row0 + 8 (1, 3)
    auto pack = [&]() {
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
        pa[n8 / 2][(n8 % 2) * 2] = pack_bf16(sc[4 * n8], sc[4 * n8 + 1]);
        pa[n8 / 2][(n8 % 2) * 2 + 1] = pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);
      }
    };
    // O *= alpha (no product in flight)
    auto rescale = [&]() {
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        o[4 * n8] *= alpha[0];
        o[4 * n8 + 1] *= alpha[0];
        o[4 * n8 + 2] *= alpha[1];
        o[4 * n8 + 3] *= alpha[1];
      }
    };

    // Tile j's softmax runs while tile j - 1's P V is on the tensor cores:
    // S_j and P_{j-1} V_{j-1} are issued together, S_j is waited for (wgmma
    // groups complete in order), the softmax writes only sc, then P V is
    // waited for and P_j packed into pa. Waits and descriptors come before
    // each wgmma fence, and the registers a pending product reads are not
    // written (a P packed while P V ran, or copied between two P buffers,
    // made ptxas serialise every wgmma of the kernel: C7513). A stage's K
    // is released once its S is done, its V once its P V is.
    auto stage_in = [&]() {  // the rescale and P are done before the products
      fence_acc(o);
      fence_frag(pa);
      wgmma_fence();
    };
    auto stage_out = [&]() {
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pa);
    };
    mbar_wait(q_full, 0);
    wait_k(0);
    const uint64_t dk0 = desc_k(0);
    wgmma_fence();
    scores(dk0);
    wgmma_wait<0>();
    fence_acc(sc);
    mbar_arrive_if(&k_empty[0], lane == 0);
    softmax(0);
    pack();
    for (int j = 1; j < nt; ++j) {
      rescale();
      wait_k(j);
      wait_v(j - 1);
      const uint64_t dk = desc_k(j), dv = desc_v(j - 1);
      stage_in();
      scores(dk);
      product(dv, pa);
      wgmma_wait<1>();
      fence_acc(sc);
      mbar_arrive_if(&k_empty[j % kStages], lane == 0);
      softmax(j);
      stage_out();
      mbar_arrive_if(&v_empty[(j - 1) % kStages], lane == 0);
      pack();
    }
    rescale();
    wait_v(nt - 1);
    const uint64_t dv = desc_v(nt - 1);
    stage_in();
    product(dv, pa);
    stage_out();
    mbar_arrive_if(&v_empty[(nt - 1) % kStages], lane == 0);

    // ---- epilogue: O / max(l, 1e-30) in bf16 into this warpgroup's Q rows
    // (its last S product is done), laid out as the o map's swizzled boxes,
    // then TMA stores; the map drops rows past s and columns past hd ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += shfl_xor(l[r], 1);
      l[r] += shfl_xor(l[r], 2);
    }
    const float d0 = 1.f / fmaxf(l[0], 1e-30f), d1 = 1.f / fmaxf(l[1], 1e-30f);
    unsigned char* stage = sq + wg * 64 * kSw;  // box x at stage + x * kQBox
    const int r0 = warp * 16 + lane / 4;        // the fragment rows in the box: r0, r0 + 8
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      const int col = 8 * n8 + col0, x = col / C::kBoxCols;
      const int byte = (col % C::kBoxCols) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        // the TMA swizzle: 16-byte chunk c of row r lies at c ^ (r % 8)
        // (128-byte rows) or c ^ (r / 2 % 4) (64-byte rows)
        const int swz = kSw == 128 ? (r & 7) : ((r >> 1) & 3);
        *reinterpret_cast<uint32_t*>(stage + x * C::kQBox + r * kSw +
                                     ((((byte >> 4) ^ swz)) << 4) + (byte & 15)) =
            h ? pack_bf16(o[4 * n8 + 2] * d1, o[4 * n8 + 3] * d1)
              : pack_bf16(o[4 * n8] * d0, o[4 * n8 + 1] * d0);
      }
    }
    fence_proxy_async_shared();
    named_sync(1 + wg, 128);  // the warpgroup's rows are written
    if (t == 0) {
      for (int x = 0; x < C::kBoxes; ++x)
        tma_store(&a.o_map, stage + x * C::kQBox, x * C::kBoxCols, q_start + wg * 64, bh);
      bulk_commit();
      bulk_wait<0, true>();  // shared memory is read before the block exits
    }
  }
}

template <typename K, typename A>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const A& a,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Args& a, int bh, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid(bh, (a.s + kSimtBQ - 1) / kSimtBQ);
    return launch(fa_simt_kernel<HD>, grid, SimtCfg<HD>::kThreads, SimtCfg<HD>::kSmem, a, stream);
  }
  using C = WgCfg<HD>;
  TmaArgs t{};
  const int bkv = bh / a.h * a.hkv;
  const uint64_t s = a.s;
  if (!make_map(&t.q_map, a.q, HD, s, bh, C::kBoxCols, kBQ, C::kSw) ||
      !make_map(&t.k_map, a.k, HD, s, bkv, C::kBoxCols, C::kBK, C::kSw) ||
      !make_map(&t.v_map, a.v, HD, s, bkv, C::kBoxCols, C::kBK, C::kSw) ||
      !make_map(&t.o_map, a.o, HD, s, bh, C::kBoxCols, 64, C::kSw))
    return cudaErrorInvalidValue;
  t.h = a.h, t.hkv = a.hkv, t.s = a.s, t.causal = a.causal, t.window = a.window;
  t.scale_log2 = static_cast<float>(a.scale * 1.4426950408889634);
  const dim3 grid(bh, (a.s + kBQ - 1) / kBQ);
  return launch(fa_wgmma_kernel<HD>, grid, kWgThreads, C::kSmem, t, stream);
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
      (s + kSimtBQ - 1) / kSimtBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, h, hkv, s, causal, window,
               static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return static_cast<int>(launch_hd<32>(dtype, a, b * h, st));
    case 64: return static_cast<int>(launch_hd<64>(dtype, a, b * h, st));
    case 80: return static_cast<int>(launch_hd<80>(dtype, a, b * h, st));
    case 96: return static_cast<int>(launch_hd<96>(dtype, a, b * h, st));
    case 128: return static_cast<int>(launch_hd<128>(dtype, a, b * h, st));
    case 256: return static_cast<int>(launch_hd<256>(dtype, a, b * h, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
