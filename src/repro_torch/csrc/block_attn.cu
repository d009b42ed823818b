// Block-sparse local flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/block_attn.py::block_attention_pallas.  q, k and
// v are (B, S, H, hd); kv_map (nq, max_nb) int32 lists, for each q-block
// of bq rows, the kv-blocks of bk keys it may touch (-1 pads).  Within a
// listed block, key kpos is visible to query qpos when qpos >= kpos
// (causal) and qpos - kpos < window (window > 0).  Scores are
// (q · k) / scale with scale = sqrt(hd), and the softmax runs online in
// f32 (m, l, acc) with the reference's guards: m_safe = 0 while a row's
// max is -inf, corr = 0 while its previous max was -inf, and the output is
// acc / max(l, 1e-20), written once in q's dtype.
//
// The TPU kernel takes one example and folds all H heads into one
// (bq, H, hd) block, walking grid (nq, max_nb) and fetching block 0 for
// pad entries.  At H = 16 and hd = 256 in f32 that block alone is 2 MB,
// where one SM has 227 KB of shared memory.
//
// The design.  One CTA owns 128 query rows of one (example, head): a
// whole q-block of up to 128 rows (a longer one is cut into 128-row
// slices), so each K/V chunk is streamed once per q-block.  It holds two
// consumer warpgroups (64 rows each) and a producer warpgroup, one warp
// of which loads.
//   - The producer's warpgroup hands its registers to the consumers
//     (setmaxnreg: 40 against 232 a thread), so that the accumulators
//     (64 × 256 f32 a warpgroup, 128 a thread) stay in registers.
//   - Q, K and V are read as (B·S, H, hd) through 3D TMA boxes of one
//     128-byte column block (32 f32 or 64 bf16 values) × rows, with the
//     128-byte swizzle; columns past hd and rows past B·S come in as
//     zeros.  Q lands once; K and V chunks of KT keys (32 f32, 64 bf16)
//     pass through a ring of 2 to 6 stages (K, V, K, V, ...) that the
//     producer keeps full, each stage completed on an mbarrier, so the
//     next chunk's loads run under the current chunk's products.  Where
//     TMA cannot take the rows (bf16 with hd % 8 != 0, or a misaligned
//     base) the producer writes the same swizzled layout with its own
//     loads: one read path for the consumers.
//   - The CTA walks the live entries of its kv_map row in order, KT keys
//     at a time, and skips chunks that none of its rows may see (above
//     the causal diagonal, behind the window); a warpgroup whose 64 rows
//     see none of a chunk only waits for it and releases it.
//   - f32 (FFMA, no TF32): S = Q·Kᵀ on hopper.cuh's k-major tile
//     (FfmaTileK 4 × 4: both operands along hd, conflict free on the
//     swizzled blocks; 8 shared loads for every 64 FFMA, so S is bound
//     by shared memory's wavefronts); the row max and sum stay in
//     registers (the 8 threads of a row group reduce by shuffles), the
//     exponentials are one FFMA and ex2.approx as in bf16, P goes to
//     shared memory (double-buffered, so one warpgroup barrier a chunk),
//     and P·V runs on an 8 × 16 register tile (P rows broadcast along the
//     keys, V rows along hd): 24 shared loads for every 512 FFMA.  Larger
//     S tiles did not pay (PERF.md): beside P·V's 128 accumulators they
//     spill, or leave one warp a scheduler to hide the loads.
//   - bf16: both products on wgmma with f32 accumulators: S(64 × 64) =
//     Q·Kᵀ with Q and K K-major, then P from registers (the S
//     accumulator's fragment is the A fragment of the next product,
//     rounded once to bf16) times V MN-major (the transpose bit), 4 atoms
//     of 64 columns at hd = 256.  The softmax runs in the log2 domain:
//     one FFMA (the score times log2(e) / scale, less the row max) and
//     ex2.approx an element.  The row sums take the f32 P before
//     rounding.
//   - Every sum has a fixed order (k16 steps, chunks in kv_map order, a
//     fixed shuffle tree), no atomics: two runs give the same bits.  One
//     launch covers the batch.
//
// What bounds it on the H100: operations (4·hd FLOPs a visible pair; at
// recurrentgemma-9b's shape 481 GFLOP: 7.2 ms at the FP32 rate, 0.49 ms at
// the bf16 tensor-core rate).  f32 runs at the FFMA tile's rate; bf16 is
// held back by the softmax between the two products (exp2 of every score
// on the SFU), which the second warpgroup's products overlap.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;                     // query rows of a CTA
constexpr int kWgs = 2;                        // consumer warpgroups
constexpr int kAttnThreads = (kWgs + 1) * 128; // and the producer's
// registers a thread after setmaxnreg: the producer warpgroup gives its
// own back, so that two consumer warps of 232 and the producer's of 40
// fit the 16 384 of each SM sub-partition
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 6;
constexpr int kSmemOne = 232448;               // a CTA's shared memory
constexpr int kBlock = 128;                    // bytes of a column block row

// keys a chunk (KT) and values a 128-byte column block (E)
template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int E = 32, KT = 32; };
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int E = 64, KT = 64;
};

struct Geo {
  int B, S, H, hd, max_nb, bq, bk, causal, window;
  float scale;
  int nb;                 // column blocks over hd (the kernel's NB)
  int kt;                 // keys a chunk
  int n_sub;              // CTAs a q-block
  int stages, tile_bytes;
  int q_off, ring_off, p_off, c_off, bar_off, smem;
  int tma;                // TMA boxes, else the producer's loads
};

// ---- the chunk walk, the same in the producer and the consumers

__device__ __forceinline__ bool visible(const Geo& g, int lo, int hi,
                                        int k_lo, int k_n) {
  if (g.causal && k_lo > hi) return false;
  if (g.window > 0 && lo - (k_lo + k_n - 1) >= g.window) return false;
  return true;
}

struct Cursor {
  int e = 0, c0 = 0;
};

// The next chunk of the kv_map row that query rows lo .. hi may see:
// keys k_lo .. k_lo + k_n - 1 of one kv-block.  False when none is left.
__device__ __forceinline__ bool next_chunk(const Geo& g,
                                           const int* __restrict__ row,
                                           int lo, int hi, Cursor& cur,
                                           int& k_lo, int& k_n) {
  while (cur.e < g.max_nb) {
    const int id = row[cur.e];
    if (id >= 0 && cur.c0 < g.bk) {
      k_lo = id * g.bk + cur.c0;
      k_n = min(g.kt, g.bk - cur.c0);
      cur.c0 += g.kt;
      if (visible(g, lo, hi, k_lo, k_n)) return true;
      continue;
    }
    ++cur.e;
    cur.c0 = 0;
  }
  return false;
}

// Whether every row lo .. hi sees every key of a full chunk: then no
// element needs its mask.
__device__ __forceinline__ bool inside(const Geo& g, int lo, int hi,
                                       int k_lo, int k_n) {
  return k_n == g.kt && (!g.causal || k_lo + k_n - 1 <= lo) &&
         (g.window <= 0 || hi - k_lo < g.window);
}

__device__ __forceinline__ bool key_ok(const Geo& g, int qpos, int kpos,
                                       int key, int k_n) {
  return key < k_n && (!g.causal || qpos >= kpos) &&
         (g.window <= 0 || qpos - kpos < g.window);
}

// ---- loads: `rows` rows from row0 of x viewed as (B·S, H, hd), head h,
// into NB swizzled column blocks of rows × 128 bytes

template <typename T, int NB>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const T* __restrict__ x,
                                          int64_t row0, int rows, int h,
                                          const Geo& g, int lane) {
  constexpr int per = 16 / sizeof(T), E = Cfg<T>::E;
  const int64_t total = (int64_t)g.B * g.S;
  const int units = rows * NB * 8;
  for (int idx = lane; idx < units; idx += 32) {
    const int u = idx & 7, r = (idx >> 3) % rows, b = (idx >> 3) / rows;
    const int64_t row = row0 + r;
    __align__(16) T v[per];
#pragma unroll
    for (int e = 0; e < per; ++e) {
      const int n = b * E + u * per + e;
      v[e] = row < total && n < g.hd ? x[(row * g.H + h) * g.hd + n]
                                     : from_f32<T>(0.0f);
    }
    *reinterpret_cast<uint4*>(dst + (b * rows + r) * kBlock +
                              ((u ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <typename T, int NB>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          const T* __restrict__ x,
                                          int64_t row0, int rows, int h,
                                          const Geo& g, uint64_t* bar,
                                          int lane) {
  if (g.tma) {
    if (lane == 0) {
      mbar_expect_tx(bar, NB * rows * kBlock);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tma_3d(dst + b * rows * kBlock, map, b * Cfg<T>::E, h, (int)row0,
               bar);
    }
  } else {
    copy_tile<T, NB>(dst, x, row0, rows, h, g, lane);
    fence_async_smem();                  // read next by wgmma (bf16)
  }
  mbar_arrive(bar);                      // every producer lane
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(wg + 1) : "memory");
}

// 2^x on the SFU (ex2.approx.ftz: within 2 ulp, results under 2^-126 as
// 0); the softmax's exponentials in both dtypes
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- f32: FFMA tiles

template <int NB>
struct F32Consumer {
  static constexpr int KT = Cfg<float>::KT;
  using STile = FfmaTileK<float, 4, 4, 64, KT, kBlock>;
  // P·V: 64 rows × NB·32 columns over 128 threads, CW float4 units a
  // thread (TXN threads across a row), TM rows a thread
  static constexpr int UNITS = NB * 8;
  static constexpr int TXN = UNITS < 16 ? UNITS : 16;
  static constexpr int CW = UNITS / TXN;
  static constexpr int TYN = 128 / TXN;
  static constexpr int TM = 64 / TYN;

  __device__ static void run(unsigned char* smem, const Geo& g,
                             const int* __restrict__ row, int q_lo,
                             int q_rows, int wg, int t,
                             float* __restrict__ out, int64_t out0,
                             uint64_t* qfull, uint64_t* full,
                             uint64_t* empty) {
    const int lane = t & 31;
    const int sx = t % 8, sy = t / 8;      // S: rows sy + 16i, keys sx + 8j
    const int px = t % TXN, py = t / TXN;         // P·V: rows py + TYN·i
    const int w_lo = q_lo + wg * 64;
    const int w_rows = min(64, q_rows - wg * 64);
    const unsigned char* qs = smem + g.q_off + wg * 64 * kBlock;
    const float sl2 = 1.4426950408889634f / g.scale;
    float* pbase = reinterpret_cast<float*>(smem + g.p_off) + wg * 64 * KT;
    float* cbase = reinterpret_cast<float*>(smem + g.c_off) + wg * 64;

    float acc[TM][CW][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.0f;
    }

    mbar_wait(qfull, 0);
    Cursor cur;
    int k_lo, k_n, it = 0, buf = 0;
    while (next_chunk(g, row, q_lo, q_lo + q_rows - 1, cur, k_lo, k_n)) {
      const bool see = visible(g, w_lo, w_lo + w_rows - 1, k_lo, k_n);
      // ---- S = Q·Kᵀ
      const int stk = it % g.stages;
      mbar_wait(&full[stk], (it / g.stages) & 1);
      float s[16];
      if (see) {
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0.0f;
        const unsigned char* ks = smem + g.ring_off + stk * g.tile_bytes;
#pragma unroll 1
        for (int b = 0; b < NB; ++b) {
          const int quads = min(8, (g.hd - b * 32) / 4);
          if (quads > 0)
            STile::step(s, qs + b * kRows * kBlock, ks + b * KT * kBlock, 64,
                        KT, kBlock, true, quads, t);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stk]);
      ++it;

      // ---- the online softmax; P and corr to shared memory
      float* pb = pbase + buf * 2 * 64 * KT;
      float* cb = cbase + buf * 2 * 64;
      if (see) {
        const bool all = inside(g, w_lo, w_lo + w_rows - 1, k_lo, k_n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = sy + 16 * i, qpos = w_lo + r;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = sx + 8 * j;
            float& sv = s[i * 4 + j];
            if (!all && !key_ok(g, qpos, k_lo + key, key, k_n))
              sv = -INFINITY;
            mx = fmaxf(mx, sv);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          // the log2 domain, scaled once: p = 2^(s·log2(e)/scale - m)
          const float m_new = fmaxf(m[i], mx * sl2);
          const float m_safe = isfinite(m_new) ? m_new : 0.0f;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ex2(fmaf(s[i * 4 + j], sl2, -m_safe));
            pb[r * KT + sx + 8 * j] = p;
            sum += p;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          const float corr = isfinite(m[i]) ? ex2(m[i] - m_safe) : 0.0f;
          m[i] = m_new;
          l[i] = l[i] * corr + sum;
          if (sx == 0) cb[r] = corr;
        }
        wg_sync(wg);                              // P and corr written
      }

      // ---- acc = acc · corr + P·V
      const int stv = it % g.stages;
      mbar_wait(&full[stv], (it / g.stages) & 1);
      if (see) {
        const unsigned char* vs = smem + g.ring_off + stv * g.tile_bytes;
        float corr[TM];
        bool moved = false;                       // a row's max moved
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          corr[i] = cb[py + TYN * i];
          moved |= corr[i] != 1.0f;
        }
        if (moved)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < CW; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
#pragma unroll 2
        for (int kq = 0; kq < KT; kq += 4) {
          float4 pa[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            pa[i] = *reinterpret_cast<const float4*>(
                pb + (py + TYN * i) * KT + kq);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // row k of V: this thread's units px + TXN·c share px & 7
            // (TXN is 8 or 16), so one swizzled offset serves all CW
            const int k = kq + kk;
            const unsigned char* vrow = vs + (px >> 3) * KT * kBlock +
                                        k * kBlock +
                                        (((px & 7) ^ (k & 7)) << 4);
            float4 vb[CW];
#pragma unroll
            for (int c = 0; c < CW; ++c)
              vb[c] = *reinterpret_cast<const float4*>(
                  vrow + c * (TXN / 8) * KT * kBlock);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float p = kk == 0 ? pa[i].x : kk == 1 ? pa[i].y
                              : kk == 2 ? pa[i].z : pa[i].w;
#pragma unroll
              for (int c = 0; c < CW; ++c) {
                acc[i][c][0] = fmaf(p, vb[c].x, acc[i][c][0]);
                acc[i][c][1] = fmaf(p, vb[c].y, acc[i][c][1]);
                acc[i][c][2] = fmaf(p, vb[c].z, acc[i][c][2]);
                acc[i][c][3] = fmaf(p, vb[c].w, acc[i][c][3]);
              }
            }
          }
        }
        buf ^= 1;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stv]);
      ++it;
    }

    // ---- out = acc / max(l, 1e-20), the row sums through shared memory
    float* lrow = reinterpret_cast<float*>(smem + g.c_off) + 4 * 64 + wg * 64;
    if (sx == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) lrow[sy + 16 * i] = l[i];
    wg_sync(wg);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = py + TYN * i;
      if (r >= w_rows) continue;
      const float lv = fmaxf(lrow[r], 1e-20f);
      float* orow = out + out0 + (int64_t)(wg * 64 + r) * g.H * g.hd;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int col = 4 * (px + TXN * c);
        if (col < g.hd)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[i][c][0] / lv, acc[i][c][1] / lv,
                          acc[i][c][2] / lv, acc[i][c][3] / lv);
      }
    }
  }
};

// ---- bf16: wgmma

// D(64 × 64) += A(64 × 16, bf16 registers) · B(16 × 64) from shared memory
template <int TB, int base, int R>
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[R], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  static_assert(base + 32 <= R, "accumulator too small");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D8(base), WG_D8(base + 8), WG_D8(base + 16), WG_D8(base + 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O's atoms b .. NB - 1 += P(k16 step j) · V(keys 16j .., columns 64b ..)
template <int NB, int b = 0>
__device__ __forceinline__ void pv_atoms(float (&o)[NB * 32],
                                         const uint32_t (&pa)[16], int j,
                                         uint32_t vs) {
  if constexpr (b < NB) {
    wgmma_n64_rs<1, 32 * b>(o, pa[4 * j], pa[4 * j + 1], pa[4 * j + 2],
                            pa[4 * j + 3],
                            gmma_desc(vs + b * Cfg<__nv_bfloat16>::KT *
                                               kBlock + 2048 * j, 1024));
    pv_atoms<NB, b + 1>(o, pa, j, vs);
  }
}

template <int NB>
struct Bf16Consumer {
  static constexpr int KT = Cfg<__nv_bfloat16>::KT;

  __device__ static void run(unsigned char* smem, const Geo& g,
                             const int* __restrict__ row, int q_lo,
                             int q_rows, int wg, int t,
                             __nv_bfloat16* __restrict__ out, int64_t out0,
                             uint64_t* qfull, uint64_t* full,
                             uint64_t* empty) {
    const int lane = t & 31;
    const int w_lo = q_lo + wg * 64;
    const int w_rows = min(64, q_rows - wg * 64);
    const float sl2 = 1.4426950408889634f / g.scale;
    const uint32_t qs = smem_u32(smem + g.q_off) + wg * 64 * kBlock;

    float o[NB * 32];
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    mbar_wait(qfull, 0);
    Cursor cur;
    int k_lo, k_n, it = 0;
    while (next_chunk(g, row, q_lo, q_lo + q_rows - 1, cur, k_lo, k_n)) {
      const bool see = visible(g, w_lo, w_lo + w_rows - 1, k_lo, k_n);
      // ---- S = Q·Kᵀ, both K-major
      const int stk = it % g.stages;
      mbar_wait(&full[stk], (it / g.stages) & 1);
      float s[32];
      if (see) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        const uint32_t ks = smem_u32(smem + g.ring_off + stk * g.tile_bytes);
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int steps = (g.hd - b * 64 + 15) / 16;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < steps)
              wgmma_n64<0, 0, 0>(
                  s, gmma_desc(qs + b * kRows * kBlock + 32 * kk, 16),
                  gmma_desc(ks + b * KT * kBlock + 32 * kk, 16));
        }
        wgmma_commit_wait();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stk]);
      ++it;

      // ---- the online softmax in registers, P packed for the next product
      uint32_t pa[16];
      if (see) {
        float mx[2] = {-INFINITY, -INFINITY};
        if (!inside(g, w_lo, w_lo + w_rows - 1, k_lo, k_n)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            int r, c;
            wgmma_at(i, t, r, c);
            if (!key_ok(g, w_lo + r, k_lo + c, c, k_n)) s[i] = -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i]);
        // the row max and the exponents in the log2 domain, scaled once
        float m_safe[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h] * sl2);
          m_safe[h] = isfinite(m_new) ? m_new : 0.0f;
          corr[h] = isfinite(m[h]) ? ex2(m[h] - m_safe[h]) : 0.0f;
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i & 3) >> 1;
          s[i] = ex2(fmaf(s[i], sl2, -m_safe[h]));    // masked: ex2(-inf) = 0
          sum[h] += s[i];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l[h] = l[h] * corr[h] + sum[h];
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        if (corr[0] != 1.0f || corr[1] != 1.0f)  // a row's max moved
#pragma unroll
          for (int i = 0; i < NB * 32; ++i) o[i] *= corr[(i & 3) >> 1];
      }

      // ---- O += P·V, V MN-major
      const int stv = it % g.stages;
      mbar_wait(&full[stv], (it / g.stages) & 1);
      if (see) {
        const uint32_t vs = smem_u32(smem + g.ring_off + stv * g.tile_bytes);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) pv_atoms<NB>(o, pa, j, vs);
        wgmma_commit_wait();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stv]);
      ++it;
    }

    // ---- out = o / max(l, 1e-20), two columns a store
#pragma unroll
    for (int i = 0; i < NB * 32; i += 2) {
      int r, c;
      wgmma_at(i % 32, t, r, c);
      c += 64 * (i / 32);
      if (r >= w_rows || c >= g.hd) continue;
      const float lv = fmaxf(l[(i & 3) >> 1], 1e-20f);
      *reinterpret_cast<__nv_bfloat162*>(
          out + out0 + (int64_t)(wg * 64 + r) * g.H * g.hd + c) =
          __floats2bfloat162_rn(o[i] / lv, o[i + 1] / lv);
    }
  }
};

// grid: (nq · n_sub, H, B).  Threads 0 .. 255 consume (warpgroup w: rows
// 64w .. 64w + 63 of the CTA's slice); of the warpgroup 256 .. 383, the
// first warp produces and the others leave.
template <typename T, int NB>
__global__ void __launch_bounds__(kAttnThreads, 1)
block_attn_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_map,
                  T* __restrict__ out, const Geo g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + kMaxStages;
  const int t = threadIdx.x, lane = t & 31;
  const int qi = blockIdx.x / g.n_sub, sub = blockIdx.x % g.n_sub;
  const int h = blockIdx.y;
  const int q_lo = qi * g.bq + sub * kRows;
  const int q_rows = min(kRows, g.bq - sub * kRows);
  const int wgs = (q_rows + 63) / 64;
  const int* row = kv_map + (int64_t)qi * g.max_nb;
  const int64_t row0 = (int64_t)blockIdx.z * g.S;   // the example's row 0

  if (t == 0) {
    mbar_init(qfull, 32);                    // every producer lane arrives
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * wgs);         // every live consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= kWgs * 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (t >= kWgs * 128 + 32) return;
    // ---- producer warp: Q once, then K and V of every chunk in turn
    load_tile<T, NB>(smem + g.q_off, &q_map, q, row0 + q_lo, kRows, h, g,
                     qfull, lane);
    Cursor cur;
    int k_lo, k_n, it = 0;
    while (next_chunk(g, row, q_lo, q_lo + q_rows - 1, cur, k_lo, k_n)) {
      for (int kv = 0; kv < 2; ++kv, ++it) {
        const int st = it % g.stages;
        mbar_wait(&empty[st], ((it / g.stages) & 1) ^ 1);
        load_tile<T, NB>(smem + g.ring_off + st * g.tile_bytes,
                         kv ? &v_map : &k_map, kv ? v : k, row0 + k_lo, g.kt,
                         h, g, &full[st], lane);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = t / 128;
  if (wg >= wgs) return;                     // a slice of 64 rows or fewer
  const int64_t out0 = ((row0 + q_lo) * g.H + h) * g.hd;
  if constexpr (sizeof(T) == 4)
    F32Consumer<NB>::run(smem, g, row, q_lo, q_rows, wg, t % 128, out, out0,
                         qfull, full, empty);
  else
    Bf16Consumer<NB>::run(smem, g, row, q_lo, q_rows, wg, t % 128, out,
                          out0, qfull, full, empty);
}

// ---- host side

// The shared-memory layout of one CTA (1024-aligned regions, 1 KB of
// slack for the alignment), and the CTAs a q-block.
cudaError_t layout(int dtype, int hd, int bq, Geo* geo) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (hd <= 0 || hd % 4 || hd > 256 || bq <= 0) return cudaErrorInvalidValue;
  Geo& g = *geo;
  const int e = dtype ? Cfg<__nv_bfloat16>::E : Cfg<float>::E;
  g.kt = dtype ? Cfg<__nv_bfloat16>::KT : Cfg<float>::KT;
  const int blocks = (hd + e - 1) / e;
  g.nb = blocks <= 1 ? 1 : blocks <= 2 ? 2 : blocks <= 4 ? 4 : 8;
  g.n_sub = (bq + kRows - 1) / kRows;
  g.tile_bytes = g.nb * g.kt * kBlock;
  g.q_off = 0;
  const int q_bytes = g.nb * kRows * kBlock;
  // f32: P (2 buffers × 2 warpgroups × 64 × KT) and corr (2 × 2 × 64),
  // then the row sums (2 × 64)
  const int p_bytes = dtype ? 0 : 2 * kWgs * 64 * g.kt * 4;
  const int c_bytes = dtype ? 0 : (2 * kWgs + kWgs) * 64 * 4;
  const int bar_bytes = 8 * (1 + 2 * kMaxStages);
  const int fixed = 1024 + q_bytes + p_bytes + c_bytes + bar_bytes;
  g.stages = (kSmemOne - fixed) / g.tile_bytes;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  if (g.stages < 2) return cudaErrorInvalidValue;
  g.ring_off = q_bytes;
  g.p_off = g.ring_off + g.stages * g.tile_bytes;
  g.c_off = g.p_off + p_bytes;
  g.bar_off = g.c_off + c_bytes;
  g.smem = 1024 + g.bar_off + bar_bytes;
  return cudaSuccess;
}

template <typename T, int NB>
cudaError_t launch_nb(const void* q, const void* k, const void* v,
                      const int* kv_map, void* out, int nq, Geo g,
                      cudaStream_t st) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (g.tma) {
    const uint64_t dims[3] = {(uint64_t)g.hd, (uint64_t)g.H,
                              (uint64_t)g.B * g.S};
    const uint64_t strides[2] = {(uint64_t)g.hd * sizeof(T),
                                 (uint64_t)g.H * g.hd * sizeof(T)};
    const uint32_t qbox[3] = {(uint32_t)Cfg<T>::E, 1, (uint32_t)kRows};
    const uint32_t kbox[3] = {(uint32_t)Cfg<T>::E, 1, (uint32_t)g.kt};
    const int dt = sizeof(T) == 2;
    if (!encode_map(&maps[0], dt, q, 3, dims, strides, qbox, true) ||
        !encode_map(&maps[1], dt, k, 3, dims, strides, kbox, true) ||
        !encode_map(&maps[2], dt, v, 3, dims, strides, kbox, true))
      g.tma = 0;                         // the producer's own loads
  }
  const cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nq * g.n_sub, g.H, g.B);
  block_attn_kernel<T, NB><<<grid, kAttnThreads, g.smem, st>>>(
      maps[0], maps[1], maps[2], (const T*)q, (const T*)k, (const T*)v,
      kv_map, (T*)out, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_map, void* out, int nq, const Geo& g,
                   cudaStream_t st) {
  switch (g.nb) {
    case 1: return launch_nb<T, 1>(q, k, v, kv_map, out, nq, g, st);
    case 2: return launch_nb<T, 2>(q, k, v, kv_map, out, nq, g, st);
    case 4: return launch_nb<T, 4>(q, k, v, kv_map, out, nq, g, st);
    case 8:
      if constexpr (sizeof(T) == 4)
        return launch_nb<T, 8>(q, k, v, kv_map, out, nq, g, st);
      break;
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike), all
// contiguous (B, S, H, hd); kv_map is (nq, max_nb) int32 with ids in
// [-1, S / bk).  hd is a positive multiple of 4 up to 256; S is a multiple
// of bq and of bk; scale divides the scores.
int maple_block_attention(const void* q, const void* k, const void* v,
                          const int* kv_map, void* out, int dtype, int B,
                          int S, int H, int hd, int nq, int max_nb, int bq,
                          int bk, int causal, int window, float scale,
                          void* stream) {
  if (hd <= 0 || hd % 4 || hd > 256 || bq <= 0 || bk <= 0 || S % bq ||
      S % bk || nq != S / bq)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  Geo g{};
  const cudaError_t err = layout(dtype, hd, bq, &g);
  if (err != cudaSuccess) return (int)err;
  g.B = B; g.S = S; g.H = H; g.hd = hd; g.max_nb = max_nb; g.bq = bq;
  g.bk = bk; g.causal = causal; g.window = window; g.scale = scale;
  const int isz = dtype ? 2 : 4;
  g.tma = (hd * isz) % 16 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kv_map, out, nq, g, st);
  return (int)launch<__nv_bfloat16>(q, k, v, kv_map, out, nq, g, st);
}

// The layout a launch takes: out = {column blocks, keys a chunk, ring
// stages, dynamic shared memory bytes, CTAs a q-block, TMA possible (the
// row strides; the operands' alignment is the launch's)}.
int maple_block_attention_layout(int dtype, int hd, int bq, int* out) {
  Geo g{};
  const cudaError_t err = layout(dtype, hd, bq, &g);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.nb;
  out[1] = g.kt;
  out[2] = g.stages;
  out[3] = g.smem;
  out[4] = g.n_sub;
  out[5] = (hd * (dtype ? 2 : 4)) % 16 == 0;
  return (int)cudaSuccess;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
