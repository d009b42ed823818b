// Maple block-sparse × dense SpMM kernels for Hopper (sm_90a).
//
// Three kernels, one run walk (run_kernel), differing in where a run's
// steps come from and in the epilogue:
//
// * maple_spmm_naive (B3) — replaces repro/kernels/maple_spmm.py::
//   maple_spmm_batched_pallas (:91, the "naive" schedule).  The TPU kernel
//   walks every block slot, pads included, as one sequential grid axis and
//   the wrapper masks empty block-rows afterwards.  Here each block-row i is
//   one run whose steps are its slots row_ptr[i] .. row_ptr[i+1] in
//   construction order, step s multiplying block s by B's panel
//   block_col[s] (block_col < 0 is masked).  The metadata is read straight
//   from row_ptr and block_col: no host plan.  The row is written once, in
//   B's dtype; a row with no slot is written as zeros in the same launch.
//
// * maple_spmm_compact (B1) — replaces maple_spmm.py::
//   maple_spmm_compact_pallas (:288, the planned "compact" layout).  Every
//   (lane, row) run of the plan (SpmmPlan.runs) flushes its f32 PSB to its
//   own compact slot; dead slots are never written.
//
// * maple_spmm_planned (B4) — replaces maple_spmm.py::
//   maple_spmm_planned_pallas (:176, the planned "rmw" layout).  The TPU
//   kernel runs lanes as a sequential grid axis: a row's first flusher
//   overwrites its output tile, later ones read it back and add.  Here a
//   block-row's runs (SpmmPlan.row_runs, sorted by row, lane order kept)
//   are summed in lane order into the merged f32 (G, M, N) result, and a
//   row with no run is written as zeros, in one launch.
//
// The canonical summation tree.  A run's steps [first, end), len steps,
// are cut into kSeg = 4 contiguous segments, segment j holding steps
// [first + len·j/4, first + len·(j+1)/4) (integer division; a segment may
// be empty).  Partial p_j is the chain over segment j's live steps in step
// order, from 0: on the FFMA tiles each weight block adds its bk products
// to every output element one FFMA at a time, in k order (N > 4) or in the
// skinny tile's rotated k order, fixed by the row (N <= 4, SkinnyTile); on
// the tensor cores (bf16, 64 × 64 blocks) each block is the same four
// wgmma k16 steps, whose internal order the hardware fixes.  A run's PSB
// is (p_0 + p_1) + (p_2 + p_3).  B3 writes a row's PSB (its one run) as
// 0 + PSB, cast once; B4 adds a row's PSBs in lane order,
// ((0 + PSB_0) + PSB_1) + ..., the order of the slot merge
// (ops._scatter_merge_f32) after B1.  The tree depends only on the run's
// steps and on (bm, bk, N, dtype): not on the N tile, since output
// columns never mix, nor on the grid, the runs of a row or, for B3, the
// number of batches G.  So B4 equals B1 + merge bit for bit, B3 equals B4
// on a table of one run a row, cast, and a rerun gives the same bits.
//
// The walk.  A thread-block cluster of kSeg = 4 CTAs owns one (run, N
// tile, batch g): CTA j walks segment j.  In each CTA one producer warp
// keeps a ring of 2 to 4 shared-memory stages full, each stage one weight
// block and its B panel, completed on an mbarrier:
//   - the weight block (bm·bk contiguous) arrives with one 1D
//     cp.async.bulk; in bf16 at 64 × 64 with one 2D TMA load through a
//     tensor map with the 128-byte swizzle that wgmma reads;
//   - the B panel, rows col·bk .. col·bk + bk of B viewed as (G·K, N):
//     one 2D TMA load (columns past N come in as zeros) where N·size is a
//     multiple of 16 bytes; else one 1D bulk copy of the contiguous bk × N
//     panel where one N tile covers N (decode, the logit head: the FFMA
//     consumers read B with row stride N, wgmma's n8 consumers lay it out
//     themselves); else the producer warp copies it itself (N = 21 over
//     two tiles, bf16 N = 17, a B that is not 16-byte aligned).
// B3 folds batches where G·N is narrow: on the skinny tile (N <= 4) and on
// wgmma's n8 tile (bf16 64 × 64, N <= 8) one cluster takes up to 4 / N
// (8 / N) batches side by side, the tile's column c being batch c / N,
// column c % N; the producer brings each batch's contiguous bk × N panel
// with its own bulk copy (or copies them itself).  So at decode (G 4,
// N 1) each weight block is read once, not once per batch.  At N = 1 the
// fold has layouts of its own: the skinny tile splits its 4 columns over
// all 4 consumer warps (SkinnyFold, bm <= 64), and the n8 tile takes 8
// batches' panels as one TMA box over B viewed as (G, K): K-major with
// the 128-byte swizzle, so the consumers lay nothing out (kBFoldTma).
// Elsewhere g stays in the grid, a row's G clusters next to each other so
// that they share the weight block in L2.
// bf16 stays bf16 in shared memory.  The consumers are one warpgroup:
//   - N <= 4 (f32, and bf16 at other block shapes): the skinny tile, one
//     row and 4 columns a thread (B3 folded at N = 1: 2 columns);
//   - else f32 (and bf16 at other block shapes): a register-blocked FFMA
//     tile, up to 8 × 8 outputs a thread, operands read from shared memory
//     as 4-wide vectors (A along k; B along n);
//   - bf16 at 64 × 64 blocks: wgmma.m64nNk16.f32.bf16.bf16 with A K-major
//     and the B panel MN-major (the transpose bit), f32 accumulators in
//     registers: one or two n64 atoms with the 128-byte swizzle, or one
//     unswizzled n8 for N <= 8 (B3 folded at N = 1: B K-major, swizzled).
// Each consumer warp hands a stage back on an mbarrier when it is done with
// it, so the next blocks load while this one is multiplied.  After the
// walk, every CTA puts its partial in its own shared memory, and each sums
// a quarter of the tile's registers, (p_0 + p_1) + (p_2 + p_3), reading
// the four partials through distributed shared memory, and writes that
// quarter of the epilogue.  B1's epilogue writes the run's slot; B3's the
// row, in B's dtype.  B4's writes the row as 0 + PSB when the row has one
// run; when it has several, each run puts its PSB in a scratch buffer (the
// wrapper's torch.empty) and adds one to the row's counter (one a
// quarter); the last to arrive sums the row's PSBs from the scratch buffer
// in lane order, writes the row and resets the counter to 0.  The counter
// only decides who sums; the sum's order is fixed.  A row's first run
// also writes zeros over the empty rows before it (the last run, those
// after it).  No atomics on values.  The wrapper narrows the N tile while
// the grid would give fewer than 4 CTAs an SM (maple_spmm.walk_tile), and
// asks for 2 stages where a segment averages 16 steps or fewer, so that
// more CTAs share an SM, 4 where segments are long (maple_spmm.ring_stages;
// B3: maple_spmm.naive_route).
//
// What bounds them on the H100: every live weight block is read once per
// N tile, 2·N FLOPs per weight element (B3: per batch too).  Below
// N·G ≈ 10 (decode, the logit head) that is under the ridge of either
// type (f32: 67 TFLOP/s over 3.35 TB/s, about 20 FLOPs a byte), so the
// weight bytes bound the kernel and the design is about bytes in flight:
// 2 to 4 stages of 16 KB (f32) a CTA, several CTAs an SM, 4 CTAs a run so
// that the grid fills the card, and B3's folded batches.  At N ≥ 128
// (training, prefill) the operations bound it: the FFMA tile reuses each
// A value 8 times and each B value 8 times from registers, and bf16 goes
// to the tensor cores.  f32 does not use the tensor cores: TF32 would
// round the operands to 10 bits of mantissa, and the port's f32 parity
// (ROADMAP's North star) asks for IEEE f32 products; 3xTF32 (split each
// operand into two TF32 terms) would keep f32 accuracy at three
// tensor-core products and is left for later.
//
// Plain C interface (bound with ctypes); every launcher returns
// cudaGetLastError() right after the launch.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kSeg = 4;                      // segments a run = CTAs a cluster
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 100 * 1024;

enum Mode { kCompact = 0, kPlanned = 1, kNaive = 2 };
// B3 folded at N = 1, bf16 at 64 × 64: B viewed as (G, K) by one TMA box
enum BMode { kBTensor = 0, kBPanel = 1, kBManual = 2, kBFoldTma = 3 };

struct RunGeo {
  int K, N, bm, bk;  // B is (G, K, N); blocks (nb, bm, bk)
  int tile;          // output columns a CTA owns
  int ldb;           // row stride of the staged B panel, elements
  int b_mode;        // BMode
  int steps;         // plan steps a lane
  int n_runs;        // B1 / B4: runs; B3: block-rows
  int gm;            // B3 / B4: block-rows
  int n_slots;       // B1: slots a batch
  int stages;
  int b_off;         // byte offset of the B panel in a stage
  int p_off;         // byte offset of the bulk-copied B panel(s)
  int stage_bytes;
  int ring_bytes;    // the ring, at least the stash of partials
  unsigned tx;       // bytes the asynchronous copies bring a stage (B3
                     // folded: the weight block's; each batch adds its own)
  int G;             // B3: batches
  int fold;          // B3: batches a cluster takes side by side (0: one,
                     // from the grid)
  int groups;        // B3: batch groups of a row in the grid
  int gstride;       // B3 folded: elements between two batches' panels
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the address of `p` in the shared memory of CTA `rank` of this cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// No memory clobber: the loads of a batch go out back to back, and the
// cluster barrier before them orders them after the partials' stores.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// A partial in shared memory: register i of thread t at float
// ((i / 4)·128 + t)·4 + i % 4, so that a thread's 4-wide loads are
// contiguous and a quarter warp's are 128 contiguous bytes; at i·128 + t
// for tiles of fewer than 4 registers or a count not divisible by 4.
template <int R>
__device__ __forceinline__ void stash_partial(float* stash,
                                              const float (&acc)[R], int t) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      reinterpret_cast<float4*>(stash)[j * kConsumers + t] =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) stash[i * kConsumers + t] = acc[i];
  }
}

// Registers [base, base + Q) of thread t summed over the cluster's four
// stashed partials, (p0 + p1) + (p2 + p3), in batches so that many remote
// loads are in flight at once.
template <int R, int Q>
__device__ __forceinline__ void reduce_partials(const float* stash, int base,
                                                float (&v)[Q], int t) {
  uint32_t at[kSeg];
#pragma unroll
  for (int c = 0; c < kSeg; ++c) at[c] = cluster_addr(stash, c);
  if constexpr (Q % 4 == 0) {                // base % 4 == 0 too
    constexpr int kBatch = Q / 4 < 4 ? Q / 4 : 4;
#pragma unroll
    for (int j0 = 0; j0 < Q / 4; j0 += kBatch) {
      float4 p[kSeg][kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int c = 0; c < kSeg; ++c)
          p[c][b] = ld_cluster4(
              at[c] + ((base / 4 + j0 + b) * kConsumers + t) * 16);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float* o = v + 4 * (j0 + b);
        o[0] = (p[0][b].x + p[1][b].x) + (p[2][b].x + p[3][b].x);
        o[1] = (p[0][b].y + p[1][b].y) + (p[2][b].y + p[3][b].y);
        o[2] = (p[0][b].z + p[1][b].z) + (p[2][b].z + p[3][b].z);
        o[3] = (p[0][b].w + p[1][b].w) + (p[2][b].w + p[3][b].w);
      }
    }
  } else {
    float p[kSeg][Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int i = base + j;
#pragma unroll
      for (int c = 0; c < kSeg; ++c)
        p[c][j] = ld_cluster(
            at[c] + (R % 4 == 0 ? ((i / 4) * kConsumers + t) * 4 + i % 4
                                : i * kConsumers + t) * 4);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) v[j] = (p[0][j] + p[1][j]) + (p[2][j] + p[3][j]);
  }
}

// Element (k, c) of a staged narrow B panel (the skinny and n8 tiles) in
// B3's kernels, rows ldb apart: batch c / N, column c % N where the tile
// is folded, else column c.
__device__ __forceinline__ int panel_at(const RunGeo& geo, int k, int c) {
  if (!geo.fold) return k * geo.ldb + c;
  return (c / geo.N) * geo.gstride + k * geo.ldb + c % geo.N;
}

// ---- the skinny FFMA consumer (N <= 4: decode, the logit head): thread t
// holds row t and the 4 columns of the tile (`cols` of them live).  Rows
// lie bk·size bytes apart, a multiple of 128 for bk = 64, so the 8 rows of
// a quarter warp would read one bank: row t walks its k quads from quad
// t % (bk / 4) on, wrapping.  For N > 1 it also starts each quad at k
// offset (t / 2) % 4, so that the B rows a quarter warp reads (16 bytes
// each at N = 4) fall in 8 banks too; it then reads A one value at a time
// (the 8 rows' values lie in 8 banks).  The chain of each output element
// is the row's rotated k order, fixed by bk, the row and whether N is 1.

template <typename T>
struct SkinnyTile {
  static constexpr int R = 4;
  static constexpr bool kWgmma = false;

  // kFold: B3's folded panels (compiled into B3's kernels only)
  template <bool kFold>
  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t, int cols) {
    using V = typename Vec4<T>::type;
    if (t >= geo.bm) return;
    const T* a_row = reinterpret_cast<const T*>(stage) + t * geo.bk;
    const T* b_s = reinterpret_cast<const T*>(stage + geo.b_off);
    const int nq = geo.bk / 4, s = (t / 2) % 4;
    int q = t % nq;
    for (int i = 0; i < nq; ++i, q = q + 1 == nq ? 0 : q + 1) {
      if (geo.ldb == 1) {                    // N = 1: 4 k in one vector
        float a[4], bq[4];
        Vec4<T>::unpack(*reinterpret_cast<const V*>(a_row + 4 * q), a);
        Vec4<T>::unpack(*reinterpret_cast<const V*>(b_s + 4 * q), bq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc[0] = fmaf(a[kk], bq[kk], acc[0]);
      } else if (geo.ldb % 4 == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * q + (kk + s) % 4;
          const float a = to_f32(a_row[k]);
          float bq[4];
          Vec4<T>::unpack(*reinterpret_cast<const V*>(b_s + k * geo.ldb), bq);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = fmaf(a, bq[c], acc[c]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * q + (kk + s) % 4;
          const float a = to_f32(a_row[k]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < cols)
              acc[c] = fmaf(a, to_f32(b_s[kFold ? panel_at(geo, k, c)
                                                : k * geo.ldb + c]),
                            acc[c]);
        }
      }
    }
  }

  __device__ static bool at(int i, const RunGeo& geo, int t, int& r,
                            int& c) {
    r = t;
    c = i;
    return t < geo.bm;
  }
};

// ---- B3's folded skinny tile (N = 1, bm <= 64: decode): the tile's 4
// columns are 4 batches, two a thread: thread t holds row t % 64 and
// columns 2·(t / 64) and 2·(t / 64) + 1, so all four consumer warps work.
// Each column's chain is SkinnyTile's at N = 1 (quads from t % (bk / 4)
// on, 4 k in order), so a column's bits do not depend on the fold.
template <typename T>
struct SkinnyFold {
  static constexpr int R = 2;
  static constexpr bool kWgmma = false;

  template <bool kFold>
  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t, int /*cols*/) {
    using V = typename Vec4<T>::type;
    const int r = t % 64, c0 = 2 * (t / 64);
    if (r >= geo.bm) return;
    const T* a_row = reinterpret_cast<const T*>(stage) + r * geo.bk;
    const T* b0 = reinterpret_cast<const T*>(stage + geo.b_off) +
                  c0 * geo.gstride;
    const T* b1 = b0 + geo.gstride;
    const int nq = geo.bk / 4;
    int q = r % nq;
    for (int i = 0; i < nq; ++i, q = q + 1 == nq ? 0 : q + 1) {
      float a[4], x0[4], x1[4];
      Vec4<T>::unpack(*reinterpret_cast<const V*>(a_row + 4 * q), a);
      Vec4<T>::unpack(*reinterpret_cast<const V*>(b0 + 4 * q), x0);
      Vec4<T>::unpack(*reinterpret_cast<const V*>(b1 + 4 * q), x1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc[0] = fmaf(a[kk], x0[kk], acc[0]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc[1] = fmaf(a[kk], x1[kk], acc[1]);
    }
  }

  __device__ static bool at(int i, const RunGeo& geo, int t, int& r,
                            int& c) {
    r = t % 64;
    c = 2 * (t / 64) + i;
    return r < geo.bm;
  }
};

// ---- the wgmma consumer (bf16, bm = bk = 64): one warpgroup, WN columns
// as WN / 64 atoms of 64; a 64 × 64 weight block is 4 k16 steps.
// WN = 8 (N <= 8, or G·N <= 8 folded: decode, the logit head) keeps B as
// (bk, 8) rows of 16 bytes; its panel(s), bulk-copied as contiguous
// (bk, N) rows, are laid out there by the consumers (zeros past the live
// columns) before the product.
template <int WN>
struct WgmmaTile {
  static constexpr int R = WN / 2;     // 64 × WN f32 over 128 threads
  static constexpr bool kWgmma = true;

  template <bool kFold>
  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t, int cols) {
    const uint32_t a0 = smem_u32(stage), b0 = a0 + geo.b_off;
    if constexpr (WN == 8) {
      if (kFold && geo.b_mode == kBFoldTma) {   // (8 batches, bk) K-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n8<0, 0, 0>(acc, gmma_desc(a0 + 32 * kk, 16),
                            gmma_desc(b0 + 32 * kk, 16));
        wgmma_commit_wait();
        return;
      }
      if (geo.b_mode == kBPanel || (kFold && geo.fold)) {
        const __nv_bfloat16* panel =
            reinterpret_cast<const __nv_bfloat16*>(stage + geo.p_off);
        const int k = t / 2, c0 = 4 * (t % 2);
        __align__(8) __nv_bfloat16 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = c0 + e < cols
                     ? panel[kFold ? panel_at(geo, k, c0 + e)
                                   : k * geo.N + c0 + e]
                     : __float2bfloat16(0.0f);
        *reinterpret_cast<uint2*>(const_cast<unsigned char*>(stage) +
                                  geo.b_off + k * 16 + 2 * c0) =
            *reinterpret_cast<const uint2*>(v);
        fence_async_smem();
        consumer_sync();
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n8<0, 1, 0>(acc, gmma_desc(a0 + 32 * kk, 16),
                          gmma_desc_plain(b0 + 256 * kk));
      wgmma_commit_wait();
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A: k16 slice kk is 32 bytes into each swizzled 128-byte row;
        // B: 16 k-rows of 128 bytes; the atom of columns 64 .. 127
        // follows the first after bk rows
        const uint64_t da = gmma_desc(a0 + 32 * kk, 16);
        wgmma_n64<0, 1, 0>(acc, da, gmma_desc(b0 + 2048 * kk, 1024));
        if constexpr (WN == 128)
          wgmma_n64<0, 1, 32>(acc, da,
                              gmma_desc(b0 + 8192 + 2048 * kk, 1024));
      }
      wgmma_commit_wait();
    }
  }

  // the accumulator fragment: register h·32 + 4q + e of thread t holds row
  // 16·warp + lane/4 + 8·(e/2), column 64h + 8q + 2·(lane%4) + e%2
  __device__ static bool at(int i, const RunGeo& geo, int t, int& r,
                            int& c) {
    wgmma_at(i, t, r, c);
    return true;
  }
};

// registers [base, base + Q) of thread t into the (bm, N) tile at out_tile
template <class Tile, int Q>
__device__ __forceinline__ void store_part(const float (&v)[Q], int base,
                                           float* out_tile, int n0,
                                           const RunGeo& geo, int t) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    int r, c;
    if (Tile::at(base + j, geo, t, r, c) && n0 + c < geo.N)
      out_tile[(int64_t)r * geo.N + n0 + c] = v[j];
  }
}

// B3: registers [base, base + Q) of thread t into block-row `row` of the
// (G, gm·bm, N) output, as 0 + PSB cast to O.  Folded, column c of the
// tile is batch g0 + c / N, column c % N; else batch g0, column n0 + c.
template <class Tile, typename O, int Q>
__device__ __forceinline__ void store_row(const float (&v)[Q], int base,
                                          O* __restrict__ out, int row,
                                          int g0, int cols, int n0,
                                          const RunGeo& geo, int t) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    int r, c;
    if (!Tile::at(base + j, geo, t, r, c)) continue;
    int g = g0, n = n0 + c;
    if (geo.fold) {
      if (c >= cols) continue;
      g = g0 + c / geo.N;
      n = c % geo.N;
    } else if (n >= geo.N) {
      continue;
    }
    out[(((int64_t)g * geo.gm + row) * geo.bm + r) * geo.N + n] =
        from_f32<O>(0.0f + v[j]);
  }
}

// The producer's own copy of a B panel (modes the copy engines cannot
// take): the FFMA layout is (bk, ldb) row-major, wgmma's the swizzled
// MN-major atoms; columns past N are zero.
template <typename T, class Tile>
__device__ __forceinline__ void manual_panel(unsigned char* dst,
                                             const T* __restrict__ b,
                                             int64_t brow, int n0,
                                             const RunGeo& geo, int lane) {
  if constexpr (Tile::kWgmma) {
    const int cpr = geo.tile / 8;                 // 16-byte chunks a row
    const int total = geo.bk * cpr;
    for (int c0 = lane; c0 < total; c0 += 32 * 4) {
      __align__(16) T v[4][8];                    // loads first, then stores
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u, k = c / cpr, nc = c % cpr;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int n = n0 + nc * 8 + e;
          v[u][e] = c < total && n < geo.N ? b[(brow + k) * geo.N + n]
                                           : from_f32<T>(0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u, k = c / cpr, nc = c % cpr;
        if (c >= total) break;
        const int off = geo.tile == 8 ? k * 16
            : (nc / 8) * geo.bk * 128 + k * 128 + (((nc % 8) ^ (k & 7)) << 4);
        *reinterpret_cast<uint4*>(dst + off) =
            *reinterpret_cast<const uint4*>(v[u]);
      }
    }
  } else {
    T* b_s = reinterpret_cast<T*>(dst);
    const int total = geo.bk * geo.tile;
    for (int base = lane; base < total; base += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + 32 * u;
        const int k = idx / geo.tile, n = n0 + idx % geo.tile;
        v[u] = (idx < total && n < geo.N) ? b[(brow + k) * geo.N + n]
                                          : from_f32<T>(0.0f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + 32 * u;
        if (idx < total) b_s[(idx / geo.tile) * geo.ldb + idx % geo.tile] = v[u];
      }
    }
  }
}

// B3 folded, where the bulk copies cannot take the panels: the producer
// copies batches g0 .. g0 + nbat of rows brow .. brow + bk (contiguous
// bk·N elements each) side by side, gstride apart.
template <typename T>
__device__ __forceinline__ void manual_panels(unsigned char* dst,
                                              const T* __restrict__ b,
                                              int g0, int nbat, int64_t brow,
                                              const RunGeo& geo, int lane) {
  T* b_s = reinterpret_cast<T*>(dst);
  const int per = geo.bk * geo.N, total = nbat * per;
  for (int base = lane; base < total; base += 32 * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + 32 * u;
      if (idx < total)
        v[u] = b[((int64_t)(g0 + idx / per) * geo.K + brow) * geo.N +
                 idx % per];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + 32 * u;
      if (idx < total) b_s[(idx / per) * geo.gstride + idx % per] = v[u];
    }
  }
}

// The largest x in [0, hi] with ptr[x] <= v (-1 if none), found by one
// warp probing 32 points a round: 3 rounds of loads for 2 400 rows.
__device__ __forceinline__ int warp_last_le(const int* __restrict__ ptr,
                                            int hi, int v, int lane) {
  int lo = -1;                               // ptr[lo] <= v, or lo = -1
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int x = min(lo + 1 + lane * step, hi);
    const unsigned ok = __ballot_sync(0xffffffffu, ptr[x] <= v);
    if (ok == 0) return lo;                  // ptr[lo + 1] > v
    const int j = 31 - __clz(ok);
    const int xj = min(lo + 1 + j * step, hi);
    hi = j == 31 || xj == hi ? hi : min(xj + step - 1, hi);
    lo = xj;
  }
  return lo;
}

// zeros over block-rows [lo, hi) of batch g, this tile's columns; thread
// `who` of `threads` doing their share
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int g,
                                          int lo, int hi, int n0,
                                          const RunGeo& geo, int who,
                                          int threads) {
  if (lo >= hi) return;
  const int w = min(geo.tile, geo.N - n0);
  const int64_t n = (int64_t)(hi - lo) * geo.bm * w;
  float* base = out + ((int64_t)g * geo.gm + lo) * geo.bm * geo.N + n0;
  for (int64_t e = who; e < n; e += threads)
    base[(e / w) * geo.N + e % w] = 0.0f;
}

// grid: (kSeg · items, N tiles, G), clusters of kSeg along x.  B1: item =
// run of `runs`; B4: item = run of `row_runs` (one item when there is no
// run, which writes the zeros).  B3: grid (kSeg · gm · groups, N tiles,
// 1), item = (block-row, batch group), a row's groups next to each other;
// `runs` is row_ptr and `step_col` block_col.
template <typename T, class Tile, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
run_kernel(const __grid_constant__ CUtensorMap a_map,
           const __grid_constant__ CUtensorMap b_map,
           const T* __restrict__ blocks, const int* __restrict__ order,
           const int* __restrict__ step_col, const int* __restrict__ runs,
           const int* __restrict__ row_run_ptr, const T* __restrict__ b,
           void* __restrict__ out_raw, float* __restrict__ scratch,
           int* __restrict__ counters, RunGeo geo) {
  constexpr int R = Tile::R;
  // B3's folds are compiled into its kernels only, so that B1's and B4's
  // stay as lean as they were
  constexpr bool kB3 = kMode == kNaive;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + geo.ring_bytes);
  uint64_t* empty = full + kMaxStages;
  // B4's row: [0] the last-arrival flag, [1] the row, [2] its first run,
  // [3] its runs, [4] the first empty row before it (found while the
  // first blocks load)
  int* meta = reinterpret_cast<int*>(empty + kMaxStages);
  float* stash = reinterpret_cast<float*>(ring);
  float* out = reinterpret_cast<float*>(out_raw);
  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int item = blockIdx.x / kSeg, tile = blockIdx.y;
  int run = item, g = blockIdx.z;
  if constexpr (kMode == kNaive) {
    run = item / geo.groups;
    g = item % geo.groups * (geo.fold ? geo.fold : 1);
  }
  const int n0 = tile * geo.tile;
  // B3 folded: batches g .. g + nbat side by side, `cols` live columns
  const bool fold = kB3 && geo.fold;
  const int nbat = fold ? min(geo.fold, geo.G - g) : 1;
  const int cols = fold ? nbat * geo.N : geo.N;

  if (t == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 32);             // every producer lane arrives
      mbar_init(&empty[s], kConsumers / 32);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int base = 0, s0 = 0, s1 = 0;              // this CTA's segment
  if (run < geo.n_runs) {
    int first, len;
    if constexpr (kMode == kNaive) {
      first = runs[run];
      len = runs[run + 1] - first;
    } else {
      first = runs[4 * run + 1];
      len = runs[4 * run + 2] - first;
      base = runs[4 * run] * geo.steps;
    }
    s0 = first + len * (int)rank / kSeg;
    s1 = first + len * ((int)rank + 1) / kSeg;
  }
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  if (t >= kConsumers) {
    // ---- producer warp
    const int lane = t - kConsumers;
    const int isz = sizeof(T);
    const bool panels = fold && geo.b_mode == kBPanel;
    const uint32_t tx = geo.tx + (panels ? nbat * geo.bk * geo.N * isz : 0);

    int it = 0;
    for (int s = s0; s < s1; ++s) {
      const int col = step_col[base + s];
      if (col < 0) continue;                 // a pad step adds nothing
      const int blk = kMode == kNaive ? s : order[base + s];
      const int st = it % geo.stages;
      mbar_wait(&empty[st], ((it / geo.stages) & 1) ^ 1);
      unsigned char* stage = ring + st * geo.stage_bytes;
      const int64_t brow = (int64_t)g * geo.K + (int64_t)col * geo.bk;
      if (lane == 0) {
        mbar_expect_tx(&full[st], tx);
        if constexpr (Tile::kWgmma)
          tma_2d(stage, &a_map, 0, blk * geo.bm, &full[st]);
        else
          bulk_copy(stage, blocks + (int64_t)blk * geo.bm * geo.bk,
                    geo.bm * geo.bk * isz, &full[st]);
        if (fold) {
          if (panels)
            for (int j = 0; j < nbat; ++j)
              bulk_copy(stage + geo.p_off + j * geo.gstride * isz,
                        b + (brow + (int64_t)j * geo.K) * geo.N,
                        geo.bk * geo.N * isz, &full[st]);
          else if (kB3 && geo.b_mode == kBFoldTma)
            tma_2d(stage + geo.b_off, &b_map, col * geo.bk, g, &full[st]);
        } else if (geo.b_mode == kBTensor) {
          if constexpr (Tile::kWgmma) {
            for (int h = 0; h < (geo.tile + 63) / 64; ++h)
              tma_2d(stage + geo.b_off + h * geo.bk * 128, &b_map,
                     n0 + 64 * h, (int)brow, &full[st]);
          } else {
            tma_2d(stage + geo.b_off, &b_map, n0, (int)brow, &full[st]);
          }
        } else if (geo.b_mode == kBPanel) {
          bulk_copy(stage + geo.p_off, b + brow * geo.N,
                    geo.bk * geo.N * isz, &full[st]);
        }
      }
      if (geo.b_mode == kBManual) {
        if (fold)
          manual_panels<T>(stage + geo.p_off, b, g, nbat,
                           (int64_t)col * geo.bk, geo, lane);
        else
          manual_panel<T, Tile>(stage + geo.b_off, b, brow, n0, geo, lane);
        fence_async_smem();
      }
      mbar_arrive(&full[st]);
      ++it;
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroup; warp 0 first finds B4's row while the
    // first blocks load
    if (kMode == kPlanned && t < 32 && run < geo.n_runs) {
      const int row = warp_last_le(row_run_ptr, geo.gm - 1, run, t);
      const int p0 = row_run_ptr[row];
      // a row's first run zeros the empty rows just before it
      const int lo = p0 == run
          ? warp_last_le(row_run_ptr, geo.gm - 1, run - 1, t) + 1 : row;
      if (t == 0) {
        meta[1] = row;
        meta[2] = p0;
        meta[3] = row_run_ptr[row + 1] - p0;
        meta[4] = lo;
      }
    }
    int it = 0;
    for (int s = s0; s < s1; ++s) {
      if (step_col[base + s] < 0) continue;
      const int st = it % geo.stages;
      mbar_wait(&full[st], (it / geo.stages) & 1);
      __syncwarp();
      Tile::template step<kB3>(acc, ring + st * geo.stage_bytes, geo, t,
                               cols);
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(&empty[st]);
      ++it;
    }
    consumer_sync();                         // the ring is free
    stash_partial<R>(stash, acc, t);
  }
  cluster_sync();                            // the four partials are stashed
  // Each CTA of the cluster sums a quarter of the registers (CTA 0 all of
  // them for tiles of fewer than 4) and writes that part of the epilogue.
  constexpr int Q = R % kSeg == 0 ? R / kSeg : R;
  const int parts = R % kSeg == 0 ? kSeg : 1;
  const int part = R % kSeg == 0 ? (int)rank : 0;
  const bool mine = t < kConsumers && (int)rank < parts;
  const int base_i = part * Q;
  float v[Q];
  if (mine) reduce_partials<R, Q>(stash, base_i, v, t);
  cluster_sync();                            // the stashes may go
  if (!mine) return;

  if constexpr (kMode == kNaive) {
    store_row<Tile, T, Q>(v, base_i, reinterpret_cast<T*>(out_raw), run, g,
                          cols, n0, geo, t);
  } else if constexpr (kMode == kCompact) {
    if (run >= geo.n_runs) return;
    const int slot = runs[4 * run + 3];
    store_part<Tile, Q>(v, base_i, out + ((int64_t)g * geo.n_slots + slot) *
                                             geo.bm * geo.N, n0, geo, t);
  } else {
    const int who = part * kConsumers + t, threads = parts * kConsumers;
    if (geo.n_runs == 0) {
      zero_rows(out, g, 0, geo.gm, n0, geo, who, threads);
      return;
    }
    const int row = meta[1], p0 = meta[2], nr = meta[3], k = run - p0;
    zero_rows(out, g, meta[4], row, n0, geo, who, threads);
    if (run == geo.n_runs - 1)
      zero_rows(out, g, row + 1, geo.gm, n0, geo, who, threads);
    float* row_out = out + ((int64_t)g * geo.gm + row) * geo.bm * geo.N;
    if (nr == 1) {
#pragma unroll
      for (int j = 0; j < Q; ++j) v[j] = 0.0f + v[j];
      store_part<Tile, Q>(v, base_i, row_out, n0, geo, t);
      return;
    }
    // a split row: PSBs meet in the scratch buffer, and for each quarter
    // the last run to arrive sums them in lane order
    float* psbs = scratch + ((int64_t)g * gridDim.y + tile) * geo.n_runs *
                                (int64_t)(R * kConsumers);
#pragma unroll
    for (int j = 0; j < Q; ++j)
      psbs[(int64_t)run * R * kConsumers + (base_i + j) * kConsumers + t] =
          v[j];
    __threadfence();
    consumer_sync();
    if (t == 0) {
      int* count = counters +
          (((int64_t)g * gridDim.y + tile) * geo.gm + row) * kSeg + part;
      const bool last = atomicAdd(count, 1) == nr - 1;
      if (last) *count = 0;                  // ready for the next launch
      meta[0] = last;
    }
    consumer_sync();
    if (!meta[0]) return;
    __threadfence();
    float sum[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) sum[j] = 0.0f;
    for (int q = 0; q < nr; ++q) {
      const float* src = psbs + (int64_t)(p0 + q) * R * kConsumers +
                         base_i * kConsumers + t;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        sum[j] = sum[j] + (q == k ? v[j] : __ldcg(src + j * kConsumers));
    }
    store_part<Tile, Q>(sum, base_i, row_out, n0, geo, t);
  }
}

// ---- host side

// Everything a launch needs, from the shapes alone.  kind: 0 / 1 / 2
// wgmma with 8 / 64 / 128 columns, 3 the skinny FFMA tile (N <= 4), 4 + c
// the FFMA tile kTiles[c], kSkinnyFold B3's folded skinny tile (N = 1).
constexpr int kSkinnyFold = 11;
struct RunPlan {
  RunGeo geo;
  int kind, ntiles, frag;       // frag: floats of one partial (128 · R)
  size_t smem;
};

// the stage size, the ring and the shared memory of a plan whose panel
// takes b_bytes a stage
cudaError_t size_ring(RunPlan* p, int b_bytes, int align, int max_stages,
                      int r) {
  RunGeo& g = p->geo;
  g.stage_bytes = (g.b_off + b_bytes + align - 1) / align * align;
  g.stages = kRingBudget / g.stage_bytes;
  const int cap = max_stages < 2 ? 2 : max_stages > kMaxStages
                                                 ? kMaxStages : max_stages;
  if (g.stages > cap) g.stages = cap;
  if (g.stages < 2) return cudaErrorInvalidValue;   // blocks too large
  const int stash = r * kConsumers * 4;
  g.ring_bytes = g.stages * g.stage_bytes;
  if (g.ring_bytes < stash) g.ring_bytes = (stash + 1023) / 1024 * 1024;
  p->smem = 1024 + g.ring_bytes + 2 * kMaxStages * 8 + 32;
  return cudaSuccess;
}

cudaError_t plan_runs(int dtype, const void* b, int N, int K, int bm, int bk,
                      int bn, int max_stages, RunPlan* p) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  const bool wg = dtype == 1 && bm == 64 && bk == 64;
  int tile = bn > 128 ? 128 : bn;
  int r = 0;
  if (wg) {
    tile = N <= 8 ? 8 : tile <= 64 ? 64 : 128;
    p->kind = tile == 8 ? 0 : tile == 64 ? 1 : 2;
    r = tile / 2;
  } else if (N <= 4 && bm <= kConsumers) {
    tile = 4;
    p->kind = 3;
    r = 4;
  } else {
    const int c = ffma_tile(bm, tile);
    if (c < 0) return cudaErrorInvalidConfiguration;
    p->kind = 4 + c;
    r = kTiles[c][0] * kTiles[c][1];
  }
  if ((bm * bk * isz) % 16) return cudaErrorInvalidValue;
  RunGeo& g = p->geo;
  g = RunGeo{};
  g.K = K; g.N = N; g.bm = bm; g.bk = bk; g.tile = tile;
  const bool aligned = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int align = wg ? 1024 : 128;
  g.b_off = (bm * bk * isz + align - 1) / align * align;
  g.p_off = g.b_off;
  int b_bytes = bk * tile * isz;             // the staged panel
  g.ldb = tile;
  if ((N * isz) % 16 == 0 && aligned && bk <= 256) {
    g.b_mode = kBTensor;
    g.tx = b_bytes;
  } else if (N <= tile && (bk * N * isz) % 16 == 0 && aligned &&
             (!wg || tile == 8)) {
    g.b_mode = kBPanel;
    g.tx = bk * N * isz;
    g.ldb = N;
    if (wg) {
      g.p_off = g.b_off + b_bytes;           // laid out by the consumers
      b_bytes += bk * N * isz;
    } else {
      b_bytes = (bk * N + tile) * isz;       // columns past N read garbage
    }
  } else {
    g.b_mode = kBManual;
    g.tx = 0;
  }
  g.tx += bm * bk * isz;
  const cudaError_t err = size_ring(p, b_bytes, align, max_stages, r);
  if (err != cudaSuccess) return err;
  p->ntiles = (N + tile - 1) / tile;
  p->frag = r * kConsumers;
  return cudaSuccess;
}

// B3: the run walk's plan, then the fold.  On the skinny tile and wgmma's
// n8 tile a cluster takes fold = tile / N batches side by side: each
// batch's contiguous (bk, N) panel at gstride = bk·N elements from the
// last, by one bulk copy each where every panel is 16-byte aligned, else
// copied by the producer.  At N = 1 the skinny tile folds only as
// SkinnyFold (bm <= 64).  Elsewhere g stays in the grid (fold 0).
cudaError_t plan_naive(int dtype, const void* b, int G, int N, int K, int bm,
                       int bk, int bn, int max_stages, RunPlan* p) {
  cudaError_t err = plan_runs(dtype, b, N, K, bm, bk, bn, max_stages, p);
  if (err != cudaSuccess) return err;
  RunGeo& g = p->geo;
  g.G = G;
  g.fold = 0;
  g.groups = G;
  if (p->kind != 0 && p->kind != 3) return cudaSuccess;
  if (p->kind == 3 && N == 1 && bm > 64) return cudaSuccess;
  const int isz = dtype ? 2 : 4;
  const int panel = bk * N * isz;
  const bool aligned = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  g.fold = g.tile / N;
  g.groups = (G + g.fold - 1) / g.fold;
  g.ldb = N;
  g.gstride = bk * N;
  g.b_mode = aligned && panel % 16 == 0 && ((int64_t)K * N * isz) % 16 == 0
                 ? kBPanel : kBManual;
  g.tx = bm * bk * isz;                      // each batch adds its panel
  int b_bytes = g.fold * panel;
  if (p->kind == 0 && N == 1 && aligned && ((int64_t)K * isz) % 16 == 0) {
    g.b_mode = kBFoldTma;                    // 8 rows of B as (G, K)
    b_bytes = 8 * bk * isz;
    g.tx += b_bytes;
  } else if (p->kind == 0) {                 // n8: (bk, 8) laid out first
    g.p_off = g.b_off + bk * 16;
    b_bytes += bk * 16;
  } else if (N == 1 && bm <= 64) {
    p->kind = kSkinnyFold;
  }
  return size_ring(p, b_bytes, p->kind == 0 ? 1024 : 128, max_stages,
                   p->frag / kConsumers);
}

struct RunArgs {
  CUtensorMap a_map, b_map;
  const void *blocks, *b;
  const int *order, *step_col, *runs, *row_run_ptr;
  void* out;
  float* scratch;
  int* counters;
};

template <typename T, class Tile, int kMode>
cudaError_t launch_runs(const RunArgs& a, const RunGeo& geo, dim3 grid,
                        size_t smem, cudaStream_t stream) {
  auto kernel = run_kernel<T, Tile, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSeg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a.a_map, a.b_map,
                           (const T*)a.blocks, a.order, a.step_col, a.runs,
                           a.row_run_ptr, (const T*)a.b, a.out, a.scratch,
                           a.counters, geo);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch_ffma(int c, const RunArgs& a, const RunGeo& geo,
                        dim3 grid, size_t smem, cudaStream_t st) {
  switch (c) {
    case 0: return launch_runs<T, FfmaTile<T, 8, 8>, kMode>(a, geo, grid, smem, st);
    case 1: return launch_runs<T, FfmaTile<T, 4, 8>, kMode>(a, geo, grid, smem, st);
    case 2: return launch_runs<T, FfmaTile<T, 4, 4>, kMode>(a, geo, grid, smem, st);
    case 3: return launch_runs<T, FfmaTile<T, 2, 4>, kMode>(a, geo, grid, smem, st);
    case 4: return launch_runs<T, FfmaTile<T, 1, 4>, kMode>(a, geo, grid, smem, st);
    case 5: return launch_runs<T, FfmaTile<T, 1, 2>, kMode>(a, geo, grid, smem, st);
    case 6: return launch_runs<T, FfmaTile<T, 1, 1>, kMode>(a, geo, grid, smem, st);
    default: return cudaErrorInvalidConfiguration;
  }
}

// Maps, then the launch over `grid` (see run_kernel).
template <int kMode>
cudaError_t launch_walk(RunArgs& a, RunPlan& p, int dtype, int nb, int G,
                        dim3 grid, cudaStream_t st) {
  const RunGeo& geo = p.geo;
  memset(&a.a_map, 0, sizeof(a.a_map));
  memset(&a.b_map, 0, sizeof(a.b_map));
  const int isz = dtype ? 2 : 4;
  const bool wg = p.kind < 3;
  if (wg && !encode_2d(&a.a_map, dtype, a.blocks, geo.bk,
                       (uint64_t)nb * geo.bm, geo.bk * isz, geo.bk, geo.bm,
                       true))
    return cudaErrorInvalidValue;
  const bool swizzled = wg && geo.tile >= 64;
  if (geo.b_mode == kBTensor && !geo.fold &&
      !encode_2d(&a.b_map, dtype, a.b, geo.N, (uint64_t)G * geo.K,
                 (uint64_t)geo.N * isz, swizzled ? 64 : geo.tile, geo.bk,
                 swizzled))
    return cudaErrorInvalidValue;
  if (geo.b_mode == kBFoldTma &&
      !encode_2d(&a.b_map, dtype, a.b, geo.K, G, (uint64_t)geo.K * isz,
                 geo.bk, 8, true))
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  switch (p.kind) {
    case 0: return launch_runs<bf16, WgmmaTile<8>, kMode>(a, geo, grid, p.smem, st);
    case 1: return launch_runs<bf16, WgmmaTile<64>, kMode>(a, geo, grid, p.smem, st);
    case 2: return launch_runs<bf16, WgmmaTile<128>, kMode>(a, geo, grid, p.smem, st);
    case 3:
      return dtype == 0
          ? launch_runs<float, SkinnyTile<float>, kMode>(a, geo, grid, p.smem, st)
          : launch_runs<bf16, SkinnyTile<bf16>, kMode>(a, geo, grid, p.smem, st);
    case kSkinnyFold:
      if constexpr (kMode == kNaive)
        return dtype == 0
            ? launch_runs<float, SkinnyFold<float>, kMode>(a, geo, grid, p.smem, st)
            : launch_runs<bf16, SkinnyFold<bf16>, kMode>(a, geo, grid, p.smem, st);
      return cudaErrorInvalidConfiguration;
    default:
      return dtype == 0
          ? launch_ffma<float, kMode>(p.kind - 4, a, geo, grid, p.smem, st)
          : launch_ffma<bf16, kMode>(p.kind - 4, a, geo, grid, p.smem, st);
  }
}

}  // namespace

extern "C" {

// The layout of a B3 launch: out[0..6) = kind (see RunPlan), N tile, N
// tiles, fold (0: g in the grid), batch groups a row, B's copy (BMode);
// `aligned` stands for B's pointer.
int maple_spmm_naive_layout(int dtype, int G, int N, int K, int bm, int bk,
                            int bn, int aligned, int* out) {
  RunPlan p{};
  const cudaError_t err = plan_naive(
      dtype, reinterpret_cast<const void*>(aligned ? 0 : 8), G, N, K, bm, bk,
      bn, kMaxStages, &p);
  out[0] = p.kind; out[1] = p.geo.tile; out[2] = p.ntiles;
  out[3] = p.geo.fold; out[4] = p.geo.groups; out[5] = p.geo.b_mode;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16.  B is (G, K, N), out (G, gm*bm, N) in
// B's dtype; row_ptr (gm + 1), block_col (one a slot); bn the N tile,
// `stages` caps the ring (2 .. 4).
int maple_spmm_naive(const void* blocks, const int* row_ptr,
                     const int* block_col, const void* b, void* out,
                     int dtype, int G, int nb, int gm, int K, int N, int bm,
                     int bk, int bn, int stages, void* stream) {
  if (G == 0 || gm == 0 || N == 0) return (int)cudaSuccess;
  RunPlan p;
  cudaError_t err = plan_naive(dtype, b, G, N, K, bm, bk, bn, stages, &p);
  if (err != cudaSuccess) return (int)err;
  p.geo.n_runs = gm;
  p.geo.gm = gm;
  RunArgs a{};
  a.blocks = blocks; a.b = b; a.step_col = block_col; a.runs = row_ptr;
  a.out = out;
  const dim3 grid(kSeg * gm * p.geo.groups, p.ntiles, 1);
  return (int)launch_walk<kNaive>(a, p, dtype, nb, G, grid,
                                  (cudaStream_t)stream);
}

// The N tiles of a B1 / B4 launch and the floats of one partial (the B4
// scratch buffer holds G · ntiles · n_runs of them; its counters are
// G · ntiles · gm · 4 ints, zero between launches).
int maple_spmm_run_layout(int dtype, int N, int K, int bm, int bk, int bn,
                          int* ntiles, int* frag) {
  RunPlan p{};
  const cudaError_t err = plan_runs(dtype, nullptr, N, K, bm, bk, bn,
                                    kMaxStages, &p);
  *ntiles = p.ntiles;
  *frag = p.frag;
  return (int)err;
}

// order / step_col are (L, steps) flattened; runs (n_runs, 4); out is the
// f32 compact tile buffer (G, n_slots * bm, N) with n_slots = L * r_max;
// `stages` caps the ring (2 .. 4).
int maple_spmm_compact(const void* blocks, const int* order,
                       const int* step_col, const int* runs, const void* b,
                       float* out, int dtype, int G, int nb, int n_runs,
                       int steps, int n_slots, int K, int N, int bm, int bk,
                       int bn, int stages, void* stream) {
  if (G == 0 || n_runs == 0 || N == 0) return (int)cudaSuccess;
  RunPlan p;
  cudaError_t err = plan_runs(dtype, b, N, K, bm, bk, bn, stages, &p);
  if (err != cudaSuccess) return (int)err;
  p.geo.steps = steps;
  p.geo.n_runs = n_runs;
  p.geo.n_slots = n_slots;
  RunArgs a{};
  a.blocks = blocks; a.b = b; a.order = order; a.step_col = step_col;
  a.runs = runs; a.out = out;
  return (int)launch_walk<kCompact>(a, p, dtype, nb, G,
                                    dim3(kSeg * n_runs, p.ntiles, G),
                                    (cudaStream_t)stream);
}

// row_runs (n_runs, 4) sorted by block-row, row_run_ptr (gm + 1); out is
// the merged f32 result (G, gm * bm, N), every row written; scratch and
// counters as maple_spmm_run_layout sizes them.
int maple_spmm_planned(const void* blocks, const int* order,
                       const int* step_col, const int* row_runs,
                       const int* row_run_ptr, const void* b, float* out,
                       float* scratch, int* counters, int dtype, int G,
                       int nb, int gm, int n_runs, int steps, int K, int N,
                       int bm, int bk, int bn, int stages, void* stream) {
  if (G == 0 || gm == 0 || N == 0) return (int)cudaSuccess;
  RunPlan p;
  cudaError_t err = plan_runs(dtype, b, N, K, bm, bk, bn, stages, &p);
  if (err != cudaSuccess) return (int)err;
  p.geo.steps = steps;
  p.geo.n_runs = n_runs;
  p.geo.gm = gm;
  RunArgs a{};
  a.blocks = blocks; a.b = b; a.order = order; a.step_col = step_col;
  a.runs = row_runs; a.row_run_ptr = row_run_ptr; a.out = out;
  a.scratch = scratch; a.counters = counters;
  return (int)launch_walk<kPlanned>(
      a, p, dtype, nb, G, dim3(kSeg * (n_runs > 0 ? n_runs : 1), p.ntiles, G),
      (cudaStream_t)stream);
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
