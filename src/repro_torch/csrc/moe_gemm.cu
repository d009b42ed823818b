// MoE grouped GEMM for Hopper (sm_90a): y[t] = x[t] · w[expert(t)].
//
// Replaces repro/kernels/moe_gemm.py::moe_gemm_pallas (:57).  x is (T, D)
// with the tokens sorted by expert and each expert's segment padded to a
// multiple of the token tile bt; expert_of_tile (T / bt,) int32 names the
// expert that owns each tile; w is (E, D, F).  Every output element is an
// f32 sum over D, written once in x's dtype:
//
//   y[t, f] = Σ_d x[t, d] · w[expert_of_tile[t / bt], d, f]
//
// The TPU grid (T/bt, F/bf, D/bd) carries a (bt, bf) f32 PSB in VMEM
// across the sequential D steps.  Here one CTA owns one (token piece, 64
// columns of F) output tile and loops over D itself, 64 rows of D a stage
// (32 for f32 pieces of 32 tokens or more, kStageRows).
// A piece is the token tile, or 128 tokens of it where bt > 128: the
// smallest of 8, 16, 32, 64, 96 and 128 that covers bt (rows past the
// tile are multiplied but never written), so a piece never spans two
// experts and the CTA reads its expert id once.  An expert with no tile is
// never read (the Maple zero-block skip).  No atomics: every output
// element has one owner, and its sum runs over D in one fixed order.
//
// What bounds it on the H100: bytes, at granite-moe-3b's shapes in bf16
// (prefill, bt = 96: 94 MB, 28 µs against 7 µs of tensor-core work;
// decode, bt = 8: the experts' weights, 75 MB, for a few rows each) and at
// decode in f32; f32 operations at prefill (FFMA: 108 µs).  So each weight
// panel is read once per token piece, the F tiles of one piece run next
// to each other so that its x panel comes from L2, and the loads are kept
// in flight: one producer warp keeps a 48 KB ring of 2 to 8 stages full
// on mbarriers, up to 3 CTAs an SM, each stage x's (piece, rows) panel
// from a 2D tensor map over (T, D) and w's (rows, 64) panel from a 3D
// tensor map over (E, D, F), so
// that a box past D comes in as zeros where a 2D view (E·D, F) would
// bring expert e + 1's rows.  Where a row stride (D·size, F·size) is not a
// multiple of 16 bytes, the tensor maps cannot address the operands and
// the producer warp copies both panels itself into the same layouts.  The
// consumers are one warpgroup:
//   - bf16: wgmma with the product swapped, yᵀ = wᵀ · xᵀ, so that the
//     tokens are the instruction's N (8 at decode, 96 at prefill) and the
//     64 columns of F its M: A is w's panel, MN-major (the transpose bit),
//     B is x's panel, K-major, both with the 128-byte swizzle; a piece is
//     one or two atoms (n8, n32, n64), 4 k16 steps a stage;
//   - f32: the FFMA register tile of the run walk (up to 8 × 8 outputs a
//     thread, operands read as 4-wide vectors), no TF32, so that f32 keeps
//     IEEE products.
// The epilogue puts the tile in shared memory as (token, F) rows and
// writes y's rows 16 bytes a thread (8 for bf16), coalesced.  At these
// shapes bf16 runs at 2.2 TB/s, as torch.bmm does (PERF.md): no stage
// count, ring size or occupancy moved it (tools/spmm_walk/variants.py).
//
// The backward (dy the (T, F) gradient of y) runs on the same file:
//   - dx = dy · w[e]ᵀ on moe_kernel in its transposed-weight mode (kT):
//     F is the reduction and D the output columns, and w is read in place,
//     never copied transposed.  bf16 loads w's (64 D rows, 64 F) panel as
//     it lies in memory (TMA with the 128-byte swizzle, or the producer's
//     copies) and feeds it to wgmma K-major; f32 has the producer warp
//     write the panel transposed into the FFMA tile's (F rows, 64 D)
//     layout, lanes over D so that the stores do not conflict;
//   - dW[e] = Σ x_tileᵀ · dy_tile on moe_dw_kernel: one CTA per (expert,
//     64 rows of D, 64 columns of F) walks its expert's tiles in ascending
//     order and their rows in order, each element one f32 FFMA chain,
//     written once in the weights' dtype (zeros for an expert with no
//     tile).  No atomics: reruns are bit-identical.
//
// Plain C interface (bound with ctypes); the launchers return
// cudaGetLastError() right after the launch.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kFt = 64;                      // F columns of a CTA
constexpr int kOutLd = kFt + 4;              // floats a row of the out tile
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 48 * 1024;
constexpr int kPieces[6] = {8, 16, 32, 64, 96, 128};

struct MoeGeo {
  int T, D, F, bt;
  int piece, pieces;   // tokens a CTA; CTAs a token tile
  int ksteps;          // stages of D
  int tma;             // 1: tensor maps; 0: the producer copies the panels
  int stages, stage_bytes, ring_bytes;
  unsigned tx;
  // the stage as the consumers read it: x's panel at 0, (piece, bk), k
  // contiguous; w's at b_off, (bk, 64), n contiguous; out tile (piece, 64);
  // bk, the D rows of a stage (kStageRows)
  int bm, bk, tile, ldb, b_off;
};

// ---- the wgmma consumer (bf16), the product swapped: the accumulator is
// yᵀ's (64 F, P tokens) tile
// D rows of a stage: 64 for bf16 (4 wgmma k16 steps) and for f32 pieces
// under 32 tokens (decode: fewer, larger copies); 32 for f32 pieces of 32
// tokens or more, so that 3 CTAs share an SM
template <typename T, int P>
constexpr int kStageRows = sizeof(T) == 2 || P < 32 ? 64 : 32;

// kT (dx): the weight panel is (64 output columns, 64 of the reduction),
// K-major, addressed as x's panel is
template <int P, bool kT>
struct MoeWgmma {
  static constexpr int R = P / 2;
  static constexpr int TA = kT ? 0 : 1;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const MoeGeo& geo, int /*t*/, int /*cols*/) {
    const uint32_t x0 = smem_u32(stage), w0 = x0 + geo.b_off;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = wᵀ (64 F × 16 D): 16 D-rows of 128 bytes, MN-major (kT: w
      // itself, 64 D-rows of 128 bytes of F, K-major);
      // B = xᵀ (16 D × P): 32 bytes into each token's 128-byte row,
      // K-major, an atom of tokens o .. at o·128 bytes
      const uint64_t da = kT ? gmma_desc(w0 + 32 * kk, 16)
                             : gmma_desc(w0 + 2048 * kk, 1024);
      const uint32_t xb = x0 + 32 * kk;
      if constexpr (P >= 64) wgmma_n64<TA, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P == 128)
        wgmma_n64<TA, 0, 32>(acc, da, gmma_desc(xb + 8192, 16));
      if constexpr (P == 96)
        wgmma_n32<TA, 0, 32>(acc, da, gmma_desc(xb + 8192, 16));
      if constexpr (P == 32) wgmma_n32<TA, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P <= 16) wgmma_n8<TA, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P == 16)
        wgmma_n8<TA, 0, 4>(acc, da, gmma_desc(xb + 1024, 16));
    }
    wgmma_commit_wait();
  }

  // register i of thread t: (token, F column) of the tile
  __device__ static bool at(int i, const MoeGeo& /*geo*/, int t, int& tok,
                            int& f) {
    wgmma_at(i, t, f, tok);
    return true;
  }
};

// rows × W elements at dst (row r at r·W·size bytes; for bf16, W = 64,
// with the 128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)),
// element (r, j) = src[r·ld + j] where r < rows_ok and j < cols_ok, else 0
template <typename T, int W>
__device__ __forceinline__ void copy_panel(unsigned char* dst,
                                           const T* __restrict__ src,
                                           int64_t ld, int rows, int rows_ok,
                                           int cols_ok, int lane) {
  constexpr int E = 16 / sizeof(T), cpr = W / E;
  for (int idx = lane; idx < rows * cpr; idx += 32) {
    const int r = idx / cpr, c = idx % cpr;
    __align__(16) T v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = c * E + e;
      v[e] = r < rows_ok && j < cols_ok ? src[(int64_t)r * ld + j]
                                        : from_f32<T>(0.0f);
    }
    const int cc = sizeof(T) == 2 ? c ^ (r & 7) : c;
    *reinterpret_cast<uint4*>(dst + r * W * sizeof(T) + cc * 16) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// f32 w's (64 D rows, KC of F) panel transposed into KC rows of 64 (D
// contiguous): element (k, n) = src[n·ld + k] where k < k_ok and
// n < n_ok, else 0.  Lanes take consecutive n, so that the stores hit 32
// banks; each reads a 4-wide run of k where the row allows it, kUnroll
// loads in flight before it stores.
template <int KC>
__device__ __forceinline__ void copy_panel_t(unsigned char* dst,
                                             const float* __restrict__ src,
                                             int64_t ld, int k_ok, int n_ok,
                                             int lane) {
  constexpr int kTotal = KC / 4 * kFt;       // 4-wide runs of the panel
  float* out = reinterpret_cast<float*>(dst);
  const bool vec = ld % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int base = lane; base < kTotal; base += 32 * kUnroll) {
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + 32 * u, n = idx % kFt, k = idx / kFt * 4;
      const float* p = src + (int64_t)n * ld + k;
      const bool row = idx < kTotal && n < n_ok;
      if (row && vec && k + 3 < k_ok) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = row && k + j < k_ok ? p[j] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + 32 * u, n = idx % kFt, k = idx / kFt * 4;
      if (idx < kTotal)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[(k + j) * kFt + n] = v[u][j];
    }
  }
}

// grid: (ceil(F / 64), T / bt · pieces); F tiles of one piece next to
// each other.  In the transposed-weight mode (kT) D is the reduction
// (w's F) and F the output columns (w's D): w is (E, F, D) to the kernel.
template <typename T, class Tile, int KC, bool kT>
__global__ void __launch_bounds__(kThreads, 3)
moe_kernel(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap w_map,
           const T* __restrict__ x, const int* __restrict__ eot,
           const T* __restrict__ w, T* __restrict__ y, MoeGeo geo) {
  constexpr int R = Tile::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + geo.ring_bytes);
  uint64_t* empty = full + kMaxStages;
  const int t = threadIdx.x;
  const int f0 = blockIdx.x * kFt;
  const int tile = blockIdx.y / geo.pieces;
  const int tok0 = tile * geo.bt + blockIdx.y % geo.pieces * geo.piece;
  const int rows = min(geo.piece, (tile + 1) * geo.bt - tok0);
  const int64_t e = eot[tile];

  if (t == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 32);             // every producer lane arrives
      mbar_init(&empty[s], kConsumers / 32);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= kConsumers) {
    // ---- producer warp
    const int lane = t - kConsumers;
    for (int it = 0; it < geo.ksteps; ++it) {
      const int st = it % geo.stages, d0 = it * KC;
      mbar_wait(&empty[st], ((it / geo.stages) & 1) ^ 1);
      unsigned char* stage = ring + st * geo.stage_bytes;
      if (geo.tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[st], geo.tx);
          tma_2d(stage, &x_map, d0, tok0, &full[st]);
          if (kT)
            tma_3d(stage + geo.b_off, &w_map, d0, f0, (int)e, &full[st]);
          else
            tma_3d(stage + geo.b_off, &w_map, f0, d0, (int)e, &full[st]);
        }
      } else {
        copy_panel<T, KC>(stage, x + (int64_t)tok0 * geo.D + d0, geo.D,
                          geo.piece, geo.T - tok0, geo.D - d0, lane);
        if constexpr (!kT)
          copy_panel<T, kFt>(stage + geo.b_off,
                             w + (e * geo.D + d0) * geo.F + f0, geo.F, KC,
                             geo.D - d0, geo.F - f0, lane);
        else if constexpr (sizeof(T) == 2)
          copy_panel<T, KC>(stage + geo.b_off,
                            w + (e * geo.F + f0) * geo.D + d0, geo.D, kFt,
                            geo.F - f0, geo.D - d0, lane);
        else
          copy_panel_t<KC>(stage + geo.b_off,
                           w + (e * geo.F + f0) * geo.D + d0, geo.D,
                           geo.D - d0, geo.F - f0, lane);
        fence_async_smem();
      }
      mbar_arrive(&full[st]);
    }
    return;
  }
  // ---- consumer warpgroup
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int it = 0; it < geo.ksteps; ++it) {
    const int st = it % geo.stages;
    mbar_wait(&full[st], (it / geo.stages) & 1);
    __syncwarp();
    Tile::step(acc, ring + st * geo.stage_bytes, geo, t, 0);
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&empty[st]);
  }
  consumer_sync();                           // the ring is free
  float* out_s = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int r, c;
    if (Tile::at(i, geo, t, r, c)) out_s[r * kOutLd + c] = acc[i];
  }
  consumer_sync();
  constexpr int cpr = kFt / 4;               // 4-column chunks a row
  const bool vec = geo.F % 4 == 0;
  for (int idx = t; idx < rows * cpr; idx += kConsumers) {
    const int r = idx / cpr, q = idx % cpr, f = f0 + 4 * q;
    const float4 v = *reinterpret_cast<const float4*>(out_s + r * kOutLd +
                                                      4 * q);
    T* dst = y + (int64_t)(tok0 + r) * geo.F + f;
    __align__(16) T o[4] = {from_f32<T>(v.x), from_f32<T>(v.y),
                            from_f32<T>(v.z), from_f32<T>(v.w)};
    if (vec && f + 3 < geo.F) {
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f + j < geo.F) dst[j] = o[j];
    }
  }
}

// ---- host side

int pick_piece(int bt) {
  for (int p : kPieces)
    if (p >= bt) return p;
  return 128;
}

// Everything a launch needs, from the shapes alone.  D is the reduction
// and F the output columns (trans: w's F and D); f32 in the
// transposed-weight mode takes the producer's copies.
cudaError_t plan_moe(int dtype, const void* x, const void* w, int T, int D,
                     int F, int bt, int trans, MoeGeo* g, size_t* smem) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (bt <= 0 || bt % 8 || T % bt) return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  *g = MoeGeo{};
  g->T = T; g->D = D; g->F = F; g->bt = bt;
  g->piece = pick_piece(bt);
  g->pieces = (bt + g->piece - 1) / g->piece;
  const int kc = dtype || g->piece < 32 ? 64 : 32;     // kStageRows
  g->ksteps = (D + kc - 1) / kc;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  g->tma = D > 0 && (D * isz) % 16 == 0 && (F * isz) % 16 == 0 && al(x) &&
           al(w) && !(trans && dtype == 0);
  const int x_bytes = g->piece * kc * isz, w_bytes = kc * kFt * isz;
  g->bm = g->piece; g->bk = kc; g->tile = kFt; g->ldb = kFt;
  g->b_off = x_bytes;
  g->stage_bytes = x_bytes + w_bytes;        // a multiple of 1024
  g->stages = kRingBudget / g->stage_bytes;
  if (g->stages > kMaxStages) g->stages = kMaxStages;
  if (g->stages < 2) g->stages = 2;
  g->tx = x_bytes + w_bytes;
  const int out_tile = g->piece * kOutLd * 4;
  g->ring_bytes = g->stages * g->stage_bytes;
  if (g->ring_bytes < out_tile) g->ring_bytes = (out_tile + 1023) / 1024 * 1024;
  *smem = 1024 + g->ring_bytes + 2 * kMaxStages * 8;
  if ((int64_t)(T / bt) * g->pieces > 65535) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <typename T, class Tile, int P, bool kT>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& wm, const void* x,
                   const int* eot, const void* w, void* y, const MoeGeo& g,
                   size_t smem, cudaStream_t st) {
  auto kernel = moe_kernel<T, Tile, kStageRows<T, P>, kT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.F + kFt - 1) / kFt, g.T / g.bt * g.pieces);
  kernel<<<grid, kThreads, smem, st>>>(xm, wm, (const T*)x, eot, (const T*)w,
                                       (T*)y, g);
  return cudaGetLastError();
}

template <int P>
using FfmaFor = FfmaTile<float, kTiles[ffma_tile(P, kFt)][0],
                         kTiles[ffma_tile(P, kFt)][1]>;

template <int P, bool kT>
cudaError_t launch_mode(int dtype, const CUtensorMap& xm,
                        const CUtensorMap& wm, const void* x, const int* eot,
                        const void* w, void* y, const MoeGeo& g, size_t smem,
                        cudaStream_t st) {
  if (dtype == 1)
    return launch<__nv_bfloat16, MoeWgmma<P, kT>, P, kT>(xm, wm, x, eot, w, y,
                                                         g, smem, st);
  return launch<float, FfmaFor<P>, P, kT>(xm, wm, x, eot, w, y, g, smem, st);
}

template <int P>
cudaError_t launch_piece(int dtype, int trans, const CUtensorMap& xm,
                         const CUtensorMap& wm, const void* x, const int* eot,
                         const void* w, void* y, const MoeGeo& g, size_t smem,
                         cudaStream_t st) {
  if (trans)
    return launch_mode<P, true>(dtype, xm, wm, x, eot, w, y, g, smem, st);
  return launch_mode<P, false>(dtype, xm, wm, x, eot, w, y, g, smem, st);
}

// x (T, K) times w's panels: out (T, N), K the reduction; w is (E, K, N),
// or (E, N, K) with trans.  The forward and dx launches both end here.
cudaError_t run_moe(const void* x, const int* eot, const void* w, void* y,
                    int dtype, int T, int K, int N, int E, int bt, int trans,
                    cudaStream_t st) {
  if (bt <= 0 || bt % 8 || T % bt) return cudaErrorInvalidValue;
  if (T == 0 || N == 0) return cudaSuccess;
  MoeGeo g;
  size_t smem = 0;
  cudaError_t err = plan_moe(dtype, x, w, T, K, N, bt, trans, &g, &smem);
  if (err != cudaSuccess) return err;
  CUtensorMap xm, wm;
  memset(&xm, 0, sizeof(xm));
  memset(&wm, 0, sizeof(wm));
  const int isz = dtype ? 2 : 4;
  const bool swz = dtype == 1;
  if (g.tma) {
    // w's dims innermost first: (N, K, E), or (K, N, E) with trans; the
    // box is (64 of N, bk of K), or (bk of K, 64 of N)
    const uint64_t inner = trans ? K : N, outer = trans ? N : K;
    const uint64_t wd[3] = {inner, outer, (uint64_t)E};
    const uint64_t ws[2] = {inner * isz, (uint64_t)K * N * isz};
    const uint32_t wb[3] = {trans ? (uint32_t)g.bk : (uint32_t)kFt,
                            trans ? (uint32_t)kFt : (uint32_t)g.bk, 1};
    if (!encode_2d(&xm, dtype, x, K, T, (uint64_t)K * isz, g.bk, g.piece,
                   swz) ||
        !encode_map(&wm, dtype, w, 3, wd, ws, wb, swz))
      return cudaErrorInvalidValue;
  }
  switch (g.piece) {
    case 8: return launch_piece<8>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    case 16: return launch_piece<16>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    case 32: return launch_piece<32>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    case 64: return launch_piece<64>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    case 96: return launch_piece<96>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    case 128: return launch_piece<128>(dtype, trans, xm, wm, x, eot, w, y, g, smem, st);
    default: return cudaErrorInvalidConfiguration;
  }
}

// ---- dW
constexpr int kDwTile = 64;       // rows of D and columns of F a CTA owns
constexpr int kDwRows = 32;       // token rows a stage
constexpr int kDwThreads = 256;   // 16 × 16 threads, 4 × 4 outputs each

// grid: (ceil(F / 64), ceil(D / 64), E).  Thread (ty, tx) owns rows
// 4·ty .. of D and columns 4·tx .. of F; a stage holds kDwRows token rows
// of x's and dy's panels in f32, and each row adds its outer product to
// the accumulators in row order.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
moe_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const int* __restrict__ eot, T* __restrict__ dw, int D, int F,
              int bt, int n_tiles) {
  __shared__ __align__(16) float xs[kDwRows][kDwTile];
  __shared__ __align__(16) float gs[kDwRows][kDwTile];
  const int f0 = blockIdx.x * kDwTile, d0 = blockIdx.y * kDwTile;
  const int e = blockIdx.z, t = threadIdx.x, tx = t % 16, ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (eot[tile] != e) continue;            // the same for every thread
    const int end = (tile + 1) * bt;
    for (int r0 = tile * bt; r0 < end; r0 += kDwRows) {
      const int rows = min(kDwRows, end - r0);
      __syncthreads();                       // the last stage is consumed
      for (int idx = t; idx < rows * kDwTile; idx += kDwThreads) {
        const int r = idx / kDwTile, c = idx % kDwTile;
        const int64_t row = r0 + r;
        xs[r][c] = d0 + c < D ? to_f32(x[row * D + d0 + c]) : 0.0f;
        gs[r][c] = f0 + c < F ? to_f32(dy[row * F + f0 + c]) : 0.0f;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[r][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&gs[r][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + 4 * ty + i;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + 4 * tx + j;
      if (f < F) dw[((int64_t)e * D + d) * F + f] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// The layout of a launch: out[0..5) = token piece, pieces a tile, 1 for
// tensor maps (0: the producer copies), stages, F tiles; `aligned` stands
// for x's and w's pointers.
int maple_moe_layout(int dtype, int T, int D, int F, int bt, int aligned,
                     int* out) {
  MoeGeo g;
  size_t smem = 0;
  const void* p = reinterpret_cast<const void*>(aligned ? 0 : 8);
  const cudaError_t err = plan_moe(dtype, p, p, T, D, F, bt, 0, &g, &smem);
  out[0] = g.piece; out[1] = g.pieces; out[2] = g.tma; out[3] = g.stages;
  out[4] = (F + kFt - 1) / kFt;
  return (int)err;
}

// The same for dx over w (E, D, F): out[4] = the tiles of D.
int maple_moe_layout_dx(int dtype, int T, int D, int F, int bt, int aligned,
                        int* out) {
  MoeGeo g;
  size_t smem = 0;
  const void* p = reinterpret_cast<const void*>(aligned ? 0 : 8);
  const cudaError_t err = plan_moe(dtype, p, p, T, F, D, bt, 1, &g, &smem);
  out[0] = g.piece; out[1] = g.pieces; out[2] = g.tma; out[3] = g.stages;
  out[4] = (D + kFt - 1) / kFt;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y alike).  bt is a positive
// multiple of 8 that divides T; expert_of_tile holds T / bt ids in
// [0, E); w is (E, D, F).
int maple_moe_gemm(const void* x, const int* expert_of_tile, const void* w,
                   void* y, int dtype, int T_rows, int D, int F, int E,
                   int bt, void* stream) {
  return (int)run_moe(x, expert_of_tile, w, y, dtype, T_rows, D, F, E, bt, 0,
                      (cudaStream_t)stream);
}

// dx (T, D) = dy (T, F) · w[expert]ᵀ, w (E, D, F) read in place.
int maple_moe_gemm_dx(const void* dy, const int* expert_of_tile,
                      const void* w, void* dx, int dtype, int T_rows, int D,
                      int F, int E, int bt, void* stream) {
  return (int)run_moe(dy, expert_of_tile, w, dx, dtype, T_rows, F, D, E, bt, 1,
                      (cudaStream_t)stream);
}

// dw (E, D, F) = Σ over expert e's tiles of x_tileᵀ · dy_tile; x (T, D),
// dy (T, F); bt divides T.
int maple_moe_dw(const void* x, const void* dy, const int* expert_of_tile,
                 void* dw, int dtype, int T_rows, int D, int F, int E, int bt,
                 void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (bt <= 0 || T_rows % bt) return (int)cudaErrorInvalidValue;
  if (D == 0 || F == 0 || E == 0) return (int)cudaSuccess;
  const dim3 grid((F + kDwTile - 1) / kDwTile, (D + kDwTile - 1) / kDwTile, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = T_rows / bt;
  if (dtype == 1)
    moe_dw_kernel<__nv_bfloat16><<<grid, kDwThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, expert_of_tile,
        (__nv_bfloat16*)dw, D, F, bt, n_tiles);
  else
    moe_dw_kernel<float><<<grid, kDwThreads, 0, st>>>(
        (const float*)x, (const float*)dy, expert_of_tile, (float*)dw, D, F,
        bt, n_tiles);
  return (int)cudaGetLastError();
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
