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
//     never copied transposed.  w's (64 D rows, kc of F) panel comes as it
//     lies in memory, by TMA with the 128-byte swizzle (or the producer's
//     copies into the same layout), beside dy's (piece, kc) panel laid out
//     alike: bf16 (kc 64) feeds both to wgmma K-major; f32 (kc 32, one
//     128-byte row) multiplies on the k-major FFMA tile (hopper.cuh
//     FfmaTileK), whose operands both have their rows along the reduction;
//   - dW[e] = Σ x_tileᵀ · dy_tile on moe_dw_kernel (below).
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
// tokens or more, so that 3 CTAs share an SM, and for f32 dx at every
// piece (one swizzled 128-byte row)
template <typename T, int P, bool kT>
constexpr int kStageRows = sizeof(T) == 2 ? 64 : kT || P >= 32 ? 32 : 64;

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

// f32 dx: the k-major FFMA tile with its geometry fixed at compile time
// and two quads a loop turn.  A is dy's (P tokens, 32 of F) panel, B is
// w's (64 D rows, 32 of F) panel, each row 128 bytes swizzled as the TMA
// lays it out; thread (ty, tx) holds tokens ty + i·ty_n and D columns
// tx + j·tx_n.
template <int P>
struct MoeFfmaK {
  static constexpr int kTile = ffma_tile(P, kFt);
  using Tile = FfmaTileK<float, kTiles[kTile][0], kTiles[kTile][1], P, kFt,
                         128, 2>;
  static constexpr int R = Tile::R;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const MoeGeo& geo, int t, int /*cols*/) {
    Tile::step(acc, stage, stage + geo.b_off, P, kFt, 128, true, 8, t);
  }

  __device__ static bool at(int i, const MoeGeo& /*geo*/, int t, int& r,
                            int& c) {
    return Tile::at(i, P, kFt, t, r, c);
  }
};

// rows × W elements at dst (row r at r·W·size bytes; with kSwz, rows of
// 128 bytes with the 128-byte swizzle: 16-byte chunk c of row r at chunk
// c ^ (r % 8)), element (r, j) = src[r·ld + j] where r < rows_ok and
// j < cols_ok, else 0
template <typename T, int W, bool kSwz = sizeof(T) == 2>
__device__ __forceinline__ void copy_panel(unsigned char* dst,
                                           const T* __restrict__ src,
                                           int64_t ld, int rows, int rows_ok,
                                           int cols_ok, int lane) {
  constexpr int E = 16 / sizeof(T), cpr = W / E;
  static_assert(!kSwz || W * sizeof(T) == 128, "a swizzled row is 128 bytes");
  for (int idx = lane; idx < rows * cpr; idx += 32) {
    const int r = idx / cpr, c = idx % cpr;
    __align__(16) T v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = c * E + e;
      v[e] = r < rows_ok && j < cols_ok ? src[(int64_t)r * ld + j]
                                        : from_f32<T>(0.0f);
    }
    const int cc = kSwz ? c ^ (r & 7) : c;
    *reinterpret_cast<uint4*>(dst + r * W * sizeof(T) + cc * 16) =
        *reinterpret_cast<const uint4*>(v);
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
        // kT: both panels k-major in swizzled 128-byte rows, as the TMA
        // brings them
        copy_panel<T, KC, sizeof(T) == 2 || kT>(
            stage, x + (int64_t)tok0 * geo.D + d0, geo.D, geo.piece,
            geo.T - tok0, geo.D - d0, lane);
        if constexpr (!kT)
          copy_panel<T, kFt>(stage + geo.b_off,
                             w + (e * geo.D + d0) * geo.F + f0, geo.F, KC,
                             geo.D - d0, geo.F - f0, lane);
        else
          copy_panel<T, KC, true>(stage + geo.b_off,
                                  w + (e * geo.F + f0) * geo.D + d0, geo.D,
                                  kFt, geo.F - f0, geo.D - d0, lane);
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
// transposed-weight mode stages 32 of the reduction (one swizzled 128-byte
// row) at every piece.
cudaError_t plan_moe(int dtype, const void* x, const void* w, int T, int D,
                     int F, int bt, int trans, MoeGeo* g, size_t* smem) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (bt <= 0 || bt % 8 || T % bt) return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  *g = MoeGeo{};
  g->T = T; g->D = D; g->F = F; g->bt = bt;
  g->piece = pick_piece(bt);
  g->pieces = (bt + g->piece - 1) / g->piece;
  const int kc = dtype ? 64 : trans || g->piece >= 32 ? 32 : 64; // kStageRows
  g->ksteps = (D + kc - 1) / kc;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  g->tma = D > 0 && (D * isz) % 16 == 0 && (F * isz) % 16 == 0 && al(x) &&
           al(w);
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
  auto kernel = moe_kernel<T, Tile, kStageRows<T, P, kT>, kT>;
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
  if constexpr (kT)
    return launch<float, MoeFfmaK<P>, P, kT>(xm, wm, x, eot, w, y, g, smem,
                                             st);
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

// Bind this thread's context with cudaFree(nullptr), which stream capture
// refuses.  A stream under capture was begun where the context is bound
// (a CUDA graph of a serving step), so a captured launch skips the call.
cudaError_t bind_context(cudaStream_t st) {
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  const cudaError_t err = cudaStreamIsCapturing(st, &capturing);
  if (err != cudaSuccess) return err;
  return capturing == cudaStreamCaptureStatusNone ? cudaFree(nullptr)
                                                  : cudaSuccess;
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
  const bool swz = dtype == 1 || trans;      // f32 dx: the k-major tile
  if (g.tma) {
    // cuTensorMapEncodeTiled needs this thread's context: bind it first
    // (an autograd worker's first CUDA call can be this launch)
    if ((err = bind_context(st)) != cudaSuccess) return err;
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

// ---- dW[e] (D, F) = Σ over expert e's tiles of x_tileᵀ · dy_tile
//
// No TPU kernel: the reference trains its MoE layer through einsum
// (repro/models/moe.py:97-100), whose gradient XLA computes.  x is (T, D)
// and dy (T, F), tiles of bt token rows, tile i owned by expert
// expert_of_tile[i]; dW is (E, D, F) in x's dtype.
//
// What bounds it on the H100.  At granite-moe-3b's training shapes (E 48,
// one tile of 56 rows an expert, D 1 536 and F 512 or the reverse) the
// reduction is only 56 rows deep: f32 does 2·T·D·F = 4.2 GFLOPs (63 µs on
// FFMA) and writes 151 MB (45 µs), bf16 on the tensor cores is bound by
// writing its 75 MB (22 µs).  So the kernel keeps the loads, the products
// and the stores of dW in flight at once:
//   - Persistent CTAs, as many as the card holds at once, walk
//     the (expert, 64 rows of D, 128 columns of F) output tiles, expert
//     outermost, so that an expert's rows are read from L2 by all its
//     tiles at about the same time.
//   - One producer warp keeps a ring of 2 to 4 stages full on mbarriers:
//     a stage is kr token rows of one tile (bf16 up to 64, a multiple of
//     16; f32 up to 24, a multiple of 8), x's (kr, 64) panel and dy's
//     (kr, 128) panel as they lie in memory, by TMA boxes of 3D tensor
//     maps over x and dy viewed as (T / bt, bt, ·): a box that runs past
//     the tile's bt rows (granite's 56, a tile of 8) comes in as zeros,
//     not as the next expert's rows.  Where D·size or F·size is not a
//     multiple of 16 bytes, the producer's own copies write the same
//     layout with the same zeros.  It walks expert e's tiles in ascending
//     order (a ballot over expert_of_tile, whose first 128 entries each
//     warp holds in registers) and each tile's rows in order.
//   - bf16 multiplies on wgmma: A = x_tileᵀ (64 D, k16) and B = dy_tile
//     (k16, 64 F) are both MN-major (the transpose bits) in 128-byte rows
//     with the 128-byte swizzle, two n64 atoms a k16 step, f32 in
//     registers; f32 on FFMA, an 8 × 8 register tile a thread (two float4
//     of x's row and two of dy's row per token: 64 FFMAs for 4 shared
//     loads), IEEE products, no TF32, rows past the tile skipped.  Each
//     f32 element is one FFMA chain over the expert's rows in ascending
//     tile and row order.
//   - The tile is rounded once to the weights' dtype into a shared-memory
//     buffer (bf16 one of two) and leaves by TMA stores (a 3D map over
//     (E, D, F): nothing past D or F is written), which overlap the next
//     tile's products; with the producer's copies, the threads store it.
//     bf16 takes 2 CTAs an SM, f32 (bound by its FFMAs) 3.
// An expert with no tile gets zeros.  No atomics: reruns are bit-identical.

constexpr int kDwD = 64;           // D rows of a tile (wgmma's M)
constexpr int kDwF = 128;          // F columns of a tile (two n64 atoms)
constexpr int kDwMaxStages = 4;
constexpr int kDwMaxOut = 2;
// a CTA's ring and out buffers: bf16 2 CTAs an SM, f32 (bound by its
// FFMAs) 3
constexpr int kDwBudgetBf16 = 112 * 1024;
constexpr int kDwBudgetF32 = 72 * 1024;

struct DwGeo {
  int D, F, bt, n_tiles;
  int kr;            // token rows a stage
  int spt;           // stages a token tile
  int d_tiles, f_tiles, items;
  int tma;           // 1: tensor maps; 0: the threads' own copies
  int stages, stage_bytes, b_off;   // x's (kr, 64) at 0, dy's (kr, 128)
  int out_bufs, out_bytes, out_off; // (64, 128) tiles in x's dtype
  uint32_t tx;
};

// expert_of_tile as a warp reads it, in words of 32 tiles (lane l: tile
// 32·w + l): the first kEotHeld words are held in registers, read once,
// so that finding an expert's tiles takes no load on the path of each
// output tile; later words are read when asked.
constexpr int kEotHeld = 4;

struct EotWords {
  int held[kEotHeld];

  __device__ EotWords(const int* __restrict__ eot, int n_tiles, int lane) {
#pragma unroll
    for (int k = 0; k < kEotHeld; ++k)
      held[k] = 32 * k + lane < n_tiles ? eot[32 * k + lane] : -1;
  }

  // bit l: tile 32·w + l belongs to expert e
  __device__ unsigned match(const int* __restrict__ eot, int n_tiles, int w,
                            int e, int lane) const {
    int v = -1;
    if (w < kEotHeld) {
#pragma unroll
      for (int k = 0; k < kEotHeld; ++k)
        if (k == w) v = held[k];
    } else if (32 * w + lane < n_tiles) {
      v = eot[32 * w + lane];
    }
    return __ballot_sync(0xffffffffu, v == e);
  }
};

// output tile `item`: expert e, rows d0 .. of D, columns f0 .. of F
__device__ __forceinline__ void dw_item(const DwGeo& g, int item, int& e,
                                        int& d0, int& f0) {
  const int rest = item / g.f_tiles;
  f0 = (item % g.f_tiles) * kDwF;
  d0 = (rest % g.d_tiles) * kDwD;
  e = rest / g.d_tiles;
}

// bf16: D(64 D × 128 F) += x_tileᵀ (64 × 16) · dy_tile (16 × 128), both
// MN-major: 16 token rows of 128 bytes a k16 step, 8-row groups 1 KB
// apart; dy's panel is two (kr, 64) sub-panels, one an n64 atom
struct DwWgmma {
  static constexpr int R = 64;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const DwGeo& geo, int live, int /*t*/) {
    const uint32_t x0 = smem_u32(stage), g0 = x0 + geo.b_off;
    const uint32_t g1 = g0 + geo.kr * 128;
    const int ks = (live + 15) / 16;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < ks) {
        const uint64_t da = gmma_desc(x0 + 2048 * kk, 1024);
        wgmma_n64<1, 1, 0>(acc, da, gmma_desc(g0 + 2048 * kk, 1024));
        wgmma_n64<1, 1, 32>(acc, da, gmma_desc(g1 + 2048 * kk, 1024));
      }
    wgmma_commit_wait();
  }

  // the tile in bf16 as two (64, 64) boxes of 128-byte rows, swizzled
  __device__ static int offset(int r, int c) {
    const int cc = c % 64;
    return (c / 64) * kDwD * 128 + r * 128 + (((cc / 8) ^ (r & 7)) << 4) +
           (cc % 8) * 2;
  }

  __device__ static void put(const float (&acc)[R], unsigned char* out,
                             int t) {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      int r, c;
      wgmma_at(i, t, r, c);
      *reinterpret_cast<__nv_bfloat162*>(out + offset(r, c)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }

  __device__ static void store(const CUtensorMap* map,
                               const unsigned char* out, const DwGeo& geo,
                               int e, int d0, int f0) {
    tma_store_3d(map, out, f0, d0, e);
    if (f0 + 64 < geo.F) tma_store_3d(map, out + kDwD * 128, f0 + 64, d0, e);
  }

  // the 16-byte unit u (columns 8·u ..) of row r
  __device__ static const unsigned char* unit(const unsigned char* out,
                                              int r, int u) {
    return out + offset(r, 8 * u);
  }
};

// f32: thread (ty, tx) = (t / 16, t % 16) holds D rows 4·ty + i % 4 +
// 32·(i / 4) and F columns 4·tx + j % 4 + 64·(j / 4), i, j < 8; each token
// row adds the outer product of two float4 pairs (x's row broadcast over
// a half warp, dy's row read 256 contiguous bytes a half warp)
struct DwFfma {
  static constexpr int R = 64;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const DwGeo& geo, int live, int t) {
    const float* xs = reinterpret_cast<const float*>(stage) + 4 * (t / 16);
    const float* gs =
        reinterpret_cast<const float*>(stage + geo.b_off) + 4 * (t % 16);
#pragma unroll 2
    for (int k = 0; k < live; ++k) {
      float a[8], b[8];
      Vec4<float>::unpack(*reinterpret_cast<const float4*>(xs + k * kDwD), a);
      Vec4<float>::unpack(
          *reinterpret_cast<const float4*>(xs + k * kDwD + 32), a + 4);
      Vec4<float>::unpack(*reinterpret_cast<const float4*>(gs + k * kDwF), b);
      Vec4<float>::unpack(
          *reinterpret_cast<const float4*>(gs + k * kDwF + 64), b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
    }
  }

  // the tile in f32 as one (64, 128) box of 512-byte rows
  __device__ static void put(const float (&acc)[R], unsigned char* out,
                             int t) {
    float* o = reinterpret_cast<float*>(out);
    const int tx = t % 16, ty = t / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* v = acc + i * 8 + 4 * h;
        *reinterpret_cast<float4*>(
            o + (4 * ty + i % 4 + 32 * (i / 4)) * kDwF + 4 * tx + 64 * h) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
  }

  __device__ static void store(const CUtensorMap* map,
                               const unsigned char* out, const DwGeo& /*geo*/,
                               int e, int d0, int f0) {
    tma_store_3d(map, out, f0, d0, e);
  }

  // the 16-byte unit u (columns 4·u ..) of row r
  __device__ static const unsigned char* unit(const unsigned char* out,
                                              int r, int u) {
    return out + r * kDwF * 4 + 16 * u;
  }
};

// The tile from shared memory by the consumer threads, 16 bytes a
// thread, 16 (f32 32) threads a row; rows past D and columns past F left
// out.
template <typename T, class Tile>
__device__ __forceinline__ void store_tile(const unsigned char* out,
                                           T* __restrict__ dw,
                                           const DwGeo& geo, int e, int d0,
                                           int f0, int t) {
  constexpr int E = 16 / sizeof(T), units = kDwF / E;
  const bool vec = (geo.F * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  for (int idx = t; idx < kDwD * units; idx += kConsumers) {
    const int r = idx / units, u = idx % units, f = f0 + u * E;
    if (d0 + r >= geo.D || f >= geo.F) continue;
    T* dst = dw + ((int64_t)e * geo.D + d0 + r) * geo.F + f;
    const uint4 v = *reinterpret_cast<const uint4*>(Tile::unit(out, r, u));
    if (vec && f + E <= geo.F) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const T* el = reinterpret_cast<const T*>(&v);
      for (int j = 0; j < E && f + j < geo.F; ++j) dst[j] = el[j];
    }
  }
}

// grid: persistent, CTA x takes output tiles x, x + gridDim.x, ...;
// threads 0 .. 127 consume, 128 .. 159 produce
template <typename T, class Tile>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 3)
moe_dw_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap dy_map,
              const __grid_constant__ CUtensorMap dw_map,
              const T* __restrict__ x, const T* __restrict__ dy,
              const int* __restrict__ eot, T* __restrict__ dw, DwGeo geo) {
  constexpr int R = Tile::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + geo.out_off + geo.out_bufs * geo.out_bytes);
  uint64_t* empty = full + kDwMaxStages;
  const int t = threadIdx.x, lane = t & 31;

  if (t == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 32);               // every producer lane arrives
      mbar_init(&empty[s], kConsumers / 32); // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= kConsumers) {
    // ---- producer warp: each tile of expert e, in ascending order
    const EotWords words(eot, geo.n_tiles, lane);
    int it = 0;
    for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
      int e, d0, f0;
      dw_item(geo, item, e, d0, f0);
      for (int w = 0; 32 * w < geo.n_tiles; ++w) {
        unsigned mine = words.match(eot, geo.n_tiles, w, e, lane);
        while (mine) {
          const int tile = 32 * w + __ffs(mine) - 1;
          mine &= mine - 1;
          for (int s = 0; s < geo.spt; ++s, ++it) {
            const int st = it % geo.stages, r0 = s * geo.kr;
            mbar_wait(&empty[st], ((it / geo.stages) & 1) ^ 1);
            unsigned char* stage = smem + st * geo.stage_bytes;
            unsigned char* gst = stage + geo.b_off;
            if (geo.tma) {
              if (lane == 0) {
                mbar_expect_tx(&full[st], geo.tx);
                tma_3d(stage, &x_map, d0, r0, tile, &full[st]);
                tma_3d(gst, &dy_map, f0, r0, tile, &full[st]);
                if constexpr (sizeof(T) == 2)
                  tma_3d(gst + geo.kr * 128, &dy_map, f0 + 64, r0, tile,
                         &full[st]);
              }
            } else {
              const int64_t row = (int64_t)tile * geo.bt + r0;
              const int rows_ok = min(geo.kr, geo.bt - r0);
              copy_panel<T, kDwD>(stage, x + row * geo.D + d0, geo.D,
                                  geo.kr, rows_ok, geo.D - d0, lane);
              const T* g = dy + row * geo.F + f0;
              if constexpr (sizeof(T) == 2) {
                copy_panel<T, 64>(gst, g, geo.F, geo.kr, rows_ok,
                                  geo.F - f0, lane);
                copy_panel<T, 64>(gst + geo.kr * 128, g + 64, geo.F, geo.kr,
                                  rows_ok, geo.F - f0 - 64, lane);
              } else {
                copy_panel<T, kDwF>(gst, g, geo.F, geo.kr, rows_ok,
                                    geo.F - f0, lane);
              }
              fence_async_smem();
            }
            mbar_arrive(&full[st]);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const EotWords words(eot, geo.n_tiles, lane);
  int it = 0, ob = 0;
  for (int item = blockIdx.x; item < geo.items; item += gridDim.x) {
    int e, d0, f0;
    dw_item(geo, item, e, d0, f0);
    int n = 0;                               // expert e's tiles
    for (int w = 0; 32 * w < geo.n_tiles; ++w)
      n += __popc(words.match(eot, geo.n_tiles, w, e, lane));
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    for (int s = 0; s < n * geo.spt; ++s, ++it) {
      const int st = it % geo.stages;
      mbar_wait(&full[st], (it / geo.stages) & 1);
      const int live = min(geo.kr, geo.bt - (s % geo.spt) * geo.kr);
      Tile::step(acc, smem + st * geo.stage_bytes, geo, live, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the tile through shared memory, rounded once
    unsigned char* out = smem + geo.out_off + ob * geo.out_bytes;
    if (t == 0 && geo.tma) {                 // this buffer's last store
      if (geo.out_bufs == 2) bulk_wait_read<1>();
      else bulk_wait_read<0>();
    }
    consumer_sync();                         // the buffer is free
    Tile::put(acc, out, t);
    if (geo.tma) {
      fence_async_smem();
      consumer_sync();                       // the tile is written
      if (t == 0) {
        Tile::store(&dw_map, out, geo, e, d0, f0);
        bulk_commit();
      }
    } else {
      consumer_sync();
      store_tile<T, Tile>(out, dw, geo, e, d0, f0, t);
    }
    ob = ob + 1 == geo.out_bufs ? 0 : ob + 1;
  }
  if (t == 0 && geo.tma) bulk_wait_all();
}

// Everything a dW launch needs but the grid: the stage rows, TMA or the
// threads' copies, and the most out buffers (up to 2) beside 2 stages,
// then the most stages (up to 4), that fit the dtype's budget.
cudaError_t plan_dw(int dtype, const void* x, const void* dy, const void* dw,
                    int T, int D, int F, int E, int bt, DwGeo* g) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (bt <= 0 || T % bt) return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  *g = DwGeo{};
  g->D = D; g->F = F; g->bt = bt; g->n_tiles = T / bt;
  const int q = dtype ? 16 : 8, cap = dtype ? 64 : 24;
  g->kr = min(cap, (bt + q - 1) / q * q);
  g->spt = (bt + g->kr - 1) / g->kr;
  g->d_tiles = (D + kDwD - 1) / kDwD;
  g->f_tiles = (F + kDwF - 1) / kDwF;
  const int64_t items = (int64_t)E * g->d_tiles * g->f_tiles;
  if (items > 0x7fffffff) return cudaErrorInvalidConfiguration;
  g->items = (int)items;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  g->tma = T > 0 && (D * isz) % 16 == 0 && (F * isz) % 16 == 0 && al(x) &&
           al(dy) && al(dw);
  const int x_bytes = g->kr * kDwD * isz;    // a multiple of 1024
  g->b_off = x_bytes;
  g->stage_bytes = x_bytes + g->kr * kDwF * isz;
  g->tx = g->stage_bytes;
  const int budget = dtype ? kDwBudgetBf16 : kDwBudgetF32;
  g->out_bytes = kDwD * kDwF * isz;
  g->out_bufs = (budget - 2 * g->stage_bytes) / g->out_bytes;
  g->out_bufs = max(1, min(kDwMaxOut, g->out_bufs));
  g->stages = (budget - g->out_bufs * g->out_bytes) / g->stage_bytes;
  g->stages = max(1, min(kDwMaxStages, g->stages));
  g->out_off = g->stages * g->stage_bytes;
  return cudaSuccess;
}

template <typename T, class Tile>
cudaError_t launch_dw(const DwGeo& g, int E, const void* x, const void* dy,
                      const int* eot, void* dw, cudaStream_t st) {
  auto kernel = moe_dw_kernel<T, Tile>;
  const size_t smem = 1024 + g.out_off + (size_t)g.out_bufs * g.out_bytes +
                      2 * kDwMaxStages * 8;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > g.items) grid = g.items;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (g.tma) {
    // cuTensorMapEncodeTiled needs this thread's context: bind it first
    if ((err = bind_context(st)) != cudaSuccess) return err;
    const int dt = sizeof(T) == 2;
    const uint64_t isz = sizeof(T);
    const uint32_t fb = dt ? 64 : kDwF;      // bf16: 128-byte swizzled boxes
    const uint64_t xd[3] = {(uint64_t)g.D, (uint64_t)g.bt,
                            (uint64_t)g.n_tiles};
    const uint64_t xs[2] = {g.D * isz, (uint64_t)g.bt * g.D * isz};
    const uint32_t xb[3] = {kDwD, (uint32_t)g.kr, 1};
    const uint64_t gd[3] = {(uint64_t)g.F, (uint64_t)g.bt,
                            (uint64_t)g.n_tiles};
    const uint64_t gs[2] = {g.F * isz, (uint64_t)g.bt * g.F * isz};
    const uint32_t gb[3] = {fb, (uint32_t)g.kr, 1};
    const uint64_t wd[3] = {(uint64_t)g.F, (uint64_t)g.D, (uint64_t)E};
    const uint64_t ws[2] = {g.F * isz, (uint64_t)g.D * g.F * isz};
    const uint32_t wb[3] = {fb, kDwD, 1};
    if (!encode_map(&maps[0], dt, x, 3, xd, xs, xb, dt) ||
        !encode_map(&maps[1], dt, dy, 3, gd, gs, gb, dt) ||
        !encode_map(&maps[2], dt, dw, 3, wd, ws, wb, dt))
      return cudaErrorInvalidValue;
  }
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], (const T*)x, (const T*)dy, eot, (T*)dw, g);
  return cudaGetLastError();
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

// The layout of a dW launch: out[0..7) = token rows a stage, stages a
// token tile, 1 for tensor maps (0: the threads' copies), stages of the
// ring, out buffers, tiles of D, tiles of F; `aligned` stands for x's,
// dy's and dW's pointers.
int maple_moe_layout_dw(int dtype, int T, int D, int F, int bt, int aligned,
                        int* out) {
  DwGeo g;
  const void* p = reinterpret_cast<const void*>(aligned ? 0 : 8);
  const cudaError_t err = plan_dw(dtype, p, p, p, T, D, F, 1, bt, &g);
  out[0] = g.kr; out[1] = g.spt; out[2] = g.tma; out[3] = g.stages;
  out[4] = g.out_bufs; out[5] = g.d_tiles; out[6] = g.f_tiles;
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
// dy (T, F); bt divides T.  Every element of dw is written.
int maple_moe_dw(const void* x, const void* dy, const int* expert_of_tile,
                 void* dw, int dtype, int T_rows, int D, int F, int E, int bt,
                 void* stream) {
  DwGeo g;
  const cudaError_t err =
      plan_dw(dtype, x, dy, dw, T_rows, D, F, E, bt, &g);
  if (err != cudaSuccess) return (int)err;
  if (g.items == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)launch_dw<__nv_bfloat16, DwWgmma>(g, E, x, dy, expert_of_tile,
                                                  dw, st);
  return (int)launch_dw<float, DwFfma>(g, E, x, dy, expert_of_tile, dw, st);
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
