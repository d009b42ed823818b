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
// Plain C interface (bound with ctypes); the launcher returns
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

template <int P>
struct MoeWgmma {
  static constexpr int R = P / 2;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const MoeGeo& geo, int /*t*/, int /*cols*/) {
    const uint32_t x0 = smem_u32(stage), w0 = x0 + geo.b_off;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = wᵀ (64 F × 16 D): 16 D-rows of 128 bytes, MN-major;
      // B = xᵀ (16 D × P): 32 bytes into each token's 128-byte row,
      // K-major, an atom of tokens o .. at o·128 bytes
      const uint64_t da = gmma_desc(w0 + 2048 * kk, 1024);
      const uint32_t xb = x0 + 32 * kk;
      if constexpr (P >= 64) wgmma_n64<1, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P == 128)
        wgmma_n64<1, 0, 32>(acc, da, gmma_desc(xb + 8192, 16));
      if constexpr (P == 96)
        wgmma_n32<1, 0, 32>(acc, da, gmma_desc(xb + 8192, 16));
      if constexpr (P == 32) wgmma_n32<1, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P <= 16) wgmma_n8<1, 0, 0>(acc, da, gmma_desc(xb, 16));
      if constexpr (P == 16)
        wgmma_n8<1, 0, 4>(acc, da, gmma_desc(xb + 1024, 16));
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

// grid: (ceil(F / 64), T / bt · pieces); F tiles of one piece next to
// each other
template <typename T, class Tile, int KC>
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
          tma_3d(stage + geo.b_off, &w_map, f0, d0, (int)e, &full[st]);
        }
      } else {
        copy_panel<T, KC>(stage, x + (int64_t)tok0 * geo.D + d0, geo.D,
                          geo.piece, geo.T - tok0, geo.D - d0, lane);
        copy_panel<T, kFt>(stage + geo.b_off,
                           w + (e * geo.D + d0) * geo.F + f0, geo.F, KC,
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

// Everything a launch needs, from the shapes alone.
cudaError_t plan_moe(int dtype, const void* x, const void* w, int T, int D,
                     int F, int bt, MoeGeo* g, size_t* smem) {
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

template <typename T, class Tile, int P>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& wm, const void* x,
                   const int* eot, const void* w, void* y, const MoeGeo& g,
                   size_t smem, cudaStream_t st) {
  auto kernel = moe_kernel<T, Tile, kStageRows<T, P>>;
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

template <int P>
cudaError_t launch_piece(int dtype, const CUtensorMap& xm,
                         const CUtensorMap& wm, const void* x, const int* eot,
                         const void* w, void* y, const MoeGeo& g, size_t smem,
                         cudaStream_t st) {
  if (dtype == 1)
    return launch<__nv_bfloat16, MoeWgmma<P>, P>(xm, wm, x, eot, w, y, g,
                                                 smem, st);
  return launch<float, FfmaFor<P>, P>(xm, wm, x, eot, w, y, g, smem, st);
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
  const cudaError_t err = plan_moe(dtype, p, p, T, D, F, bt, &g, &smem);
  out[0] = g.piece; out[1] = g.pieces; out[2] = g.tma; out[3] = g.stages;
  out[4] = (F + kFt - 1) / kFt;
  return (int)err;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y alike).  bt is a positive
// multiple of 8 that divides T; expert_of_tile holds T / bt ids in
// [0, E); w is (E, D, F).
int maple_moe_gemm(const void* x, const int* expert_of_tile, const void* w,
                   void* y, int dtype, int T_rows, int D, int F, int E,
                   int bt, void* stream) {
  if (bt <= 0 || bt % 8 || T_rows % bt) return (int)cudaErrorInvalidValue;
  if (T_rows == 0 || F == 0) return (int)cudaSuccess;
  MoeGeo g;
  size_t smem = 0;
  cudaError_t err = plan_moe(dtype, x, w, T_rows, D, F, bt, &g, &smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xm, wm;
  memset(&xm, 0, sizeof(xm));
  memset(&wm, 0, sizeof(wm));
  const int isz = dtype ? 2 : 4;
  const bool swz = dtype == 1;
  if (g.tma) {
    const uint64_t wd[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
    const uint64_t ws[2] = {(uint64_t)F * isz, (uint64_t)D * F * isz};
    const uint32_t wb[3] = {kFt, (uint32_t)g.bk, 1};
    if (!encode_2d(&xm, dtype, x, D, T_rows, (uint64_t)D * isz, g.bk,
                   g.piece, swz) ||
        !encode_map(&wm, dtype, w, 3, wd, ws, wb, swz))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (g.piece) {
    case 8: return (int)launch_piece<8>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    case 16: return (int)launch_piece<16>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    case 32: return (int)launch_piece<32>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    case 64: return (int)launch_piece<64>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    case 96: return (int)launch_piece<96>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    case 128: return (int)launch_piece<128>(dtype, xm, wm, x, expert_of_tile, w, y, g, smem, st);
    default: return (int)cudaErrorInvalidConfiguration;
  }
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
