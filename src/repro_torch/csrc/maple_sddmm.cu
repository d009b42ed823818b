// Maple block SDDMM for Hopper (sm_90a): the dA half of the maple_spmm
// backward.
//
// Replaces repro/kernels/maple_sddmm.py::maple_sddmm_bsr_pallas.  For
// C = A·B with A block-sparse, the gradient of A's payload is the dense
// product dC·Bᵀ sampled at A's block pattern:
//
//   dA[s] = Σ_g Σ_n dC[g, row(s)·bm + i, n] · B[g, col(s)·bk + k, n]
//
// one (bm, bk) f32 tile per block slot s; pad slots (block_col < 0) come
// out 0.  The TPU grid (n_blocks, G, N/bn) keeps the slot outermost and
// carries the (bm, bk) PSB across the sequential (g, j) steps.  Both
// operands have the reduction axis N contiguous (dC is (G, M, N), B is
// (G, K, N)): K-major on both sides, as wgmma takes them untransposed.
//
// The design.  One CTA of one consumer warpgroup and one producer warp
// owns a run of consecutive slots, an even share over every CTA the card
// holds at once (at most 16 slots), their block_row / block_col read
// once, a slot a lane.  N is staged in chunks of one 128-byte row (32 f32
// or 64 bf16 values; one narrower chunk, unswizzled, where N·size is under
// 128 bytes), chunk c = (g, j) for g in order, then j.
//   - The dC panel of a block-row (bm rows, every chunk) is loaded once
//     and kept while the slots of that row follow one another: the CTA
//     reloads it only when block_row changes from one live slot to the
//     next, so it is right for any slot order and needs no host table
//     (BlockCSR lists slots by row, so a row's slots share it).  The
//     panel sits in a ring of one or two buffers, so the next row's panel
//     loads while this row's last slot is multiplied.
//   - The producer warp keeps a ring of 2 to 4 stages full, one B chunk
//     (bk rows) a stage, each completed on an mbarrier: by 2D TMA boxes
//     with the 128-byte swizzle where N·size is a multiple of 16 bytes,
//     else by its own loads into the same layout (N = 1, 21, 37, bf16
//     N = 4), zeros past N.
//   - The launcher sizes shared memory for as many CTAs an SM as the
//     kernel's registers allow (at most 4): the panel kept where it fits
//     that budget (and 64 KB), else each stage brings its dC chunk beside
//     the B chunk.  At the MLP's N = 256 that streams dC: the extra CTAs
//     an SM are worth more there than the panel's reuse (PERF.md, PR 18).
//   - bf16 at 64 × 64 blocks (and a full 128-byte chunk) multiplies on
//     wgmma.m64n64k16 with both operands K-major (the swizzled chunks are
//     wgmma's canonical layout), the f32 accumulator in registers; f32,
//     and bf16 at other blocks, on the k-major FFMA tile (hopper.cuh
//     FfmaTileK: 4-wide reads along k, bank-conflict free on the swizzled
//     chunks; at 64 × 64 blocks and 128-byte chunks with its geometry
//     fixed at compile time, so that row offsets are load immediates).
//     Each output element is one chain over (g, n) in order (on FFMA one
//     fmaf a product; on wgmma its fixed k16 steps): no atomics, so two
//     runs give the same bits.
//   - Each slot's tile is written to a shared-memory buffer (one or two)
//     and leaves in one 1D bulk store (the (bm, bk) tile is contiguous in
//     out), which overlaps the next slot's product; a pad slot stores
//     zeros the same way.
//
// What bounds it on the H100.  Each live slot does 2·bm·bk·G·N FLOPs and
// writes bm·bk·4 bytes.  At the MLP's training shape (64 × 64 blocks,
// G = 1, N = 256 tokens) that is 512 FLOPs per output byte: f32 is bound
// by the FP32 rate (above the ridge of 67 TFLOP/s / 3.35 TB/s = 20), and
// the FFMA tile reuses each A value 8 times and each B value 4 times from
// registers; bf16 on the tensor cores is bound by the output's 25 MB, and
// in practice by the dC and B chunks it reads from L2 (bk·N·2 bytes a
// slot).  At the logit head's shape (N = 4 tokens) it is 8 FLOPs per
// byte: the 16 KB output tile of each of ~48 000 slots bounds it, and the
// bulk stores of several CTAs an SM keep the writes in flight.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxStages = 4;
constexpr int kMaxChunk = 16;                // slots a CTA (at most 32)
static_assert(kMaxChunk <= 32, "a CTA's slots are held one a lane");
constexpr int kPanelBudget = 64 * 1024;      // a resident dC panel
constexpr int kSmemOne = 232448;             // a CTA's shared memory
constexpr int kSmemSm = 233472;              // an SM's, 1 KB a CTA reserved
constexpr int kMaxCtas = 4;                  // CTAs an SM the layout aims at
constexpr int kBarBytes = 128;

struct Geo {
  int G, M, K, N, bm, bk;
  int pitch;        // bytes of a staged row (16 .. 128)
  int swz;          // 128-byte swizzle (pitch 128)
  int nc;           // N columns a chunk
  int nchunks_n;    // chunks over N
  int chunks;       // G · nchunks_n
  int a_bytes;      // a staged dC chunk (bm rows), 1024-aligned
  int b_bytes;      // a staged B chunk (bk rows), 1024-aligned
  int panels;       // dC panel buffers (0: dC streamed in each stage)
  int stages, stage_bytes;
  int panel_off, ring_off, out_off, bar_off;
  int out_bufs, out_bytes, out_stride;
  int tma;          // operands by TMA, else by the producer's loads
  int n_blocks;
  uint32_t tx_stage, tx_panel;
};

// N columns of chunk c that lie before N
__device__ __forceinline__ int chunk_live(const Geo& geo, int c) {
  return min(geo.nc, geo.N - (c % geo.nchunks_n) * geo.nc);
}

// The producer's own copy of one chunk: `rows` rows of x from row `row0`
// of the (G·X, N) view, columns n0 .. n0 + live, into the staged layout
// (pitch, swizzle), zeros past N.  It writes the 16-byte units that the
// consumers read: whole 32-byte pairs (wgmma's k16 step), within a row.
template <typename T>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const T* __restrict__ x,
                                           int64_t row0, int rows, int n0,
                                           int live, const Geo& geo,
                                           int lane) {
  constexpr int per = 16 / sizeof(T);
  const int units = min(geo.pitch / 16, (live + 2 * per - 1) / (2 * per) * 2);
  const int total = rows * units;
  for (int base = lane; base < total; base += 32 * 4) {
    __align__(16) T v[4][per];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + 32 * u, r = idx / units, q = idx % units;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        const int n = q * per + e;
        v[u][e] = idx < total && n < live
                      ? x[(row0 + r) * geo.N + n0 + n] : from_f32<T>(0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + 32 * u, r = idx / units, q = idx % units;
      if (idx >= total) break;
      const int unit = geo.swz ? q ^ (r & 7) : q;
      *reinterpret_cast<uint4*>(dst + r * geo.pitch + unit * 16) =
          *reinterpret_cast<const uint4*>(v[u]);
    }
  }
}

// chunk c of rows row0 .. row0 + rows of x viewed as (G·X, N): one TMA
// box (lane 0; the barrier's bytes are expected by the caller) or the
// warp's own loads
template <typename T>
__device__ __forceinline__ void load_chunk(unsigned char* dst,
                                           const CUtensorMap* map,
                                           const T* __restrict__ x, int X,
                                           int row0, int rows, int c,
                                           const Geo& geo, uint64_t* bar,
                                           int lane) {
  const int g = c / geo.nchunks_n, n0 = (c % geo.nchunks_n) * geo.nc;
  if (geo.tma) {
    if (lane == 0) tma_2d(dst, map, n0, g * X + row0, bar);
  } else {
    copy_chunk<T>(dst, x, (int64_t)g * X + row0, rows, n0,
                  chunk_live(geo, c), geo, lane);
  }
}

// ---- the consumers' product of one chunk

// f32, and bf16 at blocks other than 64 × 64: the k-major FFMA tile
template <typename T, int TM, int TN, int BM = 0, int BK = 0, int PITCH = 0>
struct Ffma {
  using Tile = FfmaTileK<T, TM, TN, BM, BK, PITCH>;
  static constexpr int R = Tile::R;

  __device__ static void step(float (&acc)[R], const unsigned char* a,
                              const unsigned char* b, const Geo& geo,
                              int live, int t) {
    Tile::step(acc, a, b, geo.bm, geo.bk, geo.pitch, geo.swz, (live + 3) / 4,
               t);
  }

  __device__ static bool at(int i, const Geo& geo, int t, int& r, int& c) {
    return Tile::at(i, geo.bm, geo.bk, t, r, c);
  }
};

// bf16 at 64 × 64 blocks: D(64 × 64) += dC(64 × 16) · B(64 × 16)ᵀ, both
// K-major with the 128-byte swizzle; a chunk is 4 k16 steps (fewer past N)
struct Wgmma {
  static constexpr int R = 32;

  __device__ static void step(float (&acc)[R], const unsigned char* a,
                              const unsigned char* b, const Geo& /*geo*/,
                              int live, int /*t*/) {
    const uint32_t a0 = smem_u32(a), b0 = smem_u32(b);
    const int ks = (live + 15) / 16;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < ks)
        wgmma_n64<0, 0, 0>(acc, gmma_desc(a0 + 32 * kk, 16),
                           gmma_desc(b0 + 32 * kk, 16));
    wgmma_commit_wait();
  }

  __device__ static bool at(int i, const Geo& /*geo*/, int t, int& r,
                            int& c) {
    wgmma_at(i, t, r, c);
    return true;
  }
};

// grid: (CTAs,); CTA x owns slots [x·n_blocks / CTAs, (x + 1)·n_blocks /
// CTAs), at most 32.  Threads 0 .. 127 consume, 128 .. 159 produce.
template <typename T, class Tile>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const __grid_constant__ CUtensorMap dc_map,
             const __grid_constant__ CUtensorMap b_map,
             const T* __restrict__ dc, const T* __restrict__ b,
             const int* __restrict__ block_row,
             const int* __restrict__ block_col, float* __restrict__ out,
             Geo geo) {
  constexpr int R = Tile::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.bar_off);
  uint64_t* empty = full + kMaxStages;
  uint64_t* pfull = empty + kMaxStages;       // the panel ring
  uint64_t* pempty = pfull + 2;
  const int t = threadIdx.x, lane = t & 31;
  const int s0 = (int)((int64_t)blockIdx.x * geo.n_blocks / gridDim.x);
  const int n =
      (int)((int64_t)(blockIdx.x + 1) * geo.n_blocks / gridDim.x) - s0;
  // every warp holds the CTA's slots, slot s0 + i on lane i, read once
  // (one load latency a CTA, not two a slot)
  const int my_col = lane < n ? block_col[s0 + lane] : -1;
  const int my_row = lane < n ? block_row[s0 + lane] : 0;

  if (t == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(&full[s], 32);               // every producer lane arrives
      mbar_init(&empty[s], kConsumers / 32); // every consumer warp
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(&pfull[p], 32);
      mbar_init(&pempty[p], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= kConsumers) {
    // ---- producer warp
    int it = 0, np = 0, cur = -1;
    for (int i = 0; i < n; ++i) {
      const int col = __shfl_sync(0xffffffffu, my_col, i);
      const int row = __shfl_sync(0xffffffffu, my_row, i);
      if (col < 0) continue;                 // a pad slot loads nothing
      if (geo.panels && row != cur) {        // the row's dC panel, once
        const int pb = np % geo.panels;
        mbar_wait(&pempty[pb], ((np / geo.panels) & 1) ^ 1);
        unsigned char* panel =
            smem + geo.panel_off + pb * geo.chunks * geo.a_bytes;
        if (geo.tma && lane == 0) mbar_expect_tx(&pfull[pb], geo.tx_panel);
        for (int c = 0; c < geo.chunks; ++c)
          load_chunk<T>(panel + c * geo.a_bytes, &dc_map, dc, geo.M,
                        row * geo.bm, geo.bm, c, geo, &pfull[pb], lane);
        if (!geo.tma) fence_async_smem();
        mbar_arrive(&pfull[pb]);
        ++np;
        cur = row;
      }
      for (int c = 0; c < geo.chunks; ++c) {
        const int st = it % geo.stages;
        mbar_wait(&empty[st], ((it / geo.stages) & 1) ^ 1);
        unsigned char* stage = smem + geo.ring_off + st * geo.stage_bytes;
        if (geo.tma && lane == 0) mbar_expect_tx(&full[st], geo.tx_stage);
        load_chunk<T>(stage, &b_map, b, geo.K, col * geo.bk, geo.bk, c, geo,
                      &full[st], lane);
        if (!geo.panels)                     // dC streamed beside B
          load_chunk<T>(stage + geo.b_bytes, &dc_map, dc, geo.M,
                        row * geo.bm, geo.bm, c, geo, &full[st], lane);
        if (!geo.tma) fence_async_smem();
        mbar_arrive(&full[st]);
        ++it;
      }
    }
    return;
  }

  // ---- consumer warpgroup
  int it = 0, np = 0, cur = -1, ob = 0;
  for (int si = 0; si < n; ++si) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.0f;
    const int col = __shfl_sync(0xffffffffu, my_col, si);
    const int row = __shfl_sync(0xffffffffu, my_row, si);
    if (col >= 0) {
      const unsigned char* panel = nullptr;
      if (geo.panels) {
        if (row != cur) {
          if (np > 0 && (t & 31) == 0)       // done with the last panel
            mbar_arrive(&pempty[(np - 1) % geo.panels]);
          mbar_wait(&pfull[np % geo.panels], (np / geo.panels) & 1);
          ++np;
          cur = row;
        }
        panel = smem + geo.panel_off +
                ((np - 1) % geo.panels) * geo.chunks * geo.a_bytes;
      }
      for (int c = 0; c < geo.chunks; ++c) {
        const int st = it % geo.stages;
        mbar_wait(&full[st], (it / geo.stages) & 1);
        const unsigned char* stage =
            smem + geo.ring_off + st * geo.stage_bytes;
        const unsigned char* a =
            panel ? panel + c * geo.a_bytes : stage + geo.b_bytes;
        Tile::step(acc, a, stage, geo, chunk_live(geo, c), t);
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(&empty[st]);
        ++it;
      }
    }
    // the tile through shared memory and out in one bulk store
    if (t == 0) {
      if (geo.out_bufs == 2) bulk_wait_read<1>();
      else bulk_wait_read<0>();
    }
    consumer_sync();                         // the buffer is free
    float* o = reinterpret_cast<float*>(smem + geo.out_off +
                                        ob * geo.out_stride);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int r, c;
      if (Tile::at(i, geo, t, r, c)) o[r * geo.bk + c] = acc[i];
    }
    fence_async_smem();
    consumer_sync();                         // the tile is written
    if (t == 0) {
      bulk_store(out + (int64_t)(s0 + si) * geo.bm * geo.bk, o,
                 geo.out_bytes);
      bulk_commit();
    }
    ob = ob + 1 == geo.out_bufs ? 0 : ob + 1;
  }
  if (t == 0) bulk_wait_all();
}

// ---- host side

// The FFMA tiles (hopper.cuh kTiles), wgmma, and the (4, 8) tile at 64 × 64
// blocks and 128-byte chunks with its geometry fixed at compile time
constexpr int kWgmmaKind = 7;
constexpr int kFixedKind = 8;

// Everything a launch needs from the shapes and the operands' alignment,
// but the layout of shared memory.
cudaError_t plan(int dtype, const void* dc, const void* b, int G, int M,
                 int K, int N, int bm, int bk, Geo* geo, int* kind) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int isz = dtype ? 2 : 4;
  Geo& g = *geo;
  g = Geo{};
  g.G = G; g.M = M; g.K = K; g.N = N; g.bm = bm; g.bk = bk;
  const int row_bytes = N > 0 ? (N * isz + 15) / 16 * 16 : 16;
  g.pitch = row_bytes < 128 ? row_bytes : 128;
  g.swz = g.pitch == 128;
  g.nc = g.pitch / isz;
  g.nchunks_n = (N + g.nc - 1) / g.nc;
  g.chunks = G * g.nchunks_n;
  if (bm == 64 && bk == 64 && g.swz) {
    *kind = dtype == 1 ? kWgmmaKind : kFixedKind;
  } else {
    *kind = ffma_tile(bm, bk);
    if (*kind < 0) return cudaErrorInvalidConfiguration;
  }
  g.out_bytes = bm * bk * 4;
  if (g.out_bytes % 16) return cudaErrorInvalidValue;   // bulk-store unit
  g.out_stride = (g.out_bytes + 127) / 128 * 128;
  const bool aligned = reinterpret_cast<uintptr_t>(dc) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  g.tma = g.chunks > 0 && (N * isz) % 16 == 0 && aligned && bm <= 256 &&
          bk <= 256;
  g.a_bytes = (bm * g.pitch + 1023) / 1024 * 1024;
  g.b_bytes = (bk * g.pitch + 1023) / 1024 * 1024;
  g.tx_panel = g.chunks * bm * g.pitch;
  return cudaSuccess;
}

// The shared memory of `ctas` CTAs an SM: the dC panel kept (one or two
// buffers) where it fits, else streamed beside B; then the most stages and
// out buffers.  Returns the bytes, 0 when nothing fits.
size_t layout(Geo& g, int ctas) {
  const int limit = ctas > 1 ? kSmemSm / ctas - 1024 : kSmemOne;
  // (panel buffers, stages, out buffers), most overlap first
  const int prefs[6][3] = {{2, 4, 2}, {2, 3, 2}, {1, 4, 2}, {1, 3, 2},
                           {1, 3, 1}, {1, 2, 1}};
  const bool modes[2] = {true, false};
  for (const bool resident : modes) {
    if (resident && g.chunks * g.a_bytes > kPanelBudget) continue;
    const int stage = g.b_bytes + (resident ? 0 : g.a_bytes);
    for (const auto& p : prefs) {
      const int panels = resident ? p[0] : 0;
      const size_t need = 1024 + (size_t)panels * g.chunks * g.a_bytes +
                          (size_t)p[1] * stage + (size_t)p[2] * g.out_stride +
                          kBarBytes;
      if (need > (size_t)limit) continue;
      g.panels = panels;
      g.stages = p[1];
      g.stage_bytes = stage;
      g.out_bufs = p[2];
      g.tx_stage = g.bk * g.pitch + (resident ? 0 : g.bm * g.pitch);
      g.panel_off = 0;
      g.ring_off = panels * g.chunks * g.a_bytes;
      g.out_off = g.ring_off + g.stages * g.stage_bytes;
      g.bar_off = g.out_off + g.out_bufs * g.out_stride;
      return need;
    }
  }
  return 0;
}

template <typename T, class Tile>
cudaError_t launch(const void* dc, const void* b, const int* block_row,
                   const int* block_col, float* out, Geo geo, int chunk,
                   cudaStream_t stream) {
  auto kernel = sddmm_kernel<T, Tile>;
  // as many CTAs an SM as the registers allow (at most kMaxCtas), with the
  // layout that fits them
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int warp_regs = (attr.numRegs * 32 + 255) / 256 * 256;
  int ctas = 65536 / (warp_regs * (kThreads / 32));
  ctas = ctas < 1 ? 1 : ctas > kMaxCtas ? kMaxCtas : ctas;
  size_t smem = layout(geo, ctas);
  while (!smem && --ctas >= 1) smem = layout(geo, ctas);
  if (!smem) return cudaErrorInvalidValue;             // blocks too large
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return err;
  const int64_t n = geo.n_blocks;
  int64_t grid = 0;
  if (chunk > 0) {
    grid = (n + chunk - 1) / chunk;
  } else {
    // every resident CTA of the card takes an even share (shares differ
    // by one slot at most), at most kMaxChunk slots
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    grid = (n + kMaxChunk - 1) / kMaxChunk;
    if (grid < resident) grid = resident;
  }
  if (grid > n) grid = n;
  if ((n + grid - 1) / grid > 32) return cudaErrorInvalidValue;  // a lane
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (geo.tma) {
    const int dt = sizeof(T) == 2;
    const uint64_t row_bytes = (uint64_t)geo.N * sizeof(T);
    if (!encode_2d(&maps[0], dt, dc, geo.N, (uint64_t)geo.G * geo.M,
                   row_bytes, geo.nc, geo.bm, geo.swz) ||
        !encode_2d(&maps[1], dt, b, geo.N, (uint64_t)geo.G * geo.K,
                   row_bytes, geo.nc, geo.bk, geo.swz))
      return cudaErrorInvalidValue;
  }
  sddmm_kernel<T, Tile><<<(unsigned)grid, kThreads, smem, stream>>>(
      maps[0], maps[1], (const T*)dc, (const T*)b, block_row, block_col, out,
      geo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int kind, const void* dc, const void* b,
                     const int* block_row, const int* block_col, float* out,
                     const Geo& geo, int chunk, cudaStream_t st) {
#define MAPLE_FFMA(c, tm, tn)                                               \
  case c:                                                                   \
    return launch<T, Ffma<T, tm, tn>>(dc, b, block_row, block_col, out, geo, \
                                      chunk, st);
  switch (kind) {
    MAPLE_FFMA(0, 8, 8)
    MAPLE_FFMA(1, 4, 8)
    MAPLE_FFMA(2, 4, 4)
    MAPLE_FFMA(3, 2, 4)
    MAPLE_FFMA(4, 1, 4)
    MAPLE_FFMA(5, 1, 2)
    MAPLE_FFMA(6, 1, 1)
    case kWgmmaKind:
      if constexpr (sizeof(T) == 2)
        return launch<T, Wgmma>(dc, b, block_row, block_col, out, geo,
                                chunk, st);
      return cudaErrorInvalidConfiguration;
    case kFixedKind:
      return launch<T, Ffma<T, 4, 8, 64, 64, 128>>(
          dc, b, block_row, block_col, out, geo, chunk, st);
    default:
      return cudaErrorInvalidConfiguration;
  }
#undef MAPLE_FFMA
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dC and B alike).  out is the f32
// (n_blocks, bm, bk) payload gradient; every slot is written.  chunk: the
// slots a CTA (at most 32), 0 for an even share over every CTA the card
// holds at once (at most 16).
int maple_sddmm_bsr(const void* dc, const void* b, const int* block_row,
                    const int* block_col, float* out, int dtype,
                    int n_blocks, int G, int M, int K, int N, int bm, int bk,
                    int chunk, void* stream) {
  if (n_blocks == 0) return (int)cudaSuccess;
  Geo geo;
  int kind = -1;
  const cudaError_t err = plan(dtype, dc, b, G, M, K, N, bm, bk, &geo, &kind);
  if (err != cudaSuccess) return (int)err;
  geo.n_blocks = n_blocks;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(kind, dc, b, block_row, block_col, out, geo,
                                chunk, st);
  return (int)dispatch<__nv_bfloat16>(kind, dc, b, block_row, block_col, out,
                                      geo, chunk, st);
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
