// Maple block-sparse × dense SpMM kernels for Hopper (sm_90a).
//
// Three kernels.  B3 keeps the tile engine it had; B1 and B4 share a run
// walk built for Hopper.
//
// * maple_spmm_naive (B3) — replaces repro/kernels/maple_spmm.py::
//   maple_spmm_batched_pallas (the "naive" schedule).  The TPU kernel walks
//   every block slot, pads included, as one sequential grid axis and the
//   wrapper masks empty block-rows afterwards.  Here one thread block owns
//   one (block-row i, N tile, batch g) output tile and walks the row's
//   slots row_ptr[i] .. row_ptr[i+1] (pads are never visited, and
//   block_col < 0 is masked all the same).  An empty block-row flushes a
//   zero tile, so no mask pass is needed; the tile is cast to the input
//   type once.  S groups of threads take steps j, j + S, ... each into its
//   own register PSB, summed in group order at the end; each thread starts
//   its share of a step's 16-byte loads before it stores any of them.
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
// B1 and B4 run one kernel, run_kernel, that differs only in its epilogue.
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
// is (p_0 + p_1) + (p_2 + p_3).  B4 then adds a row's PSBs in lane order,
// ((0 + PSB_0) + PSB_1) + ..., the order of the slot merge
// (ops._scatter_merge_f32) after B1.  The tree depends only on the run's
// steps and on (bm, bk, N ≤ 4, dtype); the N tile does not enter it, since
// output columns never mix; nor do the grid or the runs of a row.  So B4
// equals B1 + merge bit for bit, and a rerun gives the same bits.
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
// bf16 stays bf16 in shared memory.  The consumers are one warpgroup:
//   - N <= 4 (f32, and bf16 at other block shapes): the skinny tile, one
//     row and 4 columns a thread;
//   - else f32 (and bf16 at other block shapes): a register-blocked FFMA
//     tile, up to 8 × 8 outputs a thread, operands read from shared memory
//     as 4-wide vectors (A along k; B along n);
//   - bf16 at 64 × 64 blocks: wgmma.m64nNk16.f32.bf16.bf16 with A K-major
//     and the B panel MN-major (the transpose bit), f32 accumulators in
//     registers: one or two n64 atoms with the 128-byte swizzle, or one
//     unswizzled n8 for N <= 8.
// Each consumer warp hands a stage back on an mbarrier when it is done with
// it, so the next blocks load while this one is multiplied.  After the
// walk, every CTA puts its partial in its own shared memory, and each sums
// a quarter of the tile's registers, (p_0 + p_1) + (p_2 + p_3), reading
// the four partials through distributed shared memory, and writes that
// quarter of the epilogue.  B1's epilogue writes the run's slot.  B4's
// writes the row as 0 + PSB when the row has one run; when it has several,
// each run puts its PSB in a scratch buffer (the wrapper's torch.empty)
// and adds one to the row's counter (one a quarter); the last to arrive
// sums the row's PSBs from the scratch buffer in lane order, writes the
// row and resets the counter to 0.  The counter only decides who sums; the
// sum's order is fixed.  A row's first run also writes zeros over the
// empty rows before it (the last run, those after it).  No atomics on
// values.  The wrapper narrows the N tile while the grid would give fewer
// than 4 CTAs an SM (maple_spmm.walk_tile), and asks for 2 stages where a
// segment averages 16 steps or fewer, so that more CTAs share an SM, 4
// where segments are long (maple_spmm.ring_stages).
//
// What bounds them on the H100: every live weight block is read once per
// N tile, 2·N FLOPs per weight element.  Below N ≈ 10 (decode, the logit
// head; N = 1 and 4) that is under the ridge of either type (f32: 67
// TFLOP/s over 3.35 TB/s, about 20 FLOPs a byte), so the weight bytes bound
// the kernel and the design is about bytes in flight: 2 to 4 stages of
// 16 KB (f32) a CTA, several CTAs an SM, and 4 CTAs a run so that the
// grid fills the card.  At N ≥ 128 (training) the operations bound it:
// the FFMA tile reuses each A value 8 times and each B value 8 times from
// registers, and bf16 goes to the tensor cores.  f32 does not use the
// tensor cores: TF32 would round the operands to 10 bits of mantissa, and
// the port's f32 parity (ROADMAP's North star) asks for IEEE f32 products;
// 3xTF32 (split each operand into two TF32 terms) would keep f32 accuracy
// at three tensor-core products and is left for later.
//
// Plain C interface (bound with ctypes); every launcher returns
// cudaGetLastError() right after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kUnroll = 8;      // loads a thread starts before storing any
constexpr int kMaxThreads = 256;

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ __forceinline__ static void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ __forceinline__ static void unpack(const uint2& v, float* o) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
  }
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// Geometry of one launch.  A group of tpg = (bm/TM)·(bn/TN) threads owns
// the (bm, bn) tile: thread (ty, tx) holds rows ty + i·(bm/TM) and columns
// tx + j·(bn/TN).  kc rows of the contraction are staged at a time.
struct Geom {
  int K, N, bm, bk, bn, kc, groups;
};

__host__ __device__ __forceinline__ int stage_floats(const Geom& g) {
  return g.bm * (g.kc + 1) + g.kc * g.bn;   // +1: rows of A in distinct banks
}

// Shared floats the walk uses: the groups' staging areas, reused for the
// fixed-order reduction of their PSBs.
__host__ __device__ __forceinline__ int walk_floats(const Geom& g) {
  const int staged = g.groups * stage_floats(g);
  const int reduce = g.groups * g.bm * g.bn;
  return staged > reduce ? staged : reduce;
}

// Stage kc columns of weight block a_blk and the matching kc rows of B's
// panel (columns n0 .. n0+bn, zero past N) into this group's shared memory.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ a_blk,
                                      const T* __restrict__ b_g, int col,
                                      int k0, int n0, const Geom& geo,
                                      int gtid, int tpg, float* a_s,
                                      float* b_s) {
  using V = typename Vec4<T>::type;
  const int a_stride = geo.kc + 1;
  const int qpr = geo.kc / 4;                 // 4-element vectors per row
  const int nvec = geo.bm * qpr;
  for (int base = gtid; base < nvec; base += kUnroll * tpg) {
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * tpg;
      if (idx < nvec) {
        const int r = idx / qpr, q = idx % qpr;
        Vec4<T>::unpack(*reinterpret_cast<const V*>(
                            a_blk + r * geo.bk + k0 + 4 * q), v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * tpg;
      if (idx < nvec) {
        const int r = idx / qpr, q = idx % qpr;
        float* dst = a_s + r * a_stride + 4 * q;
        dst[0] = v[u][0]; dst[1] = v[u][1]; dst[2] = v[u][2]; dst[3] = v[u][3];
      }
    }
  }
  const int64_t krow0 = (int64_t)col * geo.bk + k0;
  const int nb = geo.kc * geo.bn;
  for (int base = gtid; base < nb; base += kUnroll * tpg) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * tpg;
      const int kk = idx / geo.bn, n = n0 + idx % geo.bn;
      v[u] = (idx < nb && n < geo.N)
                 ? to_f32(b_g[(krow0 + kk) * geo.N + n]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * tpg;
      if (idx < nb) b_s[idx] = v[u];
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void fma_stage(float (&acc)[TM][TN],
                                          const float* a_s, const float* b_s,
                                          const Geom& geo, int gtid) {
  const int tx_n = geo.bn / TN, ty_n = geo.bm / TM;
  const int tx = gtid % tx_n, ty = gtid / tx_n;
  const int a_stride = geo.kc + 1;
  for (int kk = 0; kk < geo.kc; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a_s[(ty + i * ty_n) * a_stride + kk];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b_s[kk * geo.bn + tx + j * tx_n];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// B3's walk: steps [first, end) of a step stream, step s
// contributing blocks[block_of(s)] · B[g][col_of(s) panel] unless
// col_of(s) < 0.  Groups take steps round-robin; the tile comes back in
// group 0's registers (other groups return with it unspecified).
template <typename T, int TM, int TN, typename StepFn>
__device__ __forceinline__ void walk(float (&acc)[TM][TN],
                                     const T* __restrict__ blocks,
                                     const T* __restrict__ b_g, int first,
                                     int end, int n0, const Geom& geo,
                                     float* smem, StepFn step_of) {
  const int tpg = (geo.bm / TM) * (geo.bn / TN);
  const int group = threadIdx.x / tpg, gtid = threadIdx.x % tpg;
  float* a_s = smem + group * stage_floats(geo);
  float* b_s = a_s + geo.bm * (geo.kc + 1);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int s0 = first; s0 < end; s0 += geo.groups) {
    const int s = s0 + group;
    int blk = 0, col = -1;
    if (s < end) step_of(s, blk, col);
    const T* a_blk = blocks + (int64_t)blk * geo.bm * geo.bk;
    for (int k0 = 0; k0 < geo.bk; k0 += geo.kc) {
      if (col >= 0) stage(a_blk, b_g, col, k0, n0, geo, gtid, tpg, a_s, b_s);
      __syncthreads();
      if (col >= 0) fma_stage(acc, a_s, b_s, geo, gtid);
      __syncthreads();
    }
  }
  if (geo.groups == 1) return;
  // fixed-order reduction of the groups' PSBs through shared memory
  const int tx_n = geo.bn / TN, ty_n = geo.bm / TM;
  const int tx = gtid % tx_n, ty = gtid / tx_n;
  float* part = smem + group * geo.bm * geo.bn;
  if (group > 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        part[(ty + i * ty_n) * geo.bn + tx + j * tx_n] = acc[i][j];
  }
  __syncthreads();
  if (group == 0) {
    for (int h = 1; h < geo.groups; ++h) {
      const float* other = smem + h * geo.bm * geo.bn;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += other[(ty + i * ty_n) * geo.bn + tx + j * tx_n];
    }
  }
}

template <typename O, int TM, int TN>
__device__ __forceinline__ void flush_tile(const float (&acc)[TM][TN],
                                           O* __restrict__ out_tile, int n0,
                                           const Geom& geo) {
  const int tpg = (geo.bm / TM) * (geo.bn / TN);
  if (threadIdx.x >= tpg) return;             // group 0 holds the sum
  const int tx_n = geo.bn / TN, ty_n = geo.bm / TM;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * ty_n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * tx_n;
      if (n < geo.N) out_tile[(int64_t)r * geo.N + n] = from_f32<O>(acc[i][j]);
    }
  }
}

// grid: (gm, ceil(N / bn), G)
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
naive_kernel(const T* __restrict__ blocks, const int* __restrict__ row_ptr,
             const int* __restrict__ block_col, const T* __restrict__ b,
             T* __restrict__ out, Geom geo) {
  extern __shared__ float smem[];
  const int i = blockIdx.x, n0 = blockIdx.y * geo.bn, g = blockIdx.z;
  float acc[TM][TN];
  walk<T, TM, TN>(acc, blocks, b + (int64_t)g * geo.K * geo.N, row_ptr[i],
                  row_ptr[i + 1], n0, geo, smem,
                  [&](int s, int& blk, int& col) {
                    blk = s;
                    col = block_col[s];
                  });
  T* out_tile = out + ((int64_t)g * gridDim.x + i) * geo.bm * geo.N;
  flush_tile<T, TM, TN>(acc, out_tile, n0, geo);
}

// Register tile per thread: the first (TM, TN) that divides the tile and
// gives a group of 64..256 threads; (1, 1) for the small tiles of the
// tests.  Returns -1 when no tile fits.
int pick_config(int bm, int bn, int* tpg) {
  const int tms[5] = {4, 4, 2, 2, 1}, tns[5] = {8, 4, 4, 2, 1};
  for (int c = 0; c < 5; ++c) {
    if (bm % tms[c] || bn % tns[c]) continue;
    *tpg = (bm / tms[c]) * (bn / tns[c]);
    if (*tpg >= 64 && *tpg <= kMaxThreads) return c;
  }
  *tpg = bm * bn;
  return *tpg <= kMaxThreads ? 4 : -1;
}

Geom make_geom(int K, int N, int bm, int bk, int bn, int tpg) {
  int kc = 4;
  while (kc < 32 && bk % (2 * kc) == 0) kc *= 2;   // bk % 4 == 0 checked
  const int groups = kMaxThreads / tpg > 8 ? 8 : kMaxThreads / tpg;
  return Geom{K, N, bm, bk, bn, kc, groups};
}

size_t smem_bytes(const Geom& g) { return sizeof(float) * walk_floats(g); }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename T, int TM, int TN>
cudaError_t launch_naive(const void* blocks, const int* row_ptr,
                         const int* block_col, const void* b, void* out,
                         int G, int gm, const Geom& geo,
                         cudaStream_t stream) {
  const dim3 grid(gm, (geo.N + geo.bn - 1) / geo.bn, G);
  const int threads = geo.groups * (geo.bm / TM) * (geo.bn / TN);
  const size_t smem = smem_bytes(geo);
  cudaError_t err = prepare(naive_kernel<T, TM, TN>, smem);
  if (err != cudaSuccess) return err;
  naive_kernel<T, TM, TN><<<grid, threads, smem, stream>>>(
      (const T*)blocks, row_ptr, block_col, (const T*)b, (T*)out, geo);
  return cudaGetLastError();
}

#define DISPATCH_CONFIG(cfg, LAUNCH, T, ...)                      \
  switch (cfg) {                                                  \
    case 0: return (int)LAUNCH<T, 4, 8>(__VA_ARGS__);             \
    case 1: return (int)LAUNCH<T, 4, 4>(__VA_ARGS__);             \
    case 2: return (int)LAUNCH<T, 2, 4>(__VA_ARGS__);             \
    case 3: return (int)LAUNCH<T, 2, 2>(__VA_ARGS__);             \
    case 4: return (int)LAUNCH<T, 1, 1>(__VA_ARGS__);             \
    default: return (int)cudaErrorInvalidConfiguration;           \
  }


// ---------------------------------------------------------------------------
// B1 and B4: the run walk (see the header)
// ---------------------------------------------------------------------------

constexpr int kSeg = 4;                      // segments a run = CTAs a cluster
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 100 * 1024;

enum BMode { kBTensor = 0, kBPanel = 1, kBManual = 2 };

struct RunGeo {
  int K, N, bm, bk;  // B is (G, K, N); blocks (nb, bm, bk)
  int tile;          // output columns a CTA owns
  int ldb;           // row stride of the staged B panel, elements
  int b_mode;        // BMode
  int steps;         // plan steps a lane
  int n_runs;
  int gm;            // B4: block-rows
  int n_slots;       // B1: slots a batch
  int stages;
  int b_off;         // byte offset of the B panel in a stage
  int p_off;         // byte offset of a bulk-copied B panel (kBPanel)
  int stage_bytes;
  int ring_bytes;    // the ring, at least the stash of partials
  unsigned tx;       // bytes the asynchronous copies bring a stage
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait that
// lasts seconds means a lost copy: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

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

// the consumer warpgroup alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// ---- the FFMA consumer: thread (ty, tx) holds rows ty + i·ty_n and, for
// TN % 4 == 0, columns 4·tx + (j % 4) + (j / 4)·4·tx_n (4-wide groups, so
// that a quarter warp reads 128 contiguous bytes of a B row).
template <typename T, int TM, int TN>
struct FfmaTile {
  static constexpr int R = TM * TN;
  static constexpr bool kWgmma = false;

  __device__ static bool place(const RunGeo& geo, int t, int& tx, int& ty,
                               int& tx_n, int& ty_n) {
    tx_n = geo.tile / TN;
    ty_n = geo.bm / TM;
    tx = t % tx_n;
    ty = t / tx_n;
    return t < tx_n * ty_n;
  }

  __device__ static int col(int j, int tx, int tx_n) {
    return TN % 4 == 0 ? (j / 4) * 4 * tx_n + 4 * tx + j % 4 : tx * TN + j;
  }

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t) {
    using V = typename Vec4<T>::type;
    int tx, ty, tx_n, ty_n;
    if (!place(geo, t, tx, ty, tx_n, ty_n)) return;
    const T* a_s = reinterpret_cast<const T*>(stage);
    const T* b_s = reinterpret_cast<const T*>(stage + geo.b_off);
    const bool bvec = geo.ldb % 4 == 0;
    for (int k0 = 0; k0 < geo.bk; k0 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        Vec4<T>::unpack(*reinterpret_cast<const V*>(
                            a_s + (ty + i * ty_n) * geo.bk + k0), a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* brow = b_s + (k0 + kk) * geo.ldb;
        float bv[TN];
        if constexpr (TN % 4 == 0) {
          if (bvec) {
#pragma unroll
            for (int j = 0; j < TN; j += 4) {
              float q[4];
              Vec4<T>::unpack(*reinterpret_cast<const V*>(
                                  brow + col(j, tx, tx_n)), q);
              bv[j] = q[0]; bv[j + 1] = q[1]; bv[j + 2] = q[2];
              bv[j + 3] = q[3];
            }
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = to_f32(brow[col(j, tx, tx_n)]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = to_f32(brow[col(j, tx, tx_n)]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i * TN + j] = fmaf(a[i][kk], bv[j], acc[i * TN + j]);
      }
    }
  }

  // the row and the column (from the tile's first) of register i
  __device__ static bool at(int i, const RunGeo& geo, int t, int& r,
                            int& c) {
    int tx, ty, tx_n, ty_n;
    if (!place(geo, t, tx, ty, tx_n, ty_n)) return false;
    r = ty + (i / TN) * ty_n;
    c = col(i % TN, tx, tx_n);
    return true;
  }
};

// ---- the skinny FFMA consumer (N <= 4: decode, the logit head): thread t
// holds row t and the 4 columns of the tile.  Rows lie bk·size bytes apart,
// a multiple of 128 for bk = 64, so the 8 rows of a quarter warp would read
// one bank: row t walks its k quads from quad t % (bk / 4) on, wrapping.
// For N > 1 it also starts each quad at k offset (t / 2) % 4, so that the
// B rows a quarter warp reads (16 bytes each at N = 4) fall in 8 banks
// too; it then reads A one value at a time (the 8 rows' values lie in 8
// banks).  The chain of each output element is the row's rotated k
// order, fixed by bk, the row and whether N is 1.

template <typename T>
struct SkinnyTile {
  static constexpr int R = 4;
  static constexpr bool kWgmma = false;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t) {
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
            if (c < geo.N) acc[c] = fmaf(a, to_f32(b_s[k * geo.ldb + c]),
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

// ---- the wgmma consumer (bf16, bm = bk = 64): one warpgroup, WN columns
// as WN / 64 atoms of 64; a 64 × 64 weight block is 4 k16 steps.
// a 128-byte-swizzled operand: 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((1024 >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// an unswizzled (interleaved) operand of 8 × 16-byte core matrices, the
// next 8 rows 128 bytes on
__device__ __forceinline__ uint64_t gmma_desc_plain(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)(128 >> 4) << 32;
  return d;
}

#define WG_D8(b) "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), \
    "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), \
    "+f"(d[b + 7])

// D(64 × 64, f32 registers from d[base]) += A(64 × 16, K-major) · B(16 × 64,
// MN-major: the transpose bit)
template <int R, int base>
__device__ __forceinline__ void wgmma_n64(float (&d)[R], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_D8(base), WG_D8(base + 8), WG_D8(base + 16), WG_D8(base + 24)
      : "l"(da), "l"(db), "r"(1));
}

// D(64 × 8) += A(64 × 16, K-major) · B(16 × 8, MN-major)
template <int R>
__device__ __forceinline__ void wgmma_n8(float (&d)[R], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// WN = 8 (N <= 8: decode, the logit head) keeps B as (bk, 8) rows of 16
// bytes; its panel, bulk-copied as the contiguous (bk, N) rows, is laid out
// there by the consumers (zeros past N) before the product.
template <int WN>
struct WgmmaTile {
  static constexpr int R = WN / 2;     // 64 × WN f32 over 128 threads
  static constexpr bool kWgmma = true;

  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const RunGeo& geo, int t) {
    const uint32_t a0 = smem_u32(stage), b0 = a0 + geo.b_off;
    if constexpr (WN == 8) {
      if (geo.b_mode == kBPanel) {
        const __nv_bfloat16* panel =
            reinterpret_cast<const __nv_bfloat16*>(stage + geo.p_off);
        const int k = t / 2, c0 = 4 * (t % 2);
        __align__(8) __nv_bfloat16 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = c0 + e < geo.N ? panel[k * geo.N + c0 + e]
                                : __float2bfloat16(0.0f);
        *reinterpret_cast<uint2*>(const_cast<unsigned char*>(stage) +
                                  geo.b_off + k * 16 + 2 * c0) =
            *reinterpret_cast<const uint2*>(v);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync();
      }
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n8<R>(acc, gmma_desc(a0 + 32 * kk, 16),
                    gmma_desc_plain(b0 + 256 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      return;
    }
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: k16 slice kk is 32 bytes into each swizzled 128-byte row;
      // B: 16 k-rows of 128 bytes; the atom of columns 64 .. 127 follows
      // the first after bk rows
      const uint64_t da = gmma_desc(a0 + 32 * kk, 16);
      wgmma_n64<R, 0>(acc, da, gmma_desc(b0 + 2048 * kk, 1024));
      if constexpr (WN == 128)
        wgmma_n64<R, 32>(acc, da, gmma_desc(b0 + 8192 + 2048 * kk, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  }

  // the accumulator fragment: register h·32 + 4q + e of thread t holds row
  // 16·warp + lane/4 + 8·(e/2), column 64h + 8q + 2·(lane%4) + e%2
  __device__ static bool at(int i, const RunGeo& geo, int t, int& r,
                            int& c) {
    const int w = t / 32, l = t % 32, e = i % 4;
    r = 16 * w + l / 4 + 8 * (e / 2);
    c = 64 * (i / 32) + 8 * ((i % 32) / 4) + 2 * (l % 4) + e % 2;
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
// run, which writes the zeros).
template <typename T, class Tile, bool kPlanned>
__global__ void __launch_bounds__(kThreads, 1)
run_kernel(const __grid_constant__ CUtensorMap a_map,
           const __grid_constant__ CUtensorMap b_map,
           const T* __restrict__ blocks, const int* __restrict__ order,
           const int* __restrict__ step_col, const int* __restrict__ runs,
           const int* __restrict__ row_run_ptr, const T* __restrict__ b,
           float* __restrict__ out, float* __restrict__ scratch,
           int* __restrict__ counters, RunGeo geo) {
  constexpr int R = Tile::R;
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
  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int run = blockIdx.x / kSeg, tile = blockIdx.y, g = blockIdx.z;
  const int n0 = tile * geo.tile;

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
    const int first = runs[4 * run + 1], len = runs[4 * run + 2] - first;
    base = runs[4 * run] * geo.steps;
    s0 = first + len * (int)rank / kSeg;
    s1 = first + len * ((int)rank + 1) / kSeg;
  }
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  if (t >= kConsumers) {
    // ---- producer warp
    const int lane = t - kConsumers;

    int it = 0;
    for (int s = s0; s < s1; ++s) {
      const int col = step_col[base + s];
      if (col < 0) continue;                 // a pad step adds nothing
      const int blk = order[base + s];
      const int st = it % geo.stages;
      mbar_wait(&empty[st], ((it / geo.stages) & 1) ^ 1);
      unsigned char* stage = ring + st * geo.stage_bytes;
      const int64_t brow = (int64_t)g * geo.K + (int64_t)col * geo.bk;
      if (lane == 0) {
        mbar_expect_tx(&full[st], geo.tx);
        if constexpr (Tile::kWgmma)
          tma_2d(stage, &a_map, 0, blk * geo.bm, &full[st]);
        else
          bulk_copy(stage, blocks + (int64_t)blk * geo.bm * geo.bk,
                    geo.bm * geo.bk * sizeof(T), &full[st]);
        if (geo.b_mode == kBTensor) {
          if constexpr (Tile::kWgmma) {
            for (int h = 0; h < (geo.tile + 63) / 64; ++h)
              tma_2d(stage + geo.b_off + h * geo.bk * 128, &b_map,
                     n0 + 64 * h, (int)brow, &full[st]);
          } else {
            tma_2d(stage + geo.b_off, &b_map, n0, (int)brow, &full[st]);
          }
        } else if (geo.b_mode == kBPanel) {
          bulk_copy(stage + geo.p_off, b + brow * geo.N,
                    geo.bk * geo.N * sizeof(T), &full[st]);
        }
      }
      if (geo.b_mode == kBManual) {
        manual_panel<T, Tile>(stage + geo.b_off, b, brow, n0, geo, lane);
        // generic stores, read next by the async proxy (wgmma)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      mbar_arrive(&full[st]);
      ++it;
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroup; warp 0 first finds B4's row while the
    // first blocks load
    if (kPlanned && t < 32 && run < geo.n_runs) {
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
      Tile::step(acc, ring + st * geo.stage_bytes, geo, t);
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

  if constexpr (!kPlanned) {
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) p = nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2D map over rows of `inner` elements, `row_bytes` apart
bool encode_2d(CUtensorMap* map, int dtype, const void* base, uint64_t inner,
               uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
               uint32_t box_outer, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, dtype ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kTiles[7][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 4}, {1, 4},
                              {1, 2}, {1, 1}};

// The FFMA register tile: the one that puts the most of the 128 consumer
// threads to work (the larger tile on a tie); -1 when none fits.
int ffma_tile(int bm, int tile) {
  int best = -1, best_threads = 0;
  for (int c = 0; c < 7; ++c) {
    const int tm = kTiles[c][0], tn = kTiles[c][1];
    if (bm % tm || tile % tn) continue;
    const int threads = (bm / tm) * (tile / tn);
    if (threads <= kConsumers && threads > best_threads) {
      best = c;
      best_threads = threads;
    }
  }
  return best;
}

// Everything a launch needs, from the shapes alone.  kind: 0 / 1 / 2
// wgmma with 8 / 64 / 128 columns, 3 the skinny FFMA tile (N <= 4), 4 + c
// the FFMA tile kTiles[c].
struct RunPlan {
  RunGeo geo;
  int kind, ntiles, frag;       // frag: floats of one partial (128 · R)
  size_t smem;
};

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
    if (wg) {
      g.p_off = g.b_off + b_bytes;           // laid out by the consumers
      b_bytes += bk * N * isz;
    } else {
      g.ldb = N;
      b_bytes = (bk * N + tile) * isz;       // columns past N read garbage
    }
  } else {
    g.b_mode = kBManual;
    g.tx = 0;
  }
  g.tx += bm * bk * isz;
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
  p->ntiles = (N + tile - 1) / tile;
  p->frag = r * kConsumers;
  return cudaSuccess;
}

struct RunArgs {
  CUtensorMap a_map, b_map;
  const void *blocks, *b;
  const int *order, *step_col, *runs, *row_run_ptr;
  float *out, *scratch;
  int* counters;
};

template <typename T, class Tile, bool kPlanned>
cudaError_t launch_runs(const RunArgs& a, const RunGeo& geo, dim3 grid,
                        size_t smem, cudaStream_t stream) {
  auto kernel = run_kernel<T, Tile, kPlanned>;
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

template <typename T, bool kPlanned>
cudaError_t launch_ffma(int c, const RunArgs& a, const RunGeo& geo,
                        dim3 grid, size_t smem, cudaStream_t st) {
  switch (c) {
    case 0: return launch_runs<T, FfmaTile<T, 8, 8>, kPlanned>(a, geo, grid, smem, st);
    case 1: return launch_runs<T, FfmaTile<T, 4, 8>, kPlanned>(a, geo, grid, smem, st);
    case 2: return launch_runs<T, FfmaTile<T, 4, 4>, kPlanned>(a, geo, grid, smem, st);
    case 3: return launch_runs<T, FfmaTile<T, 2, 4>, kPlanned>(a, geo, grid, smem, st);
    case 4: return launch_runs<T, FfmaTile<T, 1, 4>, kPlanned>(a, geo, grid, smem, st);
    case 5: return launch_runs<T, FfmaTile<T, 1, 2>, kPlanned>(a, geo, grid, smem, st);
    case 6: return launch_runs<T, FfmaTile<T, 1, 1>, kPlanned>(a, geo, grid, smem, st);
    default: return cudaErrorInvalidConfiguration;
  }
}

// Maps, then the launch of B1 (kPlanned false) or B4 over `items` runs.
template <bool kPlanned>
cudaError_t launch_walk(RunArgs& a, RunPlan& p, int dtype, int nb, int G,
                        int items, cudaStream_t st) {
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
  if (geo.b_mode == kBTensor &&
      !encode_2d(&a.b_map, dtype, a.b, geo.N, (uint64_t)G * geo.K,
                 (uint64_t)geo.N * isz, swizzled ? 64 : geo.tile, geo.bk,
                 swizzled))
    return cudaErrorInvalidValue;
  const dim3 grid(kSeg * items, p.ntiles, G);
  using bf16 = __nv_bfloat16;
  switch (p.kind) {
    case 0: return launch_runs<bf16, WgmmaTile<8>, kPlanned>(a, geo, grid, p.smem, st);
    case 1: return launch_runs<bf16, WgmmaTile<64>, kPlanned>(a, geo, grid, p.smem, st);
    case 2: return launch_runs<bf16, WgmmaTile<128>, kPlanned>(a, geo, grid, p.smem, st);
    case 3:
      return dtype == 0
          ? launch_runs<float, SkinnyTile<float>, kPlanned>(a, geo, grid, p.smem, st)
          : launch_runs<bf16, SkinnyTile<bf16>, kPlanned>(a, geo, grid, p.smem, st);
    default:
      return dtype == 0
          ? launch_ffma<float, kPlanned>(p.kind - 4, a, geo, grid, p.smem, st)
          : launch_ffma<bf16, kPlanned>(p.kind - 4, a, geo, grid, p.smem, st);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  B is (G, K, N), out (G, gm*bm, N).
// bk must be a multiple of 4 and the block payload 16-byte aligned.
int maple_spmm_naive(const void* blocks, const int* row_ptr,
                     const int* block_col, const void* b, void* out,
                     int dtype, int G, int gm, int K, int N, int bm, int bk,
                     int bn, void* stream) {
  if (G == 0 || gm == 0 || N == 0) return (int)cudaSuccess;
  if (bk % 4) return (int)cudaErrorInvalidValue;
  int tpg = 0;
  const int cfg = pick_config(bm, bn, &tpg);
  const Geom geo = make_geom(K, N, bm, bk, bn, tpg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_CONFIG(cfg, launch_naive, float, blocks, row_ptr, block_col, b,
                    out, G, gm, geo, st)
  }
  if (dtype == 1) {
    DISPATCH_CONFIG(cfg, launch_naive, __nv_bfloat16, blocks, row_ptr,
                    block_col, b, out, G, gm, geo, st)
  }
  return (int)cudaErrorInvalidValue;
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
  return (int)launch_walk<false>(a, p, dtype, nb, G, n_runs,
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
  return (int)launch_walk<true>(a, p, dtype, nb, G, n_runs > 0 ? n_runs : 1,
                                (cudaStream_t)stream);
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
