// Maple block-sparse × dense SpMM kernels for Hopper (sm_90a), f32 FMA.
//
// Three kernels, one shared tile engine:
//
// * maple_spmm_naive — replaces repro/kernels/maple_spmm.py::
//   maple_spmm_batched_pallas (the "naive" schedule).  The TPU kernel walks
//   every block slot, pads included, as one sequential grid axis and the
//   wrapper masks empty block-rows afterwards.  Here one thread block owns
//   one (block-row i, N tile, batch g) output tile and walks the row's
//   slots row_ptr[i] .. row_ptr[i+1] (pads are never visited, and
//   block_col < 0 is masked all the same).  An empty block-row flushes a
//   zero tile, so no mask pass is needed; the tile is cast to the input
//   type once.
//
// * maple_spmm_compact — replaces maple_spmm.py::maple_spmm_compact_pallas
//   (the planned "compact" layout).  The TPU grid runs each of the plan's
//   lanes as one sequential walk; with 8 lanes that would occupy 8 of the
//   132 SMs.  Every (lane, row) run flushes to its own compact slot, so the
//   runs are independent: the host derives the run table once per plan
//   (SpmmPlan.runs) and one thread block runs one (run, N tile, batch g),
//   flushing its f32 tile to the run's slot.  Pad steps (step_col < 0) add
//   nothing; dead slots are never written.
//
// * maple_spmm_planned — replaces maple_spmm.py::maple_spmm_planned_pallas
//   (the planned "rmw" layout).  The TPU kernel runs lanes as a sequential
//   grid axis: a row's first flusher overwrites its output tile, later
//   flushers read it back and add in f32, and rows no lane flushes are left
//   for a mask.  Here a loop inside the block takes the place of that
//   sequential axis: one thread block owns one (block-row i, N tile, batch
//   g) output tile and walks row i's runs in lane order (the host sorts the
//   run table by row, stably: SpmmPlan.row_runs / row_run_ptr).  Each run
//   is zeroed and walked exactly as the compact kernel walks it, then added
//   into the row's f32 accumulator, so a split row sums ((0 + run0) + run1)
//   + ... — the rmw order, and the slot merge's — and the tile is written
//   once.  A row with no run is written as zeros.  No atomics, no flags
//   between blocks.  Since the run walk is the compact kernel's own code,
//   the result equals compact + merge bit for bit on the same plan.  It
//   trades the merge's extra pass over the slot buffer for one block per
//   row: a row split over many lanes is walked by one block, so where the
//   plan splits rows (a power-law pattern, 16 lanes on the MLP) it has
//   fewer blocks in flight than the compact kernel.
//
// What bounds them on the H100: every live weight block is read once per
// N tile, 2·N FLOPs per 4-byte weight element.  Below N ≈ 10 (decode, the
// logit head) that is under the FP32 ridge of 67 TFLOP/s / 3.35 TB/s, so
// the weight bytes bound the kernel and the design is about keeping enough
// loads in flight:
//   - a thread block holds S independent groups of threads.  Group j takes
//     steps j, j + S, ... of the walk, so S weight blocks stream at once.
//     Each group keeps its own (bm, bn) f32 PSB in registers (TM × TN per
//     thread).  At the end the groups' PSBs are summed in group order,
//     0 + 1 + ... + S-1, so the result is the same on every run;
//   - each thread starts its share of a block's loads, 16 bytes each,
//     before it stores any of them to shared memory.
// Prefill (N = 128) is above the ridge; there the register tile reuses
// each shared-memory operand TM or TN times.  Not done yet: overlapping a
// step's loads with the previous step's FMAs (cp.async / TMA), tensor
// cores (wgmma), and sharing one weight block among the G batches.
//
// Plain C interface (bound with ctypes); every launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The walk all three kernels share: steps [first, end) of a step stream, step s
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

// grid: (n_runs, ceil(N / bn), G); runs[r] = (lane, first, end, flat slot)
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
compact_kernel(const T* __restrict__ blocks, const int* __restrict__ order,
               const int* __restrict__ step_col,
               const int* __restrict__ runs, const T* __restrict__ b,
               float* __restrict__ out, int steps, int n_slots, Geom geo) {
  extern __shared__ float smem[];
  const int run = blockIdx.x, n0 = blockIdx.y * geo.bn, g = blockIdx.z;
  const int lane = runs[4 * run], first = runs[4 * run + 1];
  const int end = runs[4 * run + 2], slot = runs[4 * run + 3];
  const int64_t base = (int64_t)lane * steps;
  float acc[TM][TN];
  walk<T, TM, TN>(acc, blocks, b + (int64_t)g * geo.K * geo.N, first, end,
                  n0, geo, smem, [&](int s, int& blk, int& col) {
                    blk = order[base + s];
                    col = step_col[base + s];
                  });
  float* out_tile = out + ((int64_t)g * n_slots + slot) * geo.bm * geo.N;
  flush_tile<float, TM, TN>(acc, out_tile, n0, geo);
}

// A row's running sum lives in a second register tile where two tiles fit
// (TM·TN <= 16), else in shared memory past the walk's area, each thread
// its own elements: with (4, 8) a second register tile spills (ptxas -v),
// so the (64, 128) tiles of N >= 128 keep the sum in shared memory; the
// (4, 4) tiles of decode and the logit head never spill, and extra shared
// memory would cost them occupancy.
template <int TM, int TN>
__host__ __device__ constexpr bool row_in_smem() { return TM * TN > 16; }

// grid: (gm, ceil(N / bn), G); row_runs[r] = (lane, first, end, flat slot),
// sorted by block-row, lane order kept within a row; row i's runs are
// row_runs[row_run_ptr[i] .. row_run_ptr[i + 1]]
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
planned_kernel(const T* __restrict__ blocks, const int* __restrict__ order,
               const int* __restrict__ step_col,
               const int* __restrict__ row_runs,
               const int* __restrict__ row_run_ptr, const T* __restrict__ b,
               float* __restrict__ out, int steps, Geom geo) {
  extern __shared__ float smem[];
  const int i = blockIdx.x, n0 = blockIdx.y * geo.bn, g = blockIdx.z;
  const T* b_g = b + (int64_t)g * geo.K * geo.N;
  float* row_s = smem + walk_floats(geo);
  const int tx_n = geo.bn / TN, ty_n = geo.bm / TM;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const bool holder = threadIdx.x < tx_n * ty_n;    // group 0
  const int r0 = row_run_ptr[i], r1 = row_run_ptr[i + 1];
  float acc[TM][TN], row[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = row[u][v] = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const int lane = row_runs[4 * r], first = row_runs[4 * r + 1];
    const int end = row_runs[4 * r + 2];
    const int64_t base = (int64_t)lane * steps;
    walk<T, TM, TN>(acc, blocks, b_g, first, end, n0, geo, smem,
                    [&](int s, int& blk, int& col) {
                      blk = order[base + s];
                      col = step_col[base + s];
                    });
    if (holder) {
      // the row so far (0 before its first run) plus this run's PSB
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          if constexpr (row_in_smem<TM, TN>()) {
            float* keep = row_s + (ty + u * ty_n) * geo.bn + tx + v * tx_n;
            acc[u][v] = (r == r0 ? 0.0f : *keep) + acc[u][v];
            if (r + 1 < r1) *keep = acc[u][v];
          } else {
            row[u][v] += acc[u][v];
          }
        }
    }
    // the next walk reuses shared memory that group 0 may still be reading
    __syncthreads();
  }
  float* out_tile = out + ((int64_t)g * gridDim.x + i) * geo.bm * geo.N;
  if constexpr (row_in_smem<TM, TN>())
    flush_tile<float, TM, TN>(acc, out_tile, n0, geo);
  else
    flush_tile<float, TM, TN>(row, out_tile, n0, geo);
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

template <typename T, int TM, int TN>
cudaError_t launch_compact(const void* blocks, const int* order,
                           const int* step_col, const int* runs,
                           const void* b, float* out, int G, int n_runs,
                           int steps, int n_slots, const Geom& geo,
                           cudaStream_t stream) {
  const dim3 grid(n_runs, (geo.N + geo.bn - 1) / geo.bn, G);
  const int threads = geo.groups * (geo.bm / TM) * (geo.bn / TN);
  const size_t smem = smem_bytes(geo);
  cudaError_t err = prepare(compact_kernel<T, TM, TN>, smem);
  if (err != cudaSuccess) return err;
  compact_kernel<T, TM, TN><<<grid, threads, smem, stream>>>(
      (const T*)blocks, order, step_col, runs, (const T*)b, out, steps,
      n_slots, geo);
  return cudaGetLastError();
}

template <typename T, int TM, int TN>
cudaError_t launch_planned(const void* blocks, const int* order,
                           const int* step_col, const int* row_runs,
                           const int* row_run_ptr, const void* b, float* out,
                           int G, int gm, int steps, const Geom& geo,
                           cudaStream_t stream) {
  const dim3 grid(gm, (geo.N + geo.bn - 1) / geo.bn, G);
  const int threads = geo.groups * (geo.bm / TM) * (geo.bn / TN);
  // the walk's area, then the row's running sum where it is kept there
  const size_t smem = smem_bytes(geo) + (row_in_smem<TM, TN>()
      ? sizeof(float) * geo.bm * geo.bn : 0);
  cudaError_t err = prepare(planned_kernel<T, TM, TN>, smem);
  if (err != cudaSuccess) return err;
  planned_kernel<T, TM, TN><<<grid, threads, smem, stream>>>(
      (const T*)blocks, order, step_col, row_runs, row_run_ptr, (const T*)b,
      out, steps, geo);
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

// order / step_col are (L, steps) flattened; runs (n_runs, 4); out is the
// f32 compact tile buffer (G, n_slots * bm, N) with n_slots = L * r_max.
int maple_spmm_compact(const void* blocks, const int* order,
                       const int* step_col, const int* runs, const void* b,
                       float* out, int dtype, int G, int n_runs, int steps,
                       int n_slots, int K, int N, int bm, int bk, int bn,
                       void* stream) {
  if (G == 0 || n_runs == 0 || N == 0) return (int)cudaSuccess;
  if (bk % 4) return (int)cudaErrorInvalidValue;
  int tpg = 0;
  const int cfg = pick_config(bm, bn, &tpg);
  const Geom geo = make_geom(K, N, bm, bk, bn, tpg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_CONFIG(cfg, launch_compact, float, blocks, order, step_col,
                    runs, b, out, G, n_runs, steps, n_slots, geo, st)
  }
  if (dtype == 1) {
    DISPATCH_CONFIG(cfg, launch_compact, __nv_bfloat16, blocks, order,
                    step_col, runs, b, out, G, n_runs, steps, n_slots, geo,
                    st)
  }
  return (int)cudaErrorInvalidValue;
}

// row_runs (n_runs, 4) sorted by block-row, row_run_ptr (gm + 1); out is
// the merged f32 result (G, gm * bm, N), every row written.
int maple_spmm_planned(const void* blocks, const int* order,
                       const int* step_col, const int* row_runs,
                       const int* row_run_ptr, const void* b, float* out,
                       int dtype, int G, int gm, int steps, int K, int N,
                       int bm, int bk, int bn, void* stream) {
  if (G == 0 || gm == 0 || N == 0) return (int)cudaSuccess;
  if (bk % 4) return (int)cudaErrorInvalidValue;
  int tpg = 0;
  const int cfg = pick_config(bm, bn, &tpg);
  const Geom geo = make_geom(K, N, bm, bk, bn, tpg);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_CONFIG(cfg, launch_planned, float, blocks, order, step_col,
                    row_runs, row_run_ptr, b, out, G, gm, steps, geo, st)
  }
  if (dtype == 1) {
    DISPATCH_CONFIG(cfg, launch_planned, __nv_bfloat16, blocks, order,
                    step_col, row_runs, row_run_ptr, b, out, G, gm, steps,
                    geo, st)
  }
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
