// Maple two-phase SpGEMM for Hopper (sm_90a): the numeric phase (B5), the
// dA of its backward (B6) and the dB.
//
// Replaces repro/kernels/maple_spgemm.py::maple_spgemm_pallas (B5) and
// repro/kernels/maple_sddmm.py::maple_sddmm_csr_pallas (B6); dB replaces
// the XLA scatter-add of repro/kernels/ops.py::_spgemm_value_call.
//
// The symbolic phase (kernels/schedule.py::plan_spgemm, on the host) has
// fixed C's pattern and, for every partial product A[i,k']·B[k',u], its
// position within output row i.  SpgemmPlan.on_device hands the kernels
// that plan in A's CSR slot order: slot s of row i (a_rptr[i] <= s <
// a_rptr[i+1]) consumes B row a_cols[s] (b_rptr[k'] .. b_rptr[k'+1]), and
// its partials land at positions pos[part_ptr[s] + u] of row i, whose
// values sit at out_rptr[i] .. out_rptr[i+1] of C's value vector.
//
// The TPU kernel walks 8 lanes of rows serially, one A slot per grid step,
// with a (1, lc) f32 PSB in VMEM.  Rows are atomic in the plan, so here a
// group of 8 lanes owns one output row (B5, B6) or one B row (dB), four a
// warp.  B rows average 15 entries on cage12 and 25 on poisson3Da: a warp
// a row would leave half its lanes idle in every slot.  Where a plan has
// too few rows to fill the card at 8 lanes a row (poisson3Da's 14 000),
// B5 takes a warp a row instead, with twice the slots in flight.
//
//  * B5: the group zeroes a PSB of the row's C length in shared memory,
//    applies the row's slots in order (lane j adds the partials j, j + 8,
//    ... of a slot; the partials of one slot go to distinct positions, so
//    no atomics), __syncwarp between slots, and flushes the PSB straight
//    into C's value vector (the reference's ELL -> CSR compaction, fused;
//    no (m+1, lc) buffer).  Products and sums round as the plain version's
//    do (__fmul_rn then __fadd_rn: no FMA contraction), so the two agree
//    bit for bit in f32.  Derived once per device (SpgemmPlan.on_device):
//    a record a row (first slot, slot count, C length, partial count; C
//    offset, first partial) and each slot's B row start and length
//    (slot_b).  The group asks L2 for the row's whole run of positions as
//    soon as its record arrives; lane j fetches slot t0 + j's B row in one
//    8-byte load and a scan over the group gives each slot's first
//    partial, so the pos and B gathers wait on two dependent loads (record,
//    slot_b) where a_rptr -> a_cols -> b_rptr made three, and find pos in
//    L2.  The first KS steps of G terms of D slots are loaded before
//    their updates; MAPLE_SPGEMM_ROUTES holds the routes (G, D, KS): 8
//    lanes, 2 slots and 3 steps (24 terms: cage12's B rows of 15) where
//    rows · 8 lanes fill the card's threads, else 32 lanes, 4 slots and
//    one step (poisson3Da's 14 000 rows of 25 slots: half its time at 8
//    lanes).
//  * B6: dA[s] = Σ_u B[k', u] · dC[out_rptr[i] + pos[part_ptr[s] + u]],
//    written into A's value layout at s.  A group of kCsrGroup = 8 lanes
//    owns row i (three steps of 8 cover cage12's B rows of about 15
//    entries; four rows a warp).  Lane j takes the terms j, j + 8, ... of
//    each slot's B row, the first kCsrSteps terms of kCsrDepth slots loaded together
//    (pos, B and the dC gathers through __ldg: a row's dC values are a
//    few lines of L1 that all its slots reuse), and a fixed xor-shuffle
//    tree sums each slot: reruns give the same bits.
//  * dB: a group of kDbGroup lanes owns B row k'; lane j owns B[k', j],
//    B[k', j + 8], ... and sums A[s] · dC[out_rptr[row(s)] + pos(s, u)]
//    over A's column fiber k' in fiber (row) order with one FMA chain an
//    entry: a fixed order, no atomics, so two runs give the same bits.
//    Derived once per device: a record a B row (its start and length, its
//    fiber's start and length, where its partials begin) and the
//    fiber-ordered copy of the positions with each row's C offset folded
//    in (t_cpos: fiber k''s partials are a (fiber length, B row length)
//    block), so a term is one coalesced index load and one dC gather after
//    the record, where t_perm -> part_ptr / a_rows -> out_rptr -> pos -> dC
//    made four.  kDbDepth fiber entries' first kDbSteps terms are loaded
//    before their FMAs.
//
// Both records list the rows of each window of 32 in descending order of
// slot count (B5) or fiber length (dB): a warp's four rows end nearly
// together (1.06 times the mean row where neighbours took 1.27 on
// cage12), and a block keeps neighbouring rows, which share B rows (B5)
// and C rows (dB) in L1; a sort over all rows lost that and was slower.
//
// What bounds it on the H100: bytes.  Per partial product a 4-byte
// position and a B value (B5, B6) or a dC value (B6, dB) are read once;
// 2 flops per partial cannot bound it (62 MFLOP at cage12 against ~0.06 ms
// of bytes).  The work is gathers of at most lb values at scattered
// addresses, not tiles, so no TMA or wgmma: the design keeps many short
// dependent-load chains in flight instead (groups sized to the B rows,
// fewer levels, the index stream prefetched, several slots' loads issued
// together).
//
// Plain C interface (bound with ctypes); each launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kCsrGroup = 8;     // B6: lanes an output row and a slot,
constexpr int kCsrDepth = 2;     // slots a lane group has in flight,
constexpr int kCsrSteps = 3;     // the first steps of 8 terms of each
constexpr int kDbGroup = 8;      // dB: lanes a B row,
constexpr int kDbDepth = 8;      // fiber entries a group has in flight,
constexpr int kDbSteps = 3;      // the first steps of 8 terms of each
constexpr unsigned kFull = 0xffffffffu;

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
  return __float2bfloat16_rn(v);
}

// The plan in A's CSR slot order (SpgemmPlan.on_device).
struct Plan {
  const int* a_rptr;          // (m + 1)
  const int* a_cols;          // (nnz_a)
  const int* b_rptr;          // (k + 1)
  const long long* part_ptr;  // (nnz_a + 1)
  const int* pos;             // (P)
  const long long* out_rptr;  // (m + 1)
};

// The largest of v over the warp's lane groups of width G.
template <int G>
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = G; off < kWarp; off *= 2)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Lane j of a group of G asks L2 for the 128-byte lines j, j + G, ... of
// n ints from p: a row's index stream, fetched while its metadata loads
// are in flight, so the gathers behind them find it in L2.
template <int G>
__device__ __forceinline__ void prefetch_l2(const int* p, int n, int j) {
  if (n <= 0) return;
  const char* end = (const char*)(p + n);
  for (const char* a = (const char*)((uintptr_t)p & ~(uintptr_t)127) +
                       128 * j;
       a < end; a += 128 * G)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

// ---------------------------------------------------------------- B5 ----
// grid: (ceil(m / rows),), block: rows · G lanes rounded up to warps;
// shared: rows · lc floats.  G lanes a row, D slots in flight, the first
// KS steps of G terms of each loaded at once.  Every loop runs to the
// warp's longest row, so the shuffles see all 32 lanes; a group past its
// row does nothing.
template <typename T, int G, int D, int KS>
__global__ void __launch_bounds__(256)
spgemm_kernel(const T* __restrict__ a_val, const T* __restrict__ b_val,
              const int4* __restrict__ row_meta,
              const longlong2* __restrict__ row_base,
              const int2* __restrict__ slot_b, const int* __restrict__ pos,
              T* __restrict__ out, int m, int lc, int rows) {
  extern __shared__ float smem[];
  const int j = threadIdx.x % G, r = threadIdx.x / G;
  const int at_row = blockIdx.x * rows + r;   // in the plan's row order
  int s0 = 0, n_s = 0, n_c = 0, n_p = 0;
  long long c0 = 0, pp0 = 0;
  if (r < rows && at_row < m) {
    const int4 rec = __ldg(row_meta + at_row);
    const longlong2 base = __ldg(row_base + at_row);
    s0 = rec.x;
    n_s = rec.z ? rec.y : 0;            // no C entry: its B rows are empty
    n_c = rec.z;
    n_p = rec.w;
    c0 = base.x;
    pp0 = base.y;
  }
  const int* pos_row = pos + pp0;
  prefetch_l2<G>(pos_row, n_p, j);
  float* psb = smem + (size_t)r * lc;
  for (int p = j; p < n_c; p += G) psb[p] = 0.0f;
  const int n_max = warp_max<G>(n_s);
  __syncwarp();
  int pp_next = 0;                      // the row's partials before slot t0
  for (int t0 = 0; t0 < n_max; t0 += G) {
    // lane j fetches slot t0 + j: its B row and A value; a scan over the
    // group of the B rows' lengths gives each slot's first partial
    int my_b0 = 0, my_bn = 0;
    float my_a = 0.0f;
    if (t0 + j < n_s) {
      const int2 sb = __ldg(slot_b + s0 + t0 + j);
      my_b0 = sb.x;
      my_bn = sb.y;
      my_a = to_f32(a_val[s0 + t0 + j]);
    }
    int incl = my_bn;
#pragma unroll
    for (int off = 1; off < G; off *= 2) {
      const int v = __shfl_up_sync(kFull, incl, off, G);
      if (j >= off) incl += v;
    }
    const int my_pp = pp_next + incl - my_bn;
    pp_next += __shfl_sync(kFull, incl, G - 1, G);
    const int span = min(G, n_max - t0);
    for (int d0 = 0; d0 < span; d0 += D) {
      int b0[D], bn[D], pp[D], at[D][KS];
      float a[D], pr[D][KS];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int src = (d0 + d) & (G - 1);
        b0[d] = __shfl_sync(kFull, my_b0, src, G);
        bn[d] = __shfl_sync(kFull, my_bn, src, G);
        pp[d] = __shfl_sync(kFull, my_pp, src, G);
        a[d] = __shfl_sync(kFull, my_a, src, G);
        if (d0 + d >= span) bn[d] = 0;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int u = j + k * G;
          at[d][k] = -1;
          if (u < bn[d]) {
            at[d][k] = __ldg(pos_row + pp[d] + u);
            pr[d][k] = __fmul_rn(a[d], to_f32(__ldg(b_val + b0[d] + u)));
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d0 + d >= span) break;      // the same for every lane
#pragma unroll
        for (int k = 0; k < KS; ++k)
          if (at[d][k] >= 0) psb[at[d][k]] = __fadd_rn(psb[at[d][k]],
                                                        pr[d][k]);
        for (int u = j + KS * G; u < bn[d]; u += G) {   // rows over KS·G
          const int p = __ldg(pos_row + pp[d] + u);
          psb[p] = __fadd_rn(psb[p],
                             __fmul_rn(a[d], to_f32(__ldg(b_val + b0[d] + u))));
        }
        __syncwarp();
      }
    }
  }
  for (int p = j; p < n_c; p += G) out[c0 + p] = from_f32<T>(psb[p]);
}

// ---------------------------------------------------------------- B6 ----
// grid: (ceil(m / (warps · 4)),), block: warps · 32.  A group of G = 8
// lanes owns one output row (4 rows a warp) and walks the row's
// slots one at a time: lane j takes terms j, j + G, ... of the slot's B
// row, the first kCsrSteps terms of kCsrDepth slots loaded together, and
// the group's terms meet in a fixed xor-shuffle tree.  The row's dC
// values are gathered through L1 (__ldg): they are a few cache lines
// that every slot of the row reuses.
template <typename T>
__global__ void __launch_bounds__(256)
sddmm_csr_kernel(const T* __restrict__ dc, const T* __restrict__ b_val,
                 Plan plan, float* __restrict__ da, int m) {
  constexpr int G = kCsrGroup, D = kCsrDepth, KS = kCsrSteps;
  const int lane = threadIdx.x % kWarp, j = lane % G;
  const int row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  int s0 = 0, n_s = 0;
  long long pp_row = 0;
  const T* dc_row = dc;
  if (row < m) {
    s0 = __ldg(plan.a_rptr + row);
    n_s = __ldg(plan.a_rptr + row + 1) - s0;
    dc_row = dc + __ldg(plan.out_rptr + row);
    if (n_s) pp_row = __ldg(plan.part_ptr + s0);
  }
  // the warp walks as many slots as its longest row has
  int n_max = n_s;
#pragma unroll
  for (int off = G; off < kWarp; off *= 2)
    n_max = max(n_max, __shfl_xor_sync(kFull, n_max, off));
  const int* pos_row = plan.pos + pp_row;     // partials from the row's first
  for (int t0 = 0; t0 < n_max; t0 += G) {
    // lane j fetches slot t0 + j of its row: its B row and first partial
    int my_b0 = 0, my_bn = 0, my_pp = 0;
    if (t0 + j < n_s) {
      const int s = s0 + t0 + j;
      const int col = __ldg(plan.a_cols + s);
      my_pp = (int)(__ldg(plan.part_ptr + s) - pp_row);
      my_b0 = __ldg(plan.b_rptr + col);
      my_bn = __ldg(plan.b_rptr + col + 1) - my_b0;
    }
    const int span = min(G, n_max - t0);
    for (int d0 = 0; d0 < span; d0 += D) {
      int b0[D], bn[D], pp[D], at[D][KS];
      float bv[D][KS];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int src = (d0 + d) & (G - 1);
        b0[d] = __shfl_sync(kFull, my_b0, src, G);
        bn[d] = __shfl_sync(kFull, my_bn, src, G);
        pp[d] = __shfl_sync(kFull, my_pp, src, G);
        if (d0 + d >= span || t0 + d0 + d >= n_s) bn[d] = 0;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int u = j + k * G;
          at[d][k] = -1;
          if (u < bn[d]) {
            at[d][k] = __ldg(pos_row + pp[d] + u);
            bv[d][k] = to_f32(__ldg(b_val + b0[d] + u));
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float acc = at[d][0] >= 0
                        ? bv[d][0] * to_f32(__ldg(dc_row + at[d][0])) : 0.0f;
#pragma unroll
        for (int k = 1; k < KS; ++k)
          if (at[d][k] >= 0)
            acc = fmaf(bv[d][k], to_f32(__ldg(dc_row + at[d][k])), acc);
        for (int u = j + KS * G; u < bn[d]; u += G)   // rows over KS·G
          acc = fmaf(to_f32(__ldg(b_val + b0[d] + u)),
                     to_f32(__ldg(dc_row + __ldg(pos_row + pp[d] + u))),
                     acc);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2)
          acc += __shfl_xor_sync(kFull, acc, off);
        const int t = t0 + d0 + d;
        if (j == 0 && d0 + d < span && t < n_s) da[s0 + t] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------- dB ----
// grid: (ceil(kb / (warps · 32 / G)),), block: warps · 32.  Passes of KS·G
// terms cover B rows longer than one; every loop runs to the warp's
// longest row and fiber.
template <typename T>
__global__ void __launch_bounds__(256)
spgemm_db_kernel(const T* __restrict__ dc, const T* __restrict__ a_val,
                 const int4* __restrict__ fiber_meta,
                 const long long* __restrict__ fiber_base,
                 const int* __restrict__ t_perm,
                 const int* __restrict__ t_cpos, float* __restrict__ db,
                 int kb) {
  constexpr int G = kDbGroup, D = kDbDepth, KS = kDbSteps;
  const int j = threadIdx.x % G;
  const int at_row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  int b0 = 0, bn = 0, f0 = 0, n_f = 0;
  const int* cpos = t_cpos;
  if (at_row < kb) {                    // in the plan's B row order
    const int4 rec = __ldg(fiber_meta + at_row);
    b0 = rec.x;
    bn = rec.y;
    f0 = rec.z;
    n_f = bn ? rec.w : 0;
    cpos = t_cpos + __ldg(fiber_base + at_row);
  }
  const int n_max = warp_max<G>(n_f), bn_max = warp_max<G>(bn);
  for (int u0 = 0; u0 < bn_max; u0 += KS * G) {
    float acc[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) acc[q] = 0.0f;
    for (int t0 = 0; t0 < n_max; t0 += G) {
      // lane j fetches fiber entry t0 + j's A value
      float my_a = 0.0f;
      if (t0 + j < n_f) my_a = to_f32(a_val[__ldg(t_perm + f0 + t0 + j)]);
      const int span = min(G, n_max - t0);
      for (int d0 = 0; d0 < span; d0 += D) {
        int at[D][KS];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = t0 + d0 + d;
#pragma unroll
          for (int q = 0; q < KS; ++q) {
            const int u = u0 + j + q * G;
            at[d][q] = d0 + d < span && t < n_f && u < bn
                           ? __ldg(cpos + (size_t)t * bn + u) : -1;
          }
        }
        float g[D][KS];
#pragma unroll
        for (int d = 0; d < D; ++d)
#pragma unroll
          for (int q = 0; q < KS; ++q)
            g[d][q] = at[d][q] >= 0 ? to_f32(__ldg(dc + at[d][q])) : 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float a = __shfl_sync(kFull, my_a, (d0 + d) & (G - 1), G);
          if (d0 + d < span && t0 + d0 + d < n_f)
#pragma unroll
            for (int q = 0; q < KS; ++q) acc[q] = fmaf(a, g[d][q], acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int u = u0 + j + q * G;
      if (u < bn) db[b0 + u] = acc[q];
    }
  }
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int G, int D, int KS>
cudaError_t launch_spgemm(const void* a_val, const void* b_val,
                          const int4* row_meta, const longlong2* row_base,
                          const int2* slot_b, const int* pos, void* out,
                          int m, int lc, int rows, cudaStream_t st) {
  rows = rows < 256 / G ? rows : 256 / G;
  const size_t smem = sizeof(float) * (size_t)rows * lc;
  const cudaError_t err = fit_smem(spgemm_kernel<T, G, D, KS>, smem);
  if (err != cudaSuccess) return err;
  const int threads = (rows * G + kWarp - 1) / kWarp * kWarp;
  spgemm_kernel<T, G, D, KS><<<(m + rows - 1) / rows, threads, smem, st>>>(
      (const T*)a_val, (const T*)b_val, row_meta, row_base, slot_b, pos,
      (T*)out, m, lc, rows);
  return cudaGetLastError();
}

// B5's routes, by index: X(route, lanes a row G, slots in flight D, steps
// KS of G terms of a slot loaded at once).  Route 0 where the rows at G
// lanes fill the card's threads at least once (cage12's 130 000 rows: 3.8
// times on an H100), else route 1, a warp a row (poisson3Da's 14 000: 0.4
// times).  The threshold lies between those two measured points; no
// timed matrix sits near it.
#define MAPLE_SPGEMM_ROUTES(X) X(0, 8, 2, 3) X(1, 32, 4, 1)

template <typename T>
cudaError_t launch_spgemm(const void* a_val, const void* b_val,
                          const int4* row_meta, const longlong2* row_base,
                          const int2* slot_b, const int* pos, void* out,
                          int m, int lc, int rows, int route,
                          cudaStream_t st) {
#define MAPLE_SPGEMM_LAUNCH(R, G, D, KS)                                   \
  if (route == R)                                                         \
    return launch_spgemm<T, G, D, KS>(a_val, b_val, row_meta, row_base,  \
                                      slot_b, pos, out, m, lc, rows, st);
  MAPLE_SPGEMM_ROUTES(MAPLE_SPGEMM_LAUNCH)
#undef MAPLE_SPGEMM_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_sddmm(const void* dc, const void* b_val, const Plan& plan,
                         float* da, int m, int warps, cudaStream_t st) {
  const int rows = warps * kWarp / kCsrGroup;     // rows a CTA
  sddmm_csr_kernel<T><<<(m + rows - 1) / rows, warps * kWarp, 0, st>>>(
      (const T*)dc, (const T*)b_val, plan, da, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_db(const void* dc, const void* a_val,
                      const int4* fiber_meta, const long long* fiber_base,
                      const int* t_perm, const int* t_cpos, float* db,
                      int kb, int warps, cudaStream_t st) {
  const int rows = warps * kWarp / kDbGroup;      // B rows a CTA
  spgemm_db_kernel<T><<<(kb + rows - 1) / rows, warps * kWarp, 0, st>>>(
      (const T*)dc, (const T*)a_val, fiber_meta, fiber_base, t_perm, t_cpos,
      db, kb);
  return cudaGetLastError();
}

bool bad_warps(int warps) { return warps < 1 || warps > 32; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the two value operands alike).

// B5: C's value vector out[0 .. nnz(C)] in the values' dtype (slots past
// it are the caller's).  lc is the longest output row; rows the most
// output rows a block takes (its PSBs: rows · lc floats of shared memory;
// at most 256 / G are taken); route an index of MAPLE_SPGEMM_ROUTES
// (maple_spgemm_route picks it).  In the plan's row order, row_meta =
// (first slot, slot count, C length, partial count) and row_base = (C
// offset, first partial) of each output row; slot_b[s] = (start, length)
// of the B row A slot s consumes.
int maple_spgemm(const void* a_val, const void* b_val, const int* row_meta,
                 const long long* row_base, const int* slot_b, const int* pos,
                 void* out, int dtype, int m, int lc, int rows, int route,
                 void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (rows < 1 || lc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* meta = (const int4*)row_meta;
  const longlong2* base = (const longlong2*)row_base;
  const int2* sb = (const int2*)slot_b;
  if (dtype == 0)
    return (int)launch_spgemm<float>(a_val, b_val, meta, base, sb, pos, out,
                                     m, lc, rows, route, st);
  if (dtype == 1)
    return (int)launch_spgemm<__nv_bfloat16>(a_val, b_val, meta, base, sb,
                                             pos, out, m, lc, rows, route,
                                             st);
  return (int)cudaErrorInvalidValue;
}

// B5's route for m output rows on `device`: 0 where m · G(0) fills the
// card's threads (SMs · threads an SM) at least once, else 1; -1 on error.
int maple_spgemm_route(int m, int device) {
  int sms = 0, threads = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess ||
      cudaDeviceGetAttribute(&threads,
                             cudaDevAttrMaxThreadsPerMultiProcessor,
                             device) != cudaSuccess)
    return -1;
  int lanes = 0;
#define MAPLE_SPGEMM_LANES(R, G, D, KS) if (R == 0) lanes = G;
  MAPLE_SPGEMM_ROUTES(MAPLE_SPGEMM_LANES)
#undef MAPLE_SPGEMM_LANES
  return (long long)m * lanes >= (long long)sms * threads ? 0 : 1;
}

// The number of B5's routes; shape[0 .. 2] = (G, D, KS) of `route`, where
// it is one.
int maple_spgemm_route_shape(int route, int* shape) {
  int n = 0;
#define MAPLE_SPGEMM_SHAPE(R, G, D, KS)                                    \
  ++n;                                                                    \
  if (shape && route == R) shape[0] = G, shape[1] = D, shape[2] = KS;
  MAPLE_SPGEMM_ROUTES(MAPLE_SPGEMM_SHAPE)
#undef MAPLE_SPGEMM_SHAPE
  return n;
}

// B6: da[a_rptr[0] .. a_rptr[m]] (f32), one value per live A slot.
int maple_sddmm_csr(const void* dc, const void* b_val, const int* a_rptr,
                    const int* a_cols, const int* b_rptr,
                    const long long* part_ptr, const int* pos,
                    const long long* out_rptr, float* da, int dtype, int m,
                    int warps, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (bad_warps(warps) || warps > 8) return (int)cudaErrorInvalidValue;
  const Plan plan{a_rptr, a_cols, b_rptr, part_ptr, pos, out_rptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_sddmm<float>(dc, b_val, plan, da, m, warps, st);
  if (dtype == 1)
    return (int)launch_sddmm<__nv_bfloat16>(dc, b_val, plan, da, m, warps,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// dB: db[0 .. nnz(B)] (f32), one value per live B entry.  In the plan's
// B row order, fiber_meta = (B row start, length, first fiber entry,
// fiber length) and fiber_base = the row's first index into t_cpos; the
// fiber's partials, in fiber order, are t_cpos[base + f · length + u],
// each the C slot (out_rptr[row] + pos) that the partial of fiber entry f
// (A slot t_perm[first + f]) and B entry u lands in.
int maple_spgemm_db(const void* dc, const void* a_val, const int* fiber_meta,
                    const long long* fiber_base, const int* t_perm,
                    const int* t_cpos, float* db, int dtype, int kb,
                    int warps, void* stream) {
  if (kb == 0) return (int)cudaSuccess;
  if (bad_warps(warps) || warps > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* meta = (const int4*)fiber_meta;
  if (dtype == 0)
    return (int)launch_db<float>(dc, a_val, meta, fiber_base, t_perm, t_cpos,
                                 db, kb, warps, st);
  if (dtype == 1)
    return (int)launch_db<__nv_bfloat16>(dc, a_val, meta, fiber_base, t_perm,
                                         t_cpos, db, kb, warps, st);
  return (int)cudaErrorInvalidValue;
}

// The shared memory one block may opt in to on `device`, in bytes (the
// PSB of B5 must fit in it), or -1 on error.
int maple_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
